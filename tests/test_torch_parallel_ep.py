"""PyTorch port vs the JAX package: expert parallelism (parallel/ep.py,
ep_serve.py and the engine's ep mode) on gloo ranks.

The port's side runs in four rank processes started once for the file
(tests/mesh_ranks.py, one intra-op thread each); every job builds its own
mesh. The JAX side runs here on the CPU devices of tests/conftest.py, on the
mesh of the same shape: JAX mesh device r is the port's rank r. Every
replica gets tokens of its own, so an exchange that returned another
shard's blocks would show. Inputs come from numpy seeds and the JAX
package's PRNG keys; JAX params travel to the port through params_from_jax,
bit for bit.

Tolerances are the JAX package's for its ep mesh against one device
(tests/test_moe_pp.py, tests/test_moe_ep_serve.py): logits and gradients
within 1e-4, the loss within 1e-5, tokens and shards exactly. One JAX
interpret-mode paged call (one ep_decode_step) and three JAX ep engine runs
(ep = 2, ep = 2 x tp = 2, dp = 2 x ep = 2); the engine's other features are
held to the port's own single-device engine.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from xf_flash_attention_cutlass_tpu.models import moe as jmoe
from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
)
from xf_flash_attention_cutlass_tpu.parallel import (
    make_mesh as j_make_mesh,
    moe_ep_forward as j_moe_ep_forward,
    moe_ep_loss_and_grad as j_moe_ep_loss_and_grad,
    shard_moe_params as j_shard_moe_params,
)
from xf_flash_attention_cutlass_tpu.parallel.ep import (
    moe_param_partition_specs as j_moe_param_partition_specs,
)
from xf_flash_attention_cutlass_tpu.parallel.ep_serve import (
    ep_decode_step as j_ep_decode_step,
    ep_param_partition_specs as j_ep_param_partition_specs,
    shard_ep as j_shard_ep,
)
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
)
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.models.moe import (
    MoEConfig,
    expert_capacity,
    quantize_moe_params,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.ep import moe_param_partition_specs
from xf_flash_attention_cutlass_tpu_torch.parallel.ep_serve import ep_param_partition_specs
from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, EngineConfig
from xf_flash_attention_cutlass_tpu_torch.serve.engine import prefill_chunk_core

# the MoE models of the JAX package's tests/test_moe_pp.py (training, the
# default capacity factor: tokens drop) and tests/test_moe_ep_serve.py
TRAIN_MOE = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=96,
                 max_seq_len=256, n_experts=4, top_k=2)
SERVE_MOE = dict(TRAIN_MOE, n_kv_heads=2, capacity_factor=8.0)
BASE = dict(max_batch=4, page_size=16, num_pages=64, max_seq=256, prefill_chunk=32,
            prefill_lanes=2)
# tests/test_moe_ep_serve.py's engine prompts
PROMPTS = {0: [(7 * i + 3) % 64 for i in range(21)], 1: [5, 9, 2],
           2: [11, 3, 8, 2, 60, 17], 3: [1, 2, 3, 4, 5, 6, 7, 8, 9]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = mesh_ranks.Ranks(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _model(kw):
    """(JAX cfg, JAX f32 params, port cfg, port params)."""
    jcfg = jmoe.MoEConfig(**kw)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, MoEConfig(**kw), params_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def train_model():
    return _model(TRAIN_MOE)


@pytest.fixture(scope="module")
def serve_model():
    return _model(SERVE_MOE)


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return j_make_mesh(**axes, devices=jax.devices("cpu")[:n])


def _paths(tree, path=()):
    """(path, leaf) of every tensor leaf of a tree of dicts and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _jspec(spec, ndim):
    """A JAX PartitionSpec as the port's tuple, one entry a dim."""
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---- the training layer ----------------------------------------------------

def test_expert_capacity_signature_matches_jax(train_model):
    """expert_capacity takes the JAX package's arguments, ep included, and
    gives its counts: as there, ep does not enter the count (each shard's
    capacity comes from its own tokens)."""
    jcfg, _, cfg, _ = train_model

    def params(fn):
        return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]

    assert params(expert_capacity) == params(jmoe.expert_capacity)
    for n in (1, 8, 37, 256):
        for ep in (1, 2, 4):
            assert expert_capacity(cfg, n, ep) == jmoe.expert_capacity(jcfg, n, ep), (n, ep)


@pytest.mark.parametrize("dp,ep", [(1, 2), (2, 2), (1, 4)])
def test_moe_ep_forward_matches_jax(ranks, train_model, dp, ep):
    """moe_ep_forward on a dp x ep mesh against the JAX one: each replica's
    rows within 1e-4 (the capacity from its own 32 tokens: drops included),
    the aux loss the replicas' mean on every rank."""
    jcfg, jp, cfg, params = train_model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2 * dp * ep, 16))
    mesh = _jmesh(dp=dp, ep=ep)
    want, jaux = j_moe_ep_forward(j_shard_moe_params(jp, mesh), jnp.asarray(tokens), jcfg, mesh)
    outs = ranks.run(mesh_ranks.ep_forward, params, torch.from_numpy(tokens), cfg, dp=dp, ep=ep)
    got = torch.cat([logits for logits, _ in outs]).numpy()
    assert got.shape == want.shape
    assert _max_err(got, want) < 1e-4
    for _, aux in outs:
        assert abs(float(aux) - float(jaux)) < 1e-5


def test_moe_ep_loss_and_grad_matches_jax(ranks, train_model):
    """moe_ep_loss_and_grad on dp = 2 x ep = 2 against the JAX one: the loss
    within 1e-5, every gradient (expert leaves joined over ep) within 1e-4;
    the dp replicas hold the same gradients, and replicated leaves' are the
    same on every rank."""
    jcfg, jp, cfg, params = train_model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 17))
    mesh = _jmesh(dp=2, ep=2)
    jloss, jgrads = j_moe_ep_loss_and_grad(j_shard_moe_params(jp, mesh), jnp.asarray(tokens),
                                           jcfg, mesh)
    outs = ranks.run(mesh_ranks.ep_loss_and_grad, params, torch.from_numpy(tokens), cfg,
                     dp=2, ep=2)
    for loss, _ in outs:
        assert abs(float(loss) - float(jloss)) < 1e-5
    specs = moe_param_partition_specs(params)
    worst, n_expert = 0.0, 0
    for path, _ in _paths(params):
        per_rank = [_at(grads, path) for _, grads in outs]
        spec = _at(specs, path)
        if "ep" in spec:
            whole = torch.cat(per_rank[:2], dim=spec.index("ep"))
            assert torch.equal(torch.cat(per_rank[2:], dim=spec.index("ep")), whole), path
            n_expert += 1
        else:
            whole = per_rank[0]
            assert all(torch.equal(g, whole) for g in per_rank), path
        worst = max(worst, _max_err(whole.numpy(), np.asarray(_at(jgrads, path))))
    assert n_expert == 3 and worst < 1e-4, (n_expert, worst)


def test_expert_shards_match_jax(ranks, serve_model):
    """On ep = 2 x tp = 2: the specs equal the JAX package's, and each
    rank's shard equals the JAX NamedSharding shard on the matching CPU
    device bit for bit, as a contiguous tensor: shard_moe_params of the
    training params, and shard_ep of the INT8 engine params (the JAX
    specs with tp=True: the port's shard over the tp axis always), int8
    experts and their scales included."""
    jcfg, jp, cfg, params = serve_model
    jq = jmoe.quantize_moe_params(jp)
    qparams = params_from_jax(_np_tree(jq))
    mesh = _jmesh(ep=2, tp=2)
    devices = list(mesh.devices.reshape(-1))
    cases = [(j_moe_param_partition_specs(jp), moe_param_partition_specs(params),
              j_shard_moe_params(jp, mesh), params),
             (j_ep_param_partition_specs(jq, tp=True), ep_param_partition_specs(qparams),
              j_shard_ep(jq, {}, mesh, tp=True)[0], qparams)]
    got = ranks.run(mesh_ranks.ep_shards, params, qparams, ep=2, tp=2)
    n_ep = 0
    for i, (jspecs, specs, jshards, tree) in enumerate(cases):
        for path, leaf in _paths(tree):
            assert _at(specs, path) == _jspec(_at(jspecs, path), leaf.dim()), path
            by_device = {s.device: np.asarray(s.data) for s in _at(jshards, path).addressable_shards}
            for r, shards in enumerate(got):
                shard = _at(shards[i], path)
                want = by_device[devices[r]]
                assert shard.is_contiguous() and shard.shape == want.shape, path
                assert np.array_equal(shard.numpy(), want), (path, r)
            n_ep += "ep" in _at(specs, path)
    assert n_ep == 3 + 6  # the plain experts; the int8 experts and their scales


# ---- the serving steps ------------------------------------------------------

def _decode_inputs(cfg, n_shards, local_pages=8, page=16):
    """tests/test_moe_ep_serve.py's decode inputs, made with numpy: random
    f32 pools of n_shards * local_pages pages, two requests a replica over
    its pages [0..3] and [4..7], each row its own token and length."""
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, n_shards * local_pages, cfg.n_kv_heads, page, cfg.head_dim)
    pools = dict(k=rng.standard_normal(shape).astype(np.float32),
                 v=rng.standard_normal(shape).astype(np.float32))
    bt = np.tile(np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32), (n_shards, 1))
    kv_lens = np.asarray([17, 40, 9, 33, 25, 12, 30, 8][: 2 * n_shards], np.int32)
    tokens = np.asarray([[5], [9], [31], [2], [44], [7], [13], [20]][: 2 * n_shards], np.int32)
    return pools, bt, kv_lens, tokens


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_ep_decode_step_matches_jax(ranks, serve_model):
    """One ep_decode_step at ep = 2 against the JAX ep_decode_step (its one
    interpret-mode paged call): the tokens equal, the logits within 1e-4,
    each replica's pool pages within 1e-5; two all-to-alls a layer."""
    jcfg, jp, cfg, params = serve_model
    pools, bt, kv_lens, tokens = _decode_inputs(cfg, 2)
    mesh = _jmesh(ep=2)
    sp, spools = j_shard_ep(jp, {k: jnp.asarray(v) for k, v in pools.items()}, mesh)
    jtok, jlogits, jpools = j_ep_decode_step(sp, jnp.asarray(tokens), spools, jnp.asarray(bt),
                                             jnp.asarray(kv_lens), jcfg, mesh)
    outs = ranks.run(mesh_ranks.ep_decode, params, _t(tokens),
                     {k: _t(v) for k, v in pools.items()}, _t(bt), _t(kv_lens), cfg, ep=2)
    assert torch.cat([o[0] for o in outs]).tolist() == np.asarray(jtok).tolist()
    assert _max_err(torch.cat([o[1] for o in outs]).numpy(), jlogits) < 1e-4
    for name in pools:
        got = torch.cat([o[2][name] for o in outs], dim=1).numpy()
        assert _max_err(got, jpools[name]) < 1e-5, name
    for *_, coll in outs:
        assert coll["collective.all_to_all"] == 2 * cfg.n_layers


def test_ep_prefill_chunk_step_matches_per_shard(ranks, serve_model):
    """ep_prefill_chunk_step at ep = 2: each replica's lanes and pages give
    the single-device prefill_chunk_core's logits and pool pages over that
    replica's rows alone (the capacity from the replica's own lanes)."""
    _, _, cfg, params = serve_model
    pools, _, _, _ = _decode_inputs(cfg, 2)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32))
    n_prior = np.asarray([0, 16, 32, 0])
    n_valid = np.asarray([32, 20, 7, 32])
    bt = np.tile(np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32), (2, 1))
    outs = ranks.run(mesh_ranks.ep_prefill, params, _t(tokens), _t(n_prior), _t(n_valid),
                     {k: _t(v) for k, v in pools.items()}, _t(bt), cfg, ep=2)
    for r, (logits, got_pools) in enumerate(outs):
        rows = slice(2 * r, 2 * r + 2)
        local = {k: _t(v[:, 8 * r : 8 * r + 8]) for k, v in pools.items()}
        want = prefill_chunk_core(params, _t(tokens[rows]), _t(n_prior[rows]),
                                  _t(n_valid[rows]), local, _t(bt[rows]), cfg)
        assert _max_err(logits.numpy(), want.numpy()) < 1e-4
        for k in pools:
            assert _max_err(got_pools[k].numpy(), local[k].numpy()) < 1e-5, k


# ---- the engine against the JAX ep engine (three JAX engine runs) ----------

def _requests(prompts, max_new=5, temperature=0.0):
    return {rid: (p, max_new[rid] if isinstance(max_new, dict) else max_new, temperature)
            for rid, p in prompts.items()}


def _mesh_serve(ranks, params, cfg, ecfg, requests, prefix=None, **axes):
    """The mesh engine's (results, stats); every rank's results the same."""
    outs = ranks.run(mesh_ranks.serve, params, cfg, ecfg, requests, prefix, **axes)
    for out in outs[1:]:
        assert out[0] == outs[0][0]
    return outs[0][0], outs[0][1]


def _single(params, cfg, ecfg, requests, prefix=None):
    eng = DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu")
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    for rid, (prompt, max_new, temp) in requests.items():
        eng.add_request(rid, prompt, max_new, temperature=temp,
                        prefix_id="sys" if prefix is not None else None)
    return eng.run(max_steps=400), dict(eng.stats)


# one lane a request: the 4 requests (one chunk each) start decoding in the
# same step and end together, so no decode row is idle. The JAX MoE engine's
# paged attention gives NaN on an idle row (kv_len 0), and its dispatch and
# the exchange spread it to every row of the step
ALL_LANES = dict(BASE, prefill_lanes=4)
ENGINE_CASES = {  # name: (axes, engine config)
    "ep2": (dict(ep=2), ALL_LANES),
    "ep2_tp2": (dict(ep=2, tp=2), ALL_LANES),
    "dp2_ep2": (dict(dp=2, ep=2), ALL_LANES),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_ep_engine_matches_jax(ranks, serve_model, case):
    """The port's ep mesh engine and the JAX ep mesh engine of the same
    shape emit the same greedy streams (the JAX package's engine-level ep
    tests), and so does the port's single-device engine: ep_prefill's
    chunks and ep decode steps, replica r = dp_idx * ep + ep_idx."""
    axes, ecfg_kw = ENGINE_CASES[case]
    jcfg, jp, cfg, params = serve_model
    jeng = JDecodeEngine(jp, jcfg, JEngineConfig(**ecfg_kw), dtype=jnp.float32,
                         mesh=_jmesh(**axes))
    for rid, p in PROMPTS.items():
        jeng.add_request(rid, p, 5)
    want = {rid: [int(t) for t in toks] for rid, toks in jeng.run().items()}
    requests = _requests(PROMPTS)
    got, stats = _mesh_serve(ranks, params, cfg, EngineConfig(**ecfg_kw), requests, **axes)
    assert got == want
    assert stats["requests_finished"] == len(PROMPTS)
    assert _single(params, cfg, EngineConfig(**ecfg_kw), requests)[0] == want


# ---- the engine against the port's single-device engine --------------------

@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_ep_multi_step_matches_per_step(ranks, serve_model, temperature):
    """Windows of 3 decode steps on ep = 2 emit the per-step ep engine's
    streams, greedy and sampled (top-k 8), a request finishing mid-window;
    greedy, also the single-device engine's."""
    _, _, cfg, params = serve_model
    max_new = {0: 9, 1: 6, 2: 7, 3: 5}
    requests = _requests(PROMPTS, max_new, temperature)
    runs = {}
    for K in (1, 3):
        ecfg = EngineConfig(**dict(BASE, multi_step=K, top_k=8 if temperature else 0,
                                   sample_seed=5))
        runs[K], stats = _mesh_serve(ranks, params, cfg, ecfg, requests, ep=2)
    assert runs[3] == runs[1]
    assert all(len(runs[3][rid]) == n for rid, n in max_new.items())
    assert stats["decode_steps"] > stats["steps"]  # windows ran
    if not temperature:
        assert runs[3] == _single(params, cfg, ecfg, requests)[0]


def test_ep_all_features_matches_single_device(ranks, serve_model):
    """The JAX package's composed ep test on the port: ep = 2, INT8 experts,
    an int8 cache, a shared prefix in both replicas and speculative
    decoding; the single-device engine's streams and drafts accepted."""
    _, _, cfg, params = serve_model
    qparams = quantize_moe_params(params)
    ecfg = EngineConfig(**dict(BASE, speculate_k=3, kv_quant="int8"))
    prefix = [(3 * i + 1) % 64 for i in range(16 + 5)]
    requests = _requests({0: [9, 4, 7, 7, 7, 7], 1: [15, 2, 8]}, max_new=6)
    got, stats = _mesh_serve(ranks, qparams, cfg, ecfg, requests, prefix, ep=2)
    want, want_stats = _single(qparams, cfg, ecfg, requests, prefix)
    assert got == want
    assert stats["spec_steps"] > 0 and stats["drafts_accepted"] == want_stats["drafts_accepted"]


def test_ep_preemption_matches_single_device(ranks, serve_model):
    """A pool too small for every request on ep = 2 (6 pages a replica, two
    requests of 4 pages each on it): the replicas preempt and resume their
    own requests, with the single-device engine's streams."""
    _, _, cfg, params = serve_model
    ecfg = EngineConfig(**dict(BASE, num_pages=12))
    requests = _requests({0: [(7 * i + 3) % 64 for i in range(40)], 1: [5, 9, 2] * 11,
                          2: list(range(30)), 3: [1, 2, 3, 4] * 9}, max_new=20)
    got, stats = _mesh_serve(ranks, params, cfg, ecfg, requests, ep=2)
    assert stats["preemptions"] > 0 and stats["requests_finished"] == 4
    assert got == _single(params, cfg, ecfg, requests)[0]


# ---- what raises ------------------------------------------------------------

def test_ep_engine_refusals_match_jax(ranks, serve_model):
    """The JAX engine's two ValueErrors, raised by both packages: ep > 1
    with a dense model, and n_experts (4) not divisible by ep (3)."""
    jcfg, jp, cfg, params = serve_model
    dense = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
                 max_seq_len=256)
    jdense = JLlamaConfig(**dense)
    jdp = j_init_params(jax.random.PRNGKey(0), jdense, dtype=jnp.float32)
    ecfg = dict(BASE, max_batch=6, num_pages=66, prefill_lanes=6)
    cases = [("not a MoE", jdp, jdense, dict(ep=2)), ("divisible by ep=3", jp, jcfg, dict(ep=3))]
    for what, jparams, jc, axes in cases:
        with pytest.raises(ValueError, match=what):
            JDecodeEngine(jparams, jc, JEngineConfig(**ecfg), dtype=jnp.float32,
                          mesh=_jmesh(**axes))
        port = (params_from_jax(_np_tree(jparams)),
                LlamaConfig(**dense) if jc is jdense else cfg)
        for out in ranks.run(mesh_ranks.engine_raises, *port, EngineConfig(**ecfg), **axes):
            assert out[0] == "ValueError" and what in out[1], out
