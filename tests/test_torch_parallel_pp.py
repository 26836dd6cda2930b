"""PyTorch port vs the JAX package: pipeline parallelism (parallel/pp.py,
pp_serve.py and the stage shift of utils/collectives.py) on gloo ranks.

The port's side runs in four rank processes started once for the file
(tests/mesh_ranks.py, one intra-op thread each); every job builds its own
mesh. The JAX side runs here on the CPU devices of tests/conftest.py, on the
mesh of the same shape: JAX mesh device r is the port's rank r. The meshes
of the JAX package's tests that need 8 devices (dp x pp x tp = 2 x 2 x 2)
are covered by (1, 2, 2) and (2, 2, 1). Inputs come from numpy seeds and
the JAX package's PRNG keys; JAX params travel to the port through
params_from_jax, bit for bit.

Tolerances are the JAX package's for its pp mesh against one device
(tests/test_moe_pp.py, tests/test_parallel.py): logits within 1e-4, the
loss within 1e-5, gradients within 1e-4, tokens exactly, f32 pool pages
within 1e-5; int8 pool values within one step of the grid of the JAX
package's and their scales within 1e-6 relative (tests/test_torch_parallel.py's
rule across the two packages). One JAX interpret-mode paged call (the int8
pp_decode_step).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
)
from xf_flash_attention_cutlass_tpu.parallel import make_mesh as j_make_mesh
from xf_flash_attention_cutlass_tpu.parallel.pp import (
    pp_forward as j_pp_forward,
    pp_loss_and_grad as j_pp_loss_and_grad,
    pp_param_partition_specs as j_pp_param_partition_specs,
    shard_pp_params as j_shard_pp_params,
)
from xf_flash_attention_cutlass_tpu.parallel.pp_serve import (
    pp_decode_step as j_pp_decode_step,
    pp_pool_specs as j_pp_pool_specs,
    shard_pp_pools as j_shard_pp_pools,
)
from xf_flash_attention_cutlass_tpu.quant import quantize_kv as j_quantize_kv
from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    forward,
    loss_fn,
    params_from_jax,
)
from xf_flash_attention_cutlass_tpu_torch.parallel import (
    pp_param_partition_specs,
    pp_pool_specs,
)
from xf_flash_attention_cutlass_tpu_torch.serve import EngineConfig
from xf_flash_attention_cutlass_tpu_torch.serve.engine import decode_core

# the tiny models of the JAX package's pipeline tests (tests/test_moe_pp.py
# for training, tests/test_parallel.py's GQA one for serving)
TINY = dict(vocab_size=64, dim=64, n_layers=4, n_heads=4, n_kv_heads=4, ffn_dim=96,
            max_seq_len=256)
TINY_GQA = dict(TINY, n_kv_heads=2)
# tests/test_parallel.py's pipeline decode inputs: 9 pages of 16 rows, page 8
# the trash page, four requests over two pages each
NUM_PAGES, PAGE, TRASH = 9, 16, 8
BT = np.asarray([[0, 1], [2, 3], [4, 5], [6, 7]], np.int32)
KV_LENS = np.asarray([17, 30, 5, 22], np.int32)
TOKENS = np.asarray([[5], [9], [3], [60]], np.int32)
LIVE = [p for p in range(NUM_PAGES) if p != TRASH]


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
    jcfg = JLlamaConfig(**kw)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, LlamaConfig(**kw), params_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def train_model():
    return _model(TINY)


@pytest.fixture(scope="module")
def serve_model():
    return _model(TINY_GQA)


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


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _join(per_rank, spec, dp=1, pp=1, tp=1):
    """The whole tensor from the ranks' shards (rank order (dp, pp, tp), tp
    the fastest) under `spec`; the ranks that hold the same block must hold
    it bit for bit."""
    blocks = {}
    for r, (_, p, t) in enumerate(itertools.product(range(dp), range(pp), range(tp))):
        key = tuple(p if a == "pp" else t if a == "tp" else 0 for a in spec)
        if key in blocks:
            assert torch.equal(blocks[key], per_rank[r]), (spec, r)
        else:
            blocks[key] = per_rank[r]

    def build(prefix, dim):
        if dim == len(spec):
            return blocks[prefix]
        n = {"pp": pp, "tp": tp}.get(spec[dim], 1)
        return torch.cat([build(prefix + (i,), dim + 1) for i in range(n)], dim=dim)

    return build((), 0)


# ---- the layout --------------------------------------------------------------

@pytest.mark.parametrize("tp", [False, True])
def test_pp_specs_match_jax(train_model, tp):
    """Every param leaf's spec and every pool's equals the JAX package's,
    with and without tp; the layer stacks and the pools are sharded over
    pp on their layer axis."""
    _, jp, _, params = train_model
    jspecs = j_pp_param_partition_specs(jp, tp=tp)
    specs = pp_param_partition_specs(params, tp=tp)
    n_stage = 0
    for path, leaf in _paths(params):
        assert _at(specs, path) == _jspec(_at(jspecs, path), leaf.dim()), path
        n_stage += _at(specs, path)[0] == "pp"
    assert n_stage == len(params["layers"])
    shape = (4, NUM_PAGES, 2, PAGE, 16)
    pools = dict(k=np.zeros(shape, np.int8), v=np.zeros(shape, np.int8),
                 k_s=np.zeros(shape[:-1], np.float32), v_s=np.zeros(shape[:-1], np.float32))
    jpool = j_pp_pool_specs({k: jnp.asarray(v) for k, v in pools.items()}, tp=tp)
    got = pp_pool_specs({k: _t(v) for k, v in pools.items()}, tp=tp)
    assert got == {k: _jspec(s, pools[k].ndim) for k, s in jpool.items()}


# ---- the stage shift -----------------------------------------------------------

@pytest.mark.parametrize("axes", [dict(pp=4), dict(pp=2, tp=2), dict(pp=1)],
                         ids=["pp4", "pp2_tp2", "pp1"])
def test_ppermute_shifts_over_the_ring(ranks, axes):
    """ppermute and its reverse against index arithmetic: on the ring of a
    pp group (ranks g0 < g1 < ... in stage order), stage i receives stage
    i - 1's tensor forward and stage i + 1's in reverse, one collective each.
    A group of one rank on gloo is the documented copy: x itself, issued
    and counted nowhere."""
    pp, tp = axes["pp"], axes.get("tp", 1)
    outs = ranks.run(mesh_ranks.pp_shift, **axes)
    for r, (fwd, rev, coll) in enumerate(outs):
        i, t = divmod(r, tp)  # stage and tp coordinate of global rank r
        assert torch.equal(fwd, torch.full((2, 3), float(((i - 1) % pp) * tp + t))), r
        assert torch.equal(rev, torch.full((2, 3), float(((i + 1) % pp) * tp + t))), r
        assert coll == ({} if pp == 1 else {"collective.ppermute": 2}), r


# ---- training ------------------------------------------------------------------

@pytest.mark.parametrize("pp,tp,n_micro,ref", [(2, 1, 2, "jax"), (2, 1, 4, "single"),
                                               (4, 1, 4, "single"), (2, 2, 2, "single")])
def test_pp_forward(ranks, train_model, pp, tp, n_micro, ref):
    """pp_forward against the JAX pp_forward on a JAX pp mesh, or against
    the port's single-device forward (pp x tp: the Megatron shards inside
    each stage, the vocab-sharded head gathered): every rank's logits
    within 1e-4."""
    jcfg, jp, cfg, params = train_model
    tokens = np.random.default_rng(pp * 10 + n_micro).integers(0, 64, (2 * n_micro, 16))
    if ref == "jax":
        mesh = _jmesh(pp=pp)
        want = np.asarray(j_pp_forward(j_shard_pp_params(jp, mesh), jnp.asarray(tokens), jcfg,
                                       mesh, n_micro=n_micro))
    else:
        want = forward(params, _t(tokens), cfg).numpy()
    outs = ranks.run(mesh_ranks.pp_fwd, params, _t(tokens), cfg, n_micro, pp=pp, tp=tp)
    for out in outs:
        assert out.shape == want.shape
        assert _max_err(out.numpy(), want) < 1e-4


@pytest.mark.parametrize("dp,pp,tp", [(1, 2, 2), (2, 2, 1)])
def test_pp_loss_and_grad(ranks, train_model, dp, pp, tp):
    """pp_loss_and_grad at n_micro = 2: on dp=1 x pp=2 x tp=2 against the
    JAX function on the JAX mesh of that shape, on dp=2 x pp=2 against the
    dp-averaged single-device loss_fn and its gradient. The loss within
    1e-5 on every rank, every gradient (the ranks' shards joined over pp and
    tp, ranks holding the same block bit-equal) within 1e-4."""
    jcfg, jp, cfg, params = train_model
    b = 2 * dp
    tokens = np.random.default_rng(3 + dp).integers(0, 64, (b, 17))
    if dp == 1:
        mesh = _jmesh(dp=dp, pp=pp, tp=tp)
        jloss, jgrads = j_pp_loss_and_grad(j_shard_pp_params(jp, mesh), jnp.asarray(tokens),
                                           jcfg, mesh, n_micro=2)
        want_loss, want = float(jloss), jax.tree_util.tree_map(np.asarray, jgrads)
    else:
        leaves = [x.requires_grad_(True) for _, x in _paths(params)]
        ref = sum(loss_fn(params, _t(tokens[i:i + 2]), cfg) for i in range(0, b, 2)) / dp
        grads = torch.autograd.grad(ref, leaves)
        for x in leaves:
            x.requires_grad_(False)
        want_loss = float(ref.detach())
        want = {}
        for (path, _), g in zip(_paths(params), grads):
            node = want
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = g.numpy()
    outs = ranks.run(mesh_ranks.pp_grad, params, _t(tokens), cfg, 2, dp=dp, pp=pp, tp=tp)
    for loss, _ in outs:
        assert abs(float(loss) - want_loss) < 1e-5
    specs = pp_param_partition_specs(params, tp=tp > 1)
    worst = 0.0
    for path, leaf in _paths(params):
        whole = _join([_at(g, path) for _, g in outs], _at(specs, path), dp, pp, tp)
        assert whole.shape == leaf.shape, path
        worst = max(worst, _max_err(whole.numpy(), _at(want, path)))
    assert worst < 1e-4, worst


# ---- serving -------------------------------------------------------------------

def _pools(quant):
    """tests/test_parallel.py's pools, drawn with numpy: f32, or int8 with
    per-token scales (the JAX quantize_kv); as JAX arrays and port tensors."""
    rng = np.random.default_rng(1)
    shape = (4, NUM_PAGES, 2, PAGE, 16)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if quant:
        kq, ks = j_quantize_kv(jnp.asarray(k), quant)
        vq, vs = j_quantize_kv(jnp.asarray(v), quant)
        jpools = dict(k=kq, v=vq, k_s=ks[..., 0], v_s=vs[..., 0])
    else:
        jpools = dict(k=jnp.asarray(k), v=jnp.asarray(v))
    return jpools, params_from_jax(_np_tree(jpools))


def _pp_decode(ranks, params, pools, cfg, n_micro=None, quant=None, **axes):
    """pp_decode_step on the ranks: (tokens, logits, the whole pools joined
    from the shards, each rank's collectives); every rank's tokens and
    logits bit-equal."""
    outs = ranks.run(mesh_ranks.pp_decode, params, _t(TOKENS), pools, _t(BT), _t(KV_LENS), cfg,
                     TRASH, n_micro, quant, **axes)
    tok, logits = outs[0][0], outs[0][1]
    for o in outs:
        assert torch.equal(o[0], tok) and torch.equal(o[1], logits)
    specs = pp_pool_specs(pools, tp=axes.get("tp", 1) > 1)
    whole = {k: _join([o[2][k] for o in outs], specs[k], 1, axes["pp"], axes.get("tp", 1))
             for k in pools}
    return tok, logits, whole, [o[3] for o in outs]


@pytest.fixture(scope="module")
def int8_jax_step(serve_model):
    """The JAX pp_decode_step at pp = 2 over int8 pools (the file's one JAX
    interpret-mode paged call): (tokens, logits, pools) as numpy."""
    jcfg, jp, _, _ = serve_model
    jpools, _ = _pools("int8")
    mesh = _jmesh(pp=2)
    tok, logits, pools = j_pp_decode_step(
        j_shard_pp_params(jp, mesh), jnp.asarray(TOKENS), j_shard_pp_pools(jpools, mesh),
        jnp.asarray(BT), jnp.asarray(KV_LENS), jcfg, mesh, trash_page=TRASH, quant="int8")
    return np.asarray(tok), np.asarray(logits), _np_tree(pools)


def test_pp_decode_step_int8_matches_jax(ranks, serve_model, int8_jax_step):
    """pp_decode_step at pp = 2 over int8 pools against the JAX one: the
    tokens equal, the logits within 1e-4, the live pages' int8 values
    within one step of the grid and their scales within 1e-6 relative; one
    stage shift per schedule step and the masked all-reduce."""
    _, _, cfg, params = serve_model
    jtok, jlogits, jpools = int8_jax_step
    _, pools = _pools("int8")
    tok, logits, whole, coll = _pp_decode(ranks, params, pools, cfg, quant="int8", pp=2)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    assert _max_err(logits.numpy(), jlogits) < 1e-4
    for name in ("k", "v"):
        got = whole[name][:, LIVE].numpy().astype(np.int32)
        assert np.abs(got - jpools[name][:, LIVE].astype(np.int32)).max() <= 1, name
        np.testing.assert_allclose(whole[name + "_s"][:, LIVE].numpy(),
                                   jpools[name + "_s"][:, LIVE], rtol=1e-6, atol=0)
    assert coll[0] == {"collective.ppermute": 3, "collective.all_reduce": 1}


@pytest.mark.parametrize("axes,n_micro", [(dict(pp=2), None), (dict(pp=4), 2),
                                          (dict(pp=2, tp=2), None)],
                         ids=["pp2", "pp4_nmicro2", "pp2_tp2"])
def test_pp_decode_step_matches_single_device(ranks, serve_model, axes, n_micro):
    """pp_decode_step over f32 pools against the port's single-device
    decode_core over the whole batch: the tokens equal, the logits within
    1e-4, the live pages within 1e-5; the trash page as it was (the fill and
    drain steps compute nothing). pp = 4 with n_micro = 2 has more drain
    steps than fill; pp x tp adds the kv-head-sharded pools, the
    all-reduced projections and the vocab-gathered head."""
    _, _, cfg, params = serve_model
    _, pools = _pools(None)
    ref_pools = {k: v.clone() for k, v in pools.items()}
    want_tok, want_logits = decode_core(params, _t(TOKENS), ref_pools, _t(BT), _t(KV_LENS), cfg)
    tok, logits, whole, coll = _pp_decode(ranks, params, pools, cfg, n_micro, **axes)
    assert torch.equal(tok, want_tok)
    assert _max_err(logits.numpy(), want_logits.numpy()) < 1e-4
    for name, ref in ref_pools.items():
        assert _max_err(whole[name][:, LIVE].numpy(), ref[:, LIVE].numpy()) < 1e-5, name
        assert torch.equal(whole[name][:, TRASH], pools[name][:, TRASH]), name
    pp, tp = axes["pp"], axes.get("tp", 1)
    steps = (n_micro or pp) + pp - 1
    if tp == 1:
        assert all(c == {"collective.ppermute": steps, "collective.all_reduce": 1} for c in coll)
    else:  # two all-reduces a layer and microbatch, the vocab gather
        local = 2 * (cfg.n_layers // pp) * (n_micro or pp)
        assert all(c == {"collective.ppermute": steps, "collective.all_reduce": 1 + local,
                         "collective.all_gather": 1} for c in coll)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pp1_decode_step_is_decode_core(ranks, serve_model, n_micro):
    """The one-rank pp = 1 group (the card's mesh): pp_decode_step equals
    decode_core run on each microbatch's rows bit for bit (tokens, logits
    and the whole pools, trash page included)."""
    _, _, cfg, params = serve_model
    _, pools = _pools("int8")
    ref_pools = {k: v.clone() for k, v in pools.items()}
    mb = TOKENS.shape[0] // n_micro
    want = [decode_core(params, _t(TOKENS[r]), ref_pools, _t(BT[r]), _t(KV_LENS[r]), cfg)
            for r in (slice(m * mb, (m + 1) * mb) for m in range(n_micro))]
    tok, logits, whole, _ = _pp_decode(ranks, params, pools, cfg, n_micro, "int8", pp=1)
    assert torch.equal(tok, torch.cat([w[0] for w in want]))
    assert torch.equal(logits, torch.cat([w[1] for w in want]))
    for name, ref in ref_pools.items():
        assert torch.equal(whole[name], ref), name


def test_pp_errors_match_jax(ranks, train_model):
    """The ValueErrors of the port's pp_forward, pp_loss_and_grad and
    pp_decode_step equal the JAX package's: an n_micro that does not divide
    the batch, a pp that does not divide the layers."""
    jcfg, jp, cfg, params = train_model
    tokens = np.random.default_rng(9).integers(0, 64, (4, 9))
    bad = dict(TINY, n_layers=3)
    mesh = _jmesh(pp=2)
    sp = j_shard_pp_params(jp, mesh)
    want = []
    for call in (lambda: j_pp_forward(sp, jnp.asarray(tokens), jcfg, mesh, n_micro=3),
                 lambda: j_pp_loss_and_grad(sp, jnp.asarray(tokens), jcfg, mesh, n_micro=3),
                 lambda: j_pp_decode_step(sp, jnp.asarray(TOKENS), {}, jnp.asarray(BT),
                                          jnp.asarray(KV_LENS), jcfg, mesh, 0, n_micro=3),
                 lambda: j_pp_decode_step(sp, jnp.asarray(TOKENS), {}, jnp.asarray(BT),
                                          jnp.asarray(KV_LENS), JLlamaConfig(**bad), mesh, 0)):
        with pytest.raises(ValueError) as e:
            call()
        want.append(str(e.value))
    _, pools = _pools(None)
    for got in ranks.run(mesh_ranks.pp_errors, params, cfg, LlamaConfig(**bad), _t(tokens),
                         pools, _t(BT), _t(KV_LENS), pp=2):
        assert got == want


def test_engine_refuses_pp_naming_pp_decode_step(ranks, serve_model):
    """DecodeEngine on a pp = 2 mesh raises NotImplementedError that points
    at parallel.pp_decode_step: the engine serves no pipeline stages (the
    JAX engine reads only dp and ep from a mesh)."""
    _, _, cfg, params = serve_model
    ecfg = EngineConfig(max_batch=4, page_size=16, num_pages=64, max_seq=256, prefill_chunk=32)
    for out in ranks.run(mesh_ranks.engine_raises, params, cfg, ecfg, pp=2):
        assert out[0] == "NotImplementedError" and "pp_decode_step" in out[1], out
