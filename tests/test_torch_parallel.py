"""PyTorch port vs the JAX package: the parallel layers (parallel/mesh.py,
tp.py, tp_serve.py) on gloo ranks, and DpPagePools.

The port's side runs in four rank processes started once for the file
(tests/mesh_ranks.py, one intra-op thread each); every job builds its own
mesh of dp x tp ranks. The JAX side runs here on the CPU devices of
tests/conftest.py, on the mesh of the same shape: JAX mesh device r is the
port's rank r. Inputs come from numpy seeds; JAX params travel to the port
through params_from_jax, bit for bit.

Tolerances: shards are compared bit for bit; f32 logits and gradients
within 1e-4 and the loss within 1e-5 (the JAX package's own tolerances for
its mesh against one device: its psum and gloo's all-reduce sum in their
own orders); tokens exactly. One JAX interpret-mode paged call (the int8
tp_decode_step).
"""

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
    quantize_params as j_quantize_params,
)
from xf_flash_attention_cutlass_tpu.parallel import (
    make_mesh as j_make_mesh,
    shard_params as j_shard_params,
    tp_forward as j_tp_forward,
    tp_loss_and_grad as j_tp_loss_and_grad,
)
from xf_flash_attention_cutlass_tpu.parallel.tp import (
    param_partition_specs as j_param_partition_specs,
)
from xf_flash_attention_cutlass_tpu.parallel.tp_serve import (
    shard_pools as j_shard_pools,
    tp_decode_step as j_tp_decode_step,
)
from xf_flash_attention_cutlass_tpu.quant import quantize_kv as j_quantize_kv
from xf_flash_attention_cutlass_tpu.serve.allocator import DpPagePools as JDpPagePools
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.models.moe import MoEConfig
from xf_flash_attention_cutlass_tpu_torch.parallel import param_partition_specs
from xf_flash_attention_cutlass_tpu_torch.serve import DpPagePools
from xf_flash_attention_cutlass_tpu_torch.serve.engine import decode_core, verify_core

# the tiny models of the JAX package's tests/test_parallel.py
TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=96,
            max_seq_len=256)
TINY_GQA = dict(TINY, n_kv_heads=2)
TINY_MOE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                max_seq_len=512, n_experts=4, top_k=2, capacity_factor=8.0)


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


def _jmesh(dp, tp):
    return j_make_mesh(dp=dp, tp=tp, devices=jax.devices("cpu")[: dp * tp])


def _params(kind):
    """(JAX cfg, JAX params, port cfg, port params) of one tiny model."""
    if kind == "moe":
        jcfg = jmoe.MoEConfig(**TINY_MOE)
        jp = jmoe.quantize_moe_params(
            jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
        return jcfg, jp, MoEConfig(**TINY_MOE), params_from_jax(_np_tree(jp))
    jcfg = JLlamaConfig(**TINY)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg,
                       dtype=jnp.bfloat16 if kind == "bf16" else jnp.float32)
    if kind == "int8":
        jp = j_quantize_params(jp)
    return jcfg, jp, LlamaConfig(**TINY), params_from_jax(_np_tree(jp))


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


def _bits(a) -> np.ndarray:
    """The raw bits of a torch tensor or a (JAX / ml_dtypes) numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.view(torch.int16)
        elif a.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            a = a.view(torch.uint8)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    if a.dtype.name.startswith("float8"):
        return a.view(np.uint8)
    return a


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---- param_partition_specs and shard_params ---------------------------------

@pytest.mark.parametrize("kind", ["bf16", "int8", "moe"])
def test_shard_params_match_jax_shards(ranks, kind):
    """Every leaf's spec equals the JAX package's, and each rank's shard of
    a dp=2 x tp=2 mesh equals the JAX NamedSharding shard on the matching
    CPU device, bit for bit, as a contiguous tensor."""
    _, jp, _, tp_params = _params(kind)
    jspecs = j_param_partition_specs(jp)
    specs = param_partition_specs(tp_params)
    for path, leaf in _paths(tp_params):
        want = tuple(_at(jspecs, path))
        want = want + (None,) * (leaf.dim() - len(want))
        assert _at(specs, path) == want, path
    mesh = _jmesh(2, 2)
    devices = list(mesh.devices.reshape(-1))
    jshards = j_shard_params(jp, mesh)
    got = ranks.run(mesh_ranks.shards, tp_params, dp=2, tp=2)
    n_sharded = 0
    for path, leaf in _paths(tp_params):
        by_device = {s.device: s.data for s in _at(jshards, path).addressable_shards}
        for r, tree in enumerate(got):
            shard = _at(tree, path)
            assert shard.is_contiguous(), path
            want = _bits(by_device[devices[r]])
            assert shard.shape == want.shape and np.array_equal(_bits(shard), want), (path, r)
        n_sharded += "tp" in _at(specs, path)
    assert n_sharded >= 8  # q, k, v, o, gate, up, down and the lm_head at least


# ---- tp_forward and tp_loss_and_grad ---------------------------------------

@pytest.fixture(scope="module")
def f32_model():
    return _params("f32")


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_tp_forward_matches_jax(ranks, f32_model, dp, tp):
    """The port's tp_forward on a dp x tp mesh against the JAX tp_forward:
    each replica's rows within 1e-4, the same on every tp rank."""
    jcfg, jp, cfg, params = f32_model
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2 * dp, 17))
    mesh = _jmesh(dp, tp)
    want = np.asarray(j_tp_forward(j_shard_params(jp, mesh), jnp.asarray(tokens), jcfg, mesh))
    outs = ranks.run(mesh_ranks.forward, params, torch.from_numpy(tokens), cfg, dp=dp, tp=tp)
    for r, out in enumerate(outs):
        assert torch.equal(out, outs[r - r % tp])  # the replica's tp ranks agree
    got = torch.cat([outs[i * tp] for i in range(dp)]).numpy()
    assert got.shape == want.shape
    assert _max_err(got, want) < 1e-4


def test_tp_loss_and_grad_matches_jax(ranks, f32_model):
    """tp_loss_and_grad on dp=2 x tp=2 against the JAX one: the loss within
    1e-5, the gradients gathered over tp within 1e-4; replicated leaves'
    gradients equal on every rank, and every dp replica holds the same."""
    jcfg, jp, cfg, params = f32_model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16))
    mesh = _jmesh(2, 2)
    jloss, jgrads = j_tp_loss_and_grad(j_shard_params(jp, mesh), jnp.asarray(tokens), jcfg, mesh)
    outs = ranks.run(mesh_ranks.loss_and_grad, params, torch.from_numpy(tokens), cfg, dp=2, tp=2)
    specs = param_partition_specs(params)
    for loss, _ in outs:
        assert abs(float(loss) - float(jloss)) < 1e-5
    worst = 0.0
    for path, leaf in _paths(params):
        spec = _at(specs, path)
        per_rank = [_at(grads, path) for _, grads in outs]
        if "tp" in spec:
            whole = torch.cat(per_rank[:2], dim=spec.index("tp"))
            assert torch.equal(torch.cat(per_rank[2:], dim=spec.index("tp")), whole), path
        else:
            whole = per_rank[0]
            assert all(torch.equal(g, whole) for g in per_rank), path
        worst = max(worst, _max_err(whole.numpy(), np.asarray(_at(jgrads, path))))
    assert worst < 1e-4, worst


# ---- the serving steps ------------------------------------------------------

def _decode_inputs(quant, dp=1, local_pages=8):
    """The JAX package's tp decode test inputs (its test_parallel.py), made
    with numpy: pools of dp * local_pages pages of 16 rows, two requests a
    replica over pages [0..3] and [4..7] (replica-local ids)."""
    jcfg = JLlamaConfig(**TINY_GQA)
    rng = np.random.default_rng(3)
    shape = (jcfg.n_layers, dp * local_pages, jcfg.n_kv_heads, 16, jcfg.head_dim)
    kpool = rng.standard_normal(shape).astype(np.float32)
    vpool = rng.standard_normal(shape).astype(np.float32)
    if quant:
        kq, ks = j_quantize_kv(jnp.asarray(kpool), quant)
        vq, vs = j_quantize_kv(jnp.asarray(vpool), quant)
        pools = dict(k=kq, v=vq, k_s=ks[..., 0], v_s=vs[..., 0])
    else:
        pools = dict(k=jnp.asarray(kpool), v=jnp.asarray(vpool))
    bt = np.tile(np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32), (dp, 1))
    kv_lens = np.asarray([17, 40, 9, 33][: 2 * dp], np.int32)
    tokens = np.asarray([[5], [9], [31], [2]][: 2 * dp], np.int32)
    return jcfg, pools, bt, kv_lens, tokens


@pytest.fixture(scope="module")
def gqa_model():
    jcfg = JLlamaConfig(**TINY_GQA)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jp, LlamaConfig(**TINY_GQA), params_from_jax(_np_tree(jp))


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _port_pools(pools):
    return params_from_jax(_np_tree(pools))


def test_tp_decode_step_int8_matches_jax(ranks, gqa_model):
    """tp_decode_step over int8 pools at tp = 2 against the JAX
    tp_decode_step: the tokens equal, the logits within 1e-4, the pools'
    kv-head shards joined equal to the JAX pools' int8 values (within one
    step of the grid) and scales (within 1e-6 relative); two all-reduces a
    layer and one all-gather."""
    jp, cfg, params = gqa_model
    jcfg, pools, bt, kv_lens, tokens = _decode_inputs("int8")
    mesh = _jmesh(1, 2)
    jtok, jlogits, jpools = j_tp_decode_step(
        j_shard_params(jp, mesh), jnp.asarray(tokens),
        j_shard_pools({k: v.copy() for k, v in pools.items()}, mesh), jnp.asarray(bt),
        jnp.asarray(kv_lens), jcfg, mesh, "int8")
    outs = ranks.run(mesh_ranks.decode, params, _t(tokens), _port_pools(pools), _t(bt),
                     _t(kv_lens), cfg, tp=2)
    tok, logits, _, coll = outs[0]
    assert all(torch.equal(o[0], tok) and torch.equal(o[1], logits) for o in outs)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    assert _max_err(logits.numpy(), jlogits) < 1e-4
    for name in ("k", "v"):
        got = torch.cat([o[2][name] for o in outs], dim=2).numpy().astype(np.int32)
        assert np.abs(got - np.asarray(jpools[name], np.int32)).max() <= 1, name
        got_s = torch.cat([o[2][name + "_s"] for o in outs], dim=2).numpy()
        np.testing.assert_allclose(got_s, np.asarray(jpools[name + "_s"]), rtol=1e-6, atol=0)
    assert coll == {"collective.all_reduce": 2 * cfg.n_layers, "collective.all_gather": 1}


def test_sp_batch_matches_all_reduces(ranks, gqa_model):
    """The reduce-scatter + all-gather structure (sp_batch) gives the plain
    all-reduces' tokens and logits bit for bit (the same sums, another
    schedule), with 4 collectives a layer and 2 more."""
    _, cfg, params = gqa_model
    _, pools, bt, kv_lens, tokens = _decode_inputs(None)
    args = (params, _t(tokens), _port_pools(pools), _t(bt), _t(kv_lens), cfg)
    plain = ranks.run(mesh_ranks.decode, *args, tp=2)
    sp = ranks.run(mesh_ranks.decode, *args, True, tp=2)
    for p, s in zip(plain, sp):
        assert torch.equal(p[0], s[0]) and torch.equal(p[1], s[1])
        for name in p[2]:
            assert torch.equal(p[2][name], s[2][name]), name
    L = cfg.n_layers
    assert sp[0][3] == {"collective.all_gather": 2 * L + 2, "collective.reduce_scatter": 2 * L}


@pytest.mark.parametrize("quant", [None, "int8"])
def test_tp_verify_step_matches_single_device(ranks, gqa_model, quant):
    """tp_verify_step (3 tokens a request, tp = 2, sp_batch) against the
    port's single-device verify_core: logits within 1e-4, the joined pool
    shards' int8 values within one step of the grid, f32 values and
    scales within 1e-5 (the JAX package's tolerance for its mesh's pools:
    the k and v rows come from matmuls of another width)."""
    _, cfg, params = gqa_model
    _, pools, bt, kv_lens, _ = _decode_inputs(quant)
    tokens = _t(np.asarray([[5, 11, 3], [9, 2, 60]], np.int32))
    lens = _t(kv_lens + 3)
    ref_pools = _port_pools(pools)
    want = verify_core(params, tokens, ref_pools, _t(bt), lens, cfg)
    outs = ranks.run(mesh_ranks.verify, params, tokens, _port_pools(pools), _t(bt), lens, cfg,
                     tp=2)
    assert outs[0][0].shape == (2, 3, cfg.vocab_size)
    assert _max_err(outs[0][0].numpy(), want.numpy()) < 1e-4
    for name, ref in ref_pools.items():
        got = torch.cat([o[1][name] for o in outs], dim=2)
        if got.dtype == torch.int8:
            assert (got.int() - ref.int()).abs().max() <= 1, name
        else:
            assert _max_err(got.numpy(), ref.numpy()) < 1e-5, name


def test_tp_dp_decode_step_matches_single_device(ranks, gqa_model):
    """tp_dp_decode_step and tp_decode_step(dp_axis=True) with sampling on
    dp = 2 x tp = 2 (replica-local page ids, the pools' pages split over
    dp) against the port's single-device decode_core over the whole batch
    (the replicas' pages side by side, their ids offset): the tokens equal,
    greedy and sampled (top-k 8; the noise is keyed by the row's index in
    the whole batch), the logits within 1e-4."""
    _, cfg, params = gqa_model
    _, pools, bt, kv_lens, tokens = _decode_inputs("int8", dp=2)
    pools = _port_pools(pools)
    whole_bt = bt + 8 * (np.arange(4) // 2)[:, None]
    sampling = dict(temperature=torch.full((4,), 0.8), step=3, seed=7, top_k=8)
    for kw in (None, sampling):
        want_tok, want_logits = decode_core(params, _t(tokens), {k: v.clone() for k, v in
                                                                 pools.items()},
                                            _t(whole_bt), _t(kv_lens), cfg, **(kw or {}))
        args = (params, _t(tokens), pools, _t(bt), _t(kv_lens), cfg)
        outs = (ranks.run(mesh_ranks.dp_decode, *args, dp=2, tp=2) if kw is None else
                ranks.run(mesh_ranks.decode, *args, False, True, kw, dp=2, tp=2))
        assert torch.equal(torch.cat([outs[0][0], outs[2][0]]), want_tok)
        got_logits = torch.cat([outs[0][1], outs[2][1]])
        assert _max_err(got_logits.numpy(), want_logits.numpy()) < 1e-4


# ---- DpPagePools -----------------------------------------------------------

def _drive(pools):
    """One operation sequence; returns every result and the final snapshot."""
    out = [pools.admit(10, 9, 20), pools.admit(11, 3, 8), pools.admit(12, 30, 40),
           pools.admit(13, 5, 6), pools.admit(14, 1, 2)]
    out += [pools.extend(0, 4), pools.extend(2, 7), pools.truncate(0, 10), pools.seq_len(2)]
    out.append(pools.prefix_alloc_all(2))
    free = pools.free_pages()
    out.append(pools.prefix_alloc_all(30))  # more than a replica holds: rolled back
    out.append(pools.free_pages() == free)
    out.append(pools.admit_prefixed_replica(1, 15, 2, 40, 50))
    out.append(pools.admit_replica(0, 16, 4, 5))
    pools.retire(1)
    out.append(pools.admit(17, 2, 3))
    bt, lens, n = pools.build_block_tables(12)
    out += [bt.tolist(), lens.tolist(), n, pools.free_pages()]
    return out, pools.snapshot()


def test_dp_page_pools_match_jax():
    """DpPagePools (native and Python allocators) against the JAX class on
    one operation sequence: least-loaded admission, replica-local page ids,
    prefix_alloc_all's rollback, the block tables and the snapshot's words;
    a restored snapshot continues as the JAX pools do."""
    geometry = (2, 10, 4, 3)  # dp, local pages, page size, local slots
    want, words = _drive(JDpPagePools(*geometry))
    for backend in ("native", "python"):
        got, got_words = _drive(DpPagePools(*geometry, backend=backend))
        assert got == want, backend
        if backend == "native":  # the Python copy keeps no target length (it writes 0)
            np.testing.assert_array_equal(got_words, words)
    restored = DpPagePools(*geometry)
    restored.restore(words)
    jp = JDpPagePools(*geometry)
    jp.restore(words)
    for pools in (restored, jp):
        pools.retire(0)
    assert restored.admit(20, 6, 9) == jp.admit(20, 6, 9)
    np.testing.assert_array_equal(restored.snapshot(), jp.snapshot())
