"""PyTorch port vs the JAX package: K1 (paged attention) and K7 (the dense
flash forward) at head dims other than 64 and 128, and an engine at head
dim 96 (K8 and K9-K11 at every head dim: test_torch_bwd_head_dims.py).

On CUDA both kernels take every head dim from 1 to 256: each is
instantiated at the rungs 64, 128, 192 and 256 and serves d with the
smallest rung >= d, reading the real d through its tensor maps; a width
whose rows are not whole 16-byte chunks takes a zero-padded copy to the
next such width. The route functions (pure Python) are held here for every
d; the padded-copy route runs on CPU tensors (the padded operands through
the plain version, then cut back to d). Inputs come from numpy seeds; the
JAX kernels run as the JAX package's own tests run them (CPU, Pallas
interpret mode), or through the JAX package's plain reference
(``ops/reference.py::attention_ref``). Tolerances: the 2x rule
(``utils/testing.py``), twice the low-precision reference's error against
the f32 reference plus 1e-5. One JAX interpret-mode paged call (d = 96,
fp8, GQA 2:1, decode rows) and one JAX engine run (a 2-layer model at
d = 96, token for token).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
)
from xf_flash_attention_cutlass_tpu.ops import paged as jpaged
from xf_flash_attention_cutlass_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from xf_flash_attention_cutlass_tpu.ops.reference import attention_ref
from xf_flash_attention_cutlass_tpu.quant.kv import quantize_kv as j_quantize_kv
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
)
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops import flash_bwd, flash_fwd as ff, paged
from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig
from xf_flash_attention_cutlass_tpu_torch.utils.testing import assert_close_2ref


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
FP8, I8 = torch.float8_e4m3fn, torch.int8
# K1's (query, pool) dtype pairs on CUDA
K1_PAIRS = [(BF16, BF16), (BF16, FP8), (BF16, I8), (F16, F16), (F16, FP8), (F16, I8),
            (F32, F32), (F32, FP8), (F32, I8)]


# ---- the route, the rung and the copy, for every head dim (pure Python) -----

@pytest.mark.parametrize("q_dt,kv_dt", K1_PAIRS,
                         ids=[f"{str(q).split('.')[-1]}-{str(k).split('.')[-1]}"
                              for q, k in K1_PAIRS])
def test_k1_route_rung_and_copy_for_every_head_dim(q_dt, kv_dt):
    """For every d in 1..256: the route does not depend on d (d = 128's, on
    a page of whole TMA boxes and on an odd page, decode and chunk rows);
    the rung is the smallest of 64, 128, 192, 256 >= the width run; the
    width run is d itself when its rows are whole 16-byte chunks (d a
    multiple of 16 over int8 / fp8 pools, 8 over 16-bit ones, 4 for f32
    queries over f32 pools), else the next such width; the split plan counts
    the blocks of that width's rung."""
    align = 16 if kv_dt in (FP8, I8) else 4 if q_dt == F32 else 8
    assert paged.head_dim_align(q_dt, kv_dt) == align
    for d in range(1, 257):
        for rows in (1, 4, 16, 17, 256):
            for page in (16, 256, 12):
                assert (paged.paged_route(rows, page, d, kv_dt, q_dt)
                        == paged.paged_route(rows, page, 128, kv_dt, q_dt))
        dm = paged.mapped_head_dim(d, q_dt, kv_dt)
        assert dm % align == 0 and d <= dm < d + align and (dm == d) == (d % align == 0)
        rung = paged.head_dim_rung(dm)
        assert rung in paged.HEAD_DIM_RUNGS and rung - 64 < dm <= rung
        route, splits = paged.paged_plan((8, 1, 32, d), (2, 65, 8, 256, d), kv_dt, 16,
                                         q_dtype=q_dt)
        cores = paged.NUM_SMS * (paged.DECODE_BLOCKS[rung] if route == "decode"
                                 else paged.F32_BLOCKS.get((kv_dt, rung), 1) if route == "f32"
                                 else 1)
        unit_blocks = 16 * 256 // paged.DECODE_TILE if route == "decode" else 16
        assert splits == paged.resolve_num_splits(0, 8, 8, 4, unit_blocks,
                                                  paged.route_row_tile(route, 4), cores)
    for d in (0, 257):
        with pytest.raises(ValueError):
            paged.head_dim_rung(d)


@pytest.mark.parametrize("dtype", [BF16, F16, F32], ids=["bf16", "f16", "f32"])
def test_k7_rung_and_copy_for_every_head_dim(dtype):
    """K7, and since K8 and K9-K11 take every head dim too, each of them,
    runs d itself when its rows are whole 16-byte chunks (a multiple of 8
    in bf16 / fp16, of 4 in f32), else the next such width, on the smallest
    rung >= it; the wide rungs of the 16-bit kernels are libraries of their
    own; d = 0 and 257 raise naming the kernel."""
    align = 4 if dtype == F32 else 8
    names = {"flash_fwd": "flash forward (K7)", "flash_probs": "attention probs (K8)",
             "flash_bwd": "flash backward (K9-K11)"}
    for d in range(1, 257):
        for lib0, what in names.items():
            dm = ff.flash_head_dim(d, dtype, what)
            assert dm % align == 0 and d <= dm < d + align
            assert ff.flash_rung(dm) == paged.head_dim_rung(dm)
            lib, _ = ff.flash_entry(lib0, lib0, dtype, dm)
            assert lib == ("flash_f32" if dtype == F32 else
                           f"{lib0}_wide" if dm > 128 else lib0)
    for d in (0, 257):
        for what in names.values():
            with pytest.raises(ValueError, match=what.replace("(", "\\(").replace(")", "\\)")):
                ff.flash_head_dim(d, dtype, what)


def test_padded_routes_keep_the_real_softmax_scale(monkeypatch):
    """The padded copies call K1 and K7 at the padded width with the softmax
    scale of the real d, 1 / sqrt(d), never of the width run or the rung."""
    seen = {}

    def record(name):
        def fn(q, *a, softmax_scale=None, **kw):
            seen[name] = (q.shape[-1], softmax_scale)
            return q, q.new_zeros(q.shape[:-1])
        return fn

    monkeypatch.setattr(paged, "paged_attention", record("k1"))
    monkeypatch.setattr(ff, "flash_fwd", record("k7"))
    q = torch.zeros((1, 1, 2, 59))
    pool = torch.zeros((3, 1, 16, 59))
    lens = torch.tensor([5])
    o, _ = paged.paged_attention_padded(q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
                                        lens, 64)
    assert o.shape[-1] == 59 and seen["k1"] == (64, 1.0 / math.sqrt(59))
    x = torch.zeros((1, 2, 3, 111))
    o, _ = ff.flash_fwd_padded(x, x, x, 112)
    assert o.shape[-1] == 111 and seen["k7"] == (112, 1.0 / math.sqrt(111))


# ---- K1 against the JAX package ----------------------------------------------

def _paged_case(seed, d, kv="fp8_e4m3", b=2, sq=1, h=4, h_k=2, page=16, n_pages=8,
                max_pages=4):
    rng = np.random.default_rng(seed)
    shape = (n_pages + 1, h_k, page, d)
    kf, vf = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    q = jnp.asarray(rng.standard_normal((b, sq, h, d)), jnp.bfloat16)
    if kv == "bf16":
        pools = dict(k=jnp.asarray(kf, jnp.bfloat16), v=jnp.asarray(vf, jnp.bfloat16),
                     ks=None, vs=None)
    else:
        kq, ks = j_quantize_kv(jnp.asarray(kf), kv)
        vq, vs = j_quantize_kv(jnp.asarray(vf), kv)
        pools = dict(k=kq, v=vq, ks=ks[..., 0], vs=vs[..., 0])
    bt = np.stack([rng.permutation(n_pages)[:max_pages] for _ in range(b)]).astype(np.int32)
    lens = rng.integers(sq, max_pages * page + 1, size=b).astype(np.int32)
    return q, pools, bt, lens


def _paged_reference(q, pools, bt, lens, upcast):
    """The JAX package's plain reference on the gathered pages, causal from
    the bottom right: attention_ref over (b, T, h_k, d) keys dequantized to
    f32 (upcast) or to q's dtype (the low-precision reference), kv_len as
    the key mask."""
    def dense(pool, scales):
        g = jnp.swapaxes(pool[bt], 2, 3)  # (b, max_pages, page, h_k, d)
        g = g.reshape(g.shape[0], -1, *g.shape[3:]).astype(jnp.float32)
        if scales is not None:
            s = jnp.swapaxes(scales[bt], 2, 3)
            g = g * s.reshape(s.shape[0], -1, s.shape[3])[..., None]
        return g if upcast else g.astype(q.dtype)

    k, v = dense(pools["k"], pools["ks"]), dense(pools["v"], pools["vs"])
    key_mask = jnp.arange(k.shape[1])[None, :] < jnp.asarray(lens)[:, None]
    o, _ = attention_ref(q.astype(jnp.float32) if upcast else q, k, v, None, key_mask, None,
                         causal=True, upcast=upcast)
    return _t(o).float()


def _port_pools(pools):
    sc = {} if pools["ks"] is None else dict(k_scales=_t(pools["ks"]), v_scales=_t(pools["vs"]))
    return _t(pools["k"]), _t(pools["v"]), sc


@pytest.mark.parametrize("d,kv", [(59, "bf16"), (111, "bf16"), (59, "fp8_e4m3"),
                                  (111, "int8")])
def test_k1_padded_copy_matches_jax_reference(d, kv):
    """paged_attention_padded (q and the pools zero-padded to the width the
    kernels read, 64 or 112, through the plain version, O cut back to d)
    against the JAX package's reference: the 2x rule, and O equal to the
    plain version at d itself up to f32 rounding of the score sums."""
    q, pools, bt, lens = _paged_case(30 + d, d, kv=kv, sq=3)
    kp, vp, sc = _port_pools(pools)
    dm = paged.mapped_head_dim(d, BF16, kp.dtype)
    assert dm > d
    to, tl = paged.paged_attention_padded(_t(q), kp, vp, _t(bt), _t(lens), dm, **sc)
    assert to.shape == (2, 3, 4, d) and tl.shape == (2, 4, 3)
    ro = _paged_reference(q, pools, bt, lens, upcast=True)
    lo = _paged_reference(q, pools, bt, lens, upcast=False)
    assert_close_2ref(to, ro, lo)
    po, pl = paged.paged_attention(_t(q), kp, vp, _t(bt), _t(lens), **sc)
    assert float((to.float() - po.float()).abs().max()) <= 2 ** -7 * float(po.abs().max())
    assert float((tl - pl).abs().max()) <= 1e-5


def test_k1_plain_matches_jax_kernel_d96_fp8_gqa():
    """The port's plain K1 at d = 96 over fp8 pools, GQA 2:1, decode rows,
    against the JAX kernel (interpret mode; it pads d to 128 inside) and
    the JAX reference: the 2x rule on O."""
    q, pools, bt, lens = _paged_case(96, 96, kv="fp8_e4m3", b=2, sq=1, h=4, h_k=2)
    jo, _ = jpaged.paged_attention(q, pools["k"], pools["v"], jnp.asarray(bt),
                                   jnp.asarray(lens), k_scales=pools["ks"],
                                   v_scales=pools["vs"])
    kp, vp, sc = _port_pools(pools)
    assert paged.paged_plan((2, 1, 4, 96), kp.shape, kp.dtype, 4)[0] == "decode"
    to, _ = paged.paged_attention(_t(q), kp, vp, _t(bt), _t(lens), **sc)
    ro = _paged_reference(q, pools, bt, lens, upcast=True)
    assert to.shape == (2, 1, 4, 96) and to.dtype == torch.bfloat16
    assert_close_2ref(to, ro, _t(jo).float())


# ---- K7 against the JAX package -----------------------------------------------

def _flash_case(seed, d, b=1, h=2, h_k=1, sq=24, sk=40):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal(s).astype(np.float32), jnp.bfloat16)
            for s in ((b, h, sq, d), (b, h_k, sk, d), (b, h_k, sk, d))]


def _flash_reference(q, k, v, upcast):
    """attention_ref (BSHD) of the JAX package, causal from the bottom right,
    in f32 (upcast) or in the inputs' dtype."""
    sw = lambda x: jnp.swapaxes(x.astype(jnp.float32) if upcast else x, 1, 2)  # noqa: E731
    o, _ = attention_ref(sw(q), sw(k), sw(v), causal=True, upcast=upcast)
    return _t(jnp.swapaxes(o, 1, 2)).float()


def _lse_reference(q, k):
    """The f32 log-sum-exp of the causal (bottom-right) scores, (b, h, sq)."""
    q, k = (np.asarray(x, np.float32) for x in (q, k))
    k = np.repeat(k, q.shape[1] // k.shape[1], axis=1)
    s = q @ np.swapaxes(k, -1, -2) / math.sqrt(q.shape[-1])
    sq, sk = s.shape[-2:]
    s = np.where(np.arange(sk)[None, :] <= np.arange(sq)[:, None] + sk - sq, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return torch.from_numpy((m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0])


@pytest.mark.parametrize("d", [40, 96, 256])
def test_k7_plain_matches_jax_kernel(d):
    """The port's plain K7 against the JAX kernel (interpret mode) and the
    JAX reference at head dims the CUDA kernel serves on the rungs 64, 128
    and 256 in place: the 2x rule on O and on LSE."""
    q, k, v = _flash_case(40 + d, d)
    jo, jl = j_flash_fwd(q, k, v, causal=True)
    to, tl = ff.flash_fwd(_t(q), _t(k), _t(v), causal=True)
    assert ff.flash_head_dim(d, BF16) == d
    assert_close_2ref(to, _flash_reference(q, k, v, True), _t(jo).float())
    assert_close_2ref(tl, _lse_reference(q, k), _t(jl))


@pytest.mark.parametrize("d", [59, 111])
def test_k7_padded_copy_matches_jax_kernel(d):
    """flash_fwd_padded (q, k, v zero-padded to 64 or 112 through the plain
    version, O cut back to d) against the JAX kernel, which pads to 128
    inside: the 2x rule on O and on LSE."""
    q, k, v = _flash_case(50 + d, d)
    dm = ff.flash_head_dim(d, BF16)
    assert dm > d
    to, tl = ff.flash_fwd_padded(_t(q), _t(k), _t(v), dm, causal=True)
    jo, jl = j_flash_fwd(q, k, v, causal=True)
    assert to.shape == (1, 2, 24, d)
    assert_close_2ref(to, _flash_reference(q, k, v, True), _t(jo).float())
    assert_close_2ref(tl, _lse_reference(q, k), _t(jl))


# ---- the refusals that stay ----------------------------------------------------

@pytest.mark.parametrize("d", [257, 59], ids=["d257", "d59_unpadded"])
def test_k8_and_k9_k11_refuse_head_dim_by_name(d):
    """K8's and K9-K11's CUDA wrappers check their inputs before they touch
    the card: at d = 257 (past every rung), and at d = 59 handed to them
    unpadded (rows of no whole 16-byte chunks, which attention_probs and
    flash_bwd copy to 64 first), each raises ValueError naming itself;
    nothing falls back to a plain version."""
    x = torch.zeros((1, 2, 64, d), dtype=BF16)
    lse = torch.zeros((1, 2, 64))
    ex = ff.Extras(1, 2, 64, 64, "cpu")
    with pytest.raises(ValueError, match="attention probs \\(K8\\)"):
        ff._attention_probs_cuda(x, x, lse, 1.0, True, (-1, -1), 0.0, None, None, ex)
    with pytest.raises(ValueError, match="flash backward \\(K9-K11\\)"):
        flash_bwd.FlashBwdLaunch(x, x, x, x, lse, x, scale=1.0, causal=True, window=(-1, -1),
                                 softcap=0.0, kv_lens=None, q_segment_ids=None,
                                 kv_segment_ids=None)


# ---- an engine at head dim 96 --------------------------------------------------

# dim 192 over 2 heads: head dim 96
D96 = dict(vocab_size=97, dim=192, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128,
           max_seq_len=512)


def test_engine_d96_token_identical_to_jax():
    """A 2-layer model at d = 96 (f32 weights and KV, 32-token chunks over
    page 16) served greedy by the JAX engine and the port's engine (plain
    versions on the CPU): the same tokens."""
    jparams = j_init_params(jax.random.PRNGKey(3), JLlamaConfig(**D96), dtype=jnp.float32)
    kw = dict(max_batch=2, page_size=16, num_pages=16, max_seq=256, prefill_chunk=32)
    prompts = {0: [(7 * i + 3) % 97 for i in range(37)], 1: [5, 9, 2, 33, 8, 1, 60]}
    jeng = JDecodeEngine(jparams, JLlamaConfig(**D96), JEngineConfig(**kw), dtype=jnp.float32)
    teng = DecodeEngine(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                        LlamaConfig(**D96), EngineConfig(**kw), dtype=torch.float32,
                        device="cpu")
    assert LlamaConfig(**D96).head_dim == 96
    for eng in (jeng, teng):
        for rid, p in prompts.items():
            eng.add_request(rid, p, 4)
    jout, tout = jeng.run(), teng.run()
    for rid in prompts:
        assert len(tout[rid]) == 4
        assert list(tout[rid]) == list(jout[rid]), rid
