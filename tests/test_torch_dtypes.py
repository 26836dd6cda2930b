"""PyTorch port vs the JAX package in the dtypes the JAX engine serves
besides bf16: fp16 and f32, through the plain versions of csrc/
paged_attention.cu (K1), csrc/paged_append.cu (K2/K5/K6) and csrc/qmm.cu
(K3/K4), and one tiny fp16 engine.

Inputs are made with numpy from a seed and handed to both packages. K1 is
held to the 2x rule against JAX's plain oracle (ops/reference.py's
attention_ref over the pages gathered and dequantized in jnp; no Pallas
call): fp16 against the float32 oracle with attention_ref in fp16 as the
low-precision oracle, f32 against the port's float64 oracle with JAX's f32
attention_ref as the low-precision one. Appends equal JAX's quantize_kv
under jax.jit and ops/kvcache.py's append_kv_paged bit for bit. K3 is held
to the 2x rule against a float64 product, JAX's quantized_matmul as the
low-precision oracle. The wrappers' dtype validators take the new dtypes
and still refuse f64 with a TypeError naming the kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
    quantize_params as j_quantize_params,
)
from xf_flash_attention_cutlass_tpu.ops import kvcache as jkvcache
from xf_flash_attention_cutlass_tpu.ops.reference import attention_ref
from xf_flash_attention_cutlass_tpu.quant import linear as jlinear
from xf_flash_attention_cutlass_tpu.quant.kv import quantize_kv as jquantize_kv
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
)
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops import flash_fwd, paged, paged_append
from xf_flash_attention_cutlass_tpu_torch.quant import linear
from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig
from xf_flash_attention_cutlass_tpu_torch.utils.testing import (
    assert_close_2ref,
    paged_attention_oracle,
)

JDT = {"f16": jnp.float16, "f32": jnp.float32, "int8": jnp.int8,
       "fp8_e4m3": jnp.float8_e4m3fn}
TDT = {"f16": torch.float16, "f32": torch.float32, "int8": torch.int8,
       "fp8_e4m3": torch.float8_e4m3fn}
# compiled, as the JAX engine fills its pools (see quant/kv.py of the port)
j_quantize_kv = jax.jit(jquantize_kv, static_argnums=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes, and the count
    is restored for the files that run after this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()]).numpy()


# ---- K1 -----------------------------------------------------------------------

def _paged_case(seed, q_dt, kv, *, b=3, sq=1, h=4, h_k=2, d=32, page=16, n_pages=12,
                max_pages=4):
    """q (b, sq, h, d) in q_dt, pools of kv ("f16" / "f32": unquantized in
    that dtype; "int8" / "fp8_e4m3": quantized by JAX's quantize_kv), block
    tables and lengths, as jax arrays; the last row has kv_len 0."""
    rng = np.random.default_rng(seed)
    shape = (n_pages + 1, h_k, page, d)
    kf = rng.standard_normal(shape).astype(np.float32)
    vf = rng.standard_normal(shape).astype(np.float32)
    q = jnp.asarray(rng.standard_normal((b, sq, h, d)), JDT[q_dt])
    if kv in ("int8", "fp8_e4m3"):
        kq, ks = j_quantize_kv(jnp.asarray(kf), kv)
        vq, vs = j_quantize_kv(jnp.asarray(vf), kv)
        pools = dict(k=kq, v=vq, ks=ks[..., 0], vs=vs[..., 0])
    else:
        pools = dict(k=jnp.asarray(kf, JDT[kv]), v=jnp.asarray(vf, JDT[kv]), ks=None, vs=None)
    bt = np.stack([rng.permutation(n_pages)[:max_pages] for _ in range(b)]).astype(np.int32)
    lens = rng.integers(sq, max_pages * page + 1, size=b).astype(np.int32)
    lens[-1] = 0
    bt[-1] = n_pages
    return q, pools, bt, lens


@functools.partial(jax.jit, static_argnames=("dtype", "window", "softcap"))
def _jax_dense(q, pools, bt, lens, dtype, window=(-1, -1), softcap=0.0):
    """JAX's plain oracle, causal from the bottom right: the pages gathered in
    logical order and dequantized in f32, then attention_ref over them with
    q, K and V in `dtype` (upcast for f32)."""
    def dense(pool):  # (pages, h_k, page, ...) -> (b, T, h_k, ...)
        g = jnp.swapaxes(pool[bt], 2, 3)
        return g.reshape(g.shape[0], -1, *g.shape[3:]).astype(jnp.float32)

    k, v = dense(pools["k"]), dense(pools["v"])
    if pools["ks"] is not None:
        k, v = k * dense(pools["ks"])[..., None], v * dense(pools["vs"])[..., None]
    key_mask = jnp.arange(k.shape[1])[None, :] < lens[:, None]
    out, _ = attention_ref(q.astype(dtype), k.astype(dtype), v.astype(dtype), None, key_mask,
                           causal=True, window_size=window, softcap=softcap,
                           upcast=dtype == jnp.float32)
    return out


@pytest.mark.parametrize(
    "q_dt,kv,sq,page,opts",
    [
        ("f16", "f16", 1, 16, {}),  # decode over fp16 pools
        ("f16", "fp8_e4m3", 1, 16, {}),  # decode over fp8 pools (the fp16 engine's)
        ("f16", "f16", 20, 16, {}),  # a chunk: the Hopper chunk route's rows
        ("f16", "int8", 5, 12, dict(window=(20, -1), softcap=30.0)),  # odd page, options
        ("f32", "f32", 1, 16, {}),  # the f32 route: decode over f32 pools
        ("f32", "fp8_e4m3", 1, 16, {}),
        ("f32", "f32", 20, 12, dict(window=(20, -1), softcap=30.0)),  # a chunk, odd page
    ],
)
def test_paged_attention_dtypes_2x_rule(q_dt, kv, sq, page, opts):
    """K1's plain version at fp16 and f32 against JAX's plain oracle (2x
    rule), routed as the card routes it; rows with kv_len 0 give O = 0."""
    q, pools, bt, lens = _paged_case(7, q_dt, kv, sq=sq, page=page)
    sc = {} if pools["ks"] is None else dict(k_scales=_t(pools["ks"]), v_scales=_t(pools["vs"]))
    tq, tk, tv, tbt, tl = _t(q), _t(pools["k"]), _t(pools["v"]), _t(bt), _t(lens)
    to, tlse = paged.paged_attention(tq, tk, tv, tbt, tl, **sc, **opts)
    assert to.dtype == TDT[q_dt] and torch.isfinite(to).all()
    assert torch.all(to[-1] == 0) and torch.all(torch.isneginf(tlse[-1]))
    live = slice(0, -1)
    jw = dict(window=opts.get("window", (-1, -1)), softcap=opts.get("softcap", 0.0))
    okw = dict(window=jw["window"], softcap=jw["softcap"],
               k_scales=sc.get("k_scales"), v_scales=sc.get("v_scales"))
    if q_dt == "f16":
        ref = _t(_jax_dense(q, pools, bt, lens, jnp.float32, **jw))
        lp = _t(_jax_dense(q, pools, bt, lens, jnp.float16, **jw))
        assert_close_2ref(to[live], ref[live], lp[live])
    else:
        ref, _ = paged_attention_oracle(tq, tk, tv, tbt, tl, ref_dtype=torch.float64, **okw)
        lp = _t(_jax_dense(q, pools, bt, lens, jnp.float32, **jw))
        assert_close_2ref(to[live], ref[live], lp[live])
    route = paged.paged_route(sq * 2, page, 32, TDT[kv], TDT[q_dt])
    # d = 32 takes the Hopper kernels too (their rung 64); odd pages the WMMA one
    assert route == ("f32" if q_dt == "f32" else "wmma" if page % 8
                     else "decode" if sq * 2 <= paged.DECODE_ROWS else "wgmma")


# ---- the append ---------------------------------------------------------------

@pytest.mark.parametrize("rows,pool", [("f16", "fp8_e4m3"), ("f16", "int8"), ("f16", "f16"),
                                       ("f32", "int8"), ("f32", "fp8_e4m3"), ("f32", "f32")])
def test_paged_append_dtypes_bit_exact(rows, pool):
    """fp16 and f32 rows appended at scattered positions (a verify-style
    sq = 3) into pools of their own dtype, int8 or fp8: values and scales
    equal JAX's append_kv_paged of JAX's jitted quantize_kv bit for bit on
    every page but the trash page. f32 rows keep their whole mantissa up to
    the quantizer."""
    rng = np.random.default_rng(11)
    b, sq, h_k, d, page, n_pages = 2, 3, 2, 64, 16, 8
    shape = (2, n_pages + 1, h_k, page, d)
    kn = (rng.standard_normal((b, sq, h_k, d)) * 3).astype(np.float32)
    vn = rng.standard_normal((b, sq, h_k, d)).astype(np.float32)
    kn[0, 0, 0] = 0.0  # amax 0: scale 1
    kn, vn = jnp.asarray(kn, JDT[rows]), jnp.asarray(vn, JDT[rows])
    bt = np.full((b, 4), n_pages, np.int32)
    bt[0, :2], bt[1, :2] = [3, 6], [0, 5]
    pos = np.asarray([14, 2], np.int32)
    quant = pool in ("int8", "fp8_e4m3")
    jk = jnp.zeros(shape, JDT[pool])
    jv = jnp.zeros(shape, JDT[pool])
    tk, tv = _t(jk), _t(jv)
    if quant:
        jks, jvs = jnp.zeros(shape[:-1], jnp.float32), jnp.zeros(shape[:-1], jnp.float32)
        tks, tvs = _t(jks), _t(jvs)
        kq, ks = j_quantize_kv(kn, pool)
        vq, vs = j_quantize_kv(vn, pool)
        jk, jv = jkvcache.append_kv_paged(jk, jv, kq, vq, jnp.asarray(bt), jnp.asarray(pos),
                                          layer_idx=jnp.int32(1))
        jks, jvs = jkvcache.append_kv_paged(jks[..., None], jvs[..., None], ks, vs,
                                            jnp.asarray(bt), jnp.asarray(pos),
                                            layer_idx=jnp.int32(1))
        paged_append.paged_append(tk, tv, _t(kn), _t(vn), _t(bt), _t(pos), layer_idx=1,
                                  k_scales=tks, v_scales=tvs)
        want = (jk, jv, jks[..., 0], jvs[..., 0])
        got = (tk, tv, tks, tvs)
    else:
        jk, jv = jkvcache.append_kv_paged(jk, jv, kn, vn, jnp.asarray(bt), jnp.asarray(pos),
                                          layer_idx=jnp.int32(1))
        paged_append.paged_append(tk, tv, _t(kn), _t(vn), _t(bt), _t(pos), layer_idx=1)
        want, got = (jk, jv), (tk, tv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g[:, :n_pages]), _bits(_t(w)[:, :n_pages]))
    assert torch.count_nonzero(tk[1, :n_pages].float()) > 0


# ---- K3/K4 --------------------------------------------------------------------

def _check_quantized_matmul(x_dt, w_dt, stacked):
    rng = np.random.default_rng(5)
    k, n = 96, 80
    w = (rng.standard_normal((2, k, n)) / np.sqrt(k)).astype(np.float32)
    jq, js = zip(*(jlinear.quantize_weight(jnp.asarray(w[i]), JDT[w_dt]) for i in range(2)))
    jq, js = jnp.stack(jq), jnp.stack(js)
    tq, ts = _t(jq), _t(js)
    for m in (8, 19):
        x = jnp.asarray(rng.standard_normal((m, k)), JDT[x_dt])
        if stacked:
            want = jlinear.quantized_matmul(x, jq, js, layer_idx=jnp.int32(1))
            got = linear.quantized_matmul(_t(x), tq, ts, layer_idx=1)
            wq, s = tq[1], ts[1]
        else:
            want = jlinear.quantized_matmul(x, jq[1], js[1])
            got = linear.quantized_matmul(_t(x), tq[1], ts[1])
            wq, s = tq[1], ts[1]
        assert got.dtype == TDT[x_dt] and got.shape == (m, n)
        ref = (_t(x).double() @ wq.double()) * s.double()
        assert_close_2ref(got, ref, _t(want))
        assert linear.qmm_route(m, k, n, wq.dtype, 0, 0, TDT[x_dt]) == (
            "f32" if x_dt == "f32" else ("decode" if m <= 16 else "wgmma"))


@pytest.mark.parametrize("x_dt,cases", [
    ("f16", [("int8", True), ("fp8_e4m3", False)]),
    ("f32", [("int8", True), ("fp8_e4m3", True), ("int8", False)]),
])
def test_quantized_matmul_dtypes_2x_rule(x_dt, cases):
    """fp16 and f32 activations over int8 / fp8 weights, stacked (layer 1)
    or single, at a decode width (m = 8) and a ragged one (m = 19): the
    port's plain version within twice JAX's error against a float64
    product, plus 1e-5."""
    for w_dt, stacked in cases:
        _check_quantized_matmul(x_dt, w_dt, stacked)


# ---- one fp16 engine ------------------------------------------------------------

TINY = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=512)


def test_engine_fp16_int8_weights_fp8_kv_matches_jax():
    """A tiny fp16 model with INT8 weights over an FP8 page-32 KV cache,
    chunked at 32 (the 36-token prompt takes two chunks), served by both
    engines from the same weights (JAX's, converted bit for bit): the
    greedy streams are equal token for token."""
    jparams = j_quantize_params(j_init_params(jax.random.PRNGKey(3), JLlamaConfig(**TINY),
                                              dtype=jnp.float16))
    kw = dict(max_batch=2, page_size=32, num_pages=8, max_seq=256, prefill_chunk=32,
              kv_quant="fp8_e4m3")
    prompts = {0: [(3 * i + 2) % 97 for i in range(36)], 1: [5, 9, 2, 33, 8, 1, 60, 4, 17]}
    jeng = JDecodeEngine(jparams, JLlamaConfig(**TINY), JEngineConfig(**kw), dtype=jnp.float16)
    teng = DecodeEngine(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                        LlamaConfig(**TINY), EngineConfig(**kw), dtype=torch.float16,
                        device="cpu")
    for eng in (jeng, teng):
        for rid, p in prompts.items():
            eng.add_request(rid, p, 4)
    jout, tout = jeng.run(), teng.run()
    assert teng.params["embed"].dtype == torch.float16
    for rid in prompts:
        assert len(tout[rid]) == 4
        assert list(tout[rid]) == list(jout[rid]), rid


# ---- the validators ---------------------------------------------------------------

def test_validators_take_the_new_dtypes():
    """The CUDA wrappers' dtype checks, which run before any launch: K1 takes
    bf16 / fp16 queries over pools of their dtype, int8 or fp8 and f32 over
    f32, int8 or fp8; the append kernel rows of each into pools of their own
    dtype, int8 or fp8; K3/K4 activations of each over weights of their
    dtype, int8 or fp8. An f64 query, row or activation, and a 16-bit query
    over the other 16-bit dtype's pools, raise TypeError naming the
    kernel. The dense flash kernels (K7, K8, K9-K11) share one dtype check,
    which K7's wrapper runs before a bucketed engine's prefill launches: it
    takes bf16, fp16 and f32 q/k/v of one dtype (f32 on csrc/flash_f32.cu)
    and raises TypeError naming the kernel for f64 and for mixed dtypes."""
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        _check_validators(dt)
    x = torch.zeros((1, 2, 8, 64), dtype=torch.float32)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        y = x.to(dt)
        flash_fwd.check_cuda_dtypes("flash forward (K7)", y, y, y)
    with pytest.raises(TypeError, match="flash forward \\(K7\\)"):
        flash_fwd.check_cuda_dtypes("flash forward (K7)", x.double(), x.double(), x.double())
    with pytest.raises(TypeError, match="flash forward \\(K7\\)"):
        flash_fwd.check_cuda_dtypes("flash forward (K7)", x, x.bfloat16(), x.bfloat16())


def _check_validators(dt):
    for other in (dt, torch.int8, torch.float8_e4m3fn):
        paged.check_kernel_dtypes(dt, other)
        paged_append.check_append_dtypes(dt, other)
        linear.check_kernel_dtypes(dt, other)
    for fn, kernel in ((paged.check_kernel_dtypes, "K1"),
                       (paged_append.check_append_dtypes, "K2/K5/K6"),
                       (linear.check_kernel_dtypes, "K3/K4")):
        with pytest.raises(TypeError, match=kernel):
            fn(torch.float64, torch.int8)
        with pytest.raises(TypeError, match=kernel):
            fn(dt, torch.float64)
    if dt != torch.float32:
        other16 = torch.float16 if dt == torch.bfloat16 else torch.bfloat16
        with pytest.raises(TypeError, match="K1"):
            paged.check_kernel_dtypes(dt, other16)
