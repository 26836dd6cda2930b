"""PyTorch port vs the JAX package: KV quantization, weight quantization and
the weight-only quantized matmul (the plain version of csrc/qmm.cu).

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs as its own tests run it (CPU, Pallas interpret mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.quant import kv as jkv
from xf_flash_attention_cutlass_tpu.quant import linear as jlinear
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.quant import kv, linear

QDTYPES = {"int8": (torch.int8, np.int8), "fp8_e4m3": (torch.float8_e4m3fn, np.uint8)}


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bits of a tensor, for bit-exact comparison."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a


def _rows(seed, shape):
    """Per-row magnitudes spread over five decades, an all-zero row, and a
    row of exact round-half ties (amax 127 gives scale 1.0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= 10.0 ** rng.uniform(-3, 2, shape[:-1] + (1,)).astype(np.float32)
    x = x.reshape(-1, shape[-1])
    x[0] = 0.0
    x[1] = 0.5
    x[1, :4] = [127.0, 2.5, -3.5, -0.5]
    return x.reshape(shape)


# The JAX package fills its pools through compiled code, where XLA turns
# amax / qmax into amax * (1 / qmax); the port writes that form (quant/kv.py),
# so the JAX side of the KV comparisons runs under jit.
j_quantize_kv = jax.jit(jkv.quantize_kv, static_argnums=1)
j_quantize_kv_pools = jax.jit(jkv.quantize_kv_pools, static_argnums=2)


@pytest.mark.parametrize("name", ["int8", "fp8_e4m3"])
def test_quantize_kv_bit_exact(name):
    x = _rows(0, (6, 5, 64))
    jq, js = j_quantize_kv(jnp.asarray(x), name)
    tq, ts = kv.quantize_kv(torch.from_numpy(x), name)
    assert tq.dtype == QDTYPES[name][0] and ts.shape == (6, 5, 1)
    np.testing.assert_array_equal(_bits(tq), _jbits(jq))
    np.testing.assert_array_equal(_bits(ts), _jbits(js))
    # bf16 input: the same float32 math after the upcast
    xb = jnp.asarray(x, jnp.bfloat16)
    jq, js = j_quantize_kv(xb, name)
    tq, ts = kv.quantize_kv(params_from_jax(np.asarray(xb)), name)
    np.testing.assert_array_equal(_bits(tq), _jbits(jq))
    np.testing.assert_array_equal(_bits(ts), _jbits(js))
    # dequantize and the pool form
    jd = jkv.dequantize_kv(jq, js)
    td = kv.dequantize_kv(tq, ts)
    np.testing.assert_array_equal(_bits(td), _jbits(jd))
    pools = kv.quantize_kv_pools(torch.from_numpy(x), torch.from_numpy(-x), name)
    jpools = j_quantize_kv_pools(jnp.asarray(x), jnp.asarray(-x), name)
    for t, j in zip(pools, jpools):
        np.testing.assert_array_equal(_bits(t), _jbits(j))


def test_quantize_kv_rejects_unknown():
    with pytest.raises(ValueError):
        kv.quantize_kv(torch.zeros(2, 4), "int4")


@pytest.mark.parametrize("dt", [torch.int8, torch.float8_e4m3fn])
def test_quantize_weight_bit_exact(dt):
    w = _rows(1, (96, 40)).T.copy()  # (d_in=40, d_out=96): per-column scales
    jdt = jnp.int8 if dt == torch.int8 else jnp.float8_e4m3fn
    jq, js = jlinear.quantize_weight(jnp.asarray(w), jdt)
    tq, ts = linear.quantize_weight(torch.from_numpy(w), dt)
    assert ts.shape == (96,)
    np.testing.assert_array_equal(_bits(tq), _jbits(jq))
    np.testing.assert_array_equal(_bits(ts), _jbits(js))


def _mm_inputs(seed, m, k, n, layers=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    shape = (k, n) if layers is None else (layers, k, n)
    w = (rng.standard_normal(shape) / np.sqrt(k)).astype(np.float32)
    return x, w


def _close_f32(got: torch.Tensor, want, k: int):
    """f32 sums in another order: within k float32 epsilons of the largest
    output (each of the k products rounds once per add at most)."""
    want = np.asarray(want, np.float32)
    tol = k * np.finfo(np.float32).eps * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("m", [8, 16, 64, 200])
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("dt", [torch.int8, torch.float8_e4m3fn])
def test_quantized_matmul_matches_jax(dt, stacked, m):
    """k and n are 128-aligned so the JAX stacked path runs its Pallas
    kernel (interpret mode), not its slice fallback. m = 8 and 16 are
    decode widths (the decode kernel on the card, with N = 8 and 16), 64
    and 200 prefill widths (the wgmma kernel)."""
    k, n = 256, 128
    jdt = jnp.int8 if dt == torch.int8 else jnp.float8_e4m3fn
    x, w = _mm_inputs(2, m, k, n, layers=2 if stacked else None)
    if stacked:
        pairs = [jlinear.quantize_weight(jnp.asarray(w[i]), jdt) for i in range(2)]
        jq = jnp.stack([p[0] for p in pairs])
        js = jnp.stack([p[1] for p in pairs])
        want = jlinear.quantized_matmul(jnp.asarray(x), jq, js, layer_idx=jnp.int32(1))
        got = linear.quantized_matmul(torch.from_numpy(x), params_from_jax(np.asarray(jq)),
                                      params_from_jax(np.asarray(js)), layer_idx=1)
    else:
        jq, js = jlinear.quantize_weight(jnp.asarray(w), jdt)
        want = jlinear.quantized_matmul(jnp.asarray(x), jq, js)
        got = linear.quantized_matmul(torch.from_numpy(x), params_from_jax(np.asarray(jq)),
                                      params_from_jax(np.asarray(js)))
    assert got.shape == (m, n) and got.dtype == torch.float32
    _close_f32(got, want, k)


def test_quantized_matmul_bf16_stack_without_scale():
    """has_scale=False: the packed bf16 stacks of pack_params_for_decode.
    bf16 outputs of two f32 sums of different order round to the same or a
    neighbouring bf16 value: within one bf16 ulp of the largest output."""
    m, k, n = 5, 256, 256
    x, w = _mm_inputs(3, m, k, n, layers=3)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = np.asarray(
        jlinear.quantized_matmul(xb, wb, None, layer_idx=jnp.int32(2)), np.float32
    )
    got = linear.quantized_matmul(params_from_jax(np.asarray(xb)),
                                  params_from_jax(np.asarray(wb)), None, layer_idx=2)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_quantized_linear_module_matches_jax():
    x, w = _mm_inputs(4, 3, 64, 48)
    bias = np.linspace(-1, 1, 48).astype(np.float32)
    jl = jlinear.QuantizedLinear.from_weight(jnp.asarray(w), jnp.asarray(bias))
    tl = linear.QuantizedLinear.from_weight(torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_array_equal(_bits(tl.w_q), _jbits(jl.w_q))
    _close_f32(tl(torch.from_numpy(x)), jl(jnp.asarray(x)), 64)
    assert dict(tl.named_buffers()).keys() == {"w_q", "scale", "bias"}


# Llama-8B's projections (K, N): q, k, v, o, gate, up, down, and the lm_head
LLAMA8B_KN = [(4096, 4096), (4096, 1024), (4096, 1024), (4096, 4096), (4096, 14336),
              (4096, 14336), (14336, 4096), (4096, 128256)]


def test_qmm_splits_cover_k_exactly():
    """The split-K plan of csrc/qmm.cu: every k-tile in exactly one split,
    no empty split, more blocks for small-m decode shapes. The wgmma
    kernel's plan at prefill widths also keeps its blocks (one an SM) in one
    wave whenever it splits."""
    for m, k, n in [(8, 4096, 1024), (8, 14336, 4096), (256, 4096, 14336),
                    (8, 4096, 128256), (5, 200, 300), (1, 64, 64)]:
        splits, per = linear.qmm_splits(m, n, k)
        n_kt = -(-k // 64)
        assert splits >= 1 and (splits - 1) * per < n_kt <= splits * per
    assert linear.qmm_splits(8, 1024, 4096)[0] > 1
    assert linear.qmm_splits(8, 128256, 4096)[0] == 1
    for m in (256, 2048):
        for k, n in LLAMA8B_KN[:7]:
            splits, per = linear.qmm_splits(m, n, k, "wgmma")
            n_kt = -(-k // 64)
            assert splits >= 1 and (splits - 1) * per < n_kt <= splits * per
            blocks = -(-m // linear.qmm_wgmma_rows(m)) * -(-n // 128)
            assert splits == 1 or blocks * splits <= 132
    assert linear.qmm_splits(256, 1024, 4096, "wgmma")[0] > 1  # k/v: 8 tiles alone


@pytest.mark.parametrize("m", [1, 8, 16])
def test_qmm_decode_splits(m):
    """The decode kernel's split plan for the seven Llama-8B projections and
    the lm_head: every k-tile in exactly one split, no split empty, the
    output tiles of a split plan within the arrival counters, N = 8 or 16
    tokens by m; and the plan keeps the card streaming with the fewest
    splits: at least 99 of the 132 SMs get a block unless that would leave
    fewer than 8 k-tiles in a split, and one split fewer would give fewer
    blocks."""
    assert linear.qmm_decode_rows(m) == (8 if m <= 8 else 16)
    for k, n in LLAMA8B_KN:
        splits, per = linear.qmm_splits(m, n, k)
        assert (splits, per) == linear.qmm_decode_splits(n, k)
        n_kt = -(-k // 64)
        ranges = [range(s * per, min(n_kt, (s + 1) * per)) for s in range(splits)]
        assert all(len(r) > 0 for r in ranges)
        assert sorted(t for r in ranges for t in r) == list(range(n_kt))
        cols = -(-n // 128)
        assert splits == 1 or cols <= linear.QMM_DECODE_COUNTERS
        assert per >= min(8, n_kt) and (cols * splits >= 99 or per == 8)
        assert splits == 1 or cols * (splits - 1) < 99
    assert linear.qmm_decode_splits(1024, 4096)[0] > 1  # k and v: 8 column tiles
    # more column tiles than counters: one split, the whole of K
    n_kt = 4096 // 64
    assert linear.qmm_decode_splits(128 * (linear.QMM_DECODE_COUNTERS + 1), 4096) == (1, n_kt)


def _stack_ptrs(layers, k, n, w_dtype, base=1 << 20):
    """Addresses of each layer of an aligned (layers, k, n) stack."""
    return [base + layer * k * n * w_dtype.itemsize for layer in range(layers)]


@pytest.mark.parametrize("w_dtype", [torch.int8, torch.float8_e4m3fn, torch.bfloat16])
def test_qmm_route(w_dtype):
    """When TMA can load both operands (every Llama-8B shape, stacked at any
    layer or single) decode widths take the decode kernel and prefill
    widths the wgmma kernel; otherwise (the ragged shapes chip_smoke.py
    checks, a misaligned x or weight) the WMMA kernel, bm16 at decode
    widths and bm64 above."""
    x_ptr = 1 << 21
    for m in (1, 8, 16):
        for k, n in LLAMA8B_KN:
            for w_ptr in _stack_ptrs(32, k, n, w_dtype) + [x_ptr]:  # stacked, single
                assert linear.qmm_route(m, k, n, w_dtype, x_ptr, w_ptr) == "decode"
        assert linear.qmm_route(m, 4096, 4096, w_dtype, x_ptr + 2, x_ptr) == "bm16"
        assert linear.qmm_route(m, 4096, 4096, w_dtype, x_ptr, x_ptr + 8) == "bm16"
    # chip_smoke.py's ragged decode shapes: N = 300 bytes, K = 203
    for m, k, n in [(1, 200, 300), (5, 203, 136)]:
        assert linear.qmm_route(m, k, n, w_dtype, x_ptr, x_ptr) == "bm16"
    for m in (17, 64, 256, 2048):
        for k, n in LLAMA8B_KN:
            for w_ptr in _stack_ptrs(32, k, n, w_dtype) + [x_ptr]:  # stacked, single
                assert linear.qmm_route(m, k, n, w_dtype, x_ptr, w_ptr) == "wgmma"
        assert linear.qmm_route(m, 4096, 4096, w_dtype, x_ptr + 8, x_ptr) == "bm64"
        assert linear.qmm_route(m, 4096, 4096, w_dtype, x_ptr, x_ptr + 4) == "bm64"
    # chip_smoke.py's ragged shapes: x rows of 8200 bytes, N = 300 / 136 / 1000 / 130
    for m, k, n in [(100, 4100, 1000), (17, 256, 130), (17, 200, 300), (100, 203, 136)]:
        assert linear.qmm_route(m, k, n, w_dtype, x_ptr, x_ptr) == "bm64"
    assert linear.qmm_route(100, 4096, 1000, torch.bfloat16, x_ptr, x_ptr) == "wgmma"
    assert linear.qmm_route(100, 4096, 1000, torch.int8, x_ptr, x_ptr) == "bm64"
