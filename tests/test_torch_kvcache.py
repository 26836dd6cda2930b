"""PyTorch port vs the JAX package: ``flash_attn_with_kvcache`` over paged
and dense caches (``ops/kvcache.py``, K1), the cases of
tests/test_kvcache.py at smaller sizes: MHA / GQA / MQA, page 16 and 256,
non-causal, local windows, explicit splits, append with both rotary layouts,
ALiBi, dense caches with cache_batch_idx and leftpad, bf16 and fp16, scalar
cache_seqlens.

Inputs are made with numpy from a seed and handed to both packages; the JAX
kernel runs in Pallas interpret mode, the port its plain version (CPU
tensors). The JAX calls run eagerly: jit takes as long here (the interpret
kernel's compile dominates) and would fuse the rotary products into FMAs,
whose keys then differ from torch's in the last bit. Pages of 64 keep the
interpret kernel's loop short.

- f32 caches: out within 1e-5 of JAX's (the same sums, split-KV partials
  merged in another order; values <= 5).
- bf16 / fp16 caches: the 2x rule against the dense f32 oracle
  (utils/testing.py::paged_attention_oracle, on the same values): the
  port's error is at most twice the JAX kernel's, plus 1e-5.
- The updated caches equal JAX's bit for bit; the port writes them in
  place into the caller's tensors. The append helpers of ops/kvcache.py
  (paged with a layer axis, paged quantized int8 / fp8, dense with
  cache_batch_idx) and dense_cache_as_paged equal JAX's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xf_flash_attention_cutlass_tpu as jx
import xf_flash_attention_cutlass_tpu_torch as tx
from xf_flash_attention_cutlass_tpu.ops.rotary import rotary_frequencies
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.utils.testing import (
    assert_close_2ref,
    max_err,
    paged_attention_oracle,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JNP = {"f32": jnp.float32, "f16": jnp.float16, "bf16": jnp.bfloat16}


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


def _inputs(sq, sk, d, page, mha_type, new_kv, rotary_fraction, alibi, batch_idx, leftpad,
            paged, seed):
    """numpy inputs of one case, as tests/test_kvcache.py builds them."""
    rng = np.random.default_rng(seed)
    b, h = 2, 6
    h_k = {"mha": 6, "gqa": 3, "mqa": 1}[mha_type]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = dict(q=f(b, sq, h, d))
    s_new = sq if new_kv else 0
    if new_kv:
        x["k"], x["v"] = f(b, s_new, h_k, d), f(b, s_new, h_k, d)
    if paged:
        pages = -(-sk // page)
        nb = pages * b * 3
        x["k_cache"], x["v_cache"] = f(nb, page, h_k, d), f(nb, page, h_k, d)
        x["block_table"] = rng.permutation(nb)[: b * pages].reshape(b, pages).astype(np.int32)
    else:
        b_cache = 2 * b if batch_idx else b
        x["k_cache"], x["v_cache"] = f(b_cache, sk, h_k, d), f(b_cache, sk, h_k, d)
    x["cache_seqlens"] = rng.integers(0 if new_kv else 1, max(sk - s_new + 1, 2),
                                      (b,)).astype(np.int32)
    if batch_idx:
        x["cache_batch_idx"] = rng.permutation(2 * b)[:b].astype(np.int32)
    if leftpad:
        x["cache_leftpad"] = np.asarray(
            [rng.integers(0, int(s)) if s > 0 else 0 for s in x["cache_seqlens"]], np.int32)
    rotary_dim = int(rotary_fraction * d) // 16 * 16
    if rotary_dim:
        cos, sin = rotary_frequencies(rotary_dim, sk + sq)
        x["rotary_cos"], x["rotary_sin"] = np.asarray(cos), np.asarray(sin)
    if alibi:
        x["alibi_slopes"] = (rng.random((b, h)) * 0.3).astype(np.float32)
    return x


_FLOATS = ("q", "k", "v", "k_cache", "v_cache", "rotary_cos", "rotary_sin")


def run_case(sq, sk, d=32, page=64, mha_type="mha", causal=True, window=(-1, -1), new_kv=False,
             rotary_fraction=0.0, rotary_interleaved=True, alibi=False, batch_idx=False,
             leftpad=False, paged=True, num_splits=0, dtype="f32", seed=0):
    x = _inputs(sq, sk, d, page, mha_type, new_kv, rotary_fraction, alibi, batch_idx, leftpad,
                paged, seed)
    flags = dict(causal=causal, window_size=tuple(window), rotary_interleaved=rotary_interleaved,
                 num_splits=num_splits)

    arrays = {n: jnp.asarray(a, JNP[dtype] if n in _FLOATS else None) for n, a in x.items()}
    jo, jl, jk, jv = jx.flash_attn_with_kvcache(**arrays, return_softmax_lse=True, **flags)
    tin = {n: _t(jnp.asarray(a, JNP[dtype])) if n in _FLOATS else torch.from_numpy(a)
           for n, a in x.items()}
    to, tl, tk, tv = tx.flash_attn_with_kvcache(**tin, return_softmax_lse=True, **flags)
    assert tk is tin["k_cache"] and tv is tin["v_cache"]  # updated in place
    assert to.dtype == tin["q"].dtype and to.shape == tuple(jo.shape)
    if dtype == "f32":
        assert max_err(to, _t(jo)) <= 1e-5
        live = torch.isfinite(_t(jl))
        assert torch.equal(torch.isfinite(tl), live)
        assert max_err(tl[live], _t(jl)[live]) <= 1e-5
    else:  # a paged decode without options: the dense oracle on the same values
        assert paged and not new_kv and causal and not alibi
        lens = tin["cache_seqlens"]
        o32, _ = paged_attention_oracle(tin["q"].float(), tin["k_cache"].transpose(1, 2).float(),
                                        tin["v_cache"].transpose(1, 2).float(),
                                        tin["block_table"], lens)
        assert_close_2ref(to, o32, _t(jo))
    for got, want in ((tk, jk), (tv, jv)):
        assert torch.equal(_bits(got), _bits(_t(want)))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("mha_type,sq,sk,page", [("mha", 1, 128, 64), ("gqa", 3, 70, 16),
                                                ("mqa", 1, 131, 64)])
def test_paged_decode(mha_type, sq, sk, page):
    run_case(sq, sk, mha_type=mha_type, page=page)


def test_paged_block256_prefill():
    run_case(40, 256, page=256)


@pytest.mark.parametrize("window", [(16, 0), (32, 32)])
def test_paged_local(window):
    run_case(3, 160, causal=False, window=window)


def test_paged_noncausal_num_splits():
    run_case(1, 250, causal=False, num_splits=3)


def test_paged_append_rotary_interleaved():
    run_case(16, 128, new_kv=True, rotary_fraction=0.5, rotary_interleaved=True)


def test_paged_append_full_rotary_neox_noncausal():
    # non-causal: every query row rotates at cache_seqlens
    run_case(4, 128, new_kv=True, rotary_fraction=1.0, rotary_interleaved=False, causal=False)


def test_paged_alibi():
    run_case(3, 128, alibi=True)


def test_dense_cache_append():
    run_case(16, 200, paged=False, new_kv=True)


def test_dense_batch_idx_append():
    run_case(8, 160, paged=False, batch_idx=True, new_kv=True)


def test_dense_leftpad_alibi_window():
    run_case(8, 200, paged=False, leftpad=True, alibi=True, window=(40, 0), seed=6)


@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_low_precision(dtype):
    run_case(1, 128, mha_type="gqa", dtype=dtype)


def test_scalar_cache_seqlens():
    rng = np.random.default_rng(1)
    q, kc, vc = (rng.standard_normal(s).astype(np.float32)
                 for s in ((2, 1, 4, 32), (2, 128, 4, 32), (2, 128, 4, 32)))
    jo, _, _ = jx.flash_attn_with_kvcache(q, kc, vc, cache_seqlens=100, causal=True)
    to, _, _ = tx.flash_attn_with_kvcache(*map(torch.from_numpy, (q, kc, vc)), cache_seqlens=100,
                                          causal=True)
    assert max_err(to, _t(jo)) <= 1e-5


@pytest.mark.parametrize("quant", [None, "int8", "fp8_e4m3"])
def test_append_helpers_match_jax(quant):
    from xf_flash_attention_cutlass_tpu.ops import kvcache as jkv
    from xf_flash_attention_cutlass_tpu_torch.ops import kvcache as tkv

    rng = np.random.default_rng(3)
    L, pages, h_k, page, d, b, s_new = 2, 12, 2, 16, 32, 3, 5
    bt = rng.permutation(pages)[: b * 4].reshape(b, 4).astype(np.int32)
    seqlens = np.asarray([0, 14, 40], np.int32)
    kn, vn = (rng.standard_normal((b, s_new, h_k, d)).astype(np.float32) for _ in range(2))
    j = lambda a: jnp.asarray(a)  # noqa: E731
    t = torch.from_numpy
    if quant is None:
        kp, vp = (rng.standard_normal((L, pages, h_k, page, d)).astype(np.float32)
                  for _ in range(2))
        want = jax.jit(jkv.append_kv_paged)(j(kp), j(vp), j(kn), j(vn), j(bt), j(seqlens),
                                            jnp.int32(1))
        got = tkv.append_kv_paged(t(kp.copy()), t(vp.copy()), t(kn), t(vn), t(bt),
                                  t(seqlens), layer_idx=1)
    else:
        from xf_flash_attention_cutlass_tpu.quant.kv import quantize_kv_pools
        kq, ks, vq, vs = quantize_kv_pools(
            *(j(rng.standard_normal((pages, h_k, page, d)).astype(np.float32))
              for _ in range(2)), quant)
        want = jax.jit(jkv.append_kv_paged_quantized)(kq, ks, vq, vs, j(kn), j(vn), j(bt),
                                                       j(seqlens))
        got = tkv.append_kv_paged_quantized(*(_t(x).clone() for x in (kq, ks, vq, vs)),
                                            t(kn), t(vn), t(bt), t(seqlens))
    for g, w in zip(got, want):
        g, w = g.contiguous(), _t(w)
        assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    kc, vc = (rng.standard_normal((4, 40, h_k, d)).astype(np.float32) for _ in range(2))
    cbi = np.asarray([3, 0, 1], np.int32)
    lens = np.asarray([0, 20, 35], np.int32)
    want = jkv.append_kv_dense(j(kc), j(vc), j(kn), j(vn), j(lens), j(cbi))
    got = tkv.append_kv_dense(t(kc.copy()), t(vc.copy()), t(kn), t(vn), t(lens), t(cbi))
    for g, w in zip(got, want):
        assert torch.equal(g, _t(w))
    jpool, jn = jkv.dense_cache_as_paged(j(kc), 16)
    tpool, tn = tkv.dense_cache_as_paged(t(kc), 16)
    assert tn == jn and torch.equal(tpool, _t(jpool))
