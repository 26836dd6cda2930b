"""PyTorch port vs the JAX package: the public API (``api.py``).

Inputs are made with numpy from a seed and handed to both packages; the JAX
kernels run as the JAX package's own tests run them (CPU, Pallas interpret
mode), under ``jax.jit``. The port runs its plain versions (CPU tensors).

- Validation: every case of tests/test_api_validation.py raises ValueError
  in both packages with the same message (dtype names without torch's
  ``torch.`` prefix).
- kvpacked equals unpacked, bit for bit.
- ``flash_attn_func`` in f32 (GQA, window, softcap, (h,) and (b, h) ALiBi):
  O within 8 f32 ulps of the largest magnitude of the JAX kernel's O, and
  LSE likewise (the two compute the same sums in another order).
- ``return_attn_probs`` without dropout: S_dmask within 1e-5 of JAX's
  (probabilities <= 1, f32 rounding of exp).
- The gradient with ALiBi: ``torch.autograd.grad`` of sum(O * W) within
  1e-5 of the largest magnitude of ``jax.grad`` of the same loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xf_flash_attention_cutlass_tpu as jx
import xf_flash_attention_cutlass_tpu_torch as tx
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.utils.testing import alibi_slopes_ref, max_err


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ULP = float(np.finfo(np.float32).eps)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


# (name, function name, args (shapes), kwargs, message regex of the JAX test)
VALIDATION = [
    ("rank_mismatch", "flash_attn_func", [(2, 64, 4), (2, 64, 4, 32), (2, 64, 4, 32)], {},
     "rank 4"),
    ("dtype_mismatch", "flash_attn_func", [(1, 8, 2, 32), ((1, 8, 2, 32), "bf16"),
                                           (1, 8, 2, 32)], {}, "dtypes must match"),
    ("bad_dtype", "flash_attn_func", [((1, 8, 2, 32), "i8")] * 3, {}, "unsupported dtype"),
    ("gqa_divisibility", "flash_attn_func", [(1, 8, 5, 32), (1, 8, 2, 32), (1, 8, 2, 32)], {},
     "multiple of kv heads"),
    ("head_dim_limit", "flash_attn_func", [(1, 8, 2, 512)] * 3, {}, "head_dim"),
    ("dropout_range", "flash_attn_func", [(1, 8, 2, 32)] * 3, dict(dropout_p=1.5),
     "dropout_p"),
    ("kvcache_append_requires_seqlens", "flash_attn_with_kvcache",
     [(1, 1, 2, 32), (1, 64, 2, 32), (1, 64, 2, 32)],
     dict(k=(1, 1, 2, 32), v=(1, 1, 2, 32)), "cache_seqlens"),
    ("kvcache_k_without_v", "flash_attn_with_kvcache",
     [(1, 1, 2, 32), (1, 64, 2, 32), (1, 64, 2, 32)], dict(k=(1, 1, 2, 32)), "together"),
    ("kvcache_paged_batch_idx_rejected", "flash_attn_with_kvcache",
     [(1, 1, 2, 32), (8, 16, 2, 32), (8, 16, 2, 32)],
     dict(cache_seqlens=("int", [8]), block_table=("int", np.zeros((1, 4))),
          cache_batch_idx=("int", [0])), "cache_batch_idx"),
]


def _arg(spec):
    """One argument of a validation case in both packages."""
    if isinstance(spec, tuple) and spec and spec[0] == "int":
        a = np.asarray(spec[1], np.int32)
        return jnp.asarray(a), torch.from_numpy(a)
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[1], str):
        shape, kind = spec
        dt = {"bf16": (jnp.bfloat16, torch.bfloat16), "i8": (jnp.int8, torch.int8)}[kind]
        return jnp.zeros(shape, dt[0]), torch.zeros(shape, dtype=dt[1])
    if isinstance(spec, tuple):  # a shape: fp16 zeros, as the JAX test makes them
        return jnp.zeros(spec, jnp.float16), torch.zeros(spec, dtype=torch.float16)
    return spec, spec


@pytest.mark.parametrize("name,fn,args,kwargs,match", VALIDATION,
                         ids=[c[0] for c in VALIDATION])
def test_validation_raises_like_jax(name, fn, args, kwargs, match):
    jargs, targs = zip(*(_arg(a) for a in args))
    jkw = {k: _arg(v)[0] for k, v in kwargs.items()}
    tkw = {k: _arg(v)[1] for k, v in kwargs.items()}
    with pytest.raises(ValueError, match=match) as jerr:
        getattr(jx, fn)(*jargs, **jkw)
    with pytest.raises(ValueError, match=match) as terr:
        getattr(tx, fn)(*targs, **tkw)
    assert str(terr.value).replace("torch.", "") == str(jerr.value)


def test_kvpacked_matches_unpacked():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((2, 96, 2, 2, 32)).astype(np.float32))
    out = tx.flash_attn_kvpacked_func(q, kv, causal=True)
    assert torch.equal(out, tx.flash_attn_func(q, kv[:, :, 0], kv[:, :, 1], causal=True))


def test_varlen_kvpacked_matches_unpacked():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((48, 4, 32)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((80, 2, 2, 32)).astype(np.float32))
    cu_q = torch.tensor([0, 16, 48], dtype=torch.int32)
    cu_k = torch.tensor([0, 32, 80], dtype=torch.int32)
    out = tx.flash_attn_varlen_kvpacked_func(q, kv, cu_q, cu_k, max_seqlen_q=32,
                                             max_seqlen_k=48, causal=True)
    ref = tx.flash_attn_varlen_func(q, kv[:, 0], kv[:, 1], cu_q, cu_k, max_seqlen_q=32,
                                    max_seqlen_k=48, causal=True)
    assert torch.equal(out, ref)


# (name, b, sq, sk, h, h_k, options); alibi "h" = (h,) slopes, "bh" = (b, h)
FUNC_CASES = [
    ("causal_gqa_alibi_h", 2, 40, 56, 4, 2, dict(causal=True, alibi="h")),
    ("window_softcap_alibi_bh", 2, 45, 45, 4, 1, dict(window_size=(9, 4), softcap=3.0,
                                                      alibi="bh")),
    ("noncausal_alibi_bh", 1, 33, 47, 2, 2, dict(alibi="bh")),
    ("local_left_only", 2, 48, 48, 4, 2, dict(window_size=(7, -1))),
]


def _func_inputs(seed, b, sq, sk, h, h_k, opts, d=16):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, h_k, d), (b, sk, h_k, d), (b, sq, h, d))]
    kw = {k: v for k, v in opts.items() if k != "alibi"}
    slopes = None
    if opts.get("alibi") == "h":
        slopes = alibi_slopes_ref(h)
    elif opts.get("alibi") == "bh":
        slopes = (rng.random((b, h)) * 0.5).astype(np.float32)
    return arrs, kw, slopes


@functools.partial(jax.jit, static_argnames=("causal", "window_size", "softcap", "probs"))
def _jax_func(q, k, v, slopes, causal=False, window_size=(-1, -1), softcap=0.0, probs=False):
    return jx.flash_attn_func(q, k, v, causal=causal, window_size=window_size, softcap=softcap,
                              alibi_slopes=slopes, return_attn_probs=probs)


@pytest.mark.parametrize("name,b,sq,sk,h,h_k,opts", FUNC_CASES, ids=[c[0] for c in FUNC_CASES])
def test_flash_attn_func_f32_ulps_of_jax(name, b, sq, sk, h, h_k, opts):
    (q, k, v, _), kw, slopes = _func_inputs(0, b, sq, sk, h, h_k, opts)
    jo, jl, jp = _jax_func(q, k, v, slopes, probs=True, **kw)
    ts = None if slopes is None else torch.from_numpy(slopes)
    to, tl, tp = tx.flash_attn_func(*(torch.from_numpy(a) for a in (q, k, v)), alibi_slopes=ts,
                                    return_attn_probs=True, **kw)
    jo, jl, jp = _t(jo), _t(jl), _t(jp)
    assert to.shape == jo.shape == (b, sq, h, 16) and tp.shape == jp.shape == (b, h, sq, sk)
    assert max_err(to, jo) <= 8 * ULP * float(jo.abs().max())
    finite = torch.isfinite(jl)
    assert torch.equal(torch.isfinite(tl), finite)
    assert max_err(tl[finite], jl[finite]) <= 8 * ULP * float(jl[finite].abs().max())
    assert max_err(tp, jp) <= 1e-5  # return_attn_probs without dropout


@pytest.mark.parametrize("name,b,sq,sk,h,h_k,opts", [FUNC_CASES[0], FUNC_CASES[1]],
                         ids=[FUNC_CASES[0][0], FUNC_CASES[1][0]])
def test_alibi_grad_matches_jax_grad(name, b, sq, sk, h, h_k, opts):
    (q, k, v, w), kw, slopes = _func_inputs(1, b, sq, sk, h, h_k, opts)

    def jloss(q, k, v):
        return jnp.sum(jx.flash_attn_func(q, k, v, alibi_slopes=slopes, **kw) * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tx.flash_attn_func(tq, tk, tv, alibi_slopes=torch.from_numpy(slopes), **kw)
    tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for got, want in zip(tg, jg):
        want = _t(want)
        assert max_err(got, want) <= 1e-5 * float(want.abs().max())
