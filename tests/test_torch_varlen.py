"""PyTorch port vs the JAX package: ragged-batch (varlen) attention,
``ops/varlen.py`` and the varlen API.

Inputs are made with numpy from a seed and handed to both packages in f32;
the JAX kernels run in Pallas interpret mode under ``jax.jit``, the port its
plain versions (CPU tensors).

- Packed varlen (causal, GQA, local windows, ``seqused_k``, (b, h) ALiBi):
  out and LSE within 8 f32 ulps of the largest magnitude of JAX's (the
  dense kernel over the packed rows, the same sums in another order).
- Paged varlen (K1 over right-aligned queries, with (b, h) ALiBi): within
  1e-5 of JAX's out on the live rows (split-KV partials merged in another
  order; values <= 5).
- The gradient of packed varlen with (b, h) ALiBi within 1e-5 of the
  largest magnitude of ``jax.grad``'s.
- Both S_dmask routes (packed, and paged through the dense rectangle)
  within 1e-5 of JAX's (probabilities <= 1).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xf_flash_attention_cutlass_tpu as jx
import xf_flash_attention_cutlass_tpu_torch as tx
from xf_flash_attention_cutlass_tpu.ops import flash_fwd as jflash
from xf_flash_attention_cutlass_tpu.ops import varlen as jvarlen
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops import flash_fwd as tflash
from xf_flash_attention_cutlass_tpu_torch.ops import varlen as tvarlen
from xf_flash_attention_cutlass_tpu_torch.utils.testing import max_err


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


def _ragged(seed, len_q, len_k, h, h_k, d=16):
    rng = np.random.default_rng(seed)
    cu_q = np.cumsum([0] + list(len_q)).astype(np.int32)
    cu_k = np.cumsum([0] + list(len_k)).astype(np.int32)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((cu_q[-1], h, d), (cu_k[-1], h_k, d), (cu_k[-1], h_k, d),
                            (cu_q[-1], h, d)))
    return rng, q, k, v, w, cu_q, cu_k


def _close_ulps(got, want):
    want = _t(want)
    assert got.shape == want.shape
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert max_err(got[fin], want[fin]) <= 8 * ULP * float(want[fin].abs().max())


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _jax_varlen(q, k, v, cu_q, cu_k, seqused_k, slopes, causal=False, window=(-1, -1)):
    return jvarlen.flash_attn_varlen(q, k, v, cu_q, cu_k, max_seqlen_q=0, max_seqlen_k=0,
                                     seqused_k=seqused_k, causal=causal, window=window,
                                     alibi_slopes=slopes)


# (name, len_q, len_k, h, h_k, options)
PACKED = [
    ("causal_gqa", [37, 5, 61], [50, 5, 80], 4, 2, dict(causal=True)),
    ("noncausal", [20, 33], [41, 17], 2, 2, dict()),
    ("local_left_right", [30, 44, 9], [52, 44, 30], 2, 1, dict(window=(8, 3))),
    ("local_causal", [40, 26], [40, 60], 4, 4, dict(causal=True, window=(12, -1))),
    ("seqused_k", [7, 20, 33], [40, 64, 100], 2, 2, dict(causal=True, used=[17, 64, 51])),
    ("alibi_per_batch", [25, 48, 11], [30, 48, 70], 4, 2, dict(causal=True, alibi=True)),
]


@pytest.mark.parametrize("name,len_q,len_k,h,h_k,opts", PACKED, ids=[c[0] for c in PACKED])
def test_packed_varlen_matches_jax(name, len_q, len_k, h, h_k, opts):
    rng, q, k, v, _, cu_q, cu_k = _ragged(0, len_q, len_k, h, h_k)
    used = None if "used" not in opts else np.asarray(opts["used"], np.int32)
    slopes = (rng.random((len(len_q), h)) * 0.3).astype(np.float32) if opts.get("alibi") else None
    kw = {k_: v_ for k_, v_ in opts.items() if k_ in ("causal", "window")}
    jo, jl = _jax_varlen(q, k, v, cu_q, cu_k, used, slopes, **kw)
    conv = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    to, tl = tvarlen.flash_attn_varlen(*map(conv, (q, k, v, cu_q, cu_k)), seqused_k=conv(used),
                                       alibi_slopes=conv(slopes), **kw)
    _close_ulps(to, jo)
    _close_ulps(tl, jl)
    assert tl.shape == (h, q.shape[0])


def test_segments_from_cu_seqlens():
    seg = tvarlen.segments_from_cu_seqlens(torch.tensor([0, 3, 3, 7], dtype=torch.int32), 9)
    assert seg.tolist() == [0, 0, 0, 2, 2, 2, 2, -1, -1]
    jseg = jvarlen.segments_from_cu_seqlens(jnp.asarray([0, 3, 3, 7], jnp.int32), 9)
    assert seg.tolist() == np.asarray(jseg).tolist()


def test_packed_varlen_alibi_per_batch_grad_matches_jax():
    rng, q, k, v, w, cu_q, cu_k = _ragged(1, [30, 52], [40, 52], 2, 2)
    slopes = (rng.random((2, 2)) * 0.2).astype(np.float32)

    jcu_q, jcu_k = jnp.asarray(cu_q), jnp.asarray(cu_k)

    def jloss(q, k, v):
        o, _ = jvarlen.flash_attn_varlen(q, k, v, jcu_q, jcu_k, max_seqlen_q=0, max_seqlen_k=0,
                                         causal=True, alibi_slopes=slopes)
        return jnp.sum(o * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, _ = tvarlen.flash_attn_varlen(tq, tk, tv, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                                     causal=True, alibi_slopes=torch.from_numpy(slopes))
    tg = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for got, want in zip(tg, jg):
        want = _t(want)
        assert max_err(got, want) <= 1e-5 * float(want.abs().max())


def _paged(seed, q_lens, kv_lens, h, h_k, d=16, page=16, max_pages=8, nb=40):
    rng = np.random.default_rng(seed)
    kc, vc = (rng.standard_normal((nb, page, h_k, d)).astype(np.float32) for _ in range(2))
    bt = rng.permutation(nb)[: len(q_lens) * max_pages].reshape(len(q_lens), max_pages)
    q = rng.standard_normal((sum(q_lens), h, d)).astype(np.float32)
    cu_q = np.cumsum([0] + list(q_lens)).astype(np.int32)
    return rng, q, kc, vc, bt.astype(np.int32), cu_q, np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi_per_batch"])
def test_paged_varlen_matches_jax(alibi):
    rng, q, kc, vc, bt, cu_q, used = _paged(2, [5, 20, 64], [37, 111, 64], 4, 2)
    slopes = (rng.random((3, 4)) * 0.1).astype(np.float32) if alibi else None
    jo, jl = jax.jit(functools.partial(jvarlen.flash_attn_varlen_paged, causal=True))(
        q, kc, vc, bt, cu_q, used, alibi_slopes=slopes)
    conv = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    to, tl = tvarlen.flash_attn_varlen_paged(*map(conv, (q, kc, vc, bt, cu_q, used)),
                                             causal=True, alibi_slopes=conv(slopes))
    assert to.shape == (q.shape[0], 4, 16) and tl.shape == (4, q.shape[0])
    assert max_err(to, _t(jo)) <= 1e-5
    assert max_err(tl, _t(jl)) <= 1e-5


def test_packed_s_dmask_matches_jax():
    rng, q, k, v, _, cu_q, cu_k = _ragged(3, [24, 40], [30, 56], 4, 2)
    slopes = (rng.random((2, 4)) * 0.3).astype(np.float32)
    args = (q, k, v, cu_q, cu_k)
    kw = dict(max_seqlen_q=40, max_seqlen_k=56, causal=True, return_attn_probs=True)
    jo, jl, jp = jax.jit(functools.partial(jx.flash_attn_varlen_func, **kw))(
        *args, alibi_slopes=slopes)
    to, tl, tp = tx.flash_attn_varlen_func(*map(torch.from_numpy, args),
                                           alibi_slopes=torch.from_numpy(slopes), **kw)
    assert tp.shape == (4, q.shape[0], k.shape[0])
    assert max_err(tp, _t(jp)) <= 1e-5
    _close_ulps(to, jo)


def test_paged_s_dmask_matches_jax():
    _, q, kc, vc, bt, cu_q, used = _paged(4, [6, 17], [30, 45], 4, 2, max_pages=4, nb=12)
    cu_k = np.cumsum([0] + list(used)).astype(np.int32)
    kw = dict(max_seqlen_q=17, max_seqlen_k=45, causal=True, return_attn_probs=True)
    _, jl, jp = jx.flash_attn_varlen_func(q, kc, vc, cu_q, cu_k, block_table=bt, **kw)
    conv = torch.from_numpy
    to, tl, tp = tx.flash_attn_varlen_func(conv(q), conv(kc), conv(vc), conv(cu_q), conv(cu_k),
                                           block_table=conv(bt), **kw)
    assert tp.shape == (4, q.shape[0], int(used.sum()))
    assert max_err(tp, _t(jp)) <= 1e-5
    assert max_err(tl, _t(jl)) <= 1e-5


def test_probs_sk_odd_gqa_dropout_matches_jax():
    """K8's plain version (the card's yardstick) against the JAX kernel in
    interpret mode where the CUDA kernel stores without TMA: sk % 4 != 0
    (83 keys), GQA 4:2, causal, dropout 0.2, both given the same LSE. The
    dropout bits differ by design (Philox here, the JAX package's own
    generator there), so the magnitudes must agree, masked entries be 0 in
    both (+0 in the port; the JAX kernel negates the dropped ones to -0),
    and each realize the drop fraction within 0.03."""
    rng = np.random.default_rng(12)
    b, h, h_k, sq, sk, d, p = 1, 4, 2, 70, 83, 32, 0.2
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h_k, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h_k, sk, d)).astype(np.float32)
    kw = dict(causal=True, dropout_p=p, dropout_seed=5)
    _, lse = tflash.flash_fwd_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    tp = tflash.attention_probs(torch.from_numpy(q), torch.from_numpy(k), lse, **kw)
    jp = _t(jflash.attention_probs(jnp.asarray(q), jnp.asarray(k), jnp.asarray(lse.numpy()),
                                   **kw))
    assert tp.shape == jp.shape == (b, h, sq, sk)
    assert max_err(tp.abs(), jp.abs()) <= 1e-5
    visible = tflash.attention_mask(b, sq, sk, "cpu", causal=True).expand(b, h, sq, sk)
    assert not torch.signbit(tp[~visible]).any()
    for plane in (tp, jp):
        assert (plane[~visible] == 0).all()
        dropped = float((torch.signbit(plane) & visible).sum()) / float(visible.sum())
        assert abs(dropped - p) < 0.03, dropped
