"""PyTorch port vs the JAX package: dense flash attention, forward
(ops/flash_fwd.py, the plain version of csrc/flash_fwd.cu), backward
(ops/flash_bwd.py, csrc/flash_bwd.cu) and the differentiable
``flash_attention``.

Inputs are made with numpy from a seed and handed to both packages; the JAX
kernels run as the JAX package's own tests run them (CPU, Pallas interpret
mode). The oracle is the JAX package's ``ops/reference.py::attention_ref``
in float32, with every mask (causal, window, kv_lens, segment ids) given as
a -inf bias, and a jnp logsumexp of the same masked scores for LSE.

- Forward, bf16 inputs: the 2x rule. The port's max error against the
  oracle is at most twice the JAX kernel's own error, plus 1e-5, for O and
  for LSE. f32 inputs: within 8 f32 ulps (of the largest magnitude) of the
  JAX kernel.
- Backward, bf16 inputs: the 3x rule with atol 1e-4, as
  tests/test_flash_bwd.py, calibrated by the JAX kernel's error against the
  oracle's gradients, for dq, dk and dv; the two-pass route (``fused=None``)
  and ``fused=True`` each against the JAX route of the same flag.
- ``flash_attention``: ``torch.autograd.grad`` against ``jax.grad`` of the
  JAX ``flash_attention`` in f32, within 1e-5 absolute (f32 rounding of
  sums of a few dozen terms of magnitude <= 1); the loss within 1e-5
  relative (a sum of some 5,000 terms).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.ops import flash as jflash
from xf_flash_attention_cutlass_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from xf_flash_attention_cutlass_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from xf_flash_attention_cutlass_tpu.ops.reference import attention_ref, construct_local_mask
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
    dropout_keep_mask,
    flash_fwd,
    fwd_block_order,
    tma_strides,
)
from xf_flash_attention_cutlass_tpu_torch.utils.testing import (
    assert_close_2ref,
    flash_attention_oracle,
    max_err,
)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


# (name, b, h, h_k, sq, sk, options); every case is bottom-right aligned
CASES = [
    ("causal", 2, 4, 2, 48, 48, dict(causal=True)),
    ("noncausal_unaligned", 2, 4, 2, 37, 53, dict()),
    ("causal_unaligned", 1, 4, 2, 37, 53, dict(causal=True)),
    ("gqa_4_1", 2, 4, 1, 40, 40, dict(causal=True)),
    ("kv_lens_empty_row", 2, 4, 2, 32, 32, dict(causal=True, kv_lens=[20, 0])),
    ("segments", 2, 2, 2, 30, 30, dict(causal=True, segments=True)),
    ("window", 1, 2, 2, 41, 41, dict(window=(6, 3))),
    ("softcap", 1, 2, 1, 33, 45, dict(causal=True, softcap=2.0)),
]


def _case(seed, b, h, h_k, sq, sk, opts, d=16, dtype=jnp.bfloat16):
    """q, k, v, dO as jnp arrays of dtype (BHSD) and the mask keywords as
    numpy arrays. Segments: two segments per row, and one query row whose
    segment id no key has (an empty row)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, d), (b, h_k, sk, d), (b, h_k, sk, d), (b, h, sq, d))]
    kw = {k: v for k, v in opts.items() if k not in ("kv_lens", "segments")}
    if "kv_lens" in opts:
        kw["kv_lens"] = np.asarray(opts["kv_lens"], np.int32)
    if opts.get("segments"):
        qs = (np.arange(sq)[None] >= sq // 2).astype(np.int32).repeat(b, 0)
        ks = (np.arange(sk)[None] >= sk // 3).astype(np.int32).repeat(b, 0)
        qs[0, 3] = 5
        kw["q_segment_ids"], kw["kv_segment_ids"] = qs, ks
    return [jnp.asarray(a, dtype) for a in arrs], kw


def _keep(b, sq, sk, causal=False, window=(-1, -1), kv_lens=None, q_segment_ids=None,
          kv_segment_ids=None, **_):
    """(b, 1, sq, sk) keep mask from the JAX package's construct_local_mask."""
    keep = np.ones((b, 1, sq, sk), bool)
    if causal:
        window = (window[0], 0)
    if window[0] >= 0 or window[1] >= 0:
        keep &= ~np.asarray(construct_local_mask(sq, sk, window))  # (1, 1, sq, sk)
    if kv_lens is not None:
        keep &= np.arange(sk)[None, None, None, :] < kv_lens[:, None, None, None]
    if q_segment_ids is not None:
        keep &= q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
    return keep


@functools.partial(jax.jit, static_argnames=("softcap",))
def _oracle_fwd(q, k, v, keep, softcap=0.0):
    """float32 oracle in BHSD: attention_ref with the mask as a -inf bias,
    and the logsumexp of the same masked scores."""
    bias = jnp.where(keep, 0.0, -jnp.inf)
    sw = lambda x: jnp.swapaxes(x.astype(jnp.float32), 1, 2)  # noqa: E731
    o, _ = attention_ref(sw(q), sw(k), sw(v), attn_bias=bias, softcap=softcap)
    g = q.shape[1] // k.shape[1]
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32) / np.sqrt(q.shape[-1]),
                   jnp.repeat(k.astype(jnp.float32), g, axis=1))
    if softcap > 0:
        s = jnp.tanh(s / softcap) * softcap
    return jnp.swapaxes(o, 1, 2), jax.nn.logsumexp(s + bias, axis=-1)


def _port_kw(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}


def _run_fwd(args, kw):
    q, k, v = args[:3]
    jo, jl = j_flash_fwd(q, k, v, **_jax_kw(kw))
    to, tl = flash_fwd(_t(q), _t(k), _t(v), **_port_kw(kw))
    return (jo, jl), (to, tl)


@pytest.mark.parametrize("name,b,h,h_k,sq,sk,opts", CASES, ids=[c[0] for c in CASES])
def test_flash_fwd_2x_rule_bf16(name, b, h, h_k, sq, sk, opts):
    args, kw = _case(1, b, h, h_k, sq, sk, opts)
    (jo, jl), (to, tl) = _run_fwd(args, kw)
    keep = _keep(b, sq, sk, **kw)
    ro, rl = (_t(a) for a in _oracle_fwd(*args[:3], keep, softcap=kw.get("softcap", 0.0)))
    jo, jl = _t(jo), _t(jl)
    assert to.shape == jo.shape and to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    assert_close_2ref(to, ro, jo)
    finite = torch.isfinite(rl)
    assert torch.equal(torch.isfinite(tl), finite)
    assert_close_2ref(tl[finite], rl[finite], jl[finite])
    empty = ~torch.from_numpy(keep.any(-1)).expand_as(finite)
    assert torch.all(to[empty] == 0) and torch.all(torch.isneginf(tl[empty]))
    if name in ("kv_lens_empty_row", "segments"):
        assert empty.any()  # the case has its empty rows


@pytest.mark.parametrize("name,b,h,h_k,sq,sk,opts", CASES[:6], ids=[c[0] for c in CASES[:6]])
def test_flash_fwd_f32_ulps_of_jax(name, b, h, h_k, sq, sk, opts):
    args, kw = _case(2, b, h, h_k, sq, sk, opts, dtype=jnp.float32)
    (jo, jl), (to, tl) = _run_fwd(args, kw)
    jo, jl = _t(jo), _t(jl)
    ulp = torch.finfo(torch.float32).eps
    assert max_err(to, jo) <= 8 * ulp * float(jo.abs().max())
    finite = torch.isfinite(jl)
    assert torch.equal(torch.isfinite(tl), finite)
    assert max_err(tl[finite], jl[finite]) <= 8 * ulp * float(jl[finite].abs().max())


def _oracle_grads(args, keep, softcap):
    """Gradients of sum(O * dO) through the float32 oracle. The mask is a
    finite bias here (a -inf row has a NaN gradient) and rows that see no
    key are zeroed after, as the kernels define them."""
    q, k, v, do = (a.astype(jnp.float32) for a in args)
    bias = jnp.where(keep, 0.0, -1e9)
    sw = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731

    def loss(q, k, v):
        o, _ = attention_ref(sw(q), sw(k), sw(v), attn_bias=bias, softcap=softcap)
        return jnp.sum(sw(o) * keep.any(-1, keepdims=True) * do)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


BWD_CASES = [CASES[0], CASES[1], CASES[3], CASES[4], CASES[5], CASES[6], CASES[7]]


@pytest.mark.parametrize("fused", [None, True])
@pytest.mark.parametrize("name,b,h,h_k,sq,sk,opts", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_flash_bwd_3x_rule_bf16(name, b, h, h_k, sq, sk, opts, fused):
    args, kw = _case(3, b, h, h_k, sq, sk, opts)
    q, k, v, do = args
    jo, jl = j_flash_fwd(q, k, v, **_jax_kw(kw))  # both backwards get the same residuals
    jg = j_flash_bwd(q, k, v, jo, jl, do, fused=fused, **_jax_kw(kw))
    tg = flash_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jl), _t(do), fused=fused, **_port_kw(kw))
    rg = _oracle_grads(args, _keep(b, sq, sk, **kw), kw.get("softcap", 0.0))
    for got, jax_got, ref, x in zip(tg, jg, rg, args[:3]):
        assert got.shape == tuple(x.shape) and got.dtype == torch.bfloat16
        assert torch.isfinite(got).all()
        assert_close_2ref(got, _t(ref), _t(jax_got), mult=3.0, atol=1e-4)
    if fused:  # the flag picks a schedule, not a function
        for a, b_ in zip(tg, flash_bwd(_t(q), _t(k), _t(v), _t(jo), _t(jl), _t(do),
                                       **_port_kw(kw))):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("name,b,h,h_k,sq,sk,opts",
                         [CASES[2], CASES[4], CASES[7]], ids=["causal", "kv_lens", "softcap"])
def test_flash_attention_autograd_matches_jax_grad(name, b, h, h_k, sq, sk, opts):
    args, kw = _case(4, b, h, h_k, sq, sk, opts, dtype=jnp.float32)
    q, k, v, do = args
    kw.pop("kv_lens", None)  # the JAX flash_attention takes segments, not kv_lens
    if name == "kv_lens":  # so express the padding as segment ids, as the model does
        kw["q_segment_ids"] = np.zeros((b, sq), np.int32)
        kw["kv_segment_ids"] = np.where(np.arange(sk)[None] < np.asarray([[20], [0]]), 0, -2
                                        ).astype(np.int32)

    def jloss(q, k, v):
        o, _ = jflash.flash_attention(q, k, v, **_jax_kw(kw))
        return jnp.sum(o * do)

    jval, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    o, lse = flash_attention(tq, tk, tv, **_port_kw(kw))
    assert not lse.requires_grad
    tval = (o * _t(do)).sum()
    tg = torch.autograd.grad(tval, (tq, tk, tv))
    assert abs(float(tval.detach()) - float(jval)) <= 1e-5 * abs(float(jval))
    for got, want in zip(tg, jg):
        assert max_err(got, _t(want)) <= 1e-5


@pytest.mark.parametrize("name,b,h,h_k,sq,sk,opts", [CASES[2], CASES[4], CASES[5], CASES[7]],
                         ids=["causal_unaligned", "kv_lens", "segments", "softcap"])
def test_flash_attention_oracle_matches_jax(name, b, h, h_k, sq, sk, opts):
    """The dense oracle that the kernels are held against on the card
    (utils/testing.py) agrees with this file's JAX oracle: O, LSE and the
    gradients within 1e-5 in f32, and O in bf16 within bf16 rounding."""
    args, kw = _case(5, b, h, h_k, sq, sk, opts)
    keep = _keep(b, sq, sk, **kw)
    ro, rl = (_t(a) for a in _oracle_fwd(*args[:3], keep, softcap=kw.get("softcap", 0.0)))
    tq, tk, tv, tdo = (_t(a).float().requires_grad_(True) for a in args)
    o32, l32 = flash_attention_oracle(tq, tk, tv, **_port_kw(kw))
    olp, _ = flash_attention_oracle(*(_t(a) for a in args[:3]), upcast=False, **_port_kw(kw))
    assert o32.dtype == torch.float32 and olp.dtype == torch.bfloat16
    assert max_err(o32.detach(), ro) <= 1e-5 and 0 < max_err(olp, ro) <= 0.05
    assert torch.equal(torch.isneginf(l32), torch.isneginf(rl))
    finite = torch.isfinite(rl)
    assert max_err(l32.detach()[finite], rl[finite]) <= 1e-5
    grads = torch.autograd.grad((o32 * tdo).sum(), (tq, tk, tv))
    for got, want in zip(grads, _oracle_grads(args, keep, kw.get("softcap", 0.0))):
        assert torch.isfinite(got).all() and max_err(got, _t(want)) <= 1e-5


def test_not_ported_options_raise():
    """The options the first dense slice left out (ALiBi, explicit
    positions, dropout) now run: ALiBi and positions match the JAX kernel
    in f32 within 8 ulps; dropout, whose mask the JAX package draws from
    another generator, matches the dense oracle given the port's mask."""
    rng = np.random.default_rng(6)
    b, h, s, d = 1, 2, 48, 16
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    pos = (np.arange(s)[None] % 30).astype(np.int32)  # two packed sequences
    seg = (np.arange(s)[None] >= 30).astype(np.int32)
    ulp = torch.finfo(torch.float32).eps
    for kw in (dict(alibi_slopes=np.asarray([0.5, 0.25], np.float32), causal=True),
               dict(q_positions=pos, kv_positions=pos, q_segment_ids=seg, kv_segment_ids=seg,
                    causal=True)):
        jo, jl = j_flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), **_jax_kw(kw))
        to, tl = flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), **_port_kw(kw))
        assert max_err(to, _t(jo)) <= 8 * ulp * float(np.abs(np.asarray(jo)).max())
        assert max_err(tl, _t(jl)) <= 8 * ulp * float(np.abs(np.asarray(jl)).max())
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, _ = flash_attention(tq, tk, tv, causal=True, dropout_p=0.1, dropout_seed=2)
    keep = dropout_keep_mask(2, 0.1, b, h, s, s, "cpu")
    o32, _ = flash_attention_oracle(tq, tk, tv, causal=True, dropout_mask=keep, dropout_p=0.1)
    assert max_err(o, o32) <= 1e-5


def test_malformed_inputs_raise():
    """Shapes are checked before any pointer reaches a kernel."""
    q, kv = torch.zeros((2, 4, 8, 16)), torch.zeros((2, 2, 8, 16))
    lens, seg = torch.full((2,), 8), torch.zeros((2, 8), dtype=torch.int32)
    for args, kw in (((q, kv, kv[:, :, :5]), {}),  # k and v differ
                     ((q, torch.zeros((2, 3, 8, 16)), torch.zeros((2, 3, 8, 16))), {}),  # 4 % 3
                     ((q, kv, kv), dict(kv_lens=lens[:1])),
                     ((q, kv, kv), dict(q_segment_ids=seg)),  # without kv_segment_ids
                     ((q, kv, kv), dict(q_segment_ids=seg, kv_segment_ids=seg[:, :5]))):
        with pytest.raises(ValueError):
            flash_fwd(*args, **kw)
    o, lse = flash_fwd(q, kv, kv)
    with pytest.raises(ValueError):
        flash_bwd(q, kv, kv, o, lse[:, :, :5], o)


# ---- K7's host-side choices (csrc/flash_fwd.cu decodes the same order) ------

@pytest.mark.parametrize("n_qt,h,b", [(1, 1, 1), (8, 32, 1), (3, 4, 2), (16, 8, 3)])
def test_fwd_block_order_visits_every_block_once_heaviest_first(n_qt, h, b):
    """Every (q tile, head, batch) exactly once; the q tiles never rise, so
    under a causal mask the blocks with the most keys start first; the heads
    of one q tile launch together (a GQA group's K/V stays in L2)."""
    order = fwd_block_order(n_qt, h, b)
    assert len(order) == n_qt * h * b
    assert set(order) == {(iq, ih, ib) for iq in range(n_qt) for ih in range(h)
                          for ib in range(b)}
    tiles = [iq for iq, _, _ in order]
    assert tiles == sorted(tiles, reverse=True) and tiles[0] == n_qt - 1
    assert [ih for _, ih, _ in order[:h]] == list(range(h))


def test_tma_strides_take_model_views_without_a_copy():
    """The (b, s, h, d) views the model hands K7 qualify for the tensor maps
    as they are; a last dimension that is not contiguous, or a row stride
    that is not a 16-byte multiple, asks for a copy; an extent-1 dimension
    gets a valid stride whatever it had."""
    x = torch.zeros((2, 40, 8, 64), dtype=torch.bfloat16)  # (b, s, h, d)
    view = x.transpose(1, 2)
    assert tma_strides(view) == [40 * 8 * 64, 64, 8 * 64]
    assert tma_strides(x.permute(0, 2, 3, 1)) is None  # d not contiguous
    odd = torch.zeros((1, 2, 5, 68), dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    assert tma_strides(odd) is None
    one = torch.zeros((1, 8, 40, 64), dtype=torch.bfloat16)
    st = tma_strides(one.as_strided(one.shape, (3, 40 * 64, 64, 1)))
    assert st == [one.numel(), 40 * 64, 64]


def test_flash_fwd_on_transposed_views_equals_contiguous():
    """The plain version gives the same bits on (b, s, h, d) views as on
    contiguous copies, as K7 must on the card."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).bfloat16()
               for sh in ((1, 70, 4, 64), (1, 70, 2, 64), (1, 70, 2, 64)))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    o1, l1 = flash_fwd(*views, causal=True, kv_lens=torch.tensor([50]))
    o2, l2 = flash_fwd(*(t.contiguous() for t in views), causal=True, kv_lens=torch.tensor([50]))
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
