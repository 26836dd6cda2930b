"""Dense flash-attention backward in the JAX package's BHSD layout.

``flash_bwd`` recomputes attention from the forward's residuals (q, k, v,
O, LSE) and the output gradient dO:

    P  = exp(S - LSE)        S = q k^T * scale (tanh softcap) - ALiBi bias,
                             masked -> 0
    dP = dO V^T
    dS = P * (dP Z - Delta)  Delta = rowsum(dO * O), in plain torch
    dQ = dS K * scale,  dK = dS^T Q * scale (summed over the GQA group),
    dV = (P Z)^T dO (summed over the GQA group)

where Z is 1 without dropout, and with it 0 on the entries the forward's
mask dropped and 1 / (1 - p) elsewhere (the mask replayed from the seed,
keyed by each q head). Returns (dq, dk, dv) in the input dtypes. The masks,
ALiBi and positions are flash_fwd's.

CUDA tensors run csrc/flash_bwd.cu (bf16, fp16) or its f32 kernels in
csrc/flash_f32.cu, at any head dim from 1 to 256, as K7 (ops/flash_fwd.py
``flash_head_dim``, ``flash_rung``; the rungs 192 and 256 of the 16-bit
kernels are the library flash_bwd_wide): a width of no whole 16-byte row
takes ``flash_bwd_padded``, a zero-padded copy counted as
"flash_bwd.pad_copy". By default the two-pass split, K9 (dQ) then K10 (dK/dV);
``fused=True`` runs K11, one pass whose dQ is summed with f32 atomics into a
buffer the wrapper allocates and then casts (atomics sum in an order that
changes from run to run). Launches count under ``flash_label``
(``flash_bwd.dq``, ``flash_bwd.dq.f16``, ``flash_bwd.dq.f32``, ...).
``fused=None`` means two-pass, as in the JAX package. The kernels read q, k,
v and dO through their strides
where the tensor maps can (the model's (b, s, h, d) views need no copy) and
write dq, dk and dv in q's and k's memory layout. K9's blocks launch in
K7's order (ops/flash_fwd.py ``fwd_block_order``), K10/K11's in
``bwd_block_order``: heaviest first under a causal mask. CPU tensors run
``flash_bwd_ref``, the plain version, for either value of ``fused``: both
schedules compute the same function (in f64 for f64 inputs: the oracle of
the f32 kernels).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
    Extras,
    XfaExtras,
    alibi_bias,
    attention_mask,
    check_cuda_dtypes,
    check_options,
    check_shapes,
    dropout_keep_mask,
    expand_kv,
    flash_entry,
    flash_head_dim,
    flash_label,
    flash_rung,
    int32_or_none,
    resolve_window,
    tma_operands,
)
from xf_flash_attention_cutlass_tpu_torch.utils import acc_dtype, is_cuda


def _group_sum(x: torch.Tensor, h_k: int) -> torch.Tensor:
    """(b, h, s, d) summed over each kv head's group -> (b, h_k, s, d)."""
    b, h, s, d = x.shape
    return x.reshape(b, h_k, h // h_k, s, d).sum(dim=2)


def flash_bwd_ref(q, k, v, o, lse, do, *, causal=False, window=(-1, -1), softcap=0.0,
                  softmax_scale=None, kv_lens=None, q_segment_ids=None,
                  kv_segment_ids=None, alibi_slopes=None, alibi_row_slopes=None,
                  q_positions=None, kv_positions=None, dropout_p=0.0,
                  dropout_seed=0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward: P, dP, dS, dQ, dK and dV worked out
    explicitly in f32 (f64 for f64 inputs), with dS rounded to K's (dQ) and
    Q's (dK) dtype and P to dO's (dV) before the products, as the kernels
    do."""
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    acc = acc_dtype(q.dtype)
    qf, dof = q.to(acc), do.to(acc)
    kf, vf = expand_kv(k, h).to(acc), expand_kv(v, h).to(acc)
    delta = (dof * o.to(acc)).sum(dim=-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if softcap > 0.0:
        tanh_s = torch.tanh(s / softcap)
        s = tanh_s * softcap
    bias = alibi_bias(b, h, sq, sk, q.device, alibi_slopes, alibi_row_slopes, q_positions,
                      kv_positions, dtype=acc)
    if bias is not None:
        s = s - bias
    keep = attention_mask(b, sq, sk, q.device, causal=causal, window=window, kv_lens=kv_lens,
                          q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                          q_positions=q_positions, kv_positions=kv_positions)
    lse = lse.to(acc)[..., None]
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, 3.0e38))
    p = torch.where(keep, torch.exp(s - lse_safe), torch.zeros_like(s))
    dp = dof @ vf.transpose(-1, -2)
    p_dv = p
    if dropout_p > 0.0:
        z = torch.where(dropout_keep_mask(dropout_seed, dropout_p, b, h, sq, sk, q.device),
                        1.0 / (1.0 - dropout_p), 0.0).to(acc)
        p_dv, dp = p * z, dp * z
    ds = p * (dp - delta)
    if softcap > 0.0:
        ds = ds * (1.0 - tanh_s * tanh_s)
    ds = ds * scale
    dq = ds.to(k.dtype).to(acc) @ kf
    dk = ds.to(q.dtype).to(acc).transpose(-1, -2) @ qf
    dv = p_dv.to(do.dtype).to(acc).transpose(-1, -2) @ dof
    return dq.to(q.dtype), _group_sum(dk, h_k).to(k.dtype), _group_sum(dv, h_k).to(v.dtype)


_fns = {}


def _fn(name: str, dtype: torch.dtype, d: int):
    """The entry point of K9 (name "flash_bwd_dq") or K10/K11
    ("flash_bwd_dkv") for the inputs' dtype and head dim, its argument types
    set."""
    lib, fn_name = flash_entry("flash_bwd", name, dtype, d)
    if (lib, fn_name) not in _fns:
        fn = getattr(_build.load(lib), fn_name)
        common = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                  + [ctypes.POINTER(XfaExtras)])
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + common + [ctypes.c_void_p] * 2
                       if name == "flash_bwd_dq" else
                       [ctypes.c_void_p] * 9 + common + [ctypes.c_int] + [ctypes.c_void_p] * 2)
        _fns[lib, fn_name] = fn
    return _fns[lib, fn_name]


def bwd_block_order(n_kt: int, h_k: int, b: int):
    """(key tile, kv head, batch) of K10/K11's blocks in launch order, as the
    kernel decodes blockIdx.x: every (batch, kv head) at key tile 0 first,
    then tile 1, so under a causal mask the blocks with the most query rows
    start first and the short ones fill the tail."""
    nbh = b * h_k
    return [(i // nbh, i % nbh % h_k, i % nbh // h_k) for i in range(n_kt * nbh)]


class FlashBwdLaunch:
    """The CUDA backward of one set of residuals, d a multiple of 8 (f32: 4)
    up to 256: checks and prepares the inputs once; ``dq()`` launches K9,
    ``dkv()`` K10 and ``fused()`` K11. ``flash_bwd`` runs dq() and dkv(), or
    fused(); chip_smoke.py times each."""

    def __init__(self, q, k, v, o, lse, do, *, scale, causal, window, softcap, kv_lens,
                 q_segment_ids, kv_segment_ids, alibi_slopes=None, alibi_row_slopes=None,
                 q_positions=None, kv_positions=None, dropout_p=0.0, dropout_seed=0):
        check_cuda_dtypes("flash backward (K9-K11)", q, k, v)
        b, h, sq, d = q.shape
        if flash_head_dim(d, q.dtype, "flash backward (K9-K11)") != d:  # flash_bwd pads them
            raise ValueError(f"the CUDA flash backward (K9-K11) kernel reads rows of whole "
                             f"16-byte chunks, got head_dim {d} of {q.dtype}")
        if do.dtype != q.dtype:
            raise TypeError(f"dO must have q's dtype {q.dtype}, got {do.dtype}")
        self.d, self.rung = d, flash_rung(d)
        h_k, sk = k.shape[1], k.shape[2]
        wl, wr = resolve_window(causal, window)
        (self.q, self.k, self.v, self.do), self.in_strides = tma_operands(q, k, v, do)
        # Delta = rowsum(dO * O): a cheap reduction left to plain torch, as
        # the JAX package leaves it to XLA
        self.delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        self.lse = lse.float().contiguous()
        self.masks = (int32_or_none(kv_lens), int32_or_none(q_segment_ids),
                      int32_or_none(kv_segment_ids))
        self.ins = (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                    self.do.data_ptr(), self.lse.data_ptr(), self.delta.data_ptr())
        self.extras = Extras(b, h, sq, sk, q.device, alibi_slopes=alibi_slopes,
                             alibi_row_slopes=alibi_row_slopes, q_positions=q_positions,
                             kv_positions=kv_positions, q_segment_ids=q_segment_ids,
                             kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                             dropout_seed=dropout_seed)
        self.tail = (*(_build.ptr(t) for t in self.masks), _build.dtype_code(q.dtype),
                     b, h, h_k, sq, sk, d, wl, wr, float(scale), float(softcap),
                     self.extras.ref())

    def _strides(self, dq, dk, dv):
        """The strides argument: q, k, v, dO, then the outputs dq (or K11's
        f32 buffer), dk, dv, each (batch, head, row) in elements."""
        outs = [s for t in (dq, dk, dv) for s in t.stride()[:3]]
        return (ctypes.c_int64 * 21)(*self.in_strides, *outs)

    def dq(self) -> torch.Tensor:
        dq = torch.empty_like(self.q)  # q's memory layout
        strides = self._strides(dq, self.k, self.v)
        rc = _fn("flash_bwd_dq", self.q.dtype, self.d)(*self.ins, dq.data_ptr(), *self.tail,
                                                       ctypes.cast(strides, ctypes.c_void_p),
                                                       _build.stream_handle())
        _build.check(rc, "flash_bwd (dq)")
        self._count("flash_bwd.dq")
        return dq

    def _count(self, kernel: str) -> None:
        _build.count_launch(flash_label(kernel, self.q.dtype), self.d, self.rung)

    def dkv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        dk, dv = torch.empty_like(self.k), torch.empty_like(self.v)
        strides = self._strides(self.q, dk, dv)
        rc = _fn("flash_bwd_dkv", self.q.dtype, self.d)(
            *self.ins, dk.data_ptr(), dv.data_ptr(), None, *self.tail, 0,
            ctypes.cast(strides, ctypes.c_void_p), _build.stream_handle())
        _build.check(rc, "flash_bwd (dkv)")
        self._count("flash_bwd.dkv")
        return dk, dv

    def fused(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dk, dv = torch.empty_like(self.k), torch.empty_like(self.v)
        if self.d == self.rung:
            dq_acc = torch.zeros_like(self.q, dtype=torch.float32)  # q's memory layout
        else:  # K11 adds all of its rung's columns (zeros past d); cut back below
            dq_acc = torch.zeros((*self.q.shape[:3], self.rung), dtype=torch.float32,
                                 device=self.q.device)
        strides = self._strides(dq_acc, dk, dv)
        rc = _fn("flash_bwd_dkv", self.q.dtype, self.d)(
            *self.ins, dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(), *self.tail, 1,
            ctypes.cast(strides, ctypes.c_void_p), _build.stream_handle())
        _build.check(rc, "flash_bwd (fused)")
        self._count("flash_bwd.fused")
        return dq_acc[..., :self.d].to(self.q.dtype), dk, dv


def flash_bwd(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, h_k, sk, d)
    v: torch.Tensor,
    o: torch.Tensor,  # (b, h, sq, d)
    lse: torch.Tensor,  # (b, h, sq) f32
    do: torch.Tensor,  # (b, h, sq, d)
    *,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,  # (h,) or (b, h) f32
    alibi_row_slopes: Optional[torch.Tensor] = None,  # (b, h, sq) f32
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
    fused: Optional[bool] = None,  # None = two-pass, as in the JAX package
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv) in the input dtypes and shapes."""
    check_shapes(q, k, v, kv_lens, q_segment_ids, kv_segment_ids)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"o and dO must be {tuple(q.shape)} and LSE {tuple(q.shape[:3])}, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} and {tuple(lse.shape)}")
    opts = dict(alibi_slopes=alibi_slopes, alibi_row_slopes=alibi_row_slopes,
                q_positions=q_positions, kv_positions=kv_positions)
    check_options(*q.shape[:3], k.shape[2], dropout_p=dropout_p, **opts)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if is_cuda(q, k, v, o, lse, do, kv_lens, q_segment_ids, kv_segment_ids, *opts.values()):
        check_cuda_dtypes("flash backward (K9-K11)", q, k, v)
        d = q.shape[-1]
        if flash_head_dim(d, q.dtype, "flash backward (K9-K11)") != d:
            return flash_bwd_padded(q, k, v, o, lse, do, flash_head_dim(d, q.dtype),
                                    causal=causal, window=window, softcap=softcap,
                                    softmax_scale=scale, kv_lens=kv_lens,
                                    q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                                    dropout_p=dropout_p, dropout_seed=dropout_seed, fused=fused,
                                    **opts)
        run = FlashBwdLaunch(q, k, v, o, lse, do, scale=scale, causal=causal, window=window,
                             softcap=softcap, kv_lens=kv_lens, q_segment_ids=q_segment_ids,
                             kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                             dropout_seed=dropout_seed, **opts)
        if fused:
            return run.fused()
        return (run.dq(), *run.dkv())
    _build.PLAIN_CALLS["flash_bwd"] += 1
    return flash_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window, softcap=softcap,
                         softmax_scale=scale, kv_lens=kv_lens, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                         dropout_seed=dropout_seed, **opts)


def flash_bwd_padded(q, k, v, o, lse, do, d_to: int, *, softmax_scale: Optional[float] = None,
                     **kw):
    """flash_bwd at a head dim K9-K11 cannot read in place (a row of no
    whole 16-byte chunks, flash_head_dim): q, k, v, O and dO copied with
    zero columns up to d_to, the call made at d_to with the softmax scale of
    the real d, dq, dk and dv cut back to d. Exact: zero columns add nothing
    to S, dP or Delta = rowsum(dO O), and give zero columns of dQ = dS K,
    dK = dS^T Q and dV = P^T dO. On CUDA tensors the copy counts under
    "flash_bwd.pad_copy"; CPU tensors run the plain version on the padded
    operands."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if is_cuda(q, k, v, o, do):
        _build.LAUNCHES["flash_bwd.pad_copy"] += 1
    qp, kp, vp, op, dop = (torch.nn.functional.pad(t, (0, d_to - d)) for t in (q, k, v, o, do))
    grads = flash_bwd(qp, kp, vp, op, lse, dop, softmax_scale=scale, **kw)
    return tuple(g[..., :d] for g in grads)
