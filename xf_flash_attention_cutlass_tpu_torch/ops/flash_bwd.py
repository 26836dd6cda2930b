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

CUDA tensors run csrc/flash_bwd.cu: by default the two-pass split, K9
(dQ) then K10 (dK/dV); ``fused=True`` runs K11, one pass whose dQ is summed
with f32 atomics into a buffer the wrapper allocates and then casts (atomics
sum in an order that changes from run to run). ``fused=None`` means two-pass,
as in the JAX package. The kernels read q, k, v and dO through their strides
where the tensor maps can (the model's (b, s, h, d) views need no copy) and
write dq, dk and dv in q's and k's memory layout. K9's blocks launch in
K7's order (ops/flash_fwd.py ``fwd_block_order``), K10/K11's in
``bwd_block_order``: heaviest first under a causal mask. CPU tensors run
``flash_bwd_ref``, the plain version, for either value of ``fused``: both
schedules compute the same function.
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
    int32_or_none,
    resolve_window,
    tma_operands,
)
from xf_flash_attention_cutlass_tpu_torch.utils import is_cuda


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
    explicitly in f32, with dS rounded to K's (dQ) and Q's (dK) dtype and P
    to dO's (dV) before the products, as the kernels do."""
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf, vf = expand_kv(k, h).float(), expand_kv(v, h).float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    s = (qf @ kf.transpose(-1, -2)) * scale
    if softcap > 0.0:
        tanh_s = torch.tanh(s / softcap)
        s = tanh_s * softcap
    bias = alibi_bias(b, h, sq, sk, q.device, alibi_slopes, alibi_row_slopes, q_positions,
                      kv_positions)
    if bias is not None:
        s = s - bias
    keep = attention_mask(b, sq, sk, q.device, causal=causal, window=window, kv_lens=kv_lens,
                          q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                          q_positions=q_positions, kv_positions=kv_positions)
    lse = lse.float()[..., None]
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.full_like(lse, 3.0e38))
    p = torch.where(keep, torch.exp(s - lse_safe), torch.zeros_like(s))
    dp = dof @ vf.transpose(-1, -2)
    p_dv = p
    if dropout_p > 0.0:
        z = torch.where(dropout_keep_mask(dropout_seed, dropout_p, b, h, sq, sk, q.device),
                        1.0 / (1.0 - dropout_p), 0.0)
        p_dv, dp = p * z, dp * z
    ds = p * (dp - delta)
    if softcap > 0.0:
        ds = ds * (1.0 - tanh_s * tanh_s)
    ds = ds * scale
    dq = ds.to(k.dtype).float() @ kf
    dk = ds.to(q.dtype).float().transpose(-1, -2) @ qf
    dv = p_dv.to(do.dtype).float().transpose(-1, -2) @ dof
    return dq.to(q.dtype), _group_sum(dk, h_k).to(k.dtype), _group_sum(dv, h_k).to(v.dtype)


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("flash_bwd")
        common = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_float] * 2
                  + [ctypes.POINTER(XfaExtras)])
        lib.xfa_flash_bwd_dq.restype = ctypes.c_int
        lib.xfa_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + common + [ctypes.c_void_p] * 2
        lib.xfa_flash_bwd_dkv.restype = ctypes.c_int
        lib.xfa_flash_bwd_dkv.argtypes = (
            [ctypes.c_void_p] * 9 + common + [ctypes.c_int] + [ctypes.c_void_p] * 2
        )
        _lib_handle = lib
    return _lib_handle


def bwd_block_order(n_kt: int, h_k: int, b: int):
    """(key tile, kv head, batch) of K10/K11's blocks in launch order, as the
    kernel decodes blockIdx.x: every (batch, kv head) at key tile 0 first,
    then tile 1, so under a causal mask the blocks with the most query rows
    start first and the short ones fill the tail."""
    nbh = b * h_k
    return [(i // nbh, i % nbh % h_k, i % nbh // h_k) for i in range(n_kt * nbh)]


class FlashBwdLaunch:
    """The CUDA backward of one set of residuals: checks and prepares the
    inputs once; ``dq()`` launches K9, ``dkv()`` K10 and ``fused()`` K11.
    ``flash_bwd`` runs dq() and dkv(), or fused(); chip_smoke.py times each."""

    def __init__(self, q, k, v, o, lse, do, *, scale, causal, window, softcap, kv_lens,
                 q_segment_ids, kv_segment_ids, alibi_slopes=None, alibi_row_slopes=None,
                 q_positions=None, kv_positions=None, dropout_p=0.0, dropout_seed=0):
        check_cuda_dtypes("flash backward (K9-K11)", q, k, v)
        if do.dtype != q.dtype:
            raise TypeError(f"dO must have q's dtype {q.dtype}, got {do.dtype}")
        b, h, sq, d = q.shape
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
        rc = _lib().xfa_flash_bwd_dq(*self.ins, dq.data_ptr(), *self.tail,
                                     ctypes.cast(strides, ctypes.c_void_p),
                                     _build.stream_handle())
        _build.check(rc, "flash_bwd (dq)")
        _build.LAUNCHES["flash_bwd.dq"] += 1
        return dq

    def dkv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        dk, dv = torch.empty_like(self.k), torch.empty_like(self.v)
        strides = self._strides(self.q, dk, dv)
        rc = _lib().xfa_flash_bwd_dkv(*self.ins, dk.data_ptr(), dv.data_ptr(), None,
                                      *self.tail, 0, ctypes.cast(strides, ctypes.c_void_p),
                                      _build.stream_handle())
        _build.check(rc, "flash_bwd (dkv)")
        _build.LAUNCHES["flash_bwd.dkv"] += 1
        return dk, dv

    def fused(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dk, dv = torch.empty_like(self.k), torch.empty_like(self.v)
        dq_acc = torch.zeros_like(self.q, dtype=torch.float32)  # q's memory layout
        strides = self._strides(dq_acc, dk, dv)
        rc = _lib().xfa_flash_bwd_dkv(*self.ins, dk.data_ptr(), dv.data_ptr(),
                                      dq_acc.data_ptr(), *self.tail, 1,
                                      ctypes.cast(strides, ctypes.c_void_p),
                                      _build.stream_handle())
        _build.check(rc, "flash_bwd (fused)")
        _build.LAUNCHES["flash_bwd.fused"] += 1
        return dq_acc.to(self.q.dtype), dk, dv


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
