"""Dense flash-attention forward in the JAX package's BHSD layout.

``flash_fwd`` attends q (b, h, sq, d) over k, v (b, h_k, sk, d) and returns
O (b, h, sq, d) in q's dtype and the natural-log LSE (b, h, sq) in f32, with
O = 0 and LSE = -inf on rows that see no key. Masks are bottom-right
aligned: query row i sits at position i + sk - sq; ``causal`` is a right
window of 0; ``window = (left, right)`` with -1 unbounded; keys at or past
``kv_lens[b]`` are masked; ``q_segment_ids`` / ``kv_segment_ids`` must match.
GQA maps q head i to kv head i // (h // h_k).

CUDA tensors run the hand-written kernel csrc/flash_fwd.cu (K7; bf16 or
fp16, head_dim 64 or 128); CPU tensors run ``flash_fwd_ref``, the plain
version, with the kernel's numerics: the softmax scale folded into q in f32
and rounded to q's dtype, f32 scores, the tanh softcap on the scaled scores,
P rounded to V's dtype for the PV product, f32 sums. ALiBi, explicit
positions and dropout wait for the slice of ``api.py`` and varlen: they raise
NotImplementedError on both routes.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.utils import is_cuda

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
M_FLOOR = -1e30  # running-max floor: exp(NEG_INF - M_FLOOR) == 0
CUDA_DTYPES = (torch.bfloat16, torch.float16)
CUDA_HEAD_DIMS = (64, 128)


def resolve_window(causal: bool, window: Tuple[int, int]) -> Tuple[int, int]:
    """(left, right) with causal as right = 0; -1 is unbounded."""
    wl, wr = (int(w) for w in window)
    return (wl, 0) if causal else (wl, wr)


def attention_mask(b: int, sq: int, sk: int, device, *, causal: bool = False,
                   window: Tuple[int, int] = (-1, -1), kv_lens=None,
                   q_segment_ids=None, kv_segment_ids=None) -> torch.Tensor:
    """Keep mask broadcastable to (b, h, sq, sk): True where query row i may
    see key j."""
    wl, wr = resolve_window(causal, window)
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if wr >= 0:
        keep = keep & (kpos <= qpos + wr)
    if wl >= 0:
        keep = keep & (kpos >= qpos - wl)
    keep = keep[None, None]
    if kv_lens is not None:
        lens = kv_lens.to(device=device, dtype=torch.long)
        keep = keep & (kpos[None, None] < lens[:, None, None, None])
    if q_segment_ids is not None:
        qs = q_segment_ids.to(device=device, dtype=torch.long)
        ks = kv_segment_ids.to(device=device, dtype=torch.long)
        keep = keep & (qs[:, None, :, None] == ks[:, None, None, :])
    return keep


def expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(b, h_k, s, d) repeated over the GQA group to (b, h, s, d)."""
    return x.repeat_interleave(h // x.shape[1], dim=1)


def flash_fwd_ref(q, k, v, *, causal=False, window=(-1, -1), softcap=0.0,
                  softmax_scale=None, kv_lens=None, q_segment_ids=None,
                  kv_segment_ids=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense forward with the kernel's numerics (one
    softmax over all keys instead of the kernel's online one)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    qs = (q.float() * scale).to(q.dtype).float()
    kf, vf = expand_kv(k, h).float(), expand_kv(v, h).float()
    s = qs @ kf.transpose(-1, -2)  # (b, h, sq, sk) f32
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    keep = attention_mask(b, sq, sk, q.device, causal=causal, window=window, kv_lens=kv_lens,
                          q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ vf
    empty = l_sum <= 0
    inv = torch.where(empty, 1.0, 1.0 / torch.where(empty, 1.0, l_sum))
    o = torch.where(empty, torch.zeros_like(acc), acc * inv)
    lse = torch.where(empty, torch.full_like(m, -torch.inf),
                      m + torch.log(torch.where(empty, 1.0, l_sum)))
    return o.to(q.dtype), lse[..., 0]


def check_not_ported(alibi_slopes, q_positions, kv_positions, dropout_p) -> None:
    extras = dict(alibi_slopes=alibi_slopes is not None,
                  positions=q_positions is not None or kv_positions is not None,
                  dropout=dropout_p > 0.0)
    missing = [k for k, on in extras.items() if on]
    if missing:
        raise NotImplementedError(f"dense flash attention does not take {missing} yet")


def check_shapes(q, k, v, kv_lens, q_segment_ids, kv_segment_ids) -> None:
    """Raise unless q (b, h, sq, d), k and v (b, h_k, sk, d) with h a
    multiple of h_k, kv_lens (b,), and the segment ids (b, sq) and (b, sk),
    given together."""
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (b={b}, h_k, sk, d={d}), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"q_heads ({h}) must be a multiple of kv_heads ({k.shape[1]})")
    if kv_lens is not None and tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens must be ({b},), got {tuple(kv_lens.shape)}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    if q_segment_ids is not None and (tuple(q_segment_ids.shape) != (b, sq)
                                      or tuple(kv_segment_ids.shape) != (b, k.shape[2])):
        raise ValueError(f"segment ids must be ({b}, {sq}) and ({b}, {k.shape[2]}), got "
                         f"{tuple(q_segment_ids.shape)} and {tuple(kv_segment_ids.shape)}")


def check_cuda_dtypes(what: str, q, k, v) -> None:
    """Raise on the dtypes and head dims csrc/flash_*.cu do not take."""
    if q.dtype not in CUDA_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the CUDA {what} kernel takes bf16 or fp16 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in CUDA_HEAD_DIMS:
        raise ValueError(f"the CUDA {what} kernel takes head_dim 64 or 128, got {q.shape[-1]}")


def int32_or_none(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.to(torch.int32).contiguous()


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("flash_fwd")
        lib.xfa_flash_fwd.restype = ctypes.c_int
        lib.xfa_flash_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        _lib_handle = lib
    return _lib_handle


def _flash_fwd_cuda(q, k, v, scale, causal, window, softcap, kv_lens, q_seg, kv_seg):
    check_cuda_dtypes("flash forward", q, k, v)
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    wl, wr = resolve_window(causal, window)
    # softmax scale folded into q in f32, rounded to q's dtype (as on the TPU)
    qs = (q.float() * scale).to(q.dtype).contiguous()
    k, v = k.contiguous(), v.contiguous()
    lens, qseg, kseg = int32_or_none(kv_lens), int32_or_none(q_seg), int32_or_none(kv_seg)
    o = torch.empty_like(qs)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _lib().xfa_flash_fwd(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _build.ptr(lens), _build.ptr(qseg), _build.ptr(kseg), _build.dtype_code(q.dtype),
        b, h, h_k, sq, sk, d, wl, wr, float(softcap), _build.stream_handle(),
    )
    _build.check(rc, "flash_fwd")
    _build.LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_fwd(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, h_k, sk, d)
    v: torch.Tensor,  # (b, h_k, sk, d)
    *,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    kv_lens: Optional[torch.Tensor] = None,  # (b,) int
    q_segment_ids: Optional[torch.Tensor] = None,  # (b, sq) int
    kv_segment_ids: Optional[torch.Tensor] = None,  # (b, sk) int
    alibi_slopes: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward. Returns (O (b, h, sq, d) in q's dtype,
    LSE (b, h, sq) f32, -inf for rows with no visible key)."""
    check_not_ported(alibi_slopes, q_positions, kv_positions, dropout_p)
    check_shapes(q, k, v, kv_lens, q_segment_ids, kv_segment_ids)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if is_cuda(q, k, v, kv_lens, q_segment_ids, kv_segment_ids):
        return _flash_fwd_cuda(q, k, v, scale, causal, window, softcap, kv_lens,
                               q_segment_ids, kv_segment_ids)
    _build.PLAIN_CALLS["flash_fwd"] += 1
    return flash_fwd_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                         softmax_scale=scale, kv_lens=kv_lens, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids)
