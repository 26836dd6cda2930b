"""Dense flash-attention forward in the JAX package's BHSD layout, and the
normalized probability plane behind ``return_attn_probs``.

``flash_fwd`` attends q (b, h, sq, d) over k, v (b, h_k, sk, d) and returns
O (b, h, sq, d) in q's dtype and the natural-log LSE (b, h, sq) in f32, with
O = 0 and LSE = -inf on rows that see no key. Masks are bottom-right
aligned: query row i sits at position i + sk - sq, key j at j, unless
``q_positions`` (b, sq) / ``kv_positions`` (b, sk) give them; ``causal`` is a
right window of 0; ``window = (left, right)`` with -1 unbounded; keys at or
past ``kv_lens[b]`` are masked; ``q_segment_ids`` / ``kv_segment_ids`` must
match. GQA maps q head i to kv head i // (h // h_k). ALiBi subtracts
slope * |qpos - kpos| from the score after the softcap, with ``alibi_slopes``
(h,) or (b, h), or ``alibi_row_slopes`` (b, h, sq), one slope per query row.
Dropout (``dropout_p``, ``dropout_seed``) zeroes P after the row sum and
scales O by 1 / (1 - p); its mask is ``dropout_keep_mask``, a counter-based
Philox4x32-10 stream keyed by (seed, batch, q head, row, key), so every
kernel replays it whatever its tiling. It cannot give the TPU's bits: the
tests hold it to the realized fraction and to replay.

``attention_probs`` recomputes the (b, h, sq, sk) f32 plane exp(S - LSE) of
a forward with the same options: masked entries and rows with LSE = -inf are
0, entries the dropout dropped are negated.

CUDA tensors run the hand-written kernels csrc/flash_fwd.cu (K7) and
csrc/flash_probs.cu (K8) (bf16 or fp16, head_dim 64 or 128); CPU tensors run
``flash_fwd_ref`` and ``attention_probs_ref``, the plain versions, with the
kernels' numerics: the softmax scale folded into q in f32 and rounded to q's
dtype, f32 scores, the tanh softcap on the scaled scores, P rounded to V's
dtype for the PV product, f32 sums. K7 and K8 apply the scale to q
themselves and read q, k (and v) through their strides (TMA tensor maps),
so the (b, s, h, d) views the model passes are not copied;
``fwd_block_order`` is the order in which they run their blocks.
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
TILE = 64  # rows / keys of one entry of the kernels' tile tables (kTile)
MASK32 = 0xFFFFFFFF
INT32_MAX, INT32_MIN = 2**31 - 1, -(2**31)


# ---- dropout: Philox4x32-10, as csrc/flash_common.cuh computes it ------------

def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 a < 2^32 and m < 2^32. The
    product can pass 2^63, so a is split into 16-bit halves."""
    p_lo, p_hi = (a & 0xFFFF) * m, (a >> 16) * m  # each < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11; curand's philox4x32_10) on int64
    tensors holding 32-bit counter words; returns the four output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & MASK32, (k1 + 0xBB67AE85) & MASK32
    return c0, c1, c2, c3


def dropout_threshold(p: float) -> int:
    """Entries whose 32 random bits are below this are dropped (the JAX
    package's threshold)."""
    return min(int(p * float(2**32)), 2**32 - 1)


def dropout_bits(seed: int, b: int, h: int, sq: int, sk: int, device) -> torch.Tensor:
    """(b, h, sq, sk) int64 random words: entry (ib, ih, row, col) is word
    col % 4 of Philox on counter (col // 4, row, ih, ib) under key seed."""
    seed &= (1 << 64) - 1
    nq = -(-sk // 4)
    shape = (b, h, sq, nq)

    def ax(n, dim):
        idx = [1, 1, 1, 1]
        idx[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).reshape(idx).expand(shape)

    words = philox4x32_10(ax(nq, 3), ax(sq, 2), ax(h, 1), ax(b, 0), seed & MASK32, seed >> 32)
    return torch.stack(words, dim=-1).reshape(b, h, sq, 4 * nq)[..., :sk]


def dropout_keep_mask(seed: int, p: float, b: int, h: int, sq: int, sk: int,
                      device) -> torch.Tensor:
    """(b, h, sq, sk) bool, True where dropout keeps the entry."""
    return dropout_bits(seed, b, h, sq, sk, device) >= dropout_threshold(p)


def resolve_window(causal: bool, window: Tuple[int, int]) -> Tuple[int, int]:
    """(left, right) with causal as right = 0; -1 is unbounded."""
    wl, wr = (int(w) for w in window)
    return (wl, 0) if causal else (wl, wr)


def positions(sq: int, sk: int, device, q_positions=None, kv_positions=None):
    """(qpos (b or 1, sq), kpos (b or 1, sk)) int64: the given positions, or
    the bottom-right aligned index geometry."""
    if q_positions is not None:
        return (q_positions.to(device=device, dtype=torch.long),
                kv_positions.to(device=device, dtype=torch.long))
    return (torch.arange(sq, device=device)[None] + (sk - sq),
            torch.arange(sk, device=device)[None])


def attention_mask(b: int, sq: int, sk: int, device, *, causal: bool = False,
                   window: Tuple[int, int] = (-1, -1), kv_lens=None,
                   q_segment_ids=None, kv_segment_ids=None, q_positions=None,
                   kv_positions=None) -> torch.Tensor:
    """Keep mask broadcastable to (b, h, sq, sk): True where query row i may
    see key j."""
    wl, wr = resolve_window(causal, window)
    qp, kp = positions(sq, sk, device, q_positions, kv_positions)
    qpos, kpos = qp[:, None, :, None], kp[:, None, None, :]
    keep = torch.ones((1, 1, sq, sk), dtype=torch.bool, device=device)
    if wr >= 0:
        keep = keep & (kpos <= qpos + wr)
    if wl >= 0:
        keep = keep & (kpos >= qpos - wl)
    if kv_lens is not None:
        lens = kv_lens.to(device=device, dtype=torch.long)
        kcol = torch.arange(sk, device=device)
        keep = keep & (kcol < lens[:, None, None, None])
    if q_segment_ids is not None:
        qs = q_segment_ids.to(device=device, dtype=torch.long)
        ks = kv_segment_ids.to(device=device, dtype=torch.long)
        keep = keep & (qs[:, None, :, None] == ks[:, None, None, :])
    return keep


def alibi_bias(b: int, h: int, sq: int, sk: int, device, alibi_slopes=None,
               alibi_row_slopes=None, q_positions=None, kv_positions=None):
    """slope * |qpos - kpos| broadcastable to (b, h, sq, sk) f32, or None
    without ALiBi. Slopes are (h,) or (b, h), or (b, h, sq) per row."""
    if alibi_slopes is None and alibi_row_slopes is None:
        return None
    qp, kp = positions(sq, sk, device, q_positions, kv_positions)
    dist = (qp[:, None, :, None] - kp[:, None, None, :]).abs().float()
    if alibi_slopes is not None:
        sl = alibi_slopes.to(device=device, dtype=torch.float32)
        sl = sl.expand(b, h) if sl.dim() == 1 else sl
        return sl[:, :, None, None] * dist
    return alibi_row_slopes.to(device=device, dtype=torch.float32)[..., None] * dist


def expand_kv(x: torch.Tensor, h: int) -> torch.Tensor:
    """(b, h_k, s, d) repeated over the GQA group to (b, h, s, d)."""
    return x.repeat_interleave(h // x.shape[1], dim=1)


def masked_scores(q, k, *, causal, window, softcap, scale, kv_lens, q_segment_ids,
                  kv_segment_ids, alibi_slopes, alibi_row_slopes, q_positions, kv_positions):
    """The forward's f32 scores (b, h, sq, sk) from q rounded after the scale,
    softcap, ALiBi, and the keep mask."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    qs = (q.float() * scale).to(q.dtype).float()
    s = qs @ expand_kv(k, h).float().transpose(-1, -2)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    bias = alibi_bias(b, h, sq, sk, q.device, alibi_slopes, alibi_row_slopes, q_positions,
                      kv_positions)
    if bias is not None:
        s = s - bias
    keep = attention_mask(b, sq, sk, q.device, causal=causal, window=window, kv_lens=kv_lens,
                          q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                          q_positions=q_positions, kv_positions=kv_positions)
    return s, keep


def flash_fwd_ref(q, k, v, *, causal=False, window=(-1, -1), softcap=0.0,
                  softmax_scale=None, kv_lens=None, q_segment_ids=None,
                  kv_segment_ids=None, alibi_slopes=None, alibi_row_slopes=None,
                  q_positions=None, kv_positions=None, dropout_p=0.0,
                  dropout_seed=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dense forward with the kernel's numerics (one
    softmax over all keys instead of the kernel's online one)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s, keep = masked_scores(q, k, causal=causal, window=window, softcap=softcap, scale=scale,
                            kv_lens=kv_lens, q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids, alibi_slopes=alibi_slopes,
                            alibi_row_slopes=alibi_row_slopes, q_positions=q_positions,
                            kv_positions=kv_positions)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    if dropout_p > 0.0:  # P leaves the row sum whole, the product without
        drop_keep = dropout_keep_mask(dropout_seed, dropout_p, b, h, sq, sk, q.device)
        p = torch.where(drop_keep, p, torch.zeros_like(p))
    acc = p.to(v.dtype).float() @ expand_kv(v, h).float()
    empty = l_sum <= 0
    inv = torch.where(empty, 1.0, 1.0 / torch.where(empty, 1.0, l_sum))
    o = acc * inv
    if dropout_p > 0.0:
        o = o * (1.0 / (1.0 - dropout_p))
    o = torch.where(empty, torch.zeros_like(acc), o)
    lse = torch.where(empty, torch.full_like(m, -torch.inf),
                      m + torch.log(torch.where(empty, 1.0, l_sum)))
    return o.to(q.dtype), lse[..., 0]


def check_options(b, h, sq, sk, alibi_slopes, alibi_row_slopes, q_positions, kv_positions,
                  dropout_p) -> None:
    """Raise on malformed ALiBi slopes, positions or dropout rate."""
    if alibi_slopes is not None and alibi_row_slopes is not None:
        raise ValueError("alibi_slopes and alibi_row_slopes are exclusive")
    if alibi_slopes is not None and tuple(alibi_slopes.shape) not in ((h,), (b, h)):
        raise ValueError(f"alibi_slopes must be ({h},) or ({b}, {h}), "
                         f"got {tuple(alibi_slopes.shape)}")
    if alibi_row_slopes is not None and tuple(alibi_row_slopes.shape) != (b, h, sq):
        raise ValueError(f"alibi_row_slopes must be ({b}, {h}, {sq}), "
                         f"got {tuple(alibi_row_slopes.shape)}")
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions go together")
    if q_positions is not None and (tuple(q_positions.shape) != (b, sq)
                                    or tuple(kv_positions.shape) != (b, sk)):
        raise ValueError(f"positions must be ({b}, {sq}) and ({b}, {sk}), got "
                         f"{tuple(q_positions.shape)} and {tuple(kv_positions.shape)}")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


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


def tile_bounds(pos: torch.Tensor, seg: Optional[torch.Tensor]) -> torch.Tensor:
    """(b, ceil(n / TILE), 4) int32: the least and largest position and
    segment id of every TILE entries of pos, seg (b, n) (segment 0 without
    segment ids). The kernels skip the tile pairs whose ranges cannot meet."""
    b, n = pos.shape
    nt = -(-n // TILE)
    seg = torch.zeros_like(pos) if seg is None else seg.to(pos.device, torch.long)

    def lo_hi(x):
        x = x.long()
        pad = (b, nt * TILE - n)
        lo = torch.cat([x, x.new_full(pad, INT32_MAX)], 1).reshape(b, nt, TILE).amin(-1)
        hi = torch.cat([x, x.new_full(pad, INT32_MIN)], 1).reshape(b, nt, TILE).amax(-1)
        return lo, hi

    return torch.stack([*lo_hi(pos), *lo_hi(seg)], dim=-1).to(torch.int32).contiguous()


class XfaExtras(ctypes.Structure):
    """struct XfaExtras of csrc/flash_common.cuh."""
    _fields_ = [("alibi", ctypes.c_void_p), ("row_slopes", ctypes.c_void_p),
                ("qpos", ctypes.c_void_p), ("kpos", ctypes.c_void_p),
                ("qtiles", ctypes.c_void_p), ("ktiles", ctypes.c_void_p),
                ("seed", ctypes.c_uint64), ("drop_thresh", ctypes.c_uint32),
                ("drop_scale", ctypes.c_float)]


class Extras:
    """The options beyond the masks as K7, K8 and K9-K11 take them: ALiBi
    slopes as (b, h) or (b, h, sq) f32, positions and segment ids turned
    into int32 positions and tile tables, the dropout threshold, scale and
    seed. Holds the tensors the struct points into."""

    def __init__(self, b, h, sq, sk, device, *, alibi_slopes=None, alibi_row_slopes=None,
                 q_positions=None, kv_positions=None, q_segment_ids=None, kv_segment_ids=None,
                 dropout_p=0.0, dropout_seed=0):
        f32 = dict(device=device, dtype=torch.float32)
        self.alibi = None if alibi_slopes is None else (
            alibi_slopes.to(**f32).expand(b, h).contiguous())
        self.row_slopes = None if alibi_row_slopes is None else (
            alibi_row_slopes.to(**f32).contiguous())
        self.qpos = int32_or_none(q_positions)
        self.kpos = int32_or_none(kv_positions)
        self.qtiles = self.ktiles = None
        if q_positions is not None or q_segment_ids is not None:
            qp, kp = positions(sq, sk, device, q_positions, kv_positions)
            self.qtiles = tile_bounds(qp.expand(b, sq), q_segment_ids)
            self.ktiles = tile_bounds(kp.expand(b, sk), kv_segment_ids)
        self.struct = XfaExtras(
            _build.ptr(self.alibi), _build.ptr(self.row_slopes), _build.ptr(self.qpos),
            _build.ptr(self.kpos), _build.ptr(self.qtiles), _build.ptr(self.ktiles),
            int(dropout_seed) & ((1 << 64) - 1),
            dropout_threshold(dropout_p),
            1.0 / (1.0 - dropout_p),
        )

    def ref(self):
        return ctypes.byref(self.struct)


_lib_handles = {}


def _lib(name="flash_fwd"):
    """The loaded library of csrc/flash_fwd.cu (K7) or csrc/flash_probs.cu (K8)."""
    if name not in _lib_handles:
        lib = _build.load(name)
        fn = getattr(lib, f"xfa_{name}")
        fn.restype = ctypes.c_int
        # 8 tensors (K7) or 6 (K8), 9 ints, softcap, scale, the strides
        fn.argtypes = ([ctypes.c_void_p] * (8 if name == "flash_fwd" else 6)
                       + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                                               ctypes.POINTER(XfaExtras), ctypes.c_void_p])
        _lib_handles[name] = lib
    return _lib_handles[name]


# ---- K7's host-side layout rules ------------------------------------------------

def fwd_block_order(n_qt: int, h: int, b: int):
    """(q tile, head, batch) of K7's blocks in launch order, as the kernel
    decodes blockIdx.x: every (batch, head) at the last q tile first, then
    the tile before it, so under a causal mask the blocks with the most keys
    start first and the short ones fill the tail."""
    nbh = b * h
    return [(n_qt - 1 - i // nbh, i % nbh % h, i % nbh // h) for i in range(n_qt * nbh)]


def tma_strides(t: torch.Tensor):
    """The (batch, head, row) element strides by which K7's tensor maps read
    a (b, heads, s, d) 16-bit tensor, or None when TMA cannot: the last
    dimension must be contiguous, the base and the strides 16-byte
    multiples. A dimension of extent 1 is never stepped, so its stride is
    replaced by a valid one."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    out = []
    for n, st in zip(t.shape[:3], t.stride()[:3]):
        st = t.numel() if n == 1 else st
        if (st * t.element_size()) % 16:
            return None
        out.append(st)
    return out


def tma_operands(*tensors):
    """The tensors as the tensor maps of K7 and K9-K11 read them: each one
    itself where ``tma_strides`` takes it (the model's (b, s, h, d) views
    do), else a contiguous copy; and their (batch, head, row) element
    strides, flat."""
    out = [t if tma_strides(t) is not None else t.clone(memory_format=torch.contiguous_format)
           for t in tensors]
    return out, [st for t in out for st in tma_strides(t)]


def _flash_fwd_cuda(q, k, v, scale, causal, window, softcap, kv_lens, q_seg, kv_seg, ex):
    """K7 on CUDA tensors. q, k and v are read through their strides where
    TMA can (tma_strides) and copied otherwise; q is not pre-scaled (the
    kernel scales it); O takes q's memory layout."""
    check_cuda_dtypes("flash forward (K7)", q, k, v)
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    wl, wr = resolve_window(causal, window)
    (q, k, v), in_strides = tma_operands(q, k, v)
    o = torch.empty_like(q)  # q's layout: (b, s, h, d) views give a (b, s, h, d) O
    strides = (ctypes.c_int64 * 12)(*in_strides, *o.stride()[:3])
    lens, qseg, kseg = int32_or_none(kv_lens), int32_or_none(q_seg), int32_or_none(kv_seg)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    rc = _lib().xfa_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _build.ptr(lens), _build.ptr(qseg), _build.ptr(kseg), _build.dtype_code(q.dtype),
        b, h, h_k, sq, sk, d, wl, wr, float(softcap), float(scale),
        ctypes.cast(strides, ctypes.c_void_p), ex.ref(), _build.stream_handle(),
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
    alibi_slopes: Optional[torch.Tensor] = None,  # (h,) or (b, h) f32
    alibi_row_slopes: Optional[torch.Tensor] = None,  # (b, h, sq) f32
    q_positions: Optional[torch.Tensor] = None,  # (b, sq) int
    kv_positions: Optional[torch.Tensor] = None,  # (b, sk) int
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward. Returns (O (b, h, sq, d) in q's dtype,
    LSE (b, h, sq) f32, -inf for rows with no visible key)."""
    check_shapes(q, k, v, kv_lens, q_segment_ids, kv_segment_ids)
    b, h, sq, d = q.shape
    opts = dict(alibi_slopes=alibi_slopes, alibi_row_slopes=alibi_row_slopes,
                q_positions=q_positions, kv_positions=kv_positions)
    check_options(b, h, sq, k.shape[2], dropout_p=dropout_p, **opts)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if is_cuda(q, k, v, kv_lens, q_segment_ids, kv_segment_ids, *opts.values()):
        ex = Extras(b, h, sq, k.shape[2], q.device, q_segment_ids=q_segment_ids,
                    kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                    dropout_seed=dropout_seed, **opts)
        return _flash_fwd_cuda(q, k, v, scale, causal, window, softcap, kv_lens,
                               q_segment_ids, kv_segment_ids, ex)
    _build.PLAIN_CALLS["flash_fwd"] += 1
    return flash_fwd_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                         softmax_scale=scale, kv_lens=kv_lens, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                         dropout_seed=dropout_seed, **opts)


# ---- K8: the probability plane ----------------------------------------------

def attention_probs_ref(q, k, lse, *, causal=False, window=(-1, -1), softcap=0.0,
                        softmax_scale=None, alibi_slopes=None, alibi_row_slopes=None,
                        q_segment_ids=None, kv_segment_ids=None, q_positions=None,
                        kv_positions=None, dropout_p=0.0, dropout_seed=0) -> torch.Tensor:
    """Plain version of K8: exp(S - LSE) in f32 with the forward's scores;
    masked entries and rows with LSE = -inf 0; visible entries the dropout
    dropped negated."""
    b, h, sq, d = q.shape
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s, keep = masked_scores(q, k, causal=causal, window=window, softcap=softcap, scale=scale,
                            kv_lens=None, q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids, alibi_slopes=alibi_slopes,
                            alibi_row_slopes=alibi_row_slopes, q_positions=q_positions,
                            kv_positions=kv_positions)
    lse = lse.float()[..., None]
    live = lse > -3e38
    keep = keep & live
    p = torch.where(keep, torch.exp(s - torch.where(live, lse, 0.0)), torch.zeros_like(s))
    if dropout_p > 0.0:
        drop_keep = dropout_keep_mask(dropout_seed, dropout_p, b, h, sq, k.shape[2], q.device)
        p = torch.where(keep & ~drop_keep, -p, p)
    return p


def _attention_probs_cuda(q, k, lse, scale, causal, window, softcap, q_seg, kv_seg, ex):
    """K8 on CUDA tensors. q and k are read through their strides where TMA
    can (tma_strides) and copied otherwise; q is not pre-scaled (the kernel
    scales it)."""
    check_cuda_dtypes("attention probs (K8)", q, k, k)
    b, h, sq, d = q.shape
    h_k, sk = k.shape[1], k.shape[2]
    wl, wr = resolve_window(causal, window)
    (q, k), in_strides = tma_operands(q, k)
    strides = (ctypes.c_int64 * 6)(*in_strides)
    lse = lse.float().contiguous()
    qseg, kseg = int32_or_none(q_seg), int32_or_none(kv_seg)
    out = torch.empty((b, h, sq, sk), dtype=torch.float32, device=q.device)
    rc = _lib("flash_probs").xfa_flash_probs(
        q.data_ptr(), k.data_ptr(), lse.data_ptr(), out.data_ptr(), _build.ptr(qseg),
        _build.ptr(kseg), _build.dtype_code(q.dtype), b, h, h_k, sq, sk, d, wl, wr,
        float(softcap), float(scale), ctypes.cast(strides, ctypes.c_void_p), ex.ref(),
        _build.stream_handle(),
    )
    _build.check(rc, "flash_probs")
    _build.LAUNCHES["flash_probs"] += 1
    return out


def attention_probs(
    q: torch.Tensor,  # (b, h, sq, d)
    k: torch.Tensor,  # (b, h_k, sk, d)
    lse: torch.Tensor,  # (b, h, sq) f32 from flash_fwd with the same options
    *,
    causal: bool = False,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    softmax_scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    alibi_row_slopes: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    dropout_seed: int = 0,
) -> torch.Tensor:
    """The (b, h, sq, sk) f32 probability plane of a forward with the same
    q, k, options and seed (the reference's S_dmask): masked entries 0,
    entries the dropout dropped negated. Materializes sq x sk per head."""
    check_shapes(q, k, k, None, q_segment_ids, kv_segment_ids)
    b, h, sq, d = q.shape
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be ({b}, {h}, {sq}), got {tuple(lse.shape)}")
    opts = dict(alibi_slopes=alibi_slopes, alibi_row_slopes=alibi_row_slopes,
                q_positions=q_positions, kv_positions=kv_positions)
    check_options(b, h, sq, k.shape[2], dropout_p=dropout_p, **opts)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if is_cuda(q, k, lse, q_segment_ids, kv_segment_ids, *opts.values()):
        ex = Extras(b, h, sq, k.shape[2], q.device, q_segment_ids=q_segment_ids,
                    kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                    dropout_seed=dropout_seed, **opts)
        return _attention_probs_cuda(q, k, lse, scale, causal, window, softcap, q_segment_ids,
                                     kv_segment_ids, ex)
    _build.PLAIN_CALLS["flash_probs"] += 1
    return attention_probs_ref(q, k, lse, causal=causal, window=window, softcap=softcap,
                               softmax_scale=scale, q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids, dropout_p=dropout_p,
                               dropout_seed=dropout_seed, **opts)
