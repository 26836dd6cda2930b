"""Paged split-KV attention over a block-table KV pool.

``paged_attention`` attends new query tokens (b, sq, h, d) over the pages
that each batch entry's block table names, causal from the bottom right:
query token t of sq sits at position kv_len - sq + t. Pools are
(num_pages, h_k, page, d), or (L, num_pages, h_k, page, d) with
``layer_idx``; int8 / fp8-e4m3 pools carry f32 per-token scales
(num_pages, h_k, page), applied to the score plane (K) and to P (V).

Options, as in the JAX package: a window (left, right) from query position
kv_len - sq + t, with causal as a right window of 0; the tanh softcap on the
K-scaled score; ALiBi slopes (h,) or (b, h), row t * group + g of KV head
kvh taking the slope of q head kvh * group + g and losing slope * |qpos -
kcol| after the softcap (the leftpad takes no part: both positions counted
from it give the same distance on every key a row sees); and
``cache_leftpad`` (b,), which masks the keys before it.

CUDA tensors run one of the three hand-written kernels of
csrc/paged_attention.cu, as ``paged_route`` picks from the shapes and the
pool dtype: the decode kernel ("decode", at most 16 query rows a KV head:
decode and short verify), the Hopper chunk kernel ("wgmma", 64 query rows a
block, more than 16 rows a KV head: prefill chunks and paged varlen), both
of which scale q themselves and write O and LSE in the caller's layout, or
the first version on WMMA ("wmma": pages of no whole TMA box). Each kernel
has an option-free instantiation and one with the options (``has_options``),
counted under labels of their own (``route_label``). Split runs give f32
partials (O, LSE); the first two routes merge them with the combine kernel
(``combine_splits``), the WMMA route with ``combine_partials`` in plain
torch. All take bf16 queries. CPU tensors run ``paged_attention_ref``, the
plain version, with the kernels' numerics. Every route cuts each entry's
keys from the first one any row can see (window start, leftpad; 0 without
them) to the last live one: the decode route into ``num_splits`` runs of
whole 64-key tiles (``decode_split_keys``), the others into ``num_splits``
equal runs of pages. The split count comes from the route's blocks
(``paged_plan``).

The layout is the JAX package's logical contract with its TPU padding
removed: pools are stored tight, and the kernel reads any page size.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.ops.combine import combine_partials
from xf_flash_attention_cutlass_tpu_torch.quant.kv import QUANT_DTYPES
from xf_flash_attention_cutlass_tpu_torch.utils import cdiv, is_cuda

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
M_FLOOR = -1e30  # running-max floor: exp(NEG_INF - M_FLOOR) == 0
NUM_SMS = 132  # H100 SXM: the cores of the split heuristic
MAX_SPLITS = 128
DECODE_ROWS = 16  # query rows a KV head up to which the decode kernel takes a call
DECODE_TILE = 64  # keys per tile of the decode kernel: its unit of splits
DECODE_BLOCKS_PER_SM = 2  # the decode kernel's resident blocks (csrc: kBlocksPerSm)


def num_splits_heuristic(
    n_work: int, num_cores: int, max_n_blocks: int, max_splits: int
) -> int:
    """Occupancy split search: if `n_work` blocks already fill >= 80% of
    the cores, don't split; otherwise take the SMALLEST split count whose
    wave efficiency (work / ceil(work / cores) / cores) is >= 85% of the
    best achievable, skipping splits that don't shrink the per-split block
    count."""
    if n_work >= 0.8 * num_cores:
        return 1
    max_splits = max(1, min(max_splits, num_cores, max_n_blocks))

    def eff(s):
        waves = n_work * s / num_cores
        return waves / math.ceil(waves)

    best = 0.0
    effs = []
    for s in range(1, max_splits + 1):
        if s > 1 and math.ceil(max_n_blocks / s) == math.ceil(max_n_blocks / (s - 1)):
            effs.append(0.0)  # same per-split work as s-1: no point
            continue
        e = eff(s)
        effs.append(e)
        best = max(best, e)
    for s in range(1, max_splits + 1):
        if effs[s - 1] >= 0.85 * best:
            return s
    return 1


def kernel_row_tile(rows: int) -> int:
    """Query rows per block of the WMMA kernel of csrc/paged_attention.cu
    (one of its two instances; the launcher is told which)."""
    return 16 if rows <= 16 else 32


WGMMA_ROWS = 64  # query rows per block of the Hopper kernel: one warpgroup's


def has_options(causal: bool, window: Tuple[int, int], softcap: float, alibi_slopes,
                cache_leftpad) -> bool:
    """Whether a call takes its kernel's options instantiation: a window
    start, a right window beyond the causal one, softcap, ALiBi or leftpad
    (non-causal attention is option-free)."""
    wr = 0 if causal else window[1]
    return (window[0] >= 0 or wr > 0 or softcap > 0.0 or alibi_slopes is not None
            or cache_leftpad is not None)


def paged_route(rows: int, page: int, d: int, kv_dtype: torch.dtype) -> str:
    """The kernel of csrc/paged_attention.cu that takes a call, a pure
    function of its shapes and pool dtype (the options pick an
    instantiation, not a kernel). With d 64 or 128, a page of whole TMA
    boxes (a multiple of 8 keys) and bf16, int8 or fp8 pools: "decode" (the
    decode kernel) when at most 16 query rows share a KV head (rows = sq *
    group: decode and short verify), else "wgmma" (the Hopper chunk
    kernel). Anything else takes "wmma" (the first version: odd pages; odd d
    and fp16 pools, which its CUDA wrapper refuses)."""
    if d in (64, 128) and page % 8 == 0 and kv_dtype in (torch.bfloat16, *QUANT_DTYPES):
        return "decode" if rows <= DECODE_ROWS else "wgmma"
    return "wmma"


def route_row_tile(route: str, rows: int) -> int:
    """Query rows per block of the route's kernel."""
    if route == "wgmma":
        return WGMMA_ROWS
    return DECODE_ROWS if route == "decode" else kernel_row_tile(rows)


def route_label(route: str, rows: int, options: bool = False) -> str:
    """The launch counter (_build.LAUNCHES) of the route's kernel: the Hopper
    kernels count their options instantiation apart, the WMMA kernel its
    decode-sized calls (<= 16 rows a KV head)."""
    if route == "decode":
        return "paged_attention.decode.options" if options else "paged_attention.decode"
    if route == "wgmma":
        return "paged_attention.prefill.options" if options else "paged_attention.prefill.wgmma"
    return "paged_attention.decode.wmma" if rows <= DECODE_ROWS else "paged_attention.prefill.wmma"


def resolve_num_splits(num_splits: int, b: int, h_k: int, rows: int, max_blocks: int,
                       row_tile: Optional[int] = None, num_cores: int = NUM_SMS) -> int:
    """Explicit num_splits wins, at most one split per key block; 0 asks the
    heuristic, with the kernel's blocks (b * h_k * row tiles of `row_tile`
    rows, the WMMA kernel's by default) as work, `num_cores` (the H100's
    SMs by default) as cores and `max_blocks` (the table's width in the
    route's split unit: pages, or 64-key tiles on the decode route) as the
    most splits."""
    if num_splits <= 0:
        tile = kernel_row_tile(rows) if row_tile is None else row_tile
        n_work = b * h_k * cdiv(rows, tile)
        num_splits = num_splits_heuristic(n_work, num_cores, max_blocks, MAX_SPLITS)
    return max(1, min(num_splits, max_blocks))


def paged_plan(q_shape, k_pool_shape, kv_dtype: torch.dtype, max_pages: int, num_splits: int = 0,
               causal: bool = True, window: Tuple[int, int] = (-1, -1), softcap: float = 0.0,
               alibi_slopes=None, cache_leftpad=None) -> Tuple[str, int]:
    """(route, splits) of a paged_attention call: the kernel paged_route
    picks and the split count resolve_num_splits gives for its blocks. On
    the decode route the cores are the H100's SMs times the decode kernel's
    resident blocks and the splits' unit is a 64-key tile; elsewhere the
    SMs and pages. k_pool_shape is (pages, h_k, page, d), or (L, ...) with a
    layer axis."""
    b, sq, h, d = q_shape
    h_k, page = k_pool_shape[-3], k_pool_shape[-2]
    rows = sq * (h // h_k)
    route = paged_route(rows, page, d, kv_dtype)
    if route == "decode":
        return route, resolve_num_splits(num_splits, b, h_k, rows,
                                         cdiv(max_pages * page, DECODE_TILE), DECODE_ROWS,
                                         NUM_SMS * DECODE_BLOCKS_PER_SM)
    return route, resolve_num_splits(num_splits, b, h_k, rows, max_pages,
                                     route_row_tile(route, rows))


def decode_split_keys(kv_len: int, n_splits: int, max_keys: int, first_key: int = 0):
    """The decode kernel's cut of one batch entry's keys: [(lo, hi)] for
    each split, the live keys (kv_len, at most the table's max_keys) from
    the 64-key tile of `first_key` (the first key any row can see: window
    start, leftpad; first_page's) cut into n_splits runs of whole tiles;
    splits past the live tiles are empty (lo == hi)."""
    live = min(kv_len, max_keys)
    n_tiles = cdiv(live, DECODE_TILE)
    first = min(max(first_key, 0) // DECODE_TILE, n_tiles)
    per = cdiv(n_tiles - first, n_splits) * DECODE_TILE
    out = []
    for s in range(n_splits):
        lo = min(first * DECODE_TILE + s * per, live)
        out.append((lo, min(lo + per, live)))
    return out


def _layer(x: Optional[torch.Tensor], layer_idx) -> Optional[torch.Tensor]:
    return x if x is None or layer_idx is None else x[int(layer_idx)]


def _squeeze_scales(s: Optional[torch.Tensor], pool: torch.Tensor):
    if s is not None and s.dim() == pool.dim():  # trailing (..., 1) of quantize_kv
        s = s[..., 0]
    return s


def _gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(pages, h_k, page, ...) gathered per batch row -> (b, h_k, T, ...)
    with T = max_pages * page keys in logical order."""
    g = pool[block_tables.long()]  # (b, max_pages, h_k, page, ...)
    g = g.transpose(1, 2)  # (b, h_k, max_pages, page, ...)
    return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3], *g.shape[4:])


def paged_attention_ref(
    q: torch.Tensor,  # (b, sq, h, d)
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d): one layer
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (b, max_pages)
    kv_lens: torch.Tensor,  # (b,)
    *,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,  # (b, h) or (h,)
    cache_leftpad: Optional[torch.Tensor] = None,  # (b,)
    num_splits: int = 1,
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, h_k, page)
    v_scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of paged attention, with the kernel's arithmetic.
    Returns (O (b, sq, h, d) in q's dtype, LSE (b, h, sq) f32).

    The softmax scale is folded into q in f32 and rounded to q's dtype,
    scores are f32, P times the V scale is rounded to q's dtype (to the
    pool's dtype for unquantized pools) before the PV product, sums are f32;
    split partials are merged by combine_partials.
    """
    b, sq, h, d = q.shape
    _, h_k, page, _ = k_pool.shape
    if h % h_k:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_k}")
    g = h // h_k
    rows = sq * g
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    kv_quant = k_scales is not None
    dt = q.dtype

    # decode swap: (b, sq, h_k, g, d) -> (b, h_k, sq*g, d), row = t*g + gi
    qf = (q.float() * scale).to(dt).float()
    qg = qf.reshape(b, sq, h_k, g, d).permute(0, 2, 1, 3, 4).reshape(b, h_k, rows, d)

    kg = _gather(k_pool, block_tables).float()  # (b, h_k, T, d)
    vg = _gather(v_pool, block_tables).float()
    T = kg.shape[2]
    ks = vs = None
    if kv_quant:
        ks = _gather(k_scales, block_tables).float()  # (b, h_k, T)
        vs = _gather(v_scales, block_tables).float()

    s = qg @ kg.transpose(-1, -2)  # (b, h_k, rows, T) f32
    if kv_quant:  # K scale on the score plane
        s = s * ks[:, :, None, :]
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap

    dev = q.device
    kcol = torch.arange(T, device=dev)[None, None, None, :]
    lens = kv_lens.to(device=dev, dtype=torch.long)[:, None, None, None]
    t_of_row = torch.arange(rows, device=dev) // g
    qpos = lens - sq + t_of_row[None, None, :, None]  # (b, 1, rows, 1)
    wl, wr = window
    if causal:
        wr = 0
    keep = kcol < lens
    if causal or wr >= 0:
        keep = keep & (kcol <= qpos + max(wr, 0))
    if wl >= 0:
        keep = keep & (kcol >= qpos - wl)
    if cache_leftpad is not None:
        keep = keep & (kcol >= cache_leftpad.to(device=dev, dtype=torch.long)[:, None, None, None])
    if alibi_slopes is not None:  # |qpos - kcol|: the leftpad masks, and adds no term
        slopes = alibi_slopes.to(device=dev, dtype=torch.float32)
        if slopes.dim() == 1:
            slopes = slopes[None].expand(b, h)
        row_slope = slopes.reshape(b, h_k, g)[:, :, torch.arange(rows, device=dev) % g]
        s = s - row_slope[..., None] * (qpos - kcol).abs().float()

    # each row's visible pages (64-key tiles on the decode route) cut into
    # num_splits equal runs, as the route's kernel does
    unit = DECODE_TILE if paged_route(rows, page, d, k_pool.dtype) == "decode" else page
    n_live = (lens.clamp_max(T) + unit - 1) // unit
    first = first_page(lens, sq, unit, wl, cache_leftpad, n_live)
    pps = (n_live - first + num_splits - 1) // num_splits
    o_parts, lse_parts = [], []
    for sp in range(num_splits):
        lo = (first + sp * pps) * unit
        in_split = (kcol >= lo) & (kcol < lo + pps * unit)
        s_sp = torch.where(keep & in_split, s, torch.full_like(s, NEG_INF))
        m = s_sp.amax(dim=-1, keepdim=True).clamp_min(M_FLOOR)
        p = torch.exp(s_sp - m)
        l_sum = p.sum(dim=-1, keepdim=True)
        if kv_quant:
            pv = (p * vs[:, :, None, :]).to(dt).float()
        else:
            pv = p.to(v_pool.dtype).float()
        o = pv @ vg
        empty = l_sum <= 0
        l_safe = torch.where(empty, 1.0, l_sum)
        o = torch.where(empty, torch.zeros_like(o), o / l_safe)
        lse = torch.where(empty, torch.full_like(m, -torch.inf), m + torch.log(l_safe))
        o_parts.append(o)
        lse_parts.append(lse[..., 0])
    if num_splits > 1:
        o, lse = combine_partials(torch.stack(o_parts), torch.stack(lse_parts))
    else:
        o, lse = o_parts[0], lse_parts[0]
    return _unswap(o, lse, b, sq, h_k, g, d, dt)


def first_page(lens, sq, page, wl, cache_leftpad, n_live):
    """The first page (of `page` keys: a split unit) any query row of each
    batch entry can see: the one of the first row's window start or of the
    leftpad (0 without either)."""
    first_key = torch.zeros_like(lens)
    if cache_leftpad is not None:
        first_key = cache_leftpad.to(device=lens.device, dtype=torch.long).reshape(lens.shape)
        first_key = first_key.clamp_min(0)
    if wl >= 0:
        first_key = torch.maximum(first_key, lens - sq - wl)
    return torch.minimum(first_key.clamp_min(0) // page, n_live)


def _unswap(o, lse, b, sq, h_k, g, d, out_dtype):
    """(b, h_k, sq*g, d) rows back to (b, sq, h, d); LSE to (b, h, sq)."""
    o = o.reshape(b, h_k, sq, g, d).permute(0, 2, 1, 3, 4).reshape(b, sq, h_k * g, d)
    lse = lse.reshape(b, h_k, sq, g).permute(0, 1, 3, 2).reshape(b, h_k * g, sq)
    return o.to(out_dtype), lse


def combine_splits_ref(o_part: torch.Tensor, lse_part: torch.Tensor,
                       out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the combine kernel: f32 split partials in the
    caller's layout, O (splits, b, sq, h, d) and LSE (splits, b, sq, h),
    merged by combine_partials into O (b, sq, h, d) in out_dtype and LSE
    (b, h, sq) f32."""
    o, lse = combine_partials(o_part, lse_part)
    return o.to(out_dtype), lse.transpose(1, 2).contiguous()


def combine_splits(o_part: torch.Tensor, lse_part: torch.Tensor,
                   out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split merge of the decode and Hopper chunk routes: on CUDA
    tensors the combine kernel (one launch, bf16 out), on CPU tensors its
    plain version, combine_splits_ref."""
    if not is_cuda(o_part, lse_part):
        _build.PLAIN_CALLS["paged_attention.combine"] += 1
        return combine_splits_ref(o_part, lse_part, out_dtype)
    n_splits, b, sq, h, d = o_part.shape
    if out_dtype != torch.bfloat16 or d not in (64, 128):
        raise ValueError(f"the combine kernel writes bf16 O of head_dim 64 or 128, got "
                         f"{out_dtype}, {d}")
    if (o_part.dtype != torch.float32 or lse_part.dtype != torch.float32
            or not o_part.is_contiguous() or not lse_part.is_contiguous()
            or tuple(lse_part.shape) != (n_splits, b, sq, h)):
        raise ValueError("the combine kernel takes contiguous f32 partials (splits, b, sq, h, d) "
                         "and (splits, b, sq, h)")
    o = torch.empty((b, sq, h, d), dtype=out_dtype, device=o_part.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=o_part.device)
    rc = _lib().xfa_paged_combine(o_part.data_ptr(), lse_part.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), n_splits, b, sq, h, d, _build.stream_handle())
    _build.check(rc, "paged_attention (combine)")
    _build.LAUNCHES["paged_attention.combine"] += 1
    return o, lse


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("paged_attention")
        lib.xfa_paged_attention.restype = ctypes.c_int
        lib.xfa_paged_attention.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 10 + [ctypes.c_float] + [ctypes.c_void_p] * 2
            + [ctypes.c_int, ctypes.c_void_p]
        )
        for fn in (lib.xfa_paged_attention_wgmma, lib.xfa_paged_decode):
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2
                + [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13
                + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
            )
        lib.xfa_paged_decode_blocks_per_sm.restype = ctypes.c_int
        lib.xfa_paged_decode_blocks_per_sm.argtypes = [ctypes.c_int] * 4
        lib.xfa_paged_combine.restype = ctypes.c_int
        lib.xfa_paged_combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        _lib_handle = lib
    return _lib_handle


def decode_blocks_per_sm(kv_dtype: torch.dtype, d: int, rows: int, options: bool = False) -> int:
    """Resident blocks an SM of the decode kernel's instantiation for these
    pools, rows and options, by the CUDA occupancy calculator (on the card)."""
    return _lib().xfa_paged_decode_blocks_per_sm(_build.dtype_code(kv_dtype), d, rows,
                                                 int(options))


def _check_cuda_inputs(q, k_pool, v_pool, k_scales, v_scales):
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA paged-attention kernel (K1) takes bf16 queries, got {q.dtype}")
    kv_quant = k_scales is not None
    if kv_quant != (k_pool.dtype in QUANT_DTYPES):
        raise ValueError(f"{k_pool.dtype} pools {'need' if not kv_quant else 'take no'} scales")
    if k_pool.dtype not in (torch.bfloat16, *QUANT_DTYPES) or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"the CUDA paged-attention kernel takes bf16/int8/fp8 pools, got {k_pool.dtype}"
        )
    d = q.shape[-1]
    if d not in (64, 128):
        raise ValueError(f"the CUDA paged-attention kernel takes head_dim 64 or 128, got {d}")
    for t in (k_pool, v_pool) + ((k_scales, v_scales) if kv_quant else ()):
        if not t.is_contiguous():
            raise ValueError("pools and scales must be contiguous")
    if kv_quant and (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError("scale pools must be float32")


def _paged_attention_cuda(q, k_pool, v_pool, layer_idx, block_tables, kv_lens, scale, causal,
                          window, softcap, alibi_slopes, cache_leftpad, num_splits, k_scales,
                          v_scales, route):
    """K1 on CUDA tensors through the kernel `route` names (paged_route's
    choice; paged_bringup.py and chip_smoke.py also force another route to
    time it on the same shapes). Pools and scales as paged_attention takes
    them, with layer_idx not yet applied."""
    wl, wr = int(window[0]), (0 if causal else int(window[1]))
    b, sq, h, d = q.shape
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).expand(b, h).contiguous()
    leftpad = None if cache_leftpad is None else cache_leftpad.to(torch.int32).contiguous()
    if route in ("decode", "wgmma"):
        return _paged_hopper_cuda(q, k_pool, v_pool, layer_idx, block_tables, kv_lens, scale,
                                  num_splits, k_scales, v_scales, route, wl, wr, float(softcap),
                                  slopes, leftpad)
    k_pool, v_pool = _layer(k_pool, layer_idx), _layer(v_pool, layer_idx)
    k_scales, v_scales = _layer(k_scales, layer_idx), _layer(v_scales, layer_idx)
    _, h_k, page, _ = k_pool.shape
    g = h // h_k
    rows = sq * g
    _check_cuda_inputs(q, k_pool, v_pool, k_scales, v_scales)
    # softmax scale folded into q in f32, rounded to q's dtype (as on the TPU)
    qs = (q.float() * scale).to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    o_part = torch.empty((num_splits, b, h_k, rows, d), dtype=torch.float32, device=q.device)
    lse_part = torch.empty((num_splits, b, h_k, rows), dtype=torch.float32, device=q.device)
    rc = _lib().xfa_paged_attention(
        qs.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), _build.dtype_code(k_pool.dtype),
        _build.ptr(k_scales), _build.ptr(v_scales), bt.data_ptr(), lens.data_ptr(),
        o_part.data_ptr(), lse_part.data_ptr(),
        b, sq, h_k, g, d, page, bt.shape[1], num_splits, wl, wr, float(softcap),
        _build.ptr(slopes), _build.ptr(leftpad), kernel_row_tile(rows), _build.stream_handle(),
    )
    _build.check(rc, "paged_attention")
    _build.LAUNCHES[route_label("wmma", rows)] += 1
    if num_splits > 1:
        o, lse = combine_partials(o_part, lse_part)
    else:
        o, lse = o_part[0], lse_part[0]
    return _unswap(o, lse, b, sq, h_k, g, d, q.dtype)


def _paged_hopper_cuda(q, k_pool, v_pool, layer_idx, block_tables, kv_lens, scale, num_splits,
                       k_scales, v_scales, route, wl, wr, softcap, slopes, leftpad):
    """The decode kernel (route "decode") or the Hopper chunk kernel
    ("wgmma"), in its options instantiation when the window (wl, wr; causal
    is wr = 0), softcap, slopes ((b, h) f32) or leftpad ((b,) int32) ask
    for it. q is read through its strides and scaled inside the kernel;
    the pools' tensor maps span every layer, so layer_idx is a page
    coordinate; one split gives O (b, sq, h, d) and LSE (b, h, sq) as they
    are, more give f32 partials in that layout for the combine kernel."""
    if layer_idx is None:  # one layer: a leading layer axis of 1, no copy
        k_pool, v_pool = k_pool[None], v_pool[None]
        k_scales = None if k_scales is None else k_scales[None]
        v_scales = None if v_scales is None else v_scales[None]
    _check_cuda_inputs(q, k_pool, v_pool, k_scales, v_scales)
    n_layers, pool_pages, h_k, page, d = k_pool.shape
    layer = 0 if layer_idx is None else int(layer_idx)
    if not 0 <= layer < n_layers:
        raise IndexError(f"layer_idx {layer} out of range for {n_layers} layers")
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool, k_scales, v_scales) if t is not None):
        raise ValueError("the Hopper paged-attention kernels read pools and scales at 16-byte "
                         "aligned bases")
    b, sq, h, _ = q.shape
    if q.stride(-1) != 1 or q.data_ptr() % 16 or any(st % 8 for st in q.stride()[:3]):
        q = q.clone(memory_format=torch.contiguous_format)  # the kernel reads 16-byte rows
    bt = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    if num_splits == 1:
        o = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    else:
        o = torch.empty((num_splits, b, sq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((num_splits, b, sq, h), dtype=torch.float32, device=q.device)
    fn = _lib().xfa_paged_decode if route == "decode" else _lib().xfa_paged_attention_wgmma
    rc = fn(
        q.data_ptr(), *q.stride()[:3], k_pool.data_ptr(), v_pool.data_ptr(),
        _build.dtype_code(k_pool.dtype), _build.ptr(k_scales), _build.ptr(v_scales),
        bt.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, sq, h_k, h // h_k, d, page, bt.shape[1], n_layers, pool_pages, layer, num_splits,
        wl, wr, float(scale), softcap, _build.ptr(slopes), _build.ptr(leftpad),
        _build.stream_handle(),
    )
    _build.check(rc, f"paged_attention ({route})")
    options = has_options(False, (wl, wr), softcap, slopes, leftpad)
    _build.LAUNCHES[route_label(route, sq * (h // h_k), options)] += 1
    if num_splits > 1:
        return combine_splits(o, lse, q.dtype)
    return o, lse


def paged_attention(
    q: torch.Tensor,  # (b, sq, h, d) — new query tokens
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d) or (L, ...) with layer_idx
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # (b, max_pages) int
    kv_lens: torch.Tensor,  # (b,) int — total visible keys (incl. new)
    *,
    softmax_scale: Optional[float] = None,
    causal: bool = True,
    window: Tuple[int, int] = (-1, -1),
    softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
    cache_leftpad: Optional[torch.Tensor] = None,
    num_splits: int = 0,  # 0: num_splits_heuristic over the H100's SMs
    k_scales: Optional[torch.Tensor] = None,  # (L?, num_pages, h_k, page[, 1]) f32
    v_scales: Optional[torch.Tensor] = None,
    layer_idx: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged-KV attention over new query tokens. Returns (O, LSE):
    O (b, sq, h, d) in q.dtype, LSE (b, h, sq) f32 natural log. Pools are
    stored tight, so their page dimension is the page size."""
    if layer_idx is not None and k_pool.dim() != 5:
        raise ValueError(
            f"layer_idx given but k_pool is not (L, pages, h_k, page, d): {tuple(k_pool.shape)}"
        )
    k_scales = _squeeze_scales(k_scales, k_pool)
    v_scales = _squeeze_scales(v_scales, v_pool)
    b, sq, h, d = q.shape
    h_k = k_pool.shape[-3]
    if h % h_k:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_k}")
    if alibi_slopes is not None and tuple(alibi_slopes.shape) not in ((h,), (b, h)):
        raise ValueError(f"alibi_slopes must be ({h},) or ({b}, {h}), "
                         f"got {tuple(alibi_slopes.shape)}")
    if cache_leftpad is not None and tuple(cache_leftpad.shape) != (b,):
        raise ValueError(f"cache_leftpad must be ({b},), got {tuple(cache_leftpad.shape)}")
    route, splits = paged_plan(q.shape, k_pool.shape, k_pool.dtype, block_tables.shape[1],
                               num_splits, causal, window, softcap, alibi_slopes, cache_leftpad)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if is_cuda(q, k_pool, v_pool, block_tables, kv_lens, alibi_slopes, cache_leftpad):
        return _paged_attention_cuda(q, k_pool, v_pool, layer_idx, block_tables, kv_lens, scale,
                                     causal, window, softcap, alibi_slopes, cache_leftpad,
                                     splits, k_scales, v_scales, route)
    _build.PLAIN_CALLS["paged_attention"] += 1
    return paged_attention_ref(
        q, _layer(k_pool, layer_idx), _layer(v_pool, layer_idx), block_tables, kv_lens,
        softmax_scale=scale, causal=causal, window=window, softcap=softcap,
        alibi_slopes=alibi_slopes, cache_leftpad=cache_leftpad, num_splits=splits,
        k_scales=_layer(k_scales, layer_idx), v_scales=_layer(v_scales, layer_idx),
    )
