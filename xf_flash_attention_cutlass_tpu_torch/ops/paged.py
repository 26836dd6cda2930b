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

CUDA tensors run one of the four hand-written kernels of
csrc/paged_attention.cu, as ``paged_route`` picks from the shapes and the
query and pool dtypes: the decode kernel ("decode", at most 16 query rows a
KV head: decode and short verify), the Hopper chunk kernel ("wgmma", 64
query rows a block, more than 16 rows a KV head: prefill chunks and paged
varlen), both of which scale q themselves and write O and LSE in the
caller's layout, the first version on WMMA ("wmma": pages of no whole TMA
box), all three for bf16 or fp16 queries over pools of the queries' dtype,
int8 or fp8, and the f32 kernel ("f32": f32 queries over f32, int8 or fp8
pools, any page, FMA in f32 throughout). The 16-bit kernels have an
option-free instantiation and one with the options (``has_options``),
counted under labels of their own (``route_label``; fp16 and f32 calls
under labels ending in ".f16" / ".f32"). Split runs give f32 partials (O,
LSE); the decode, chunk and f32 routes merge them with the combine kernel
(``combine_splits``), the WMMA route with ``combine_partials`` in plain
torch. Any other dtype raises TypeError naming K1. CPU tensors run
``paged_attention_ref``, the plain version, with the kernels' numerics.
Every route cuts each entry's keys from the first one any row can see
(window start, leftpad; 0 without them) to the last live one: the decode
route into ``num_splits`` runs of whole 64-key tiles
(``decode_split_keys``), the others into ``num_splits`` equal runs of
pages. The split count comes from the route's blocks
(``paged_plan``).

Head dims: every route takes any d from 1 to 256. The kernels are
instantiated at the rungs 64, 128, 192 and 256 (``head_dim_rung``: the
smallest rung >= d) and read the real d through their tensor maps and loads,
so nothing is padded in memory. A row must be whole 16-byte chunks
(``head_dim_align``); other widths (59, 111; 40 over int8 / fp8 pools) take
``paged_attention_padded``, a zero-padded copy of q and the layer's pools to
the next such width (``mapped_head_dim``), counted under its own label. The
softmax scale stays 1 / sqrt(d) of the real d.

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
from xf_flash_attention_cutlass_tpu_torch.utils import acc_dtype, cdiv, is_cuda

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
M_FLOOR = -1e30  # running-max floor: exp(NEG_INF - M_FLOOR) == 0
NUM_SMS = 132  # H100 SXM: the cores of the split heuristic
MAX_SPLITS = 128
DECODE_ROWS = 16  # query rows a KV head up to which the decode kernel takes a call
DECODE_TILE = 64  # keys per tile of the decode kernel: its unit of splits
HEAD_DIM_RUNGS = (64, 128, 192, 256)  # the kernels' instantiated head dims (csrc: by_rung)
# the decode kernel's resident blocks an SM at each rung (csrc: dec::Layout::kBlocks)
DECODE_BLOCKS = {64: 2, 128: 2, 192: 2, 256: 1}


def head_dim_rung(d: int) -> int:
    """The instantiation that serves head dim d: the smallest rung >= d."""
    if not 1 <= d <= HEAD_DIM_RUNGS[-1]:
        raise ValueError(f"the CUDA kernels take head dims 1 to {HEAD_DIM_RUNGS[-1]}, got {d}")
    return next(r for r in HEAD_DIM_RUNGS if r >= d)


def head_dim_align(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """Elements of a 16-byte chunk of the narrowest operand: a head dim the
    kernels read in place is a multiple of it (the tensor maps' strides and
    the 16-byte loads): 16 over int8 / fp8 pools, 8 over 16-bit pools, 4 for
    f32 queries over f32 pools."""
    if kv_dtype in QUANT_DTYPES:
        return 16
    return 4 if q_dtype == torch.float32 else 8


def mapped_head_dim(d: int, q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """The head dim a CUDA call runs at: d itself where the kernels read it
    in place, else the next multiple of head_dim_align, to which
    paged_attention_padded copies the operands."""
    a = head_dim_align(q_dtype, kv_dtype)
    return -(-d // a) * a


def _plan_rung(d: int, q_dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """The rung whose blocks the split plan counts (the top one past 256,
    which only the plain version takes)."""
    return min(cdiv(mapped_head_dim(d, q_dtype, kv_dtype), 64) * 64, HEAD_DIM_RUNGS[-1])


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


Q16_DTYPES = (torch.bfloat16, torch.float16)  # the queries of the 16-bit kernels
F32_ROWS = 16  # query rows per block of the f32 kernel
# the f32 kernel's resident blocks an SM by pool dtype and rung (its shared
# memory: 41, 77, 113 and 149 KB; at the rung 64 its registers, which depend
# on the pool dtype), for its splits; chip_smoke.py holds them to the CUDA
# occupancy calculator
F32_BLOCKS = {(torch.float32, 64): 3, (torch.float8_e4m3fn, 64): 5, (torch.int8, 64): 4,
              **{(dt, r): n for r, n in ((128, 2), (192, 2), (256, 1))
                 for dt in (torch.float32, torch.float8_e4m3fn, torch.int8)}}


def paged_route(rows: int, page: int, d: int, kv_dtype: torch.dtype,
                q_dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel of csrc/paged_attention.cu that takes a call, a pure
    function of its shapes and its query and pool dtypes (the options pick
    an instantiation, the head dim d a rung: every route takes any d from 1
    to 256). f32 queries or pools take "f32" (the f32 kernel, any page; its
    wrapper refuses f32 pools under 16-bit queries). With a page of whole
    TMA boxes (a multiple of 8 keys) and pools of the queries' 16-bit dtype,
    int8 or fp8: "decode" (the decode kernel) when at most 16 query rows
    share a KV head (rows = sq * group: decode and short verify), else
    "wgmma" (the Hopper chunk kernel). Anything else takes "wmma" (the first
    version: odd pages; 16-bit pools of the other 16-bit dtype, which its
    CUDA wrapper refuses)."""
    del d  # any head dim: the rung is head_dim_rung's
    if q_dtype == torch.float32 or kv_dtype == torch.float32:
        return "f32"
    if page % 8 == 0 and q_dtype in Q16_DTYPES and kv_dtype in (q_dtype, *QUANT_DTYPES):
        return "decode" if rows <= DECODE_ROWS else "wgmma"
    return "wmma"


def route_row_tile(route: str, rows: int) -> int:
    """Query rows per block of the route's kernel."""
    if route == "wgmma":
        return WGMMA_ROWS
    if route == "f32":
        return F32_ROWS
    return DECODE_ROWS if route == "decode" else kernel_row_tile(rows)


def route_label(route: str, rows: int, options: bool = False,
                q_dtype: torch.dtype = torch.bfloat16) -> str:
    """The launch counter (_build.LAUNCHES) of the route's kernel: the Hopper
    kernels count their options instantiation apart, the WMMA and f32
    kernels their decode-sized calls (<= 16 rows a KV head); fp16 queries
    add ".f16" (bf16 none). The f32 kernel takes the options at run time."""
    if route == "f32":
        return ("paged_attention.decode.f32" if rows <= DECODE_ROWS
                else "paged_attention.prefill.f32")
    if route == "decode":
        label = "paged_attention.decode.options" if options else "paged_attention.decode"
    elif route == "wgmma":
        label = ("paged_attention.prefill.options" if options
                 else "paged_attention.prefill.wgmma")
    else:
        label = ("paged_attention.decode.wmma" if rows <= DECODE_ROWS
                 else "paged_attention.prefill.wmma")
    return label + _build.LABEL_SUFFIX[q_dtype]


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
               alibi_slopes=None, cache_leftpad=None,
               q_dtype: torch.dtype = torch.bfloat16) -> Tuple[str, int]:
    """(route, splits) of a paged_attention call: the kernel paged_route
    picks and the split count resolve_num_splits gives for its blocks. On
    the decode route the cores are the H100's SMs times the decode kernel's
    resident blocks at the call's rung and the splits' unit is a 64-key
    tile; on the f32 route the SMs times the f32 kernel's blocks at the rung
    and pages; elsewhere the SMs and pages. k_pool_shape is (pages, h_k,
    page, d), or (L, ...) with a layer axis."""
    b, sq, h, d = q_shape
    h_k, page = k_pool_shape[-3], k_pool_shape[-2]
    rows = sq * (h // h_k)
    route = paged_route(rows, page, d, kv_dtype, q_dtype)
    if route == "decode":
        rung = _plan_rung(d, q_dtype, kv_dtype)
        return route, resolve_num_splits(num_splits, b, h_k, rows,
                                         cdiv(max_pages * page, DECODE_TILE), DECODE_ROWS,
                                         NUM_SMS * DECODE_BLOCKS[rung])
    if route == "f32":
        rung = _plan_rung(d, q_dtype, kv_dtype)
        return route, resolve_num_splits(num_splits, b, h_k, rows, max_pages, F32_ROWS,
                                         NUM_SMS * F32_BLOCKS.get((kv_dtype, rung), 1))
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
    acc = acc_dtype(dt)  # f32, or f64 for an f64 oracle run

    # decode swap: (b, sq, h_k, g, d) -> (b, h_k, sq*g, d), row = t*g + gi
    qf = (q.to(acc) * scale).to(dt).to(acc)
    qg = qf.reshape(b, sq, h_k, g, d).permute(0, 2, 1, 3, 4).reshape(b, h_k, rows, d)

    kg = _gather(k_pool, block_tables).to(acc)  # (b, h_k, T, d)
    vg = _gather(v_pool, block_tables).to(acc)
    T = kg.shape[2]
    ks = vs = None
    if kv_quant:
        ks = _gather(k_scales, block_tables).to(acc)  # (b, h_k, T)
        vs = _gather(v_scales, block_tables).to(acc)

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
        s = s - row_slope[..., None] * (qpos - kcol).abs().to(acc)

    # each row's visible pages (64-key tiles on the decode route) cut into
    # num_splits equal runs, as the route's kernel does
    unit = DECODE_TILE if paged_route(rows, page, d, k_pool.dtype, dt) == "decode" else page
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
            pv = (p * vs[:, :, None, :]).to(dt).to(acc)
        else:
            pv = p.to(v_pool.dtype).to(acc)
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
    """The split merge of the decode, Hopper chunk and f32 routes: on CUDA
    tensors the combine kernel (one launch, O in out_dtype: bf16, fp16 or
    f32), on CPU tensors its plain version, combine_splits_ref."""
    if not is_cuda(o_part, lse_part):
        _build.PLAIN_CALLS["paged_attention.combine"] += 1
        return combine_splits_ref(o_part, lse_part, out_dtype)
    n_splits, b, sq, h, d = o_part.shape
    if out_dtype not in _build.LABEL_SUFFIX:
        raise TypeError(f"the combine kernel (K1) writes bf16, fp16 or f32 O, got {out_dtype}")
    if not 1 <= d <= HEAD_DIM_RUNGS[-1] or d % 4:
        raise ValueError(f"the combine kernel (K1) merges partials of a head dim that is a "
                         f"multiple of 4 up to {HEAD_DIM_RUNGS[-1]}, got {d}")
    if (o_part.dtype != torch.float32 or lse_part.dtype != torch.float32
            or not o_part.is_contiguous() or not lse_part.is_contiguous()
            or tuple(lse_part.shape) != (n_splits, b, sq, h)):
        raise ValueError("the combine kernel takes contiguous f32 partials (splits, b, sq, h, d) "
                         "and (splits, b, sq, h)")
    o = torch.empty((b, sq, h, d), dtype=out_dtype, device=o_part.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=o_part.device)
    rc = _lib().xfa_paged_combine(o_part.data_ptr(), lse_part.data_ptr(), o.data_ptr(),
                                  lse.data_ptr(), _build.dtype_code(out_dtype), n_splits, b, sq,
                                  h, d, _build.stream_handle())
    _build.check(rc, "paged_attention (combine)")
    # the kernels of head dims 64 and 128, else the one of any width (rung 0)
    _build.count_launch("paged_attention.combine" + _build.LABEL_SUFFIX[out_dtype], d,
                        d if d in (64, 128) else 0)
    return o, lse


_lib_handles = {}


def _lib(q_dtype: torch.dtype = torch.bfloat16, d: int = 128):
    """The library of csrc/paged_attention.cu that holds the kernels for
    q_dtype queries at head dim d's rung: fp16's and the rungs 192 and 256
    are built apart (_build.VARIANTS); bf16's also holds the f32 kernel at
    its rungs, and the one of rungs 64 and 128 the combine kernel."""
    name = "paged_attention_f16" if q_dtype == torch.float16 else "paged_attention"
    if head_dim_rung(d) > 128:
        name += "_wide"
    lib = _lib_handles.get(name)
    if lib is None:
        lib = _build.load(name)
        lib.xfa_paged_attention.restype = ctypes.c_int
        lib.xfa_paged_attention.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_float]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
        )
        tail = ([ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 + [ctypes.c_float] * 2
                + [ctypes.c_void_p] * 3)
        for fn in (lib.xfa_paged_attention_wgmma, lib.xfa_paged_decode):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + tail
        lib.xfa_paged_f32.restype = ctypes.c_int
        lib.xfa_paged_f32.argtypes = [ctypes.c_void_p] + tail
        lib.xfa_paged_decode_blocks_per_sm.restype = ctypes.c_int
        lib.xfa_paged_decode_blocks_per_sm.argtypes = [ctypes.c_int] * 5
        lib.xfa_paged_f32_blocks_per_sm.restype = ctypes.c_int
        lib.xfa_paged_f32_blocks_per_sm.argtypes = [ctypes.c_int] * 2
        lib.xfa_paged_combine.restype = ctypes.c_int
        lib.xfa_paged_combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        _lib_handles[name] = lib
    return lib


def decode_blocks_per_sm(kv_dtype: torch.dtype, d: int, rows: int, options: bool = False,
                        q_dtype: torch.dtype = torch.bfloat16) -> int:
    """Resident blocks an SM of the decode kernel's instantiation for these
    queries, pools, rows, options and head dim d (its rung), by the CUDA
    occupancy calculator (on the card)."""
    return _lib(q_dtype, d).xfa_paged_decode_blocks_per_sm(_build.dtype_code(q_dtype),
                                                           _build.dtype_code(kv_dtype), d, rows,
                                                           int(options))


def f32_blocks_per_sm(kv_dtype: torch.dtype, d: int) -> int:
    """Resident blocks an SM of the f32 kernel over kv_dtype pools at head
    dim d's rung, by the CUDA occupancy calculator (on the card)."""
    return _lib(torch.float32, d).xfa_paged_f32_blocks_per_sm(_build.dtype_code(kv_dtype), d)


def check_kernel_dtypes(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> None:
    """Raise TypeError unless a kernel of K1 takes queries of q_dtype over
    pools of kv_dtype: bf16 or fp16 queries over pools of their own dtype,
    int8 or fp8 (the 16-bit kernels), f32 queries over f32, int8 or fp8
    pools (the f32 kernel)."""
    if q_dtype == torch.float32:
        ok = kv_dtype in (torch.float32, *QUANT_DTYPES)
    else:
        ok = q_dtype in Q16_DTYPES and kv_dtype in (q_dtype, *QUANT_DTYPES)
    if not ok:
        raise TypeError(f"the CUDA paged-attention kernels (K1) take bf16/fp16 queries over pools "
                        f"of their dtype, int8 or fp8, or f32 queries over f32/int8/fp8 pools; "
                        f"got {q_dtype} queries over {kv_dtype} pools")


def _check_cuda_inputs(q, k_pool, v_pool, k_scales, v_scales):
    kv_quant = k_scales is not None
    if kv_quant != (k_pool.dtype in QUANT_DTYPES):
        raise ValueError(f"{k_pool.dtype} pools {'need' if not kv_quant else 'take no'} scales")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError(f"the CUDA paged-attention kernels (K1) take K and V pools of one dtype, "
                        f"got {k_pool.dtype}/{v_pool.dtype}")
    check_kernel_dtypes(q.dtype, k_pool.dtype)
    d = q.shape[-1]
    head_dim_rung(d)
    if mapped_head_dim(d, q.dtype, k_pool.dtype) != d:  # paged_attention pads such widths
        raise ValueError(f"the CUDA paged-attention kernels (K1) read head dims that are a "
                         f"multiple of {head_dim_align(q.dtype, k_pool.dtype)} for "
                         f"{q.dtype} queries over {k_pool.dtype} pools, got {d}")
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
    if route in ("decode", "wgmma", "f32"):
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
    rc = _lib(q.dtype, d).xfa_paged_attention(
        qs.data_ptr(), _build.dtype_code(q.dtype), k_pool.data_ptr(), v_pool.data_ptr(),
        _build.dtype_code(k_pool.dtype),
        _build.ptr(k_scales), _build.ptr(v_scales), bt.data_ptr(), lens.data_ptr(),
        o_part.data_ptr(), lse_part.data_ptr(),
        b, sq, h_k, g, d, page, bt.shape[1], num_splits, wl, wr, float(softcap),
        _build.ptr(slopes), _build.ptr(leftpad), kernel_row_tile(rows), _build.stream_handle(),
    )
    _build.check(rc, "paged_attention")
    _build.count_launch(route_label("wmma", rows, q_dtype=q.dtype), d, head_dim_rung(d))
    if num_splits > 1:
        o, lse = combine_partials(o_part, lse_part)
    else:
        o, lse = o_part[0], lse_part[0]
    return _unswap(o, lse, b, sq, h_k, g, d, q.dtype)


def _paged_hopper_cuda(q, k_pool, v_pool, layer_idx, block_tables, kv_lens, scale, num_splits,
                       k_scales, v_scales, route, wl, wr, softcap, slopes, leftpad):
    """The decode kernel (route "decode"), the Hopper chunk kernel
    ("wgmma") or the f32 kernel ("f32"), the 16-bit ones in their options
    instantiation when the window (wl, wr; causal is wr = 0), softcap,
    slopes ((b, h) f32) or leftpad ((b,) int32) ask for it. q is read
    through its strides and scaled inside the kernel; the pools are read
    over every layer, so layer_idx is a page coordinate; one split gives O
    (b, sq, h, d) and LSE (b, h, sq) as they are, more give f32 partials in
    that layout for the combine kernel."""
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
    if q.stride(-1) != 1 or (route != "f32" and (q.data_ptr() % 16
                                                 or any(st % 8 for st in q.stride()[:3]))):
        q = q.clone(memory_format=torch.contiguous_format)  # 16-bit kernels read 16-byte rows
    bt = block_tables.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    if num_splits == 1:
        o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    else:
        o = torch.empty((num_splits, b, sq, h, d), dtype=torch.float32, device=q.device)
        lse = torch.empty((num_splits, b, sq, h), dtype=torch.float32, device=q.device)
    lib = _lib(q.dtype, d)
    if route == "f32":
        fn, head = lib.xfa_paged_f32, (q.data_ptr(),)
    else:
        fn = lib.xfa_paged_decode if route == "decode" else lib.xfa_paged_attention_wgmma
        head = (q.data_ptr(), _build.dtype_code(q.dtype))
    rc = fn(
        *head, *q.stride()[:3], k_pool.data_ptr(), v_pool.data_ptr(),
        _build.dtype_code(k_pool.dtype), _build.ptr(k_scales), _build.ptr(v_scales),
        bt.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, sq, h_k, h // h_k, d, page, bt.shape[1], n_layers, pool_pages, layer, num_splits,
        wl, wr, float(scale), softcap, _build.ptr(slopes), _build.ptr(leftpad),
        _build.stream_handle(),
    )
    _build.check(rc, f"paged_attention ({route})")
    options = has_options(False, (wl, wr), softcap, slopes, leftpad)
    _build.count_launch(route_label(route, sq * (h // h_k), options, q.dtype), d,
                        head_dim_rung(d))
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
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    cuda = is_cuda(q, k_pool, v_pool, block_tables, kv_lens, alibi_slopes, cache_leftpad)
    if cuda and d <= HEAD_DIM_RUNGS[-1] and mapped_head_dim(d, q.dtype, k_pool.dtype) != d:
        return paged_attention_padded(
            q, k_pool, v_pool, block_tables, kv_lens, mapped_head_dim(d, q.dtype, k_pool.dtype),
            softmax_scale=scale, causal=causal, window=window, softcap=softcap,
            alibi_slopes=alibi_slopes, cache_leftpad=cache_leftpad, num_splits=num_splits,
            k_scales=k_scales, v_scales=v_scales, layer_idx=layer_idx)
    route, splits = paged_plan(q.shape, k_pool.shape, k_pool.dtype, block_tables.shape[1],
                               num_splits, causal, window, softcap, alibi_slopes, cache_leftpad,
                               q.dtype)
    if cuda:
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


def pad_head_dim(x: torch.Tensor, d_to: int) -> torch.Tensor:
    """x (..., d) with zero columns appended up to d_to: a copy."""
    return torch.nn.functional.pad(x, (0, d_to - x.shape[-1]))


def paged_attention_padded(q, k_pool, v_pool, block_tables, kv_lens, d_to: int, *,
                           softmax_scale: Optional[float] = None, layer_idx=None,
                           k_scales=None, v_scales=None, **kw):
    """paged_attention at a head dim the kernels cannot read in place (a row
    of no whole 16-byte chunks, mapped_head_dim): q and the layer's pools
    copied with zero columns up to d_to, the call made at d_to with the
    softmax scale of the real d (zero columns add nothing to the scores,
    and give O columns of zeros), O cut back to d. On CUDA tensors the copy
    counts under "paged_attention.pad_copy"; CPU tensors run the plain
    version on the padded operands."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if is_cuda(q, k_pool, v_pool):
        _build.LAUNCHES["paged_attention.pad_copy"] += 1
    o, lse = paged_attention(
        pad_head_dim(q, d_to), pad_head_dim(_layer(k_pool, layer_idx), d_to),
        pad_head_dim(_layer(v_pool, layer_idx), d_to), block_tables, kv_lens,
        softmax_scale=scale, k_scales=_layer(k_scales, layer_idx),
        v_scales=_layer(v_scales, layer_idx), **kw)
    return o[..., :d], lse
