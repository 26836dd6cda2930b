"""In-place paged KV append, with per-token quantization for int8/fp8 pools.

``paged_append`` writes the new K/V rows (b, sq, h_k, d) of every batch entry
at positions positions[b] + t, into pool[bt[b, pos // page], :, pos % page].
It serves decode (sq = 1), verify-style appends (sq > 1 at any position) and
chunked prefill with one code path. The pools are updated IN PLACE and
returned: this is the port's counterpart of the JAX package's buffer
donation and input/output aliasing, which exist there because JAX arrays
are immutable. Rows past the block table are not written; inactive batch
rows point their block tables at a trash page and may race there, as on the
TPU — nothing ever reads the trash page.

CUDA tensors run csrc/paged_append.cu (a warp, or at head_dim <= 64 a
half-warp, per (token, kv head, K|V) row): bf16, fp16 or f32 rows, written
as they are into pools of their own dtype or quantized into int8 / fp8
pools; any other dtype raises TypeError. CPU tensors run
``paged_append_ref``, the plain version. Both quantize exactly like
quant/kv.py, so the pools they write are bit-identical.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.quant.kv import (
    QUANT_DTYPES,
    quantize_rows,
    resolve_quant,
)
from xf_flash_attention_cutlass_tpu_torch.utils import is_cuda


def paged_append_ref(
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d): one layer, updated in place
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (b, sq, h_k, d)
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (b, max_pages)
    positions: torch.Tensor,  # (b,)
    k_scales: Optional[torch.Tensor] = None,  # (num_pages, h_k, page) f32
    v_scales: Optional[torch.Tensor] = None,
) -> None:
    """Plain version: the same rows written with advanced indexing."""
    b, sq, h_k, d = k_new.shape
    page = k_pool.shape[-2]
    max_pages = block_tables.shape[1]
    dev = k_pool.device
    pos = positions.to(device=dev, dtype=torch.long)[:, None] + torch.arange(sq, device=dev)
    lp = pos // page
    valid = (pos >= 0) & (lp < max_pages)
    pe = block_tables.to(device=dev, dtype=torch.long).gather(1, lp.clamp(0, max_pages - 1))
    pe, row = pe[valid], (pos % page)[valid]
    quant = k_scales is not None
    for pool, scales, new in ((k_pool, k_scales, k_new), (v_pool, v_scales, v_new)):
        if quant:
            dt, qmax = resolve_quant(pool.dtype)
            vals, sc = quantize_rows(new.float(), dt, qmax)
            scales[pe, :, row] = sc[..., 0][valid]
        else:
            vals = new.to(pool.dtype)
        pool[pe, :, row] = vals[valid]


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("paged_append")
        lib.xfa_paged_append.restype = ctypes.c_int
        lib.xfa_paged_append.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        )
        _lib_handle = lib
    return _lib_handle


ROW_DTYPES = (torch.bfloat16, torch.float16, torch.float32)  # the kernel's K/V rows


def append_label(sq: int, row_dtype: torch.dtype) -> str:
    """The launch counter (_build.LAUNCHES) of the append kernel's
    instantiation for these rows: decode (sq = 1) or prefill, bf16 rows
    unsuffixed, fp16 and f32 rows counted apart."""
    kind = "paged_append.decode" if sq == 1 else "paged_append.prefill"
    return kind + _build.LABEL_SUFFIX[row_dtype]


def check_append_dtypes(row_dtype: torch.dtype, pool_dtype: torch.dtype) -> None:
    """Raise TypeError unless the CUDA append kernel takes rows of row_dtype
    into pools of pool_dtype: bf16, fp16 or f32 rows into pools of their own
    dtype, or into int8 / fp8 pools."""
    if row_dtype not in ROW_DTYPES:
        raise TypeError(f"the CUDA append kernel (K2/K5/K6) takes bf16/fp16/f32 K/V rows, "
                        f"got {row_dtype}")
    if pool_dtype not in (row_dtype, *QUANT_DTYPES):
        raise TypeError(f"the CUDA append kernel (K2/K5/K6) writes {row_dtype} rows into "
                        f"{row_dtype}, int8 or fp8 pools, got {pool_dtype}")


def _paged_append_cuda(k_pool, v_pool, k_new, v_new, block_tables, positions,
                       k_scales, v_scales):
    b, sq, h_k, d = k_new.shape
    quant = k_scales is not None
    if quant != (k_pool.dtype in QUANT_DTYPES):
        raise ValueError(f"{k_pool.dtype} pools {'need' if not quant else 'take no'} scales")
    if v_new.dtype != k_new.dtype or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"the CUDA append kernel (K2/K5/K6) takes K and V of one dtype, got "
                        f"rows {k_new.dtype}/{v_new.dtype}, pools {k_pool.dtype}/{v_pool.dtype}")
    check_append_dtypes(k_new.dtype, k_pool.dtype)
    pools = (k_pool, v_pool) + ((k_scales, v_scales) if quant else ())
    if not all(t.is_contiguous() for t in pools):
        raise ValueError("pools and scales must be contiguous (they are written in place)")
    if quant and (k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32):
        raise TypeError("scale pools must be float32")
    kn, vn = k_new.contiguous(), v_new.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    rc = _lib().xfa_paged_append(
        kn.data_ptr(), vn.data_ptr(), _build.dtype_code(kn.dtype), k_pool.data_ptr(),
        v_pool.data_ptr(), _build.dtype_code(k_pool.dtype),
        _build.ptr(k_scales), _build.ptr(v_scales), bt.data_ptr(), pos.data_ptr(),
        b, sq, h_k, d, k_pool.shape[-2], bt.shape[1], _build.stream_handle(),
    )
    _build.check(rc, "paged_append")
    _build.LAUNCHES[append_label(sq, kn.dtype)] += 1


def paged_append(
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d) or (L, ...) with layer_idx
    v_pool: torch.Tensor,
    k_new: torch.Tensor,  # (b, sq, h_k, d) full precision
    v_new: torch.Tensor,
    block_tables: torch.Tensor,  # (b, max_pages) int
    positions: torch.Tensor,  # (b,) int — insert position per batch row
    *,
    k_scales: Optional[torch.Tensor] = None,  # (L?, num_pages, h_k, page) f32
    v_scales: Optional[torch.Tensor] = None,
    layer_idx: Optional[int] = None,
):
    """In-place append. Returns (k_pool, v_pool[, k_scales, v_scales]) —
    the same tensors it was given, updated in place. Quantization (int8 /
    fp8 pools) happens in the kernel when scale pools are given. Pools are
    stored tight, so their page dimension is the page size."""
    quant = k_scales is not None
    if layer_idx is not None:
        layer = int(layer_idx)
        kp, vp = k_pool[layer], v_pool[layer]
        ks = k_scales[layer] if quant else None
        vs = v_scales[layer] if quant else None
    else:
        kp, vp, ks, vs = k_pool, v_pool, k_scales, v_scales
    if is_cuda(kp, vp, k_new, v_new, block_tables, positions):
        _paged_append_cuda(kp, vp, k_new, v_new, block_tables, positions, ks, vs)
    else:
        _build.PLAIN_CALLS["paged_append"] += 1
        paged_append_ref(kp, vp, k_new, v_new, block_tables, positions, ks, vs)
    if quant:
        return k_pool, v_pool, k_scales, v_scales
    return k_pool, v_pool
