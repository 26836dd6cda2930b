"""Quantized KV cache: FP8-E4M3 / INT8 values with per-token scales.

Scale granularity is one fp32 per cache row (per token per KV head). The
math is bit-exact with the pools the JAX package writes:

- qmax is 127 for int8 and 448 for fp8-e4m3;
- scale = amax * (1 / qmax), or 1 where amax is 0. The JAX package writes
  amax / qmax, but every path that fills its pools is compiled by XLA,
  which turns a division by a constant into a multiplication by the
  constant's float32 reciprocal; the two differ in the last bit for a few
  percent of int8 rows and about half of fp8 rows. (Run eagerly, the JAX
  function divides; quant/linear.py's weight scales follow that form.)
- y = x / scale is a true IEEE division; int8 rounds half to even, then
  clips to +-127; fp8 clips to +-448, then rounds to nearest even.

On CUDA, PyTorch turns a division by a Python scalar into a multiplication
by its reciprocal, so divisions here always take a tensor divisor.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

KV_QUANT_DTYPES = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}
QUANT_DTYPES = tuple(dt for dt, _ in KV_QUANT_DTYPES.values())


def resolve_quant(quant_dtype) -> Tuple[torch.dtype, float]:
    """(storage dtype, qmax) of a KV quant name or dtype."""
    if isinstance(quant_dtype, str):
        try:
            return KV_QUANT_DTYPES[quant_dtype]
        except KeyError:
            raise ValueError(
                f"unknown KV quant dtype {quant_dtype!r}; "
                f"expected one of {sorted(KV_QUANT_DTYPES)}"
            ) from None
    for dt, qmax in KV_QUANT_DTYPES.values():
        if quant_dtype == dt:
            return dt, qmax
    raise ValueError(f"unsupported KV quant dtype {quant_dtype}")


def inv_qmax(qmax: float) -> float:
    """float32 1 / qmax, as XLA folds it (exact as a Python float)."""
    return float(np.float32(1.0) / np.float32(qmax))


def quantize_with_scale(xf: torch.Tensor, scale: torch.Tensor, dt: torch.dtype,
                        qmax: float) -> torch.Tensor:
    """round(xf / scale) for int8 (half to even, clipped), or the clipped
    quotient rounded to fp8."""
    y = xf / scale
    if dt == torch.int8:
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    return torch.clamp(y, -qmax, qmax).to(dt)


def quantize_rows(xf: torch.Tensor, dt: torch.dtype, qmax: float):
    """Per-row symmetric quantization of float32 `xf` along its last axis.
    Returns (values, scales (..., 1))."""
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * inv_qmax(qmax), torch.ones_like(amax))
    return quantize_with_scale(xf, scale, dt, qmax), scale


def quantize_kv(
    x: torch.Tensor,  # (..., d) full-precision values
    quant_dtype="int8",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric quantization. Returns (values, scales) where
    scales has shape (..., 1) fp32 and values = round(x / scales)."""
    dt, qmax = resolve_quant(quant_dtype)
    return quantize_rows(x.float(), dt, qmax)


def dequantize_kv(values: torch.Tensor, scales: torch.Tensor, dtype=torch.float32):
    return (values.float() * scales.float()).to(dtype)


def quantize_kv_pools(
    k_pool: torch.Tensor,  # (num_pages, h_k, page, d) full precision
    v_pool: torch.Tensor,
    quant_dtype="int8",
):
    """Quantize internal-layout KV pools. Returns (kq, ks, vq, vs)."""
    kq, ks = quantize_kv(k_pool, quant_dtype)
    vq, vs = quantize_kv(v_pool, quant_dtype)
    return kq, ks, vq, vs
