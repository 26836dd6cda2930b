"""INT8 / FP8 weight-only projections (QKV/O, MLP and lm_head matmuls).

Weights are stored int8 (or fp8-e4m3) with one fp32 scale per output
channel; activations stay bf16 (f32 in the CPU tests). On CUDA the product
runs in the hand-written kernel csrc/qmm.cu, which dequantizes each weight
tile in shared memory right before the tensor-core product, so device memory
only ever sees one byte per weight. On the CPU the plain version
`quantized_matmul_ref` computes the same function.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import nn

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.quant.kv import quantize_with_scale
from xf_flash_attention_cutlass_tpu_torch.utils import cdiv, is_cuda

_WEIGHT_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}

# tile geometry of csrc/qmm.cu, for the split-K choice
_BN, _BK = 128, 64
_NUM_SMS = 132  # H100 SXM


def quantize_weight(
    w: torch.Tensor,  # (d_in, d_out)
    quant_dtype=torch.int8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization. Returns (w_q, scale(d_out,)).
    scale = amax / qmax as a true division, as the JAX package's
    quantize_params computes it (eagerly)."""
    if quant_dtype not in _WEIGHT_QMAX:
        raise ValueError(f"unsupported weight quant dtype {quant_dtype}")
    qmax = _WEIGHT_QMAX[quant_dtype]
    wf = w.float()
    amax = wf.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / torch.tensor(qmax, device=w.device),
                        torch.ones_like(amax))
    return quantize_with_scale(wf, scale[None, :], quant_dtype, qmax), scale


def quantized_matmul_ref(
    x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor]
) -> torch.Tensor:
    """Plain version: f32 product of x and the (unscaled) weight, scale per
    output channel, cast back to x's dtype."""
    d_in, d_out = w.shape
    y = x.reshape(-1, d_in).float() @ w.float()
    if scale is not None:
        y = y * scale.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], d_out)


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("qmm")
        lib.xfa_qmm.restype = ctypes.c_int
        lib.xfa_qmm.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 8
            + [ctypes.c_void_p]
        )
        _lib_handle = lib
    return _lib_handle


def qmm_tile_rows(m: int) -> int:
    """Rows of x per block of csrc/qmm.cu (one of its two template
    instances; the launcher is told which)."""
    return 16 if m <= 16 else 64


def qmm_splits(m: int, n: int, k: int) -> Tuple[int, int]:
    """(splits over K, k-tiles per split) of csrc/qmm.cu: split only when
    the output tiles alone leave the SMs without two blocks each, and keep
    at least 4 k-tiles per split."""
    blocks = cdiv(n, _BN) * cdiv(m, qmm_tile_rows(m))
    n_kt = cdiv(k, _BK)
    splits = max(1, min(cdiv(2 * _NUM_SMS, blocks), n_kt // 4, 16))
    kt_per = cdiv(n_kt, splits)
    return cdiv(n_kt, kt_per), kt_per


def _qmm_cuda(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
              route: str) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA qmm kernel takes bf16 activations, got {x.dtype}")
    if w.dtype not in (torch.int8, torch.float8_e4m3fn, torch.bfloat16):
        raise TypeError(f"the CUDA qmm kernel takes int8/fp8/bf16 weights, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("weight must be contiguous")
    if scale is not None and (scale.dtype != torch.float32 or not scale.is_contiguous()):
        raise ValueError("scale must be a contiguous float32 vector")
    d_in, d_out = w.shape
    x2 = x.reshape(-1, d_in).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    bm = qmm_tile_rows(m)
    splits, kt_per = qmm_splits(m, d_out, d_in)
    partial = (
        torch.empty((splits, m, d_out), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    vec_x = int(d_in % 8 == 0 and x2.data_ptr() % 16 == 0)
    vec_w = int((d_out * w.element_size()) % 16 == 0 and w.data_ptr() % 16 == 0)
    rc = _lib().xfa_qmm(
        x2.data_ptr(), w.data_ptr(), _build.dtype_code(w.dtype), _build.ptr(scale),
        y.data_ptr(), _build.ptr(partial), m, d_out, d_in, splits, kt_per,
        vec_x, vec_w, bm, _build.stream_handle(),
    )
    _build.check(rc, "qmm")
    _build.LAUNCHES[f"{route}.bm{bm}"] += 1
    return y.reshape(*x.shape[:-1], d_out)


def quantized_matmul(
    x: torch.Tensor,  # (..., d_in) bf16 (f32 on the CPU path too)
    w_q: torch.Tensor,  # (d_in, d_out) int8/fp8 — or (L, d_in, d_out) stacked
    scale: Optional[torch.Tensor],  # (d_out,) f32 — or (L, d_out); None: no scale
    *,
    layer_idx: Optional[int] = None,  # selects the stack layer
) -> torch.Tensor:
    """y = x @ (w_q * scale) with the dequantization fused into the matmul.

    With ``layer_idx`` the weight and scale carry a leading layer axis and
    layer ``layer_idx`` is read in place (a view at an offset, never a
    copy). ``scale=None`` serves unquantized bf16 stacks (the JAX package's
    ``has_scale=False``). CUDA tensors run csrc/qmm.cu; CPU tensors the
    plain version."""
    if layer_idx is not None:
        layer = int(layer_idx)
        w_q = w_q[layer]
        scale = None if scale is None else scale[layer]
        route = "qmm.stacked"
    else:
        route = "qmm.single"
    if is_cuda(x, w_q, scale):
        return _qmm_cuda(x, w_q, scale, route)
    _build.PLAIN_CALLS[route] += 1
    return quantized_matmul_ref(x, w_q, scale)


class QuantizedLinear(nn.Module):
    """Weight-only quantized linear layer: y = x @ (w_q * scale) + bias."""

    def __init__(self, w_q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_weight(cls, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    quant_dtype=torch.int8) -> "QuantizedLinear":
        wq, s = quantize_weight(w, quant_dtype)
        return cls(wq, s, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quantized_matmul(x, self.w_q, self.scale)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
