"""INT8 / FP8 weight-only projections (QKV/O, MLP and lm_head matmuls).

Weights are stored int8 (or fp8-e4m3) with one fp32 scale per output
channel; activations stay bf16 (f32 in the CPU tests). On CUDA the product
runs in the hand-written kernels of csrc/qmm.cu, which convert each weight
tile to bf16 on chip right before the tensor-core product, so device memory
only ever sees one byte per weight (`qmm_route`): with TMA-legal operands,
the decode kernel (mma.sync, a deep TMA ring, the split-K sum inside) for
m <= 16 rows and the wgmma kernel for m > 16, the weights converted in
registers by both; the WMMA kernel (in shared memory) for ragged operands.
On the CPU the plain version `quantized_matmul_ref` computes the same
function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import nn

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.quant.kv import quantize_with_scale
from xf_flash_attention_cutlass_tpu_torch.utils import cdiv, is_cuda

_WEIGHT_QMAX = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}

# tile geometry (rows, columns, depth) of the routes of csrc/qmm.cu that
# qmm_splits plans alike; the wgmma kernel's rows (tokens) are
# qmm_wgmma_rows(m); the decode kernel has its own plan (qmm_decode_splits)
_TILES = {"bm16": (16, 128, 64), "bm64": (64, 128, 64), "wgmma": (None, 128, 64)}
_NUM_SMS = 132  # H100 SXM
# resident blocks an SM of the decode kernel (csrc/qmm.cu, dec::kBlocksPerSm:
# its ring fills half an SM's shared memory); chip_smoke.py checks it against
# the occupancy calculator
QMM_DECODE_BLOCKS_PER_SM = 2
# arrival counters of the decode kernel's in-kernel split-K sum: one int32
# per 128-column output tile, allocated and zeroed once per device; a plan
# with more column tiles than this does not split
QMM_DECODE_COUNTERS = 4096
QMM_DECODE_MIN_TILES = 8  # k-tiles a split of the decode kernel holds at least
_counters = {}


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
        lib.xfa_qmm_wgmma.restype = ctypes.c_int
        lib.xfa_qmm_wgmma.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 6
            + [ctypes.c_void_p]
        )
        lib.xfa_qmm_decode.restype = ctypes.c_int
        lib.xfa_qmm_decode.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
        )
        lib.xfa_qmm_decode_blocks_per_sm.restype = ctypes.c_int
        lib.xfa_qmm_decode_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        _lib_handle = lib
    return _lib_handle


def qmm_route(m: int, k: int, n: int, w_dtype: torch.dtype, x_ptr: int = 0,
              w_ptr: int = 0) -> str:
    """The kernel of csrc/qmm.cu that computes (m, k) bf16 x (k, n) weights
    of w_dtype, with x contiguous at address x_ptr and the weight rows
    contiguous at w_ptr. When TMA can load both operands (bases 16-byte
    aligned, row strides k * 2 and n * element size multiples of 16 bytes:
    every Llama-8B shape, stacked at any layer or single): 'decode' for
    decode widths (m <= 16), 'wgmma' above. Otherwise the WMMA kernel with
    element-wise loads at the edges: 'bm16' (16-row tiles) for m <= 16,
    'bm64' above. A route chosen by shape: no route falls back to another
    when a kernel fails."""
    legal = (x_ptr % 16 == 0 and w_ptr % 16 == 0 and (k * 2) % 16 == 0
             and (n * w_dtype.itemsize) % 16 == 0)
    if m <= 16:
        return "decode" if legal else "bm16"
    return "wgmma" if legal else "bm64"


def qmm_wgmma_rows(m: int) -> int:
    """Rows (tokens) of the wgmma kernel's output tile at m rows: its wgmma
    N, 128 or 256."""
    return 256 if m > 128 else 128


def qmm_decode_rows(m: int) -> int:
    """Tokens of the decode kernel's tile at m <= 16 rows: its mma.sync N, 8
    or 16."""
    return 8 if m <= 8 else 16


@functools.lru_cache(maxsize=None)  # called once per projection of every decode step
def qmm_decode_splits(n: int, k: int) -> Tuple[int, int]:
    """(splits over K, k-tiles per split) of the decode kernel, whose splits
    are summed inside it: the fewest splits (the most k-tiles per split)
    that give at least 3/4 of the SMs a block of the 128-column tiles, but
    no fewer than 8 k-tiles (64 KB of int8 weights) a split. The kernel is
    bound by weight bytes, and a block's fixed cost (its first loads'
    latency, its partial and the last split's sum) is paid once per block,
    so long blocks on most SMs beat short blocks on all of them (a sweep of
    split counts on an H100, PERF.md). Every split's k range is whole and
    non-empty; a shape with more column tiles than the counter buffer holds
    is not split. Bytes bound it at every m <= 16, so m does not enter."""
    cols, n_kt = cdiv(n, 128), cdiv(k, 64)
    if cols > QMM_DECODE_COUNTERS:
        return 1, n_kt
    per = n_kt
    while per > QMM_DECODE_MIN_TILES and cols * cdiv(n_kt, per) < cdiv(3 * _NUM_SMS, 4):
        per -= 1
    splits = cdiv(n_kt, per)
    return splits, cdiv(n_kt, splits)  # the same splits, as even as they go


def qmm_splits(m: int, n: int, k: int, route: Optional[str] = None) -> Tuple[int, int]:
    """(splits over K, k-tiles per split) of csrc/qmm.cu's kernel `route`
    (by default the route of aligned int8 operands). The decode kernel's
    plan is `qmm_decode_splits`. Elsewhere: split only when the output
    tiles leave SMs idle, and keep at least 4 k-tiles per split. The WMMA
    kernels aim at two blocks an SM; the wgmma kernel holds an SM alone
    (its registers), so its splits keep every block in one wave."""
    route = route or qmm_route(m, k, n, torch.int8)
    if route == "decode":
        return qmm_decode_splits(n, k)
    rows, cols, depth = _TILES[route]
    rows = rows or qmm_wgmma_rows(m)
    blocks = cdiv(n, cols) * cdiv(m, rows)
    n_kt = cdiv(k, depth)
    want = _NUM_SMS // blocks if route == "wgmma" else cdiv(2 * _NUM_SMS, blocks)
    splits = max(1, min(want, n_kt // 4, 16))
    kt_per = cdiv(n_kt, splits)
    return cdiv(n_kt, kt_per), kt_per


def decode_counters(device: torch.device) -> torch.Tensor:
    """The decode kernel's arrival counters on `device`: QMM_DECODE_COUNTERS
    int32, zeroed once here when first allocated; every call leaves them 0
    again, so no call needs a memset."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    buf = _counters.get(idx)
    if buf is None:
        buf = _counters[idx] = torch.zeros(QMM_DECODE_COUNTERS, dtype=torch.int32,
                                           device=f"cuda:{idx}")
    return buf


def qmm_decode_blocks_per_sm(w_dtype: torch.dtype, rows: int) -> int:
    """Resident blocks an SM of the decode kernel's instantiation for w_dtype
    and rows (8 or 16), by the CUDA occupancy calculator (needs a card)."""
    return _lib().xfa_qmm_decode_blocks_per_sm(_build.dtype_code(w_dtype), rows)


def _qmm_cuda(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
              route: str, kind: Optional[str] = None,
              splits: Optional[int] = None) -> torch.Tensor:
    """Launch csrc/qmm.cu's kernel `kind` (by default `qmm_route`'s choice;
    chip_smoke.py names 'bm64' and 'bm16' to time the WMMA kernel beside the
    wgmma and decode ones on the same shapes) over `splits` splits of K (by
    default `qmm_splits`'; the bring-up sweeps them)."""
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
    kind = kind or qmm_route(m, d_in, d_out, w.dtype, x2.data_ptr(), w.data_ptr())
    if splits is None:
        splits, kt_per = qmm_splits(m, d_out, d_in, kind)
    else:
        kt_per = cdiv(cdiv(d_in, 64), splits)
        splits = cdiv(cdiv(d_in, 64), kt_per)
    partial = (
        torch.empty((splits, m, d_out), dtype=torch.float32, device=x.device)
        if splits > 1 else None
    )
    args = (x2.data_ptr(), w.data_ptr(), _build.dtype_code(w.dtype), _build.ptr(scale),
            y.data_ptr(), _build.ptr(partial), m, d_out, d_in, splits, kt_per)
    if kind == "decode":
        counters = decode_counters(x.device)
        if splits > 1 and cdiv(d_out, 128) > counters.numel():
            raise ValueError(f"qmm decode: {cdiv(d_out, 128)} column tiles exceed the "
                             f"{counters.numel()} split counters")
        rc = _lib().xfa_qmm_decode(*args[:6], counters.data_ptr(), *args[6:],
                                   _build.stream_handle())
    elif kind == "wgmma":
        rc = _lib().xfa_qmm_wgmma(*args, qmm_wgmma_rows(m), _build.stream_handle())
    else:
        vec_x = int(d_in % 8 == 0 and x2.data_ptr() % 16 == 0)
        vec_w = int((d_out * w.element_size()) % 16 == 0 and w.data_ptr() % 16 == 0)
        rc = _lib().xfa_qmm(*args, vec_x, vec_w, _TILES[kind][0], _build.stream_handle())
    _build.check(rc, "qmm")
    _build.LAUNCHES[f"{route}.{kind}"] += 1
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
