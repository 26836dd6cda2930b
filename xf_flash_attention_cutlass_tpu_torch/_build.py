"""Build and load the port's CUDA kernels.

Each source in ``csrc/*.cu`` is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, and loaded with ``ctypes``. All
sources are compiled together, in parallel, at first use; the libraries go
to ``build/`` inside the package (listed in ``.gitignore``) under a name
that carries a hash of the sources, so an edited source is rebuilt and an
unchanged one is reused.

``--use_fast_math`` is never passed: the quantizers in ``paged_append.cu``
need IEEE division and ``rintf`` (round half to even) to stay bit-exact with
the reference's ``jnp.round``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from typing import Dict, Optional

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

# every kernel source; each becomes lib<name>-<hash>.so
SOURCES = ("paged_attention", "paged_append", "qmm", "flash_fwd", "flash_probs", "flash_bwd")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha1()
    for name in sorted(os.listdir(CSRC_DIR)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, name), "rb") as f:
                h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(name: str, digest: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel source that is not built yet, one nvcc process
    per source, all started together. Returns {name: library path}. Raises
    with the compiler's output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    digest = _source_hash()
    paths = {n: _lib_path(n, digest) for n in SOURCES}
    todo = [n for n in SOURCES if not os.path.exists(paths[n])]
    procs = {}
    for n in todo:
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        with open(os.path.join(BUILD_DIR, f"{n}.log"), "w") as f:
            f.write(out)
        if p.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {p.returncode}) ---\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(p)
            lib = _libs[name]
        return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def dtype_code(dtype: torch.dtype) -> int:
    """The XfaDtype code (csrc/common.cuh) of a tensor dtype."""
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise ValueError(f"no CUDA kernel takes dtype {dtype}") from None


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# kept in step with enum XfaDtype in csrc/common.cuh
DTYPE_CODES = {
    torch.bfloat16: 0,
    torch.int8: 1,
    torch.float8_e4m3fn: 2,
    torch.float16: 3,
}

# Launch counts of every kernel wrapper, by route, and calls of the plain
# PyTorch versions. A wrapper adds one to LAUNCHES where it launches its
# kernel and nowhere else; chip_smoke.py clears both before driving the
# main path and reads them after, to show which path the run took.
LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
