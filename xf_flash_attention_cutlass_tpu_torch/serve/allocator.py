"""ctypes binding for the native C++ page allocator (csrc/page_allocator.cpp
at the root of the repository, shared with the JAX package).

Compiled on first use with g++ into the port's build directory (listed in
``.gitignore``), under a name that carries a hash of the source; a failed
build or load raises. A pure-Python copy with identical semantics serves
callers that ask for it with ``PagePool(..., backend="python")``; the engine
never does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import numpy as np

from xf_flash_attention_cutlass_tpu_torch._build import BUILD_DIR, PKG_DIR

_SRC = os.path.join(os.path.dirname(PKG_DIR), "csrc", "page_allocator.cpp")
_lock = threading.Lock()
_lib = None


def _build() -> ctypes.CDLL:
    """The native allocator, compiled on first use. Raises when g++ fails
    or the library does not load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            digest = hashlib.sha1(f.read()).hexdigest()[:12]
        so = os.path.join(BUILD_DIR, f"libxfa_page_allocator-{digest}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        i32, vp = ctypes.c_int32, ctypes.c_void_p
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.xfa_pool_create.restype = vp
        lib.xfa_pool_create.argtypes = [i32] * 3
        lib.xfa_pool_destroy.restype = None
        lib.xfa_pool_destroy.argtypes = [vp]
        lib.xfa_pool_free_pages.restype = i32
        lib.xfa_pool_free_pages.argtypes = [vp]
        lib.xfa_request_admit.restype = i32
        lib.xfa_request_admit.argtypes = [vp] + [i32] * 3
        lib.xfa_request_extend.restype = i32
        lib.xfa_request_extend.argtypes = [vp, i32, i32]
        lib.xfa_request_truncate.restype = i32
        lib.xfa_request_truncate.argtypes = [vp, i32, i32]
        lib.xfa_request_retire.restype = None
        lib.xfa_request_retire.argtypes = [vp, i32]
        lib.xfa_request_seq_len.restype = i32
        lib.xfa_request_seq_len.argtypes = [vp, i32]
        lib.xfa_build_block_tables.restype = i32
        lib.xfa_build_block_tables.argtypes = [vp, p32, i32, p32]
        _lib = lib
        return _lib


class _PyPool:
    """Pure-Python allocator with the native one's semantics."""

    def __init__(self, num_pages: int, page_size: int, max_requests: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free_list = list(range(num_pages - 1, -1, -1))
        self.slots = [None] * max_requests  # [id, seq_len, pages]

    def admit(self, rid, prompt_len, target_len):
        try:
            slot = self.slots.index(None)
        except ValueError:
            return -1
        need = -(-prompt_len // self.page_size)
        if len(self.free_list) < need:
            return -1
        pages = [self.free_list.pop() for _ in range(need)]
        self.slots[slot] = [rid, prompt_len, pages]
        return slot

    def extend(self, slot, n_tokens):
        ent = self.slots[slot]
        if ent is None:
            return -1
        need = -(-(ent[1] + n_tokens) // self.page_size) - len(ent[2])
        if need > len(self.free_list):
            return -1
        for _ in range(need):
            ent[2].append(self.free_list.pop())
        ent[1] += n_tokens
        return ent[1]

    def truncate(self, slot, new_len):
        ent = self.slots[slot]
        if ent is None or new_len < 0:
            return -1
        if new_len >= ent[1]:
            return ent[1]
        keep = -(-new_len // self.page_size)
        while len(ent[2]) > keep:
            self.free_list.append(ent[2].pop())
        ent[1] = new_len
        return ent[1]

    def retire(self, slot):
        ent = self.slots[slot]
        if ent is not None:
            self.free_list.extend(ent[2])
            self.slots[slot] = None


class PagePool:
    """KV page pool + request table. backend="native" (the default) runs
    the C++ allocator and raises when it cannot be built; "python" runs the
    pure-Python copy. Shared-prefix pages (the JAX package's prefix_alloc)
    wait for the port's prefix sharing."""

    def __init__(self, num_pages: int, page_size: int, max_requests: int,
                 backend: str = "native"):
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_requests = max_requests
        if backend == "native":
            self._lib = _build()
            self._h = self._lib.xfa_pool_create(num_pages, page_size, max_requests)
            self._py = None
        elif backend == "python":
            self._lib = self._h = None
            self._py = _PyPool(num_pages, page_size, max_requests)
        else:
            raise ValueError(f"backend must be 'native' or 'python', got {backend!r}")

    @property
    def native(self) -> bool:
        return self._lib is not None

    def close(self) -> None:
        if self._lib is not None and self._h:
            self._lib.xfa_pool_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_lib", None) is not None:
            self.close()

    def free_pages(self) -> int:
        if self._lib:
            return self._lib.xfa_pool_free_pages(self._h)
        return len(self._py.free_list)

    def admit(self, request_id: int, prompt_len: int, target_len: int) -> int:
        if self._lib:
            return self._lib.xfa_request_admit(self._h, request_id, prompt_len, target_len)
        return self._py.admit(request_id, prompt_len, target_len)

    def extend(self, slot: int, n_tokens: int = 1) -> int:
        if self._lib:
            return self._lib.xfa_request_extend(self._h, slot, n_tokens)
        return self._py.extend(slot, n_tokens)

    def truncate(self, slot: int, new_len: int) -> int:
        """Shrink a sequence; frees pages past the new length. Returns the
        new seq_len."""
        if self._lib:
            return self._lib.xfa_request_truncate(self._h, slot, new_len)
        return self._py.truncate(slot, new_len)

    def retire(self, slot: int) -> None:
        if self._lib:
            self._lib.xfa_request_retire(self._h, slot)
        else:
            self._py.retire(slot)

    def seq_len(self, slot: int) -> int:
        if self._lib:
            return self._lib.xfa_request_seq_len(self._h, slot)
        ent = self._py.slots[slot]
        return ent[1] if ent else -1

    def build_block_tables(self, max_pages: int):
        """Returns (block_tables (max_requests, max_pages) int32,
        seq_lens (max_requests,) int32, n_active)."""
        bt = np.zeros((self.max_requests, max_pages), np.int32)
        sl = np.zeros((self.max_requests,), np.int32)
        if self._lib:
            n = self._lib.xfa_build_block_tables(
                self._h,
                bt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                max_pages,
                sl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            return bt, sl, n
        n = 0
        for s, ent in enumerate(self._py.slots):
            if ent is None:
                continue
            pages = ent[2][:max_pages]
            bt[s, : len(pages)] = pages
            sl[s] = ent[1]
            n += 1
        return bt, sl, n
