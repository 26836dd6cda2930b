"""ctypes binding for the native C++ page allocator (the package's own
csrc/page_allocator.cpp).

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
from typing import List, Optional

import numpy as np

from xf_flash_attention_cutlass_tpu_torch._build import BUILD_DIR, CSRC_DIR

_SRC = os.path.join(CSRC_DIR, "page_allocator.cpp")
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
        lib.xfa_request_admit_prefixed.restype = i32
        lib.xfa_request_admit_prefixed.argtypes = [vp] + [i32] * 4
        lib.xfa_prefix_alloc.restype = i32
        lib.xfa_prefix_alloc.argtypes = [vp, i32, p32]
        lib.xfa_prefix_free.restype = None
        lib.xfa_prefix_free.argtypes = [vp, p32, i32]
        lib.xfa_request_shared_pages.restype = i32
        lib.xfa_request_shared_pages.argtypes = [vp, i32]
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
        lib.xfa_pool_snapshot_size.restype = i32
        lib.xfa_pool_snapshot_size.argtypes = [vp]
        lib.xfa_pool_snapshot.restype = i32
        lib.xfa_pool_snapshot.argtypes = [vp, p32, i32]
        lib.xfa_pool_restore.restype = i32
        lib.xfa_pool_restore.argtypes = [vp, p32, i32]
        _lib = lib
        return _lib


class _PyPool:
    """Pure-Python allocator with the native one's semantics."""

    def __init__(self, num_pages: int, page_size: int, max_requests: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free_list = list(range(num_pages - 1, -1, -1))
        self.slots = [None] * max_requests  # [id, seq_len, pages, shared_pages]

    def admit(self, rid, prompt_len, target_len, shared_pages=0):
        if shared_pages < 0 or prompt_len < shared_pages * self.page_size:
            return -1
        try:
            slot = self.slots.index(None)
        except ValueError:
            return -1
        need = max(-(-prompt_len // self.page_size) - shared_pages, 0)
        if len(self.free_list) < need:
            return -1
        pages = [self.free_list.pop() for _ in range(need)]
        self.slots[slot] = [rid, prompt_len, pages, shared_pages]
        return slot

    def prefix_alloc(self, n_pages):
        if n_pages < 0 or len(self.free_list) < n_pages:
            return None
        return [self.free_list.pop() for _ in range(n_pages)]

    def prefix_free(self, pages):
        self.free_list.extend(pages)

    def extend(self, slot, n_tokens):
        ent = self.slots[slot]
        if ent is None:
            return -1
        need = -(-(ent[1] + n_tokens) // self.page_size) - ent[3] - len(ent[2])
        if need > len(self.free_list):
            return -1
        for _ in range(need):
            ent[2].append(self.free_list.pop())
        ent[1] += n_tokens
        return ent[1]

    def truncate(self, slot, new_len):
        ent = self.slots[slot]
        if ent is None or new_len < ent[3] * self.page_size:
            return -1
        if new_len >= ent[1]:
            return ent[1]
        keep = max(-(-new_len // self.page_size) - ent[3], 0)
        while len(ent[2]) > keep:
            self.free_list.append(ent[2].pop())
        ent[1] = new_len
        return ent[1]

    def retire(self, slot):
        ent = self.slots[slot]
        if ent is not None:
            self.free_list.extend(ent[2])
            self.slots[slot] = None

    def snapshot(self) -> np.ndarray:
        """The native snapshot's int32 words: geometry, the free list, then
        per slot (active, id, seq_len, target_len, shared_pages, n_pages,
        pages...); the copy keeps no target length and writes 0."""
        words = [self.num_pages, self.page_size, len(self.slots),
                 len(self.free_list)] + list(self.free_list)
        for ent in self.slots:
            if ent is None:
                words += [0, -1, 0, 0, 0, 0]
            else:
                words += [1, ent[0], ent[1], 0, ent[3], len(ent[2])] + list(ent[2])
        return np.asarray(words, np.int32)

    def restore(self, words) -> None:
        w = np.asarray(words, np.int32).tolist()
        if w[:3] != [self.num_pages, self.page_size, len(self.slots)]:
            raise ValueError("allocator snapshot geometry mismatch")
        r = 4 + w[3]
        self.free_list = w[4:r]
        for s in range(len(self.slots)):
            active, rid, seq_len, _target, shared, n_pg = w[r : r + 6]
            pages = w[r + 6 : r + 6 + n_pg]
            r += 6 + n_pg
            self.slots[s] = [rid, seq_len, pages, shared] if active else None


class PagePool:
    """KV page pool + request table. backend="native" (the default) runs
    the C++ allocator and raises when it cannot be built; "python" runs the
    pure-Python copy. A shared prefix's pages (prefix_alloc) belong to the
    caller until prefix_free; a request admitted with admit_prefixed owns
    only the pages past them, and its block-table row leaves the first
    shared_pages entries for the caller to fill."""

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

    def admit_prefixed(self, request_id: int, shared_pages: int, prompt_len: int,
                       target_len: int) -> int:
        """Admit with the first `shared_pages` logical pages provided by a
        shared prefix (see prefix_alloc); prompt_len counts the prefix's
        tokens too. Only the pages past the shared region are owned."""
        if self._lib:
            return self._lib.xfa_request_admit_prefixed(self._h, request_id, shared_pages,
                                                        prompt_len, target_len)
        return self._py.admit(request_id, prompt_len, target_len, shared_pages=shared_pages)

    def prefix_alloc(self, n_pages: int) -> Optional[List[int]]:
        """Reserve pages for a shared prefix: their ids, or None when the
        pool cannot supply them. Freed only by prefix_free."""
        if self._lib:
            buf = np.zeros((max(n_pages, 1),), np.int32)
            rc = self._lib.xfa_prefix_alloc(
                self._h, n_pages, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return buf[:n_pages].tolist() if rc == 0 else None
        return self._py.prefix_alloc(n_pages)

    def prefix_free(self, pages) -> None:
        """Return a prefix's pages; no live request may still read them."""
        if self._lib:
            buf = np.ascontiguousarray(np.asarray(pages, np.int32))
            self._lib.xfa_prefix_free(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(buf))
        else:
            self._py.prefix_free(list(pages))

    def shared_pages(self, slot: int) -> int:
        """The shared-prefix pages of a slot's request; -1 when inactive."""
        if self._lib:
            return self._lib.xfa_request_shared_pages(self._h, slot)
        ent = self._py.slots[slot]
        return ent[3] if ent else -1

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

    def snapshot(self) -> np.ndarray:
        """The allocator's state (free list, per-slot page maps) as an int32
        vector, the layout of csrc/page_allocator.cpp's xfa_pool_snapshot:
        what an engine checkpoint saves."""
        if self._lib:
            n = self._lib.xfa_pool_snapshot_size(self._h)
            buf = np.zeros((n,), np.int32)
            wrote = self._lib.xfa_pool_snapshot(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
            if wrote < 0:
                raise RuntimeError("allocator snapshot failed")
            return buf[:wrote]
        return self._py.snapshot()

    def restore(self, words: np.ndarray) -> None:
        """Restore a snapshot into a pool of the same geometry; raises
        ValueError on another geometry or malformed words."""
        buf = np.ascontiguousarray(np.asarray(words, np.int32))
        if self._lib:
            rc = self._lib.xfa_pool_restore(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(buf))
            if rc != 0:
                raise ValueError("allocator snapshot geometry mismatch")
        else:
            self._py.restore(buf)

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
            off = min(ent[3], max_pages)  # own pages land after the shared region
            pages = ent[2][: max(max_pages - off, 0)]
            bt[s, off : off + len(pages)] = pages
            sl[s] = ent[1]
            n += 1
        return bt, sl, n


class DpPagePools:
    """dp independent PagePools behind one global-slot interface: the
    allocator of a data-parallel engine (serve/engine.py with a dp > 1
    mesh). Each replica owns a disjoint slice of the batch slots and of the
    page pool: global slot r * mb_local + s is local slot s of replica r,
    and every page id handed out is LOCAL to its replica's pool shard. Every
    rank runs the same operations on its own copy, so all ranks hold the
    same state. Admission goes to the replica with the most free pages
    first."""

    def __init__(self, dp: int, num_pages_local: int, page_size: int,
                 max_requests_local: int, backend: str = "native"):
        self.dp = dp
        self.mb_local = max_requests_local
        self.pools = [PagePool(num_pages_local, page_size, max_requests_local, backend)
                      for _ in range(dp)]

    @property
    def native(self) -> bool:
        return all(p.native for p in self.pools)

    def _split(self, slot: int):
        return self.pools[slot // self.mb_local], slot % self.mb_local

    def free_pages(self) -> int:
        return sum(p.free_pages() for p in self.pools)

    def admit_replica(self, replica: int, request_id: int, prompt_len: int,
                      target_len: int) -> int:
        s = self.pools[replica].admit(request_id, prompt_len, target_len)
        return -1 if s < 0 else replica * self.mb_local + s

    def admit(self, request_id: int, prompt_len: int, target_len: int) -> int:
        # the least-loaded replica first (a stable sort: ties go to the lower one)
        for r in sorted(range(self.dp), key=lambda r: -self.pools[r].free_pages()):
            s = self.admit_replica(r, request_id, prompt_len, target_len)
            if s >= 0:
                return s
        return -1

    def admit_prefixed_replica(self, replica: int, request_id: int, shared_pages: int,
                               prompt_len: int, target_len: int) -> int:
        s = self.pools[replica].admit_prefixed(request_id, shared_pages, prompt_len, target_len)
        return -1 if s < 0 else replica * self.mb_local + s

    def prefix_alloc_all(self, n_pages: int) -> Optional[List[List[int]]]:
        """Reserve n_pages prefix pages in EVERY replica's pool (the prefix
        KV is replicated into each replica, so any replica's requests read
        it through local page ids). Returns dp lists of page ids, or None
        when a replica lacks room; all or nothing: the reservations made
        before the failure are returned."""
        out = []
        for p in self.pools:
            pages = p.prefix_alloc(n_pages)
            if pages is None:
                for q, done in zip(self.pools, out):
                    q.prefix_free(done)
                return None
            out.append(pages)
        return out

    def prefix_free_all(self, pages_by_replica) -> None:
        for p, pages in zip(self.pools, pages_by_replica):
            if pages:
                p.prefix_free(pages)

    def extend(self, slot: int, n_tokens: int = 1) -> int:
        p, s = self._split(slot)
        return p.extend(s, n_tokens)

    def truncate(self, slot: int, new_len: int) -> int:
        p, s = self._split(slot)
        return p.truncate(s, new_len)

    def retire(self, slot: int) -> None:
        p, s = self._split(slot)
        p.retire(s)

    def seq_len(self, slot: int) -> int:
        p, s = self._split(slot)
        return p.seq_len(s)

    def build_block_tables(self, max_pages: int):
        """Global (dp * mb_local, max_pages) tables of replica-local page
        ids, the lengths and the number of active requests."""
        bts, lens, n_active = [], [], 0
        for p in self.pools:
            bt, kv, n = p.build_block_tables(max_pages)
            bts.append(bt)
            lens.append(kv)
            n_active += int(n)
        return np.concatenate(bts), np.concatenate(lens), n_active

    def snapshot(self) -> np.ndarray:
        """The replicas' snapshots in the JAX package's words: a (dp, n + 1)
        int64 array, row r holding replica r's word count and its words
        (zero-padded to the longest), flattened."""
        parts = [p.snapshot() for p in self.pools]
        n = max(len(x) for x in parts)
        out = np.zeros((self.dp, n + 1), np.int64)
        for r, x in enumerate(parts):
            out[r, 0] = len(x)
            out[r, 1 : 1 + len(x)] = x
        return out.reshape(-1)

    def restore(self, words: np.ndarray) -> None:
        words = np.asarray(words, np.int64).reshape(self.dp, -1)
        for r, row in enumerate(words):
            self.pools[r].restore(row[1 : 1 + int(row[0])])
