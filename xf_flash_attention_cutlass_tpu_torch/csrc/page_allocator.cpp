// KV-cache page allocator + request/block-table manager (C ABI), the port's
// own copy of the JAX package's allocator source (the same code).
//
// The native runtime tier of the serving engine: in a continuous-batching
// server the cache bookkeeping (admission, per-step page growth,
// retirement, shared prefix pages) is the hot control path, so it lives
// here in C++, off the Python hot loop.
//
// Exposed via a plain C ABI (serve/allocator.py binds with ctypes and
// compiles this file with g++ on first use). All functions are
// thread-compatible but not thread-safe: the engine serializes calls.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Request {
  int32_t id = -1;
  int32_t seq_len = 0;       // tokens currently in cache (incl. shared prefix)
  int32_t target_len = 0;    // generation stops at this length (bookkeeping)
  // logical pages [0, shared_pages) belong to a shared prefix (allocated via
  // xfa_prefix_alloc, filled into the block table by the engine) and are
  // neither owned nor freed by this request
  int32_t shared_pages = 0;
  std::vector<int32_t> pages;  // OWN physical page ids, logical order
  bool active = false;
};

struct Pool {
  int32_t num_pages;
  int32_t page_size;
  int32_t max_requests;
  std::vector<int32_t> free_list;  // stack of free physical pages
  std::vector<Request> requests;   // slot-indexed
  int64_t alloc_count = 0;         // lifetime stats
  int64_t free_count = 0;
};

int32_t pages_needed(const Pool& p, int32_t tokens) {
  return (tokens + p.page_size - 1) / p.page_size;
}

}  // namespace

extern "C" {

// Create a pool of `num_pages` pages of `page_size` tokens with
// `max_requests` request slots. Returns an opaque handle.
void* xfa_pool_create(int32_t num_pages, int32_t page_size,
                      int32_t max_requests) {
  if (num_pages <= 0 || page_size <= 0 || max_requests <= 0) return nullptr;
  Pool* p = new Pool();
  p->num_pages = num_pages;
  p->page_size = page_size;
  p->max_requests = max_requests;
  p->free_list.reserve(num_pages);
  // LIFO: low page ids come off the stack first -> sequential workloads
  // get mostly-contiguous page runs (friendlier DMA patterns)
  for (int32_t i = num_pages - 1; i >= 0; --i) p->free_list.push_back(i);
  p->requests.resize(max_requests);
  return p;
}

void xfa_pool_destroy(void* h) { delete static_cast<Pool*>(h); }

int32_t xfa_pool_free_pages(void* h) {
  return static_cast<int32_t>(static_cast<Pool*>(h)->free_list.size());
}

int32_t xfa_pool_page_size(void* h) {
  return static_cast<Pool*>(h)->page_size;
}

// Admit a request with `prompt_len` tokens, growing to at most
// `target_len`. Reserves pages for the prompt only (decode grows lazily).
// Returns the slot id, or -1 if no slot / insufficient pages.
int32_t xfa_request_admit(void* h, int32_t request_id, int32_t prompt_len,
                          int32_t target_len) {
  Pool* p = static_cast<Pool*>(h);
  int32_t slot = -1;
  for (int32_t i = 0; i < p->max_requests; ++i) {
    if (!p->requests[i].active) { slot = i; break; }
  }
  if (slot < 0) return -1;
  int32_t need = pages_needed(*p, prompt_len);
  if (static_cast<int32_t>(p->free_list.size()) < need) return -1;
  Request& r = p->requests[slot];
  r.id = request_id;
  r.seq_len = prompt_len;
  r.target_len = target_len;
  r.shared_pages = 0;
  r.active = true;
  r.pages.clear();
  for (int32_t i = 0; i < need; ++i) {
    r.pages.push_back(p->free_list.back());
    p->free_list.pop_back();
    p->alloc_count++;
  }
  return slot;
}

// Admit a request whose first `shared_pages` logical pages are a shared
// prefix (prefix-cached system prompt): only pages past the shared region
// are allocated. `prompt_len` counts ALL tokens incl. the shared prefix and
// must cover it (prompt_len >= shared_pages * page_size). The engine writes
// the prefix's physical page ids into the block-table row's first
// `shared_pages` entries after xfa_build_block_tables.
int32_t xfa_request_admit_prefixed(void* h, int32_t request_id,
                                   int32_t shared_pages, int32_t prompt_len,
                                   int32_t target_len) {
  Pool* p = static_cast<Pool*>(h);
  if (shared_pages < 0 ||
      prompt_len < shared_pages * p->page_size)
    return -1;
  int32_t slot = -1;
  for (int32_t i = 0; i < p->max_requests; ++i) {
    if (!p->requests[i].active) { slot = i; break; }
  }
  if (slot < 0) return -1;
  int32_t need = pages_needed(*p, prompt_len) - shared_pages;
  if (need < 0) need = 0;
  if (static_cast<int32_t>(p->free_list.size()) < need) return -1;
  Request& r = p->requests[slot];
  r.id = request_id;
  r.seq_len = prompt_len;
  r.target_len = target_len;
  r.shared_pages = shared_pages;
  r.active = true;
  r.pages.clear();
  for (int32_t i = 0; i < need; ++i) {
    r.pages.push_back(p->free_list.back());
    p->free_list.pop_back();
    p->alloc_count++;
  }
  return slot;
}

// Reserve `n_pages` pages for a shared prefix, written to `out`. The pages
// are owned by the caller (engine) until xfa_prefix_free. Returns 0, or -1
// if the pool cannot supply them.
int32_t xfa_prefix_alloc(void* h, int32_t n_pages, int32_t* out) {
  Pool* p = static_cast<Pool*>(h);
  if (n_pages < 0 ||
      static_cast<int32_t>(p->free_list.size()) < n_pages)
    return -1;
  for (int32_t i = 0; i < n_pages; ++i) {
    out[i] = p->free_list.back();
    p->free_list.pop_back();
    p->alloc_count++;
  }
  return 0;
}

// Return prefix pages to the pool (caller guarantees no live request still
// references them).
void xfa_prefix_free(void* h, const int32_t* pages, int32_t n_pages) {
  Pool* p = static_cast<Pool*>(h);
  for (int32_t i = 0; i < n_pages; ++i) {
    p->free_list.push_back(pages[i]);
    p->free_count++;
  }
}

int32_t xfa_request_shared_pages(void* h, int32_t slot) {
  Pool* p = static_cast<Pool*>(h);
  if (slot < 0 || slot >= p->max_requests) return -1;
  return p->requests[slot].active ? p->requests[slot].shared_pages : -1;
}

// Grow `slot` by `n_tokens` (decode step / appended chunk), allocating
// pages as the sequence crosses page boundaries. Returns the new seq_len,
// or -1 on OOM (caller should preempt / retry after retirement).
int32_t xfa_request_extend(void* h, int32_t slot, int32_t n_tokens) {
  Pool* p = static_cast<Pool*>(h);
  if (slot < 0 || slot >= p->max_requests) return -1;
  Request& r = p->requests[slot];
  if (!r.active) return -1;
  int32_t need = pages_needed(*p, r.seq_len + n_tokens) - r.shared_pages -
                 static_cast<int32_t>(r.pages.size());
  if (need > static_cast<int32_t>(p->free_list.size())) return -1;
  for (int32_t i = 0; i < need; ++i) {
    r.pages.push_back(p->free_list.back());
    p->free_list.pop_back();
    p->alloc_count++;
  }
  r.seq_len += n_tokens;
  return r.seq_len;
}

// Shrink `slot` to `new_len` tokens (speculative-decode rollback: pages
// holding only rejected-draft KV return to the pool). No-op if new_len is
// not smaller. Returns the new seq_len, or -1 on a bad slot.
int32_t xfa_request_truncate(void* h, int32_t slot, int32_t new_len) {
  Pool* p = static_cast<Pool*>(h);
  if (slot < 0 || slot >= p->max_requests) return -1;
  Request& r = p->requests[slot];
  if (!r.active) return -1;
  if (new_len < r.shared_pages * p->page_size) return -1;
  if (new_len >= r.seq_len) return r.seq_len;
  int32_t keep_own = pages_needed(*p, new_len) - r.shared_pages;
  if (keep_own < 0) keep_own = 0;
  while (static_cast<int32_t>(r.pages.size()) > keep_own) {
    p->free_list.push_back(r.pages.back());
    r.pages.pop_back();
    p->free_count++;
  }
  r.seq_len = new_len;
  return r.seq_len;
}

// Retire a request, returning its pages to the pool.
void xfa_request_retire(void* h, int32_t slot) {
  Pool* p = static_cast<Pool*>(h);
  if (slot < 0 || slot >= p->max_requests) return;
  Request& r = p->requests[slot];
  if (!r.active) return;
  for (int32_t pg : r.pages) {
    p->free_list.push_back(pg);
    p->free_count++;
  }
  r.pages.clear();
  r.active = false;
  r.id = -1;
  r.seq_len = 0;
  r.shared_pages = 0;
}

int32_t xfa_request_seq_len(void* h, int32_t slot) {
  Pool* p = static_cast<Pool*>(h);
  if (slot < 0 || slot >= p->max_requests) return -1;
  return p->requests[slot].active ? p->requests[slot].seq_len : -1;
}

int32_t xfa_request_id(void* h, int32_t slot) {
  Pool* p = static_cast<Pool*>(h);
  if (slot < 0 || slot >= p->max_requests) return -1;
  return p->requests[slot].active ? p->requests[slot].id : -1;
}

// Fill the caller's (max_requests, max_pages) int32 row-major block-table
// buffer and the (max_requests,) seq-len buffer for every slot. Inactive
// slots get seq_len 0 and page 0 entries (the kernel masks by length).
// Returns the number of active slots.
int32_t xfa_build_block_tables(void* h, int32_t* block_tables,
                               int32_t max_pages, int32_t* seq_lens) {
  Pool* p = static_cast<Pool*>(h);
  int32_t active = 0;
  for (int32_t s = 0; s < p->max_requests; ++s) {
    const Request& r = p->requests[s];
    int32_t* row = block_tables + static_cast<int64_t>(s) * max_pages;
    std::memset(row, 0, sizeof(int32_t) * max_pages);
    if (r.active) {
      // own pages land after the shared-prefix region; the engine fills
      // rows [0, shared_pages) with the prefix's physical pages
      int32_t off = r.shared_pages < max_pages ? r.shared_pages : max_pages;
      int32_t n = static_cast<int32_t>(r.pages.size());
      if (n > max_pages - off) n = max_pages - off;
      if (n > 0) std::memcpy(row + off, r.pages.data(), sizeof(int32_t) * n);
      seq_lens[s] = r.seq_len;
      active++;
    } else {
      seq_lens[s] = 0;
    }
  }
  return active;
}

int64_t xfa_pool_alloc_count(void* h) {
  return static_cast<Pool*>(h)->alloc_count;
}

// ---- snapshot / restore (engine checkpointing) ------------------------
//
// Serialized layout (int32 words):
//   [num_pages, page_size, max_requests, n_free, free_list...,
//    per slot: active, id, seq_len, target_len, shared_pages, n_pages,
//    pages...]

int32_t xfa_pool_snapshot_size(void* h) {
  Pool* p = static_cast<Pool*>(h);
  int32_t words = 4 + static_cast<int32_t>(p->free_list.size());
  for (const Request& r : p->requests)
    words += 6 + static_cast<int32_t>(r.pages.size());
  return words;
}

// Writes the snapshot into `buf` (capacity `cap` words). Returns the number
// of words written, or -1 if the buffer is too small.
int32_t xfa_pool_snapshot(void* h, int32_t* buf, int32_t cap) {
  Pool* p = static_cast<Pool*>(h);
  if (cap < xfa_pool_snapshot_size(h)) return -1;
  int32_t* w = buf;
  *w++ = p->num_pages;
  *w++ = p->page_size;
  *w++ = p->max_requests;
  *w++ = static_cast<int32_t>(p->free_list.size());
  for (int32_t pg : p->free_list) *w++ = pg;
  for (const Request& r : p->requests) {
    *w++ = r.active ? 1 : 0;
    *w++ = r.id;
    *w++ = r.seq_len;
    *w++ = r.target_len;
    *w++ = r.shared_pages;
    *w++ = static_cast<int32_t>(r.pages.size());
    for (int32_t pg : r.pages) *w++ = pg;
  }
  return static_cast<int32_t>(w - buf);
}

// Restores a snapshot into an existing pool with matching geometry.
// Returns 0 on success, -1 on malformed input or geometry mismatch.
int32_t xfa_pool_restore(void* h, const int32_t* buf, int32_t n) {
  Pool* p = static_cast<Pool*>(h);
  if (n < 4) return -1;
  const int32_t* r = buf;
  const int32_t* end = buf + n;
  if (r[0] != p->num_pages || r[1] != p->page_size ||
      r[2] != p->max_requests)
    return -1;
  int32_t n_free = r[3];
  r += 4;
  if (n_free < 0 || r + n_free > end) return -1;
  std::vector<int32_t> free_list(r, r + n_free);
  r += n_free;
  std::vector<Request> requests(p->max_requests);
  for (int32_t s = 0; s < p->max_requests; ++s) {
    if (r + 6 > end) return -1;
    Request& q = requests[s];
    q.active = r[0] != 0;
    q.id = r[1];
    q.seq_len = r[2];
    q.target_len = r[3];
    q.shared_pages = r[4];
    int32_t np = r[5];
    r += 6;
    if (np < 0 || r + np > end) return -1;
    q.pages.assign(r, r + np);
    r += np;
  }
  p->free_list = std::move(free_list);
  p->requests = std::move(requests);
  return 0;
}

}  // extern "C"
