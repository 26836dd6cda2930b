"""Continuous-batching decode engine over the paged KV cache, with chunked
prefill, on one device.

Host-side scheduling (admission, per-step page growth, retirement, OOM
preemption) follows the JAX package's serve/engine.py step for step, and the
page allocator is the same C++ one, so for the same requests both engines
assign the same pages. Each engine step runs at most one prefill chunk
(``prefill_chunk_core``) and then one batched decode step (``decode_core``,
the L = 1 case of ``verify_core``), each a Python loop over the layers.

KV pools are ``(L, num_pages + 1, h_k, page, d)`` — the extra page is the
trash page that inactive batch rows and padded chunk tails write to — with
f32 per-token scales ``(L, num_pages + 1, h_k, page)`` for int8 / fp8 pools.
They are stored tight (no TPU sublane or lane padding) and updated IN PLACE
by the append kernel: the counterpart of the JAX package's pool donation.

Cache protocol: the allocator's seq_len counts the tokens whose KV is in
the cache after the upcoming step. A decode step consumes the previously
sampled token, appends its KV at position seq_len - 1 and attends over
seq_len keys.

What this slice does not serve raises NotImplementedError: bucketed
(whole-prompt) prefill, speculative decoding, multi-step windows, shared
prefixes, sampling (temperature, top-k, top-p), meshes and MoE models.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    _proj,
    layer_view,
    mlp_block,
    pack_params_for_decode,
    rms_norm,
)
from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention
from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import paged_append
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import apply_rotary, rotary_frequencies
from xf_flash_attention_cutlass_tpu_torch.quant.kv import resolve_quant
from xf_flash_attention_cutlass_tpu_torch.serve.allocator import PagePool
from xf_flash_attention_cutlass_tpu_torch.utils import cdiv, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX package's EngineConfig, field for field. This slice serves
    prefill_chunk set, speculate_k <= 1, multi_step <= 1 and no top_k /
    top_p; DecodeEngine raises NotImplementedError for the rest."""

    max_batch: int = 8
    page_size: int = 256
    num_pages: int = 512
    max_seq: int = 4096
    kv_quant: Optional[str] = None  # None | "int8" | "fp8_e4m3"
    eos_token: int = -1  # -1: never stop on a token
    prefill_chunk: Optional[int] = None
    prefill_lanes: int = 1
    speculate_k: int = 0
    spec_ngram: int = 3
    top_k: int = 0
    top_p: float = 0.0
    sample_seed: int = 0
    approx_top_k: bool = True
    multi_step: int = 1
    pack_small_pages: bool = True

    @property
    def max_pages_per_seq(self) -> int:
        return cdiv(self.max_seq, self.page_size)


def effective_engine_config(ecfg: EngineConfig) -> EngineConfig:
    """Resolve the config the engine serves with, as the JAX package does:
    quantized pools at page sizes below 32 (dividing 32) are served with a
    32-token page and num_pages scaled down to match, so that both engines
    allocate the same pages for the same requests."""
    if (
        ecfg.kv_quant
        and ecfg.pack_small_pages
        and ecfg.page_size < 32
        and 32 % ecfg.page_size == 0
    ):
        factor = 32 // ecfg.page_size
        if ecfg.num_pages % factor:
            raise ValueError(
                f"pack_small_pages: num_pages={ecfg.num_pages} must be a "
                f"multiple of {factor} (pages per 32-row tile at "
                f"page_size={ecfg.page_size})"
            )
        ecfg = dataclasses.replace(ecfg, page_size=32, num_pages=ecfg.num_pages // factor)
    return ecfg


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next-token selection: argmax over the vocabulary, the first
    index on ties. (b, V) f32 -> (b,) int64."""
    return torch.argmax(logits, dim=-1)


def _attn_qkv(layer, x, cfg: LlamaConfig, cos, sin, positions):
    """norm -> qkv proj -> rotary; shared by prefill and decode."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    h = rms_norm(x, layer["attn_norm"], cfg.rms_eps)
    q = _proj(h, layer["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = _proj(h, layer["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = _proj(h, layer["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rotary(q, cos, sin, positions, cfg.rotary_interleaved)
    k = apply_rotary(k, cos, sin, positions, cfg.rotary_interleaved)
    return q, k, v


def _attention_layers(params, x, pools, bt, kv_lens, append_pos, positions, cfg):
    """The layer loop shared by verify/decode and chunked prefill: per
    layer, append the new tokens' KV into the pools in place, then attend
    over the paged cache (causal from the bottom right), project and run
    the MLP. Returns the final-normed hidden states."""
    b, s, _ = x.shape
    cos, sin = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base, device=x.device)
    quant = "k_s" in pools
    scales = dict(k_scales=pools["k_s"], v_scales=pools["v_s"]) if quant else {}
    for l in range(pools["k"].shape[0]):
        layer = layer_view(params["layers"], l)
        q, k_new, v_new = _attn_qkv(layer, x, cfg, cos, sin, positions)
        paged_append(pools["k"], pools["v"], k_new, v_new, bt, append_pos, layer_idx=l, **scales)
        o, _ = paged_attention(q, pools["k"], pools["v"], bt, kv_lens, causal=True,
                               layer_idx=l, **scales)
        x = x + _proj(o.reshape(b, s, cfg.n_heads * cfg.head_dim), layer["wo"])
        x = mlp_block(layer, x, cfg)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def verify_core(
    params,
    tokens: torch.Tensor,  # (b, L) — [last_sampled, draft_1, ..., draft_{L-1}]
    pools: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,  # (b, max_pages)
    kv_lens: torch.Tensor,  # (b,) — seq length AFTER this step (cur + L)
    cfg: LlamaConfig,
) -> torch.Tensor:
    """One batched multi-token step: appends all L input tokens' KV (in
    place) and returns logits at every position, (b, L, vocab) f32.

    Inactive slots (kv_len 0) must have block-table rows pointing at the
    trash page, so that their clamped write position 0 cannot corrupt live
    pages."""
    b, L = tokens.shape
    x = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)]
    append_pos = (kv_lens - L).clamp_min(0)
    positions = append_pos[:, None] + torch.arange(L, device=tokens.device)[None]
    x = _attention_layers(params, x, pools, block_tables, kv_lens, append_pos, positions, cfg)
    logits = _proj(x.reshape(b * L, -1), params["lm_head"])
    return logits.reshape(b, L, -1).float()


def decode_core(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig):
    """One batched decode step = the L = 1 case of verify_core, plus greedy
    sampling. Returns (next_tokens (b,), logits (b, vocab))."""
    logits = verify_core(params, tokens, pools, block_tables, kv_lens, cfg)[:, 0]
    return sample_tokens(logits), logits


def prefill_chunk_core(
    params,
    tokens: torch.Tensor,  # (P, C) — one fixed-size chunk per prompt lane
    n_prior: torch.Tensor,  # (P,) tokens already in the cache per lane
    n_valid: torch.Tensor,  # (P,) valid tokens per chunk row (0 = idle lane)
    pools: Dict[str, torch.Tensor],
    bt: torch.Tensor,  # (P, max_pages) per-lane block table incl. trash tail
    cfg: LlamaConfig,
) -> torch.Tensor:
    """One step of incremental prefill for P prompts: append each lane's
    chunk KV into its pages (in place), then paged attention of the chunk
    queries over cache[0 : n_prior + C]. Padded tail positions and idle
    lanes write KV that nothing attends to. Returns the logits of each
    lane's last valid token, (P, vocab) f32."""
    P, C = tokens.shape
    x = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)]
    positions = n_prior[:, None] + torch.arange(C, device=tokens.device)[None]
    x = _attention_layers(params, x, pools, bt, n_prior + C, n_prior, positions, cfg)
    last = (n_valid - 1).clamp_min(0)
    x_last = x[torch.arange(P, device=x.device), last]
    return _proj(x_last, params["lm_head"]).float()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


class DecodeEngine:
    """Continuous batching: admit, chunked prefill, batched decode, retire."""

    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        ecfg: EngineConfig,
        dtype: torch.dtype = torch.bfloat16,
        device=None,  # None: CUDA, raising when it is absent
        mesh=None,
    ):
        _check_served(params, ecfg, mesh)
        self.device = resolve_device(device)
        # decode and prefill read every projection through the stacked
        # matmul (the same buffers, no copies)
        self.params = pack_params_for_decode(_to_device(params, self.device))
        self.cfg = cfg
        ecfg = effective_engine_config(ecfg)
        self.ecfg = ecfg
        self.pool = PagePool(ecfg.num_pages, ecfg.page_size, ecfg.max_batch)
        self.trash_page = ecfg.num_pages
        if (
            ecfg.kv_quant
            and ecfg.page_size % 128 == 0
            and ecfg.prefill_chunk % 128
        ):
            # kept from the JAX package so both engines accept the same
            # configs (its TPU append writes 128-lane-aligned scale windows)
            raise ValueError(
                f"kv_quant with page_size={ecfg.page_size} needs "
                f"prefill_chunk to be a multiple of 128 (got "
                f"{ecfg.prefill_chunk}): quantized prefill appends "
                "write 128-lane-aligned scale windows"
            )
        shape = (cfg.n_layers, ecfg.num_pages + 1, cfg.n_kv_heads, ecfg.page_size, cfg.head_dim)
        if ecfg.kv_quant:
            vdt, _ = resolve_quant(ecfg.kv_quant)
            self.pools = dict(
                k=torch.zeros(shape, dtype=vdt, device=self.device),
                v=torch.zeros(shape, dtype=vdt, device=self.device),
                k_s=torch.zeros(shape[:-1], dtype=torch.float32, device=self.device),
                v_s=torch.zeros(shape[:-1], dtype=torch.float32, device=self.device),
            )
        else:
            self.pools = dict(
                k=torch.zeros(shape, dtype=dtype, device=self.device),
                v=torch.zeros(shape, dtype=dtype, device=self.device),
            )
        self.queue: deque = deque()
        self.active: Dict[int, dict] = {}  # slot -> request state
        self.results: Dict[int, List[int]] = {}
        # in-flight chunked prefills: one per lane; each engine step
        # advances every busy lane by one chunk in a single batched call
        self._prefills: List[Optional[dict]] = [None] * ecfg.prefill_lanes
        # tokens emitted by requests that were later preempted (a preempted
        # request requeues with prompt + generated and its remaining budget)
        self._preempt_emitted: Dict[int, List[int]] = {}
        self.stats: Dict[str, int] = dict(
            steps=0, decode_steps=0, spec_steps=0, prefill_chunks=0,
            tokens_emitted=0, drafts_proposed=0, drafts_accepted=0,
            requests_admitted=0, requests_finished=0, preemptions=0,
        )

    def add_request(
        self,
        request_id: int,
        prompt: List[int],
        max_new_tokens: int,
        temperature: float = 0.0,
        prefix_id: Optional[str] = None,
    ):
        if temperature > 0.0:
            raise NotImplementedError("sampling (temperature > 0) is not ported yet")
        if prefix_id is not None:
            raise NotImplementedError("shared prefixes are not ported yet")
        self.queue.append((request_id, list(prompt), max_new_tokens))

    def register_prefix(self, prefix_id: str, tokens: List[int]) -> None:
        raise NotImplementedError("shared prefixes are not ported yet")

    # ---- internals -------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _start_chunked_prefill(self, lane: int) -> bool:
        rid, prompt, max_new = self.queue[0]
        slot = self.pool.admit(rid, len(prompt), len(prompt) + max_new)
        if slot < 0:
            return False
        self.queue.popleft()
        self._prefills[lane] = dict(slot=slot, id=rid, prompt=prompt, done=0, max_new=max_new)
        return True

    def _bt_row(self, slot: int) -> np.ndarray:
        """This slot's block-table row: its own pages, trash elsewhere."""
        bt, _, _ = self.pool.build_block_tables(self.ecfg.max_pages_per_seq)
        row = bt[slot].copy()
        n_pages = cdiv(max(self.pool.seq_len(slot), 1), self.ecfg.page_size)
        row[n_pages:] = self.trash_page
        return row

    def _advance_chunked_prefill(self):
        """Advance every busy prefill lane by one chunk in ONE batched step;
        activate requests whose prompt completed."""
        P = self.ecfg.prefill_lanes
        C = self.ecfg.prefill_chunk
        tokens = np.zeros((P, C), np.int64)
        n_prior = np.zeros((P,), np.int64)
        n_valid = np.zeros((P,), np.int64)
        bt = np.full((P, self.ecfg.max_pages_per_seq), self.trash_page, np.int32)
        for lane, st in enumerate(self._prefills):
            if st is None:
                continue
            chunk = st["prompt"][st["done"] : st["done"] + C]
            tokens[lane, : len(chunk)] = chunk
            n_prior[lane] = st["done"]
            n_valid[lane] = len(chunk)
            bt[lane] = self._bt_row(st["slot"])
        logits = prefill_chunk_core(
            self.params, self._tensor(tokens), self._tensor(n_prior), self._tensor(n_valid),
            self.pools, self._tensor(bt), self.cfg,
        )
        first_tokens = None  # fetched only when a lane completes
        for lane, st in enumerate(self._prefills):
            if st is None:
                continue
            st["done"] += int(n_valid[lane])
            self.stats["prefill_chunks"] += 1
            if st["done"] < len(st["prompt"]):
                continue
            if first_tokens is None:
                first_tokens = sample_tokens(logits).cpu().numpy()
            first = int(first_tokens[lane])
            self.active[st["slot"]] = dict(
                id=st["id"], prompt=st["prompt"], last_token=first,
                generated=[first], max_new=st["max_new"],
            )
            self._prefills[lane] = None
            self.stats["requests_admitted"] += 1
            self.stats["tokens_emitted"] += 1  # prefill emits the 1st token

    def _preempt(self, slot: int) -> None:
        """OOM on page growth: requeue the request with its full context so
        it resumes through prefill once pages free up."""
        st = self.active.pop(slot)
        self.pool.retire(slot)
        remaining = st["max_new"] - len(st["generated"])
        self._preempt_emitted[st["id"]] = (
            self._preempt_emitted.get(st["id"], []) + st["generated"]
        )
        self.queue.appendleft((st["id"], st["prompt"] + st["generated"], remaining))
        self.stats["preemptions"] += 1

    def step(self) -> Dict[int, List[int]]:
        """Admit, run at most one prefill chunk per lane, retire finished
        requests, then one batched decode step. Returns tokens emitted."""
        for lane in range(self.ecfg.prefill_lanes):
            if not self.queue:
                break
            busy = sum(st is not None for st in self._prefills)
            if self._prefills[lane] is not None or (
                len(self.active) + busy >= self.ecfg.max_batch
            ):
                continue
            if not self._start_chunked_prefill(lane):
                break
        if any(st is not None for st in self._prefills):
            self._advance_chunked_prefill()
        emitted: Dict[int, List[int]] = {}
        for slot in list(self.active):
            st = self.active[slot]
            done = len(st["generated"]) >= st["max_new"] or (
                st["generated"] and st["generated"][-1] == self.ecfg.eos_token
            )
            if done:
                self.results[st["id"]] = self._preempt_emitted.pop(st["id"], []) + st["generated"]
                self.pool.retire(slot)
                del self.active[slot]
                self.stats["requests_finished"] += 1
        if not self.active:
            return emitted
        self.stats["steps"] += 1
        self.stats["decode_steps"] += 1
        for slot in list(self.active):
            if self.pool.extend(slot, 1) < 0:
                self._preempt(slot)
        if not self.active:
            return emitted
        bt, kv_lens, _ = self.pool.build_block_tables(self.ecfg.max_pages_per_seq)
        for slot in range(self.ecfg.max_batch):
            if slot not in self.active:
                bt[slot, :] = self.trash_page  # inactive rows -> trash page
        tokens = np.zeros((self.ecfg.max_batch, 1), np.int64)
        for slot, st in self.active.items():
            tokens[slot, 0] = st["last_token"]
        next_tokens, _ = decode_core(
            self.params, self._tensor(tokens), self.pools, self._tensor(bt),
            self._tensor(kv_lens), self.cfg,
        )
        next_np = next_tokens.cpu().numpy()
        for slot, st in self.active.items():
            tok = int(next_np[slot])
            st["last_token"] = tok
            st["generated"].append(tok)
            emitted.setdefault(st["id"], []).append(tok)
        self.stats["tokens_emitted"] += sum(len(v) for v in emitted.values())
        return emitted

    def has_work(self) -> bool:
        """True while a request is queued, prefilling or decoding."""
        return bool(self.queue or self.active or any(st is not None for st in self._prefills))

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.results

    def stats_summary(self) -> Dict[str, float]:
        """Derived serving metrics from the raw counters in self.stats."""
        s = self.stats
        return dict(
            s,
            tokens_per_step=(s["tokens_emitted"] / s["steps"] if s["steps"] else 0.0),
            draft_acceptance=(
                s["drafts_accepted"] / s["drafts_proposed"] if s["drafts_proposed"] else 0.0
            ),
            page_utilization=1.0 - self.pool.free_pages() / self.ecfg.num_pages,
            active_requests=len(self.active),
            queued_requests=len(self.queue),
        )


def _check_served(params, ecfg: EngineConfig, mesh) -> None:
    """Raise NotImplementedError for what this slice of the port does not
    serve; nothing is silently served another way."""
    missing = []
    if not ecfg.prefill_chunk:
        missing.append("bucketed prefill (prefill_chunk=None needs the dense flash kernel)")
    if ecfg.speculate_k > 1:
        missing.append("speculative decoding (speculate_k > 1)")
    if ecfg.multi_step > 1:
        missing.append("multi-step windows (multi_step > 1)")
    if ecfg.top_k or ecfg.top_p:
        missing.append("top-k / top-p sampling")
    if mesh is not None:
        missing.append("meshes")
    if "router" in params["layers"]:
        missing.append("MoE models")
    if missing:
        raise NotImplementedError("not ported yet: " + "; ".join(missing))
