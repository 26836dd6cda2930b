"""Continuous-batching decode engine over the paged KV cache, with bucketed
or chunked prefill, on one device or on a dp x tp mesh.

Host-side scheduling (admission, per-step page growth, retirement, OOM
preemption, multi-step windows, speculative verify, shared prefixes)
follows the JAX package's serve/engine.py step for step, and the page
allocator is the same C++ one, so for the same requests both engines assign
the same pages. With ``prefill_chunk`` unset (the default), each engine step
admits whole prompts while slots are free: ``prefill_core`` runs dense
causal flash attention (K7) over the prompt padded to a power-of-two bucket
and appends the bucket's KV at position 0. With ``prefill_chunk`` set, each
step runs at most one prefill chunk per lane (``prefill_chunk_core``). Then
comes one batched decode step (``decode_core``, the L = 1 case of
``verify_core``, plus sampling), or ``multi_step`` of them in one window
(``decode_multi_step``) when no request is queued or prefilling, or one
speculative verify step (``verify_core`` over the last token and
``speculate_k - 1`` prompt-lookup drafts) when every active request is
greedy. Each core is a Python loop over the layers.

On CUDA every decode step, per-step or windowed, is the replay of a CUDA
graph of ``decode_multi_step`` (one graph for each window length and
sampling on or off, captured at first use over static token, block-table,
length, temperature and step buffers): one host sync a window. A capture
or replay error raises; no decode step runs eagerly in its place. On the
CPU the same function runs as a plain loop.

Sampling (temperature, top-k, top-p) runs on the device: a Gumbel-max draw
over Philox4x32-10 noise whose counter is (column, row, step, lane) under
the key ``sample_seed``, so a sampled stream depends only on the seed, the
engine step and the batch row, and windows give the tokens of per-step
mode.

KV pools are ``(L, num_pages + 1, h_k, page, d)`` — the extra page is the
trash page that inactive batch rows and padded chunk tails write to — with
f32 per-token scales ``(L, num_pages + 1, h_k, page)`` for int8 / fp8 pools.
They are stored tight (no TPU sublane or lane padding) and updated IN PLACE
by the append kernel: the counterpart of the JAX package's pool donation,
and what keeps a captured graph's pool addresses valid.

Cache protocol: the allocator's seq_len counts the tokens whose KV is in
the cache after the upcoming step. A decode step consumes the previously
sampled token, appends its KV at position seq_len - 1 and attends over
seq_len keys.

Both model families serve: a layer whose params hold a ``router`` runs the
sparse MoE MLP (``models/moe.py``) where a Llama layer runs its SwiGLU MLP
(``_mlp``). Every row of a step's batch, padded bucket tails, idle chunk
lanes and dead decode rows included, competes for the experts' capacity in
row order, as in the JAX engine, which feeds the same rows.

On a mesh (``DecodeEngine(..., mesh=make_mesh(dp=, tp=))``, one process a
rank, ``parallel/``) the engine serves as the JAX engine's mesh mode does:
prefill through chunks only; the weights and the kv heads sharded over
"tp"; with dp > 1 the batch slots, prefill lanes and pages split among the
replicas (``DpPagePools``, replica-local page ids, one trash page each,
shared prefixes copied into every replica); the decode and verify steps
with the reduce-scatter + all-gather structure (sp_batch) where the batch
divides by tp and the model is dense, all-reduces elsewhere; the logits
gathered over the vocabulary before sampling, so that every rank draws the
same tokens. Every rank runs the same host bookkeeping for all replicas
and computes its replica's rows; the replicas exchange their sampled
tokens on host tensors. On CUDA the decode window is a graph replay with
its collectives captured in it.

What the port does not serve yet raises NotImplementedError: a mesh with
ep, pp or cp > 1 (expert, pipeline and context parallelism), and
checkpoints of a mesh engine (serve/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    _proj,
    attn_qkv,
    layer_view,
    mlp_block,
    pack_params_for_decode,
    rms_norm,
)
from xf_flash_attention_cutlass_tpu_torch.models.moe import moe_mlp_block
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import MASK32, flash_fwd, philox4x32_10
from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention
from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import paged_append
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import rotary_frequencies
from xf_flash_attention_cutlass_tpu_torch.quant.kv import resolve_quant
from xf_flash_attention_cutlass_tpu_torch.serve.allocator import DpPagePools, PagePool
from xf_flash_attention_cutlass_tpu_torch.utils import cdiv, resolve_device
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import (
    all_gather,
    all_reduce_,
    reduce_scatter,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX package's EngineConfig, field for field. The port serves
    every field on one device: bucketed (prefill_chunk None or 0) or
    chunked prefill over prefill_lanes, speculate_k > 1 (greedy requests),
    multi_step > 1, and sampling with top_k / top_p / approx_top_k under
    sample_seed; on a dp x tp mesh every field but bucketed prefill (as in
    the JAX engine). DecodeEngine raises NotImplementedError for a mesh
    with ep, pp or cp > 1.

    The speculative verify step runs eagerly on CUDA (no graph yet): on an
    H100 80GB HBM3 (700 W) at Llama-8B width with random weights,
    speculate_k = 3 served 144 tokens/s against 970 for the graphed
    per-step decode (chip_smoke.py's serve_speculative)."""

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


# candidate prefix of the pure top-p route with approx_top_k (the JAX
# package's _TOP_P_PREFIX_K): the nucleus is taken within the top 128
_TOP_P_PREFIX_K = 128
# the counter's last word: decode steps draw on lane 0, the first token of a
# prefill on lane 1 (with the request id as its step)
DECODE_LANE, PREFILL_LANE = 0, 1


def philox_uniform(rows: int, cols: int, step, lane: int, seed: int,
                   device, row0: int = 0) -> torch.Tensor:
    """(rows, cols) f32 u in (0, 1): entry (r, c) is the top 23 bits of the
    first word of Philox4x32-10 on counter (c, row0 + r, step, lane) under
    the key `seed`. `step` is an int or an int tensor of shape () or
    (rows,), on the device (a graph replays it); row0 is the first row's
    index in the engine's batch (a data-parallel replica's offset)."""
    seed &= (1 << 64) - 1
    shape = (rows, cols)
    col = torch.arange(cols, dtype=torch.int64, device=device)[None].expand(shape)
    row = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None].expand(shape)
    st = torch.as_tensor(step, dtype=torch.int64, device=device).reshape(-1, 1) & MASK32
    word, _, _, _ = philox4x32_10(col, row, st.expand(shape), torch.full_like(col, lane),
                                  seed & MASK32, seed >> 32)
    return ((word >> 9).to(torch.float32) + 0.5) * 2.0**-23


def gumbel_noise(rows: int, cols: int, step, lane: int, seed: int,
                 device, row0: int = 0) -> torch.Tensor:
    """(rows, cols) f32 Gumbel noise, -log(-log(u)) of philox_uniform."""
    return -torch.log(-torch.log(philox_uniform(rows, cols, step, lane, seed, device, row0)))


def _nucleus(vals: torch.Tensor, top_p: float) -> torch.Tensor:
    """Sorted (descending) scaled logits with the tokens past the nucleus
    set to -inf: a token is kept while the probability before it is below
    top_p, so the top token always survives."""
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    return vals.masked_fill(cum - probs >= top_p, float("-inf"))


def sample_tokens(
    logits: torch.Tensor,  # (b, V) f32
    temperature: Optional[torch.Tensor] = None,  # (b,) f32; <= 0: greedy row
    step=None,  # int, or int tensor () / (b,): the counter's step word
    seed: int = 0,
    top_k: int = 0,  # keep the k most probable tokens (0 = off)
    top_p: float = 0.0,  # nucleus: the smallest set with cumulative prob >= p
    approx_top_k: bool = True,
    lane: int = DECODE_LANE,
    row0: int = 0,  # the first row's index in the engine's batch (its noise counter)
) -> torch.Tensor:
    """Batched next-token selection, the JAX package's sample_tokens: rows
    with temperature <= 0 take the argmax (the first index on ties), the
    others draw from softmax(logits / max(t, 1e-6)), truncated. Any top_k >
    0 draws within the sorted top-k prefix, the nucleus taken inside the
    renormalized prefix; pure top-p with approx_top_k draws within a
    128-candidate prefix, without it over the full sorted vocabulary. The
    JAX package's approx_max_k has no torch counterpart: the prefixes are
    the exact torch.topk, which is what it computes on the CPU.

    The draw is a Gumbel-max over counter-based noise (gumbel_noise), with
    no host read: it runs inside a captured graph. (b, V) -> (b,) int64."""
    greedy = torch.argmax(logits, dim=-1)
    if temperature is None:
        return greedy
    b, V = logits.shape
    t = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    scaled = logits / torch.clamp_min(t, 1e-6)[:, None]
    step = 0 if step is None else step
    if (top_k and top_k > 0) or (top_p and top_p > 0.0 and approx_top_k):
        k = min(top_k, V) if top_k and top_k > 0 else min(_TOP_P_PREFIX_K, V)
        vals, idx = torch.topk(scaled, k, dim=-1)  # sorted, descending
        if top_p and top_p > 0.0:
            vals = _nucleus(vals, top_p)
        pos = torch.argmax(vals + gumbel_noise(b, k, step, lane, seed, logits.device, row0),
                           dim=-1)
        sampled = idx.gather(-1, pos[:, None])[:, 0]
    else:
        masked = scaled
        if top_p and top_p > 0.0:
            vals, order = torch.sort(scaled, dim=-1, descending=True)
            drop = torch.isneginf(_nucleus(vals, top_p))
            masked = scaled.masked_fill(torch.zeros_like(drop).scatter(-1, order, drop),
                                        float("-inf"))
        sampled = torch.argmax(masked + gumbel_noise(b, V, step, lane, seed, logits.device, row0),
                               dim=-1)
    return torch.where(t > 0.0, sampled, greedy)


def _rope(cfg: LlamaConfig, device, rope=None):
    """The (cos, sin) rotary tables: the caller's (the engine builds them
    once), else built here."""
    if rope is not None:
        return rope
    return rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base, device=device)


def _mlp(layer, x: torch.Tensor, cfg: LlamaConfig, group=None) -> torch.Tensor:
    """The dense SwiGLU MLP, or the sparse MoE MLP for a layer that holds
    a router (models/moe.py), as the JAX engine's _mlp chooses; under a tp
    `group` either one's ffn dim is sharded and its output all-reduced."""
    if "router" in layer:
        out, _ = moe_mlp_block(layer, x, cfg, group=group)
        return out
    return mlp_block(layer, x, cfg, group=group)


def _attention_layers(params, x, pools, bt, kv_lens, append_pos, positions, cfg, rope=None,
                      group=None, sp: bool = False):
    """The layer loop shared by verify/decode and chunked prefill: per
    layer, append the new tokens' KV into the pools in place, then attend
    over the paged cache (causal from the bottom right), project and run
    the MLP. Returns the final-normed hidden states.

    Under a tp `group` (cfg the local shard's, parallel/tp.py _local_cfg)
    the pools hold the rank's kv heads, and the O projection's and the
    MLP's partial sums are all-reduced. With `sp` (the JAX engine's
    sp_batch) each all-reduce is split into a reduce-scatter and an
    all-gather over the batch: the residual stream lives batch-sharded
    between the sharded regions, each of which starts with an all-gather
    of its input rows, and the stream is gathered once after the last
    layer (4 collectives a layer and 1, where the all-reduces issue 2 a
    layer). The same sums; b must divide by the group's size."""
    b, s, _ = x.shape
    cos, sin = _rope(cfg, x.device, rope)
    quant = "k_s" in pools
    scales = dict(k_scales=pools["k_s"], v_scales=pools["v_s"]) if quant else {}
    if sp:
        n = b // dist.get_world_size(group)
        x = x[dist.get_rank(group) * n : (dist.get_rank(group) + 1) * n]
    for l in range(pools["k"].shape[0]):
        layer = layer_view(params["layers"], l)
        x_full = all_gather(x, group) if sp else x
        q, k_new, v_new = attn_qkv(layer, x_full, cfg, cos, sin, positions)
        paged_append(pools["k"], pools["v"], k_new, v_new, bt, append_pos, layer_idx=l, **scales)
        o, _ = paged_attention(q, pools["k"], pools["v"], bt, kv_lens, causal=True,
                               layer_idx=l, **scales)
        partial = _proj(o.reshape(b, s, cfg.n_heads * cfg.head_dim), layer["wo"])
        if sp:
            x = x + reduce_scatter(partial, group)
            h = all_gather(rms_norm(x, layer["mlp_norm"], cfg.rms_eps), group)
            mlp_partial = _proj(F.silu(_proj(h, layer["w_gate"])) * _proj(h, layer["w_up"]),
                                layer["w_down"])
            x = x + reduce_scatter(mlp_partial, group)
        else:
            if group is not None:
                partial = all_reduce_(partial, group)
            x = x + partial
            x = _mlp(layer, x, cfg, group)
    if sp:
        x = all_gather(x, group)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def _lm_head(x: torch.Tensor, params, group) -> torch.Tensor:
    """The lm_head's f32 logits; a vocab-sharded head's gathered over the tp
    group, so that every rank samples the same tokens."""
    logits = _proj(x, params["lm_head"]).float()
    return logits if group is None else all_gather(logits, group, dim=-1)


def verify_core(
    params,
    tokens: torch.Tensor,  # (b, L) — [last_sampled, draft_1, ..., draft_{L-1}]
    pools: Dict[str, torch.Tensor],
    block_tables: torch.Tensor,  # (b, max_pages)
    kv_lens: torch.Tensor,  # (b,) — seq length AFTER this step (cur + L)
    cfg: LlamaConfig,
    rope=None,  # (cos, sin); None builds them
    group=None,  # tp group (parallel/tp_serve.py); cfg then the local shard's
    sp_batch: bool = False,  # the reduce-scatter + all-gather structure (_attention_layers)
) -> torch.Tensor:
    """One batched multi-token step: appends all L input tokens' KV (in
    place) and returns logits at every position, (b, L, vocab) f32.

    Inactive slots (kv_len 0) must have block-table rows pointing at the
    trash page, so that their clamped write position 0 cannot corrupt live
    pages. sp_batch runs only where it can, as in the JAX engine: under a
    tp group, for a dense model, with b divisible by the group's size;
    elsewhere the plain all-reduces run."""
    b, L = tokens.shape
    x = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)]
    append_pos = (kv_lens - L).clamp_min(0)
    positions = append_pos[:, None] + torch.arange(L, device=tokens.device)[None]
    sp = (sp_batch and group is not None and "router" not in params["layers"]
          and b % dist.get_world_size(group) == 0)
    x = _attention_layers(params, x, pools, block_tables, kv_lens, append_pos, positions, cfg,
                          rope, group, sp)
    return _lm_head(x.reshape(b * L, -1), params, group).reshape(b, L, -1)


def decode_core(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig,
                temperature=None, step=None, seed: int = 0, top_k: int = 0,
                top_p: float = 0.0, approx_top_k: bool = True, rope=None, group=None,
                sp_batch: bool = False, row0: int = 0):
    """One batched decode step = the L = 1 case of verify_core, plus
    sampling (sample_tokens; greedy when temperature is None; row0 the first
    row's index in the engine's batch). Returns (next_tokens (b,), logits
    (b, vocab))."""
    logits = verify_core(params, tokens, pools, block_tables, kv_lens, cfg, rope, group,
                         sp_batch)[:, 0]
    return sample_tokens(logits, temperature, step, seed, top_k, top_p, approx_top_k,
                         row0=row0), logits


def decode_multi_step(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig,
                      temperature=None, step0=None, seed: int = 0, top_k: int = 0,
                      top_p: float = 0.0, approx_top_k: bool = True, n_steps: int = 2,
                      rope=None, group=None, sp_batch: bool = False, row0: int = 0):
    """`n_steps` autoregressive decode steps, each fed the previous one's
    tokens on the device. Contract (the JAX package's): `kv_lens` is the
    length after the FIRST step (the engine pre-extends pages by n_steps);
    step i uses kv_lens + i and the sampling step step0 + i, the per-step
    engine's schedule, so the streams are token-identical. Returns
    ((n_steps, b) tokens, the last step's logits (b, vocab))."""
    step0 = 0 if step0 is None else step0
    toks, logits = [], None
    for i in range(n_steps):
        nt, logits = decode_core(params, tokens, pools, block_tables, kv_lens + i, cfg,
                                 temperature, step0 + i, seed, top_k, top_p, approx_top_k, rope,
                                 group, sp_batch, row0)
        toks.append(nt)
        tokens = nt[:, None]
    return torch.stack(toks), logits


def draft_prompt_lookup(ctx: List[int], n_draft: int, ngram: int = 3) -> List[int]:
    """Model-free drafting (prompt lookup), the JAX package's: find the
    latest earlier occurrence of the context's final `ngram` and propose the
    tokens that followed it, padded with the last token."""
    if n_draft <= 0:
        return []
    if len(ctx) > ngram:
        pat = ctx[-ngram:]
        for s in range(len(ctx) - ngram - 1, -1, -1):
            if ctx[s : s + ngram] == pat:
                cont = ctx[s + ngram : s + ngram + n_draft]
                if cont:
                    return (cont + [ctx[-1]] * (n_draft - len(cont)))[:n_draft]
    return [ctx[-1]] * n_draft


def prefill_core(
    params,
    tokens: torch.Tensor,  # (1, S) — the prompt padded to its bucket S
    true_len: int,
    pools: Dict[str, torch.Tensor],
    bt_row: torch.Tensor,  # (1, cdiv(S, page)) — the prompt's pages, then trash
    cfg: LlamaConfig,
    rope=None,
):
    """Prefill one request: per layer, dense causal flash attention over
    the bucket with kv_lens = [true_len], and the whole bucket's KV appended
    at position 0 (in place; the padded tail lands past the prompt or on
    the trash page, where nothing attends to it). Returns the logits of
    the last prompt token, (vocab,) f32: the engine samples the first token
    from them (DecodeEngine._sample_first)."""
    s = tokens.shape[1]
    dev = tokens.device
    x = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)]
    positions = torch.arange(s, device=dev)[None]
    cos, sin = _rope(cfg, dev, rope)
    kv_lens = torch.tensor([true_len], dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    scales = dict(k_scales=pools["k_s"], v_scales=pools["v_s"]) if "k_s" in pools else {}
    for l in range(pools["k"].shape[0]):
        layer = layer_view(params["layers"], l)
        q, k_new, v_new = attn_qkv(layer, x, cfg, cos, sin, positions)
        o, _ = flash_fwd(q.transpose(1, 2), k_new.transpose(1, 2), v_new.transpose(1, 2),
                         causal=True, kv_lens=kv_lens)
        paged_append(pools["k"], pools["v"], k_new, v_new, bt_row, zero, layer_idx=l, **scales)
        x = x + _proj(o.transpose(1, 2).reshape(1, s, cfg.n_heads * cfg.head_dim), layer["wo"])
        x = _mlp(layer, x, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return _proj(x[:, max(true_len - 1, 0)], params["lm_head"]).float()[0]


def prefill_chunk_core(
    params,
    tokens: torch.Tensor,  # (P, C) — one fixed-size chunk per prompt lane
    n_prior: torch.Tensor,  # (P,) tokens already in the cache per lane
    n_valid: torch.Tensor,  # (P,) valid tokens per chunk row (0 = idle lane)
    pools: Dict[str, torch.Tensor],
    bt: torch.Tensor,  # (P, max_pages) per-lane block table incl. trash tail
    cfg: LlamaConfig,
    rope=None,
    group=None,  # tp group (parallel/tp_serve.py); cfg then the local shard's
) -> torch.Tensor:
    """One step of incremental prefill for P prompts: append each lane's
    chunk KV into its pages (in place), then paged attention of the chunk
    queries over cache[0 : n_prior + C]. Padded tail positions and idle
    lanes write KV that nothing attends to. Returns the logits of each
    lane's last valid token, (P, vocab) f32."""
    P, C = tokens.shape
    x = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)]
    positions = n_prior[:, None] + torch.arange(C, device=tokens.device)[None]
    x = _attention_layers(params, x, pools, bt, n_prior + C, n_prior, positions, cfg, rope, group)
    last = (n_valid - 1).clamp_min(0)
    return _lm_head(x[torch.arange(P, device=x.device), last], params, group)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _take_back(counter: Counter, before: Counter) -> Counter:
    """The counts added to `counter` since it equalled `before`, taken back
    out of it (keys it did not hold before leave it again)."""
    added = Counter(counter)
    added.subtract(before)
    added = +added
    counter.subtract(added)
    for k in added:
        if not counter[k] and k not in before:
            del counter[k]
    return added


@dataclasses.dataclass
class _DecodeGraph:
    """One captured decode window: its graph, its outputs (in the engine's
    graph pool), the kernel launches one replay makes (counted on the host
    at capture; again by head dim, _build.HEAD_DIM_LAUNCHES) and the label
    its replays are counted under."""

    graph: "torch.cuda.CUDAGraph"
    tokens: torch.Tensor  # (K, rows) int64: every row, or on a mesh the replica's
    logits: torch.Tensor  # (rows, vocab) f32, the last inner step's
    launches: Counter
    label: str
    head_dims: Counter = dataclasses.field(default_factory=Counter)


class DecodeEngine:
    """Continuous batching: admit, bucketed or chunked prefill, batched
    decode (per step, in multi-step windows, or speculative), retire."""

    def __init__(
        self,
        params,
        cfg: LlamaConfig,
        ecfg: EngineConfig,
        dtype: torch.dtype = torch.bfloat16,
        device=None,  # None: CUDA, raising when it is absent
        mesh=None,  # a DeviceMesh (parallel/mesh.py make_mesh) to serve on
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        ecfg = effective_engine_config(ecfg)
        self.ecfg = ecfg
        self.mesh = mesh
        dp, tp = _check_mesh(mesh, cfg, ecfg, self.device)
        # a dp x tp mesh: each data-parallel replica owns a disjoint slice of
        # the batch slots and of the page pool, and every page id the host
        # hands out is replica-local. Every rank runs this bookkeeping for
        # all replicas (the same requests on every rank give the same
        # state); it computes its replica's rows on its kv heads, and the
        # replicas exchange the tokens they sample.
        self.n_replicas = dp
        num_pages_local = ecfg.num_pages // self.n_replicas
        self.mb_local = ecfg.max_batch // self.n_replicas
        if self.n_replicas > 1:
            self.pool = DpPagePools(self.n_replicas, num_pages_local, ecfg.page_size,
                                    self.mb_local)
        else:
            self.pool = PagePool(ecfg.num_pages, ecfg.page_size, ecfg.max_batch)
        # one trash page per replica: local id num_pages_local in each shard
        self.trash_page = num_pages_local
        self._replica = 0  # this rank's replica
        if mesh is not None:
            from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import DP, axis_index
            from xf_flash_attention_cutlass_tpu_torch.parallel.tp import shard_params

            params = shard_params(params, mesh)
            self._replica = axis_index(mesh, DP)
        # decode and prefill read every projection through the stacked
        # matmul (the same buffers, no copies)
        self.params = pack_params_for_decode(_to_device(params, self.device))
        if (
            ecfg.kv_quant
            and ecfg.prefill_chunk
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
        # this rank's pools: its replica's pages and its kv heads
        shape = (cfg.n_layers, num_pages_local + 1, cfg.n_kv_heads // tp, ecfg.page_size,
                 cfg.head_dim)
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
        # the rotary tables, built once for every core
        self.rope = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base,
                                       device=self.device)
        self.queue: deque = deque()
        self.active: Dict[int, dict] = {}  # slot -> request state
        self.results: Dict[int, List[int]] = {}
        # the sampling counter's step word: advanced where the JAX engine
        # advances its _step_count (per decode step, per window step, per
        # speculative step)
        self._step_count = 0
        # in-flight chunked prefills: one per lane; each engine step
        # advances every busy lane by one chunk in a single batched call
        self._prefills: List[Optional[dict]] = [None] * ecfg.prefill_lanes
        # shared-prefix cache: prefix_id -> dict(pages_by_replica, n_pages,
        # shared_len, tokens, remainder); slot -> prefix_id for live requests
        self._prefixes: Dict[str, dict] = {}
        self._slot_prefix: Dict[int, str] = {}
        # tokens emitted by requests that were later preempted (a preempted
        # request requeues with prompt + generated and its remaining budget)
        self._preempt_emitted: Dict[int, List[int]] = {}
        # host clock (time.perf_counter) at which each request's first token
        # was read back from the device: the end of its time to first token
        self.first_token_at: Dict[int, float] = {}
        # CUDA graphs of the decode window, by (K, sampling), sharing one
        # memory pool, over the static buffers of self._static
        self._graphs: Dict[tuple, _DecodeGraph] = {}
        self._graph_pool = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
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
        temperature: float = 0.0,  # 0: greedy; > 0 samples (top_k / top_p are engine-wide)
        prefix_id: Optional[str] = None,  # a shared prefix (register_prefix)
    ):
        if prefix_id is not None:
            if not self.ecfg.prefill_chunk:
                raise ValueError("prefix caching requires chunked prefill "
                                 "(EngineConfig.prefill_chunk)")
            if prefix_id not in self._prefixes:
                raise KeyError(f"unknown prefix {prefix_id!r}")
        self.queue.append((request_id, list(prompt), max_new_tokens, temperature, prefix_id))

    def register_prefix(self, prefix_id: str, tokens: List[int]) -> None:
        """Prefill a shared prefix (a system prompt) once into its own
        pages; requests admitted with this prefix_id attend to those pages
        through their block tables. Only whole pages are shared; the
        remainder (len % page_size tokens) is prepended to each request's
        own prompt. Requires chunked prefill. Free with release_prefix."""
        if not self.ecfg.prefill_chunk:
            raise ValueError("prefix caching requires EngineConfig.prefill_chunk")
        if prefix_id in self._prefixes:
            raise ValueError(f"prefix {prefix_id!r} already registered")
        page, C = self.ecfg.page_size, self.ecfg.prefill_chunk
        n_pages = len(tokens) // page
        shared_len = n_pages * page
        R = self.n_replicas
        if R > 1:
            # the prefix is replicated into every replica's pages, so that any
            # replica's requests read it through local page ids
            pages_by_replica = (self.pool.prefix_alloc_all(n_pages) if n_pages
                                else [[] for _ in range(R)])
        else:
            one = self.pool.prefix_alloc(n_pages) if n_pages else []
            pages_by_replica = None if one is None else [one]
        if pages_by_replica is None:
            raise RuntimeError("page pool cannot hold the prefix")
        # one lane a replica (the first of its lanes; one lane without
        # replicas): every replica prefills the same chunks into its own
        # prefix pages, the other lanes idle on the trash page
        P = self.ecfg.prefill_lanes if R > 1 else 1
        lanes = [r * (P // R) for r in range(R)]
        bt = np.full((P, self.ecfg.max_pages_per_seq), self.trash_page, np.int32)
        for lane, pages in zip(lanes, pages_by_replica):
            bt[lane, :n_pages] = pages
        pos = 0
        while pos < shared_len:
            chunk = tokens[pos : pos + C]
            buf = np.zeros((P, C), np.int64)
            n_prior = np.zeros((P,), np.int64)
            n_valid = np.zeros((P,), np.int64)
            buf[lanes, : len(chunk)] = chunk
            n_prior[lanes] = pos
            n_valid[lanes] = len(chunk)
            self._run_prefill_chunk(buf, n_prior, n_valid, bt)
            pos += len(chunk)
        self._prefixes[prefix_id] = dict(pages_by_replica=[list(p) for p in pages_by_replica],
                                         n_pages=n_pages, shared_len=shared_len,
                                         tokens=list(tokens),
                                         remainder=list(tokens[shared_len:]))

    def release_prefix(self, prefix_id: str) -> None:
        """Return a prefix's pages to the pool (no live request may still
        reference it)."""
        if prefix_id in self._slot_prefix.values():
            raise RuntimeError(f"prefix {prefix_id!r} still in use")
        pf = self._prefixes.pop(prefix_id)
        if pf["n_pages"]:
            if self.n_replicas > 1:
                self.pool.prefix_free_all(pf["pages_by_replica"])
            else:
                self.pool.prefix_free(pf["pages_by_replica"][0])

    # ---- internals -------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _exchange(self, local: torch.Tensor) -> np.ndarray:
        """The replicas' rows of a host result (dim 0: this replica's rows)
        joined in replica order over the dp group, on host tensors; the
        result itself without replicas."""
        local = local.cpu()
        if self.n_replicas > 1:
            from xf_flash_attention_cutlass_tpu_torch.parallel.tp_serve import gather_rows

            local = gather_rows(local, self.mesh)
        return local.numpy()

    def _run_prefill_chunk(self, tokens, n_prior, n_valid, bt) -> torch.Tensor:
        """prefill_chunk_core over host arrays of every lane, on the mesh
        when there is one (this replica's lanes). Returns the logits of the
        lanes this rank computed, (P_local, vocab)."""
        args = [self._tensor(a) for a in (tokens, n_prior, n_valid)]
        if self.mesh is not None:
            from xf_flash_attention_cutlass_tpu_torch.parallel.tp_serve import (
                tp_prefill_chunk_step,
            )

            logits, _ = tp_prefill_chunk_step(self.params, *args, self.pools, self._tensor(bt),
                                              self.cfg, self.mesh, dp_axis=self.n_replicas > 1,
                                              rope=self.rope)
            return logits
        return prefill_chunk_core(self.params, *args, self.pools, self._tensor(bt), self.cfg,
                                  self.rope)

    def _bucket(self, n: int) -> int:
        """The padded prefill length of an n-token prompt: the smallest
        power of two >= n, at least 32, at most max_seq (as the JAX engine)."""
        b = 32
        while b < n:
            b *= 2
        return min(b, self.ecfg.max_seq)

    def _sample_first(self, logits: torch.Tensor, rid: int, temperature: float) -> int:
        """A prefill's first token from its last prompt token's logits
        (vocab,): the argmax, or a draw on the prefill lane with the request
        id as the step (the JAX engine's fold_in(base, (rid << 8) ^ 0xA5))."""
        temps = None
        if temperature > 0.0:
            temps = torch.tensor([temperature], dtype=torch.float32, device=logits.device)
        e = self.ecfg
        return int(sample_tokens(logits[None], temps, rid, e.sample_seed, e.top_k, e.top_p,
                                 e.approx_top_k, lane=PREFILL_LANE)[0])

    def _admit_one(self) -> bool:
        """Admit the queue's head and prefill its whole prompt (bucketed);
        False when the allocator has no room for it."""
        rid, prompt, max_new, temp, _ = self.queue[0]  # no prefix: add_request guards it
        slot = self.pool.admit(rid, len(prompt), len(prompt) + max_new)
        if slot < 0:
            return False
        self.queue.popleft()
        bucket = self._bucket(len(prompt))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, : len(prompt)] = prompt
        page = self.ecfg.page_size
        n_pages = cdiv(len(prompt), page)
        bt, _, _ = self.pool.build_block_tables(self.ecfg.max_pages_per_seq)
        bt_row = np.full((1, cdiv(bucket, page)), self.trash_page, np.int32)
        bt_row[0, :n_pages] = bt[slot, :n_pages]
        logits = prefill_core(self.params, self._tensor(tokens), len(prompt), self.pools,
                              self._tensor(bt_row), self.cfg, self.rope)
        first = self._sample_first(logits, rid, temp)
        self._activate(slot, rid, prompt, first, max_new, temp, None)
        return True

    def _activate(self, slot: int, rid: int, prompt: List[int], first: int, max_new: int,
                  temperature: float, prefix_id: Optional[str]):
        """A request whose prefill emitted its first token starts decoding."""
        self.first_token_at.setdefault(rid, time.perf_counter())
        self.active[slot] = dict(id=rid, prompt=prompt, last_token=first, generated=[first],
                                 max_new=max_new, temperature=temperature, prefix_id=prefix_id)
        self.stats["requests_admitted"] += 1
        self.stats["tokens_emitted"] += 1  # prefill emits the first token

    def _start_chunked_prefill(self, lane: int) -> bool:
        rid, prompt, max_new, temp, prefix_id = self.queue[0]
        todo, base = prompt, 0
        if prefix_id is not None:
            pf = self._prefixes[prefix_id]
            todo = pf["remainder"] + prompt  # the tokens this request computes
            base = pf["shared_len"]
        total = base + len(todo)
        if self.n_replicas > 1:
            # lane l prefills into replica l // lanes_local's pages
            replica = lane // (self.ecfg.prefill_lanes // self.n_replicas)
            if prefix_id is not None:
                slot = self.pool.admit_prefixed_replica(replica, rid, pf["n_pages"], total,
                                                        total + max_new)
            else:
                slot = self.pool.admit_replica(replica, rid, total, total + max_new)
        elif prefix_id is not None:
            slot = self.pool.admit_prefixed(rid, pf["n_pages"], total, total + max_new)
        else:
            slot = self.pool.admit(rid, total, total + max_new)
        if slot < 0:
            return False
        self.queue.popleft()
        if prefix_id is not None:
            self._slot_prefix[slot] = prefix_id
        self._prefills[lane] = dict(slot=slot, id=rid, prompt=prompt, todo=todo, base=base,
                                    done=0, max_new=max_new, temperature=temp,
                                    prefix_id=prefix_id)
        return True

    def _prefix_pages(self, slot: int) -> List[int]:
        """The shared-prefix pages `slot` reads: its replica's copy."""
        pid = self._slot_prefix.get(slot)
        if pid is None:
            return []
        pbr = self._prefixes[pid]["pages_by_replica"]
        return pbr[0] if len(pbr) == 1 else pbr[slot // self.mb_local]

    def _bt_row(self, slot: int) -> np.ndarray:
        """This slot's block-table row: its own pages (after the shared
        region), the shared prefix's pages overlaid, trash elsewhere."""
        bt, _, _ = self.pool.build_block_tables(self.ecfg.max_pages_per_seq)
        row = bt[slot].copy()
        n_pages = cdiv(max(self.pool.seq_len(slot), 1), self.ecfg.page_size)
        row[n_pages:] = self.trash_page
        pages = self._prefix_pages(slot)
        row[: len(pages)] = pages
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
            chunk = st["todo"][st["done"] : st["done"] + C]
            tokens[lane, : len(chunk)] = chunk
            n_prior[lane] = st["base"] + st["done"]
            n_valid[lane] = len(chunk)
            bt[lane] = self._bt_row(st["slot"])
        logits = self._run_prefill_chunk(tokens, n_prior, n_valid, bt)
        done = []
        for lane, st in enumerate(self._prefills):
            if st is None:
                continue
            st["done"] += int(n_valid[lane])
            self.stats["prefill_chunks"] += 1
            if st["done"] >= len(st["todo"]):
                done.append(lane)
        if not done:
            return
        # each replica samples its own lanes' first tokens, then the replicas
        # exchange them (every rank knows which lanes completed)
        P_local = P // self.n_replicas
        lane0 = self._replica * P_local
        firsts = torch.full((P_local,), -1, dtype=torch.int64)
        for lane in done:
            if lane0 <= lane < lane0 + P_local:
                st = self._prefills[lane]
                firsts[lane - lane0] = self._sample_first(logits[lane - lane0], st["id"],
                                                          st["temperature"])
        firsts = self._exchange(firsts)
        for lane in done:
            st = self._prefills[lane]
            self._activate(st["slot"], st["id"], st["prompt"], int(firsts[lane]), st["max_new"],
                           st["temperature"], st["prefix_id"])
            self._prefills[lane] = None

    def _preempt(self, slot: int) -> None:
        """OOM on page growth: requeue the request with its full context so
        it resumes through prefill once pages free up."""
        st = self.active.pop(slot)
        self.pool.retire(slot)
        self._slot_prefix.pop(slot, None)
        remaining = st["max_new"] - len(st["generated"])
        self._preempt_emitted[st["id"]] = (
            self._preempt_emitted.get(st["id"], []) + st["generated"]
        )
        self.queue.appendleft((st["id"], st["prompt"] + st["generated"], remaining,
                               st["temperature"], st["prefix_id"]))
        self.stats["preemptions"] += 1

    def _grow(self, n_tokens: int) -> None:
        """Extend every active sequence by n_tokens; preempt on OOM."""
        for slot in list(self.active):
            if self.pool.extend(slot, n_tokens) < 0:
                self._preempt(slot)

    def _batch_tables(self):
        """(block tables, kv_lens) of the decode batch: inactive rows on the
        trash page, shared-prefix pages overlaid on their requests' rows."""
        bt, kv_lens, _ = self.pool.build_block_tables(self.ecfg.max_pages_per_seq)
        for slot in range(self.ecfg.max_batch):
            if slot not in self.active:
                bt[slot, :] = self.trash_page
        for slot in self.active:
            pages = self._prefix_pages(slot)
            bt[slot, : len(pages)] = pages
        return bt, kv_lens

    def step(self) -> Dict[int, List[int]]:
        """Admit and prefill, retire finished requests, then one batched
        decode step, one multi-step window or one speculative step. Returns
        tokens emitted.

        With ecfg.prefill_chunk set, at most one prefill chunk per lane runs
        before the decode batch; otherwise whole prompts are prefilled at
        admission."""
        if self.ecfg.prefill_chunk:
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
        else:
            while self.queue and len(self.active) < self.ecfg.max_batch:
                if not self._admit_one():
                    break
        emitted: Dict[int, List[int]] = {}
        for slot in list(self.active):
            st = self.active[slot]
            done = len(st["generated"]) >= st["max_new"] or (
                st["generated"] and st["generated"][-1] == self.ecfg.eos_token
            )
            if done:
                self.results[st["id"]] = self._preempt_emitted.pop(st["id"], []) + st["generated"]
                self.pool.retire(slot)
                self._slot_prefix.pop(slot, None)
                del self.active[slot]
                self.stats["requests_finished"] += 1
        if not self.active:
            return emitted
        self.stats["steps"] += 1
        # speculative decoding: greedy requests only (acceptance is equality
        # with the target's argmax, so the stream is plain greedy decoding)
        if self.ecfg.speculate_k > 1 and all(
            st["temperature"] <= 0.0 for st in self.active.values()
        ):
            self.stats["spec_steps"] += 1
            self._spec_decode(emitted)
            self.stats["tokens_emitted"] += sum(len(v) for v in emitted.values())
            return emitted
        # a multi-step window only when the host has no scheduling work
        # pending (no queue, no busy prefill lane)
        K = self.ecfg.multi_step
        if K <= 1 or self.queue or any(st is not None for st in self._prefills):
            K = 1
        self.stats["decode_steps"] += K
        self._grow(K)  # the window's tokens' KV
        if not self.active:
            return emitted
        bt, kv_lens = self._batch_tables()
        tokens = np.zeros((self.ecfg.max_batch, 1), np.int64)
        temps = np.zeros((self.ecfg.max_batch,), np.float32)
        for slot, st in self.active.items():
            tokens[slot, 0] = st["last_token"]
            temps[slot] = st["temperature"]
        # the same step schedule per step and in a window: step i of a
        # window draws with the count step i would have had alone
        step0 = self._step_count + 1
        self._step_count += K
        # lengths after the window's first step (pages were pre-extended by
        # K); inactive rows clamp to 0 as in per-step mode
        lens_first = np.maximum(kv_lens - (K - 1), 0).astype(np.int32)
        toks = self._decode_window(tokens, bt, lens_first, temps, step0, K)
        for slot, st in self.active.items():
            for i in range(K):
                tok = int(toks[i, slot])
                st["last_token"] = tok
                st["generated"].append(tok)
                emitted.setdefault(st["id"], []).append(tok)
                if len(st["generated"]) >= st["max_new"] or tok == self.ecfg.eos_token:
                    # the window's overshoot past this is discarded (it only
                    # touched this request's own pages)
                    break
        self.stats["tokens_emitted"] += sum(len(v) for v in emitted.values())
        return emitted

    def _spec_decode(self, emitted: Dict[int, List[int]]) -> None:
        """One speculative step: draft L-1 tokens per request (prompt
        lookup), verify the whole batch in one L-token step, accept the
        longest matching prefix and one bonus token (1..L tokens a request),
        truncate the rejected drafts' pages. The verify step runs eagerly."""
        L = self.ecfg.speculate_k
        self._grow(L)  # pages for every candidate position; rolled back below
        if not self.active:
            return
        bt, kv_lens = self._batch_tables()
        tokens = np.zeros((self.ecfg.max_batch, L), np.int64)
        for slot, st in self.active.items():
            drafts = draft_prompt_lookup(st["prompt"] + st["generated"], L - 1,
                                         self.ecfg.spec_ngram)
            tokens[slot] = [st["last_token"]] + drafts
        self._step_count += 1
        args = (self.params, self._tensor(tokens), self.pools, self._tensor(bt),
                self._tensor(kv_lens), self.cfg)
        if self.mesh is not None:
            from xf_flash_attention_cutlass_tpu_torch.parallel.tp_serve import tp_verify_step

            logits, _ = tp_verify_step(*args, self.mesh, dp_axis=self.n_replicas > 1,
                                       sp_batch=True, rope=self.rope)
        else:
            logits = verify_core(*args, self.rope)
        greedy = self._exchange(torch.argmax(logits, dim=-1))  # (b, L)
        for slot, st in self.active.items():
            g, drafts = greedy[slot], tokens[slot, 1:]
            a = 0
            while a < L - 1 and drafts[a] == g[a]:
                a += 1
            out = [int(t) for t in drafts[:a]] + [int(g[a])]
            out = out[: st["max_new"] - len(st["generated"])]  # the request's budget
            if self.ecfg.eos_token >= 0 and self.ecfg.eos_token in out:
                out = out[: out.index(self.ecfg.eos_token) + 1]
            self.stats["drafts_proposed"] += L - 1
            self.stats["drafts_accepted"] += max(len(out) - 1, 0)
            # the cache keeps [last] + the kept drafts: len(out) inputs
            self.pool.truncate(slot, int(kv_lens[slot]) - L + len(out))
            st["generated"].extend(out)
            st["last_token"] = out[-1]
            emitted.setdefault(st["id"], []).extend(out)

    # ---- the decode window: a plain loop on the CPU, a graph on CUDA ------
    def _window_fn(self, K: int, sampling: bool, tokens, bt, lens, temps, step0):
        """The K-step window over the whole batch's buffers; on a mesh, this
        replica's rows, with the reduce-scatter + all-gather structure (the
        JAX engine's sp_batch, which it runs where it can)."""
        e = self.ecfg
        if self.mesh is not None:
            from xf_flash_attention_cutlass_tpu_torch.parallel.tp_serve import (
                tp_decode_multi_step,
            )

            toks, logits, _ = tp_decode_multi_step(
                self.params, tokens, self.pools, bt, lens, self.cfg, self.mesh,
                temperature=temps if sampling else None, step0=step0, seed=e.sample_seed,
                top_k=e.top_k, top_p=e.top_p, approx_top_k=e.approx_top_k, sp_batch=True,
                dp_axis=self.n_replicas > 1, n_steps=K, rope=self.rope)
            return toks, logits
        return decode_multi_step(
            self.params, tokens, self.pools, bt, lens, self.cfg,
            temperature=temps if sampling else None, step0=step0, seed=e.sample_seed,
            top_k=e.top_k, top_p=e.top_p, approx_top_k=e.approx_top_k, n_steps=K,
            rope=self.rope,
        )

    def _decode_window(self, tokens, bt, lens, temps, step0: int, K: int) -> np.ndarray:
        """K decode steps from host arrays (tokens (b, 1), block tables,
        lengths after the first step, temperatures, the first step's
        count); returns the (K, b) tokens on the host: one read a window (on
        a mesh, then the replicas' exchange of their rows)."""
        sampling = bool(temps.any())
        if self.device.type != "cuda":
            toks, _ = self._window_fn(K, sampling, self._tensor(tokens), self._tensor(bt),
                                      self._tensor(lens), self._tensor(temps),
                                      torch.tensor(step0, dtype=torch.int64))
            return self._exchange(toks.T).T
        g = self._graphs.get((K, sampling)) or self._capture(K, sampling)
        s = self._static
        for name, a in (("tokens", tokens), ("bt", bt), ("lens", lens), ("temps", temps)):
            s[name].copy_(torch.from_numpy(a))
        s["step"].fill_(step0)
        g.graph.replay()
        # a replay runs no wrapper's host code: the launches and collectives
        # its capture counted are added here
        _build.LAUNCHES.update(g.launches)
        _build.HEAD_DIM_LAUNCHES.update(g.head_dims)
        _build.LAUNCHES[g.label] += 1
        return self._exchange(g.tokens.T).T

    def _capture(self, K: int, sampling: bool) -> _DecodeGraph:
        """Capture the K-step window (sampling on or off) as a CUDA graph.
        It runs first eagerly on inactive rows (trash-page tables, length 0:
        it writes only the trash page), which builds the kernels' libraries
        and runs their first-call setup (shared-memory limits, the driver
        entry point of the tensor-map encoder, K3's split counters) before
        capture. The wrappers count their launches on the host during
        capture; those counts are taken back out and added on every replay
        instead."""
        mb, mp = self.ecfg.max_batch, self.ecfg.max_pages_per_seq
        if self._static is None:
            dev = self.device
            self._static = dict(
                tokens=torch.zeros((mb, 1), dtype=torch.int64, device=dev),
                bt=torch.zeros((mb, mp), dtype=torch.int32, device=dev),
                lens=torch.zeros((mb,), dtype=torch.int32, device=dev),
                temps=torch.zeros((mb,), dtype=torch.float32, device=dev),
                step=torch.zeros((), dtype=torch.int64, device=dev),
            )
            self._graph_pool = torch.cuda.graph_pool_handle()
        s = self._static
        s["tokens"].zero_()
        s["bt"].fill_(self.trash_page)
        s["lens"].zero_()
        s["temps"].zero_()
        s["step"].zero_()

        def run():
            return self._window_fn(K, sampling, s["tokens"], s["bt"], s["lens"], s["temps"],
                                   s["step"])

        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = Counter(_build.LAUNCHES), Counter(_build.HEAD_DIM_LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            toks, logits = run()
        launches = _take_back(_build.LAUNCHES, before[0])
        head_dims = _take_back(_build.HEAD_DIM_LAUNCHES, before[1])
        g = _DecodeGraph(graph, toks, logits, launches,
                         "graph.decode_multi_step" if K > 1 else "graph.decode", head_dims)
        self._graphs[(K, sampling)] = g
        return g

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


_NOT_PORTED_AXES = (
    ("ep", "expert parallelism (the JAX package's parallel/ep.py and ep_serve.py)"),
    ("pp", "pipeline parallelism (the JAX package's parallel/pp.py and pp_serve.py)"),
    ("cp", "context parallelism (the JAX package's parallel/ring.py and ulysses.py)"),
)


def _check_mesh(mesh, cfg: LlamaConfig, ecfg: EngineConfig, device: torch.device):
    """(dp, tp) of the mesh to serve on; (1, 1) without one. Raises
    NotImplementedError for a mesh axis the port does not serve yet (ep, pp
    or cp > 1: nothing is served another way) and ValueError for what the
    JAX engine refuses too."""
    if mesh is None:
        return 1, 1
    from torch.distributed.device_mesh import DeviceMesh

    from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import AXES, DP, TP, axis_size

    if not (isinstance(mesh, DeviceMesh) and mesh.mesh_dim_names == AXES):
        raise NotImplementedError(
            f"not served: a mesh other than a DeviceMesh with the axes {AXES} "
            f"(parallel/mesh.py make_mesh), got {type(mesh).__name__}")
    for axis, what in _NOT_PORTED_AXES:
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(f"not ported yet: {what}; the mesh has {axis} = "
                                      f"{axis_size(mesh, axis)}")
    if mesh.device_type != device.type:
        raise ValueError(f"the mesh is on {mesh.device_type}, the engine on {device.type}")
    if not ecfg.prefill_chunk:
        raise ValueError("mesh mode serves prefill through the chunked path: set "
                         "EngineConfig.prefill_chunk")
    dp, tp = axis_size(mesh, DP), axis_size(mesh, TP)
    for name, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{name} {n} must divide by tp={tp}")
    if dp > 1:
        for name, val in (("max_batch", ecfg.max_batch), ("num_pages", ecfg.num_pages),
                          ("prefill_lanes", ecfg.prefill_lanes)):
            if val % dp:
                raise ValueError(f"{name} ({val}) must divide by dp={dp}")
        # the replicas exchange their sampled tokens as host tensors
        backends = str(dist.get_backend_config(mesh.get_group(DP)))
        if "cpu:" not in backends:
            raise ValueError(f"dp={dp} needs a CPU backend in the process group (e.g. "
                             f"'cpu:gloo,cuda:nccl'); it has {backends!r}")
    return dp, tp
