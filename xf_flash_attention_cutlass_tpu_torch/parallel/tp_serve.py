"""Tensor- and data-parallel paged serving: the engine's cores on a dp x tp
mesh, one process a rank.

Layout, as the JAX package's ``parallel/tp_serve.py`` shards it:
- params: the training layout (``parallel/tp.py``): QKV out-sharded, O
  in-sharded, the lm_head vocab-sharded, the rest replicated;
- KV pools ``(L, num_pages, h_k, page[, d])``: the kv heads over "tp", so
  each rank appends and attends over its local heads only (no traffic
  inside attention); with ``dp_axis`` and / or ``ep_axis`` the pages over
  those replica axes too, each replica owning its own page range,
  addressed by replica-local page ids;
- with ``ep_axis`` (expert parallelism, ``parallel/ep_serve.py``) an ep
  rank is one more replica of the batch, and the MoE layers' expert leaves
  are sharded on their expert axis; the dispatched blocks cross the ep
  group by an all-to-all each way (``parallel/ep.py``);
- per layer two all-reduces (after the O projection and after the MLP), or
  with ``sp_batch`` a reduce-scatter and an all-gather in place of each;
  one all-gather of the vocab-sharded logits, so that every rank of a
  replica samples the same tokens.

Every function takes the global batch (tokens, block tables, lengths: the
same on every rank) and this rank's pool shards, runs this rank's
replica's rows (all rows without ``dp_axis`` or ``ep_axis``) and returns
them: the logits, tokens and pools of its replica. A replica is one
coordinate on each replica axis, numbered row-major: r = dp_idx * ep +
ep_idx. ``gather_rows`` joins the replicas' rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import DP, EP, TP
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import (
    _local_cfg,
    replica_rows,
    shard_leaf,
)
from xf_flash_attention_cutlass_tpu_torch.serve.engine import (
    decode_core,
    decode_multi_step,
    prefill_chunk_core,
    verify_core,
)
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import all_gather


def batch_axes(dp_axis: bool, ep_axis: bool) -> tuple:
    """The replica axes the batch rows and the pool pages shard over."""
    return tuple(a for a, on in ((DP, dp_axis), (EP, ep_axis)) if on)


def pool_partition_specs(pools: Dict[str, torch.Tensor], dp_axis: bool = False,
                         ep_axis: bool = False) -> dict:
    """Pool specs: kv heads (dim 2) over tp; the pages (dim 1) over the
    replica axes (dp, ep) that are on (a tuple when both are)."""
    axes = batch_axes(dp_axis, ep_axis)
    pages = axes if len(axes) > 1 else (axes[0] if axes else None)
    return {name: (None, pages, TP) + (None,) * (t.dim() - 3) for name, t in pools.items()}


def shard_pools(pools: Dict[str, torch.Tensor], mesh, dp_axis: bool = False,
                ep_axis: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's block of every pool: its kv heads, and with dp_axis /
    ep_axis its replica's pages; each a contiguous tensor."""
    specs = pool_partition_specs(pools, dp_axis, ep_axis)
    return {name: shard_leaf(t, specs[name], mesh) for name, t in pools.items()}


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The replicas' rows (dim 0) joined in replica order: the global batch
    of what each (dp, ep) replica returned. Gathered over ep, then over dp,
    which gives the order r = dp_idx * ep + ep_idx."""
    for axis in (EP, DP):
        x = all_gather(x, mesh.get_group(axis))
    return x


def _local(mesh, dp_axis: bool, ep_axis: bool, n: int):
    """(this rank's rows of an n-row batch, the tp group, the tp size, the
    ep group or None)."""
    group = mesh.get_group(TP)
    axes = batch_axes(dp_axis, ep_axis)
    rows = replica_rows(mesh, n, axes) if axes else slice(0, n)
    return rows, group, dist.get_world_size(group), mesh.get_group(EP) if ep_axis else None


def tp_decode_step(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig, mesh,
                   temperature: Optional[torch.Tensor] = None, step=None, seed: int = 0,
                   top_k: int = 0, top_p: float = 0.0, approx_top_k: bool = True,
                   sp_batch: bool = False, dp_axis: bool = False, ep_axis: bool = False,
                   rope=None):
    """One tensor-parallel decode step (the engine's decode_core on local
    heads). tokens (b, 1), block_tables (b, max_pages) (replica-local page
    ids with dp_axis / ep_axis), kv_lens (b,) and temperature (b,) are
    global.
    Returns (next_tokens, logits, pools): this replica's rows, its pools
    updated in place."""
    rows, group, tp, ep_group = _local(mesh, dp_axis, ep_axis, tokens.shape[0])
    temps = None if temperature is None else temperature[rows]
    nt, logits = decode_core(params, tokens[rows], pools, block_tables[rows], kv_lens[rows],
                             _local_cfg(cfg, tp), temps, step, seed, top_k, top_p, approx_top_k,
                             rope, group, sp_batch, rows.start, ep_group)
    return nt, logits, pools


def tp_decode_multi_step(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig, mesh,
                         temperature: Optional[torch.Tensor] = None, step0=None, seed: int = 0,
                         top_k: int = 0, top_p: float = 0.0, approx_top_k: bool = True,
                         sp_batch: bool = False, dp_axis: bool = False, ep_axis: bool = False,
                         n_steps: int = 2, rope=None):
    """The mesh counterpart of decode_multi_step: n_steps decode steps in
    one call (one CUDA graph in the engine), the same sampling schedule as
    n_steps tp_decode_step calls. kv_lens is the length after the first
    step. Returns ((n_steps, b_local) tokens, the last step's logits,
    pools)."""
    rows, group, tp, ep_group = _local(mesh, dp_axis, ep_axis, tokens.shape[0])
    temps = None if temperature is None else temperature[rows]
    toks, logits = decode_multi_step(params, tokens[rows], pools, block_tables[rows],
                                     kv_lens[rows], _local_cfg(cfg, tp), temps, step0, seed,
                                     top_k, top_p, approx_top_k, n_steps, rope, group, sp_batch,
                                     rows.start, ep_group)
    return toks, logits, pools


def tp_verify_step(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig, mesh,
                   dp_axis: bool = False, ep_axis: bool = False, sp_batch: bool = False,
                   rope=None):
    """Tensor-parallel speculative verification: the L-token counterpart of
    tp_decode_step. tokens (b, L), kv_lens the lengths after the step.
    Returns ((b_local, L, vocab) logits, pools)."""
    rows, group, tp, ep_group = _local(mesh, dp_axis, ep_axis, tokens.shape[0])
    logits = verify_core(params, tokens[rows], pools, block_tables[rows], kv_lens[rows],
                         _local_cfg(cfg, tp), rope, group, sp_batch, ep_group)
    return logits, pools


def tp_prefill_chunk_step(params, tokens, n_prior, n_valid, pools, bt, cfg: LlamaConfig, mesh,
                          dp_axis: bool = False, ep_axis: bool = False, rope=None):
    """Tensor-parallel batched chunked prefill (prefill_chunk_core on local
    heads, plain all-reduces). tokens (P, C), n_prior and n_valid (P,), bt
    (P, max_pages); with dp_axis / ep_axis the lanes are split over the
    replicas.
    Returns ((P_local, vocab) logits, pools)."""
    rows, group, tp, ep_group = _local(mesh, dp_axis, ep_axis, tokens.shape[0])
    logits = prefill_chunk_core(params, tokens[rows], n_prior[rows], n_valid[rows], pools,
                                bt[rows], _local_cfg(cfg, tp), rope, group, ep_group)
    return logits, pools


def tp_dp_decode_step(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig, mesh,
                      rope=None):
    """Data- x tensor-parallel greedy decode: each dp replica serves its own
    rows against its own pages (block tables of replica-local ids, the pool
    shards from shard_pools(..., dp_axis=True)); nothing crosses replicas.
    Returns (next_tokens, logits, pools) of this replica's rows."""
    return tp_decode_step(params, tokens, pools, block_tables, kv_lens, cfg, mesh,
                          dp_axis=True, rope=rope)
