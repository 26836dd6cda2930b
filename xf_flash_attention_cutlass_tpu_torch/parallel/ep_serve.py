"""Expert-parallel serving of the MoE family over ``torch.distributed``.

The deployment of Mixtral-class models whose experts exceed one card: the
expert leaves shard on their expert axis over the mesh's "ep" axis, and the
batch (requests, KV pages, block tables) shards over ep as over dp, so an
ep rank is one more replica: it runs attention, the router and the dispatch
for its own requests, and only the GShard (E, C, d) blocks cross ranks (the
all-to-all pair of ``parallel/ep.py``), once each way a layer. As in the
JAX package's ``parallel/ep_serve.py``:
- ep alone: the non-expert params replicated, E / ep experts a rank;
- dp x ep: both axes shard the batch (replica r = dp_idx * ep + ep_idx);
- ep x tp: tp also shards the heads and the experts' ffn dim
  (``parallel/tp.py``); the exchange moves blocks of the full model width,
  and the tp all-reduce follows the combine.

The steps are ``parallel/tp_serve.py``'s with ``dp_axis`` and ``ep_axis``
on: they take the global batch and return this replica's rows. The
dispatch capacity of a shard comes from its own rows (lanes), so the batch
must divide by the replicas.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig
from xf_flash_attention_cutlass_tpu_torch.parallel.ep import expert_axis
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import EP
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import (
    _map2,
    _map_with_path,
    param_partition_specs,
    shard_leaf,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.tp_serve import (
    pool_partition_specs,
    tp_decode_step,
    tp_prefill_chunk_step,
)


def ep_param_partition_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The engine layout's specs (stacked (L, E, ...) expert leaves): the
    expert leaves' expert axis over "ep"; the rest as parallel/tp.py shards
    it over "tp" (whole on a mesh of tp = 1, where every block is the
    leaf)."""
    base = param_partition_specs(params)

    def add_ep(path, leaf):
        spec = base
        for p in path:
            spec = spec[p]
        axis = expert_axis(path, leaf)
        if axis is None:
            return spec
        if spec[axis] is not None:
            raise ValueError(f"expert leaf {path} axis {axis} already sharded: {spec}")
        return spec[:axis] + (EP,) + spec[axis + 1:]

    return _map_with_path(add_ep, params)


def shard_ep(params, pools, mesh):
    """This rank's engine MoE params and pools for ep serving: (params,
    pools), each leaf a contiguous tensor (the tensor itself where it is
    whole); the pools' pages over the (dp, ep) replicas, their kv heads
    over tp (parallel/tp_serve.py pool_partition_specs)."""
    pspecs = ep_param_partition_specs(params)
    kspecs = pool_partition_specs(pools, dp_axis=True, ep_axis=True)
    return (_map2(lambda x, s: shard_leaf(x, s, mesh), params, pspecs),
            {name: shard_leaf(t, kspecs[name], mesh) for name, t in pools.items()})


def ep_decode_step(params, tokens, pools, block_tables, kv_lens, cfg: LlamaConfig, mesh,
                   temperature: Optional[torch.Tensor] = None, step=None, seed: int = 0,
                   top_k: int = 0, top_p: float = 0.0, approx_top_k: bool = True, rope=None):
    """One expert-parallel MoE decode step. tokens (b, 1), block_tables (b,
    max_pages) of replica-local page ids, kv_lens (b,): the global batch,
    sharded over the (dp, ep) replicas. Returns (next_tokens, logits,
    pools): this replica's rows, its pools updated in place."""
    return tp_decode_step(params, tokens, pools, block_tables, kv_lens, cfg, mesh,
                          temperature, step, seed, top_k, top_p, approx_top_k,
                          dp_axis=True, ep_axis=True, rope=rope)


def ep_prefill_chunk_step(params, tokens, n_prior, n_valid, pools, bt, cfg: LlamaConfig, mesh,
                          rope=None):
    """Expert-parallel batched chunked prefill: tokens (P, C), n_prior and
    n_valid (P,), bt (P, max_pages), the lanes sharded like the decode
    batch. Returns ((P_local, vocab) logits, pools)."""
    return tp_prefill_chunk_step(params, tokens, n_prior, n_valid, pools, bt, cfg, mesh,
                                 dp_axis=True, ep_axis=True, rope=rope)
