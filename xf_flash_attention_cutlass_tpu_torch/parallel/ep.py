"""Expert parallelism (EP) for the MoE family over ``torch.distributed``.

Layout, as the JAX package's ``parallel/ep.py`` shards it:
- the expert leaves (``w_gate``, ``w_up``, ``w_down`` and their scales) are
  sharded on their expert axis over the mesh's "ep" axis, E = ep * E_local
  experts, each rank's block a contiguous tensor (the weight-only matmul's
  Hopper routes read whole rows; ``parallel/tp.py`` ``shard_params``);
  attention, router and the rest are replicated;
- the batch rows are sharded over the (dp, ep) replicas: every rank routes
  its own tokens and builds the (E, C, d) GShard blocks of its dispatch
  (``models/moe.py``), C from its local token count;
- one all-to-all sends block i of the expert axis to ep rank i, which then
  holds its E_local experts' blocks from every rank, (E_local, ep * C, d),
  source rank j's tokens at capacity offset j * C; the local experts run,
  and the inverse all-to-all returns each (E, C, d) block to its tokens'
  owner for the combine.

The exchange is differentiable (``utils/collectives.py`` ``all_to_all``:
its backward is the inverse exchange), so the same code trains. Every rank
is a process that holds its own shards; the step functions take the global
batch (the same on every rank) and return this rank's replica's rows.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch.models.moe import (
    EXPERT_NAMES,
    MoEConfig,
    expert_capacity,
    expert_ffn,
    moe_forward,
    moe_loss_fn,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import DP, EP, axis_size
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import (
    _leaves,
    _map2,
    _map_with_path,
    replica,
    replica_rows,
    shard_leaf,
)
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import all_reduce_, all_to_all


def expert_axis(path, leaf: torch.Tensor):
    """The expert axis of an expert leaf, None for any other leaf: dim -3
    of a weight (..., E, d_in, d_out), dim -2 of a quantized pair's scale
    (..., E, d_out), which is item 1 of its tuple."""
    names = [p for p in path if isinstance(p, str)]
    if not names or names[-1] not in EXPERT_NAMES:
        return None
    is_scale = type(path[-1]) is int and path[-1] == 1
    return leaf.dim() - (2 if is_scale else 3)


def moe_param_partition_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Each leaf's spec (a tuple, one entry a dim): the expert leaves
    sharded over "ep" on their expert axis, the rest replicated."""

    def spec_for(path, leaf):
        spec = [None] * leaf.dim()
        axis = expert_axis(path, leaf)
        if axis is not None:
            spec[axis] = EP
        return tuple(spec)

    return _map_with_path(spec_for, params)


def shard_moe_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shard of every leaf under moe_param_partition_specs."""
    return _map2(lambda x, s: shard_leaf(x, s, mesh), params, moe_param_partition_specs(params))


def ep_expert_apply(layer: Dict[str, Any], expert_in: torch.Tensor, *, group) -> torch.Tensor:
    """The ep_fn hook of models/moe.py's moe_mlp_block. expert_in: (E, C, d),
    this rank's tokens dispatched to all E experts; layer's expert leaves:
    this rank's E_local = E / ep experts. Returns (E, C, d): every expert's
    output for this rank's tokens."""
    E, n = expert_in.shape[0], dist.get_world_size(group)
    if E % n:
        raise ValueError(f"n_experts {E} must divide by ep={n}")
    x = all_to_all(expert_in, group, split_dim=0, concat_dim=1)  # (E_local, ep * C, d)
    y = expert_ffn(layer["w_gate"], layer["w_up"], layer["w_down"], x)
    return all_to_all(y, group, split_dim=1, concat_dim=0)


def _replica_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """x averaged over the (dp, ep) replicas: summed over ep, then dp."""
    for axis in (EP, DP):
        x = all_reduce_(x, mesh.get_group(axis))
    return x / replica(mesh)[0]


def _local_step(mesh, tokens: torch.Tensor):
    """(this replica's rows, the ep hook); the dispatch capacity comes from
    the local token count."""
    return (tokens[replica_rows(mesh, tokens.shape[0])],
            functools.partial(ep_expert_apply, group=mesh.get_group(EP)))


def moe_ep_forward(params, tokens: torch.Tensor, cfg: MoEConfig,
                   mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dp x ep MoE forward. params: this rank's shards
    (shard_moe_params); tokens: the global (b, s) batch. Returns (the
    logits of this rank's replica's rows, (b / (dp * ep), s, vocab) f32,
    the aux loss averaged over the replicas)."""
    rows, ep_fn = _local_step(mesh, tokens)
    b, s = rows.shape
    logits, aux = moe_forward(params, rows, cfg, capacity=expert_capacity(cfg, b * s),
                              ep_fn=ep_fn)
    return logits, _replica_mean(aux.detach().clone(), mesh)


def moe_ep_loss_and_grad(params, tokens: torch.Tensor, cfg: MoEConfig,
                         mesh) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One dp x ep training step: the loss and this rank's shards'
    gradients, the experts never gathered. tokens: the global (b, s + 1)
    batch. Each replica differentiates its own rows' mean loss; the loss is
    the replicas' mean. The bookkeeping of the JAX package: a replicated
    leaf's gradient (local tokens only) is averaged over dp and ep; an
    expert leaf's, which the inverse exchange's backward already summed
    over the ep group's shards, is averaged over dp and scaled by 1 / ep.
    Returns (loss, grads), grads with params' structure (None for a leaf
    that is not floating point)."""
    rows, ep_fn = _local_step(mesh, tokens)
    b, s = rows.shape
    local = _map_with_path(
        lambda _, x: x.detach().requires_grad_(True) if x.is_floating_point() else x, params)
    leaves = [x for x in _leaves(local) if x.requires_grad]
    with torch.enable_grad():
        loss = moe_loss_fn(local, rows, cfg, capacity=expert_capacity(cfg, b * (s - 1)),
                           ep_fn=ep_fn)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(x): g for x, g in zip(leaves, grads)}
    dp_group, ep_group = mesh.get_group(DP), mesh.get_group(EP)
    dp, ep = axis_size(mesh, DP), axis_size(mesh, EP)

    def reduce(path, x):
        g = by_leaf.get(id(x))
        if g is None:
            return None
        g = all_reduce_(g.detach().clone(), dp_group) / dp
        if expert_axis(path, x) is not None:
            return g / ep
        return all_reduce_(g, ep_group) / ep

    grads = _map_with_path(reduce, local)
    return _replica_mean(loss.detach().clone(), mesh), grads
