"""Tensor- and data-parallel transformer execution over ``torch.distributed``.

Megatron-style tensor parallelism, as the JAX package lays it out: weights
are sharded along their head and ffn axes over the mesh's "tp" axis, each
rank runs the kernels on its local heads (attention needs no traffic
between ranks: heads are independent), and two all-reduces a layer (after
the O projection and after the MLP's down projection) join the partial
sums. Data parallelism is the "dp" axis over the batch; the training step
averages the loss and the gradients over it.

The JAX package runs one program over global arrays under ``shard_map``.
Here every rank is a process that holds its own shards: ``shard_params``
keeps this rank's block of each sharded leaf, and the step functions take
the global batch (the same on every rank), compute this rank's replica's
rows and return them. A caller that wants the whole batch gathers the
replicas' rows (``parallel/tp_serve.py`` ``gather_rows``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    _proj,
    attention_block,
    gather_vocab,
    layer_view,
    mlp_block,
    rms_norm,
    tp_region_in,
)
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import rotary_frequencies
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import DP, EP, TP, axis_index, axis_size
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import all_reduce_

_OUT_SHARDED = ("wq", "wk", "wv", "w_gate", "w_up")
_IN_SHARDED = ("wo", "w_down")


def _map_with_path(fn: Callable, tree, path=()):
    """fn(path, leaf) over a tree of dicts, tuples and lists of tensors; the
    path holds the dict keys and the tuple positions; None stays None."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _map2(fn: Callable, tree, other):
    """fn(leaf, other's leaf) over two trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    if tree is None:
        return None
    return fn(tree, other)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_with_path(lambda _, x: out.append(x), tree)
    return out


def param_partition_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The partition spec of every leaf, in the JAX package's form: a tuple
    with one entry a dim, "tp" where the dim is sharded over the tp axis
    and None where it is whole. QKV, gate and up are sharded on their output
    dim, O and down on their input dim, the lm_head on the vocabulary, MoE
    expert scales on the ffn dim; the rest is replicated. Leaves are keyed
    by their innermost name and, for quantized tuples (w_q, scale), by
    their position: the scale is item 1."""

    def spec_for(path, leaf):
        names = [p for p in path if isinstance(p, str)]
        name = names[-1] if names else None
        nd = leaf.dim()
        f32 = leaf.dtype == torch.float32
        is_scale = nd in (1, 2) and name in _OUT_SHARDED + _IN_SHARDED + ("lm_head",) and f32
        # MoE expert scales are (L, E, d_out) at tuple position 1; a 3-D
        # full-precision Llama weight has the same rank but no tuple position
        in_tuple_scale = any(isinstance(p, int) and p == 1 for p in path)
        if name in ("w_gate", "w_up", "w_down") and nd == 3 and f32 and in_tuple_scale:
            if name == "w_down":  # (L, E, d): the output dim is whole
                return (None, None, None)
            return (None, None, TP)  # (L, E, f): the ffn dim sharded
        if name in _OUT_SHARDED:
            if is_scale:  # (L, d_out) or (d_out,)
                return (None,) * (nd - 1) + (TP,)
            return (None,) * (nd - 2) + (None, TP)
        if name in _IN_SHARDED:
            if is_scale:  # the output dim is whole; the input dim was sharded
                return (None,) * nd
            return (None,) * (nd - 2) + (TP, None)
        if name == "lm_head":
            if is_scale:
                return (None,) * (nd - 1) + (TP,)
            return (None, TP)
        return (None,) * nd

    return _map_with_path(spec_for, params)


def shard_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of x under `spec` (one entry a dim: None where
    the dim is whole, an axis name, or a tuple of axes sharding it over
    their replicas, row-major), as a contiguous tensor; x itself where
    every sharding axis has one rank."""
    whole = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n, i = replica(mesh, axes if isinstance(axes, tuple) else (axes,))
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not divide by "
                             f"{axes}={n}")
        k = x.shape[dim] // n
        x = x.narrow(dim, i * k, k)
    return whole if x is whole else x.contiguous()


def _block(mesh, rank: int, spec) -> Tuple[int, ...]:
    """rank's block index on each dim of a leaf under `spec` (0 where the
    dim is whole): its replica over the dim's axes, as shard_leaf takes it."""
    names, ranks = mesh.mesh_dim_names, mesh.mesh
    coord = (ranks == rank).nonzero()[0].tolist()
    out = []
    for axes in spec:
        i = 0
        for axis in (axes if isinstance(axes, tuple) else (axes,)) if axes else ():
            k = names.index(axis)
            i = i * ranks.shape[k] + coord[k]
        out.append(i)
    return tuple(out)


def gather_to_rank0(x: torch.Tensor, spec, mesh, pad: Optional[Dict[int, int]] = None
                    ) -> Optional[torch.Tensor]:
    """The whole tensor of which x is this rank's shard_leaf under `spec`,
    on rank 0's host; None on the other ranks (every rank of the mesh calls
    it; mesh None: x is whole). Each block goes to rank 0 once, as host
    bytes over the default group's CPU backend, from the lowest rank that
    holds it: no rank holds more than its block and a host copy of it, and
    rank 0 besides the whole tensor and one received block. `pad` {dim: n}:
    rank 0's tensor zero-padded to n entries on those dims, the whole one
    in its leading corner."""
    if mesh is None:
        blocks, me, spec = {(0,) * x.dim(): 0}, 0, (None,) * x.dim()
    else:
        me, blocks = dist.get_rank(), {}
        for q in sorted(mesh.mesh.flatten().tolist()):
            blocks.setdefault(_block(mesh, q, spec), q)
        if len(blocks) > 1 and "cpu:" not in str(dist.get_backend_config()):
            raise ValueError("gathering a sharded leaf needs a CPU backend in the default "
                             "process group (e.g. 'cpu:gloo,cuda:nccl')")
    if me != 0:
        if blocks[_block(mesh, me, spec)] == me:
            dist.send(x.detach().contiguous().cpu().reshape(-1).view(torch.uint8), dst=0)
        return None
    shape = [n * (replica(mesh, a if isinstance(a, tuple) else (a,))[0] if a else 1)
             for n, a in zip(x.shape, spec)]
    for dim, n in (pad or {}).items():
        shape[dim % x.dim()] = n
    out = torch.zeros(shape, dtype=x.dtype)
    buf = None
    for key, q in blocks.items():
        if q == 0:
            src = x.detach()
        else:
            if buf is None:
                buf = torch.empty(x.shape, dtype=x.dtype)
            dist.recv(buf.reshape(-1).view(torch.uint8), src=q)
            src = buf
        region = out
        for dim, i in enumerate(key):
            region = region.narrow(dim, i * x.shape[dim], x.shape[dim])
        region.copy_(src)
    return out


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shard of every leaf (param_partition_specs over the
    mesh's tp axis), each a contiguous tensor: the weight-only matmul's
    Hopper routes read row strides of n * itemsize, and a strided column
    view would take its WMMA route. Replicated leaves are kept as given."""
    return _map2(lambda x, s: shard_leaf(x, s, mesh), params, param_partition_specs(params))


def _local_cfg(cfg: LlamaConfig, tp_size: int) -> LlamaConfig:
    """cfg with the head counts of one tp rank's shard (the head size kept)."""
    if cfg.n_heads % tp_size or cfg.n_kv_heads % tp_size:
        raise ValueError(
            f"n_heads {cfg.n_heads} / n_kv_heads {cfg.n_kv_heads} must divide tp={tp_size}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp_size,
                               n_kv_heads=cfg.n_kv_heads // tp_size,
                               head_dim_override=cfg.head_dim)


def replica(mesh, axes=(DP, EP)) -> Tuple[int, int]:
    """(the number of replicas, this rank's replica) over the batch axes
    `axes`: a replica is one coordinate on each, numbered row-major, so on
    (dp, ep) replica r = dp_idx * ep + ep_idx (the JAX package's order of
    the (dp, ep) batch sharding and of the engine's replicas)."""
    n, r = 1, 0
    for axis in axes:
        k = axis_size(mesh, axis)
        n, r = n * k, r * k + axis_index(mesh, axis)
    return n, r


def replica_rows(mesh, n: int, axes=(DP, EP)) -> slice:
    """The rows of an n-row global batch that this rank's replica owns (a
    replica: one (dp, ep) pair, or the axes given)."""
    R, r = replica(mesh, axes)
    if n % R:
        raise ValueError(f"a batch of {n} rows does not divide by the {R} replicas of {axes}")
    k = n // R
    return slice(r * k, (r + 1) * k)


def _tp_forward_local(params, tokens: torch.Tensor, cfg: LlamaConfig, group) -> torch.Tensor:
    """This rank's forward of its rows: local heads, two all-reduces a layer,
    the vocab-sharded logits gathered. (b, s, vocab) f32."""
    lcfg = _local_cfg(cfg, dist.get_world_size(group))
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base, device=x.device)
    layers = {n: v if isinstance(v, tuple) else list(v.unbind(0))
              for n, v in params["layers"].items()}
    for l in range(cfg.n_layers):
        layer = layer_view(layers, l)
        x = attention_block(layer, x, lcfg, cos, sin, positions, group=group)
        x = mlp_block(layer, x, lcfg, group=group)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    x = tp_region_in(x, group)  # the vocab-sharded head's region
    return gather_vocab(_proj(x, params["lm_head"]).float(), group)


def tp_forward(params, tokens: torch.Tensor, cfg: LlamaConfig, mesh) -> torch.Tensor:
    """The tensor- and data-parallel forward. params: this rank's shards
    (shard_params); tokens: the global (b, s) batch, the same on every rank.
    Returns the logits of this rank's replica's rows, (b / dp, s, vocab)
    f32, the same on every tp rank of the replica."""
    return _tp_forward_local(params, tokens[replica_rows(mesh, tokens.shape[0], (DP,))], cfg,
                             mesh.get_group(TP))


def tp_loss_and_grad(params, tokens: torch.Tensor, cfg: LlamaConfig,
                     mesh) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One data- and tensor-parallel training step's loss and gradients.
    params: this rank's shards; tokens: the global (b, s + 1) batch. Each
    replica takes the next-token cross entropy over its rows; the loss and
    the gradients are averaged over dp. Returns (loss, grads): grads has
    params' structure, each this rank's shard's gradient (None for a leaf
    that is not floating point). A replicated leaf's gradient is already
    whole and the same on every tp rank: the region markers all-reduce the
    cotangents where they leave the sharded regions (Megatron's f and g)."""
    group, dp_group = mesh.get_group(TP), mesh.get_group(DP)
    dp = axis_size(mesh, DP)
    rows = tokens[replica_rows(mesh, tokens.shape[0], (DP,))]
    local = _map_with_path(
        lambda _, x: x.detach().requires_grad_(True) if x.is_floating_point() else x, params)
    leaves = [x for x in _leaves(local) if x.requires_grad]
    with torch.enable_grad():
        logits = _tp_forward_local(local, rows[:, :-1], cfg, group)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, rows[:, 1:, None].long())[..., 0].mean()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(x): g for x, g in zip(leaves, grads)}

    def dp_mean(t):
        return None if t is None else all_reduce_(t.detach().clone(), dp_group) / dp

    out = _map_with_path(lambda _, x: dp_mean(by_leaf.get(id(x))), local)
    return dp_mean(loss), out
