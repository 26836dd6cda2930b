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
from typing import Any, Callable, Dict, List, Tuple

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
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import DP, TP, axis_index, axis_size
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


def _shard(x: torch.Tensor, spec, axis: str, n: int, i: int) -> torch.Tensor:
    """Rank i's block of x along the dim that `spec` shards over `axis`, as
    a contiguous tensor (x itself where the dim is whole)."""
    if axis not in spec:
        return x
    dim = spec.index(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf does not divide by {axis}={n}")
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k).contiguous()


def shard_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shard of every leaf (param_partition_specs over the
    mesh's tp axis), each a contiguous tensor: the weight-only matmul's
    Hopper routes read row strides of n * itemsize, and a strided column
    view would take its WMMA route. Replicated leaves are kept as given."""
    n, i = axis_size(mesh, TP), axis_index(mesh, TP)
    return _map2(lambda x, s: _shard(x, s, TP, n, i), params, param_partition_specs(params))


def _local_cfg(cfg: LlamaConfig, tp_size: int) -> LlamaConfig:
    """cfg with the head counts of one tp rank's shard (the head size kept)."""
    if cfg.n_heads % tp_size or cfg.n_kv_heads % tp_size:
        raise ValueError(
            f"n_heads {cfg.n_heads} / n_kv_heads {cfg.n_kv_heads} must divide tp={tp_size}")
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp_size,
                               n_kv_heads=cfg.n_kv_heads // tp_size,
                               head_dim_override=cfg.head_dim)


def replica_rows(mesh, n: int) -> slice:
    """The rows of an n-row global batch that this rank's dp replica owns."""
    dp = axis_size(mesh, DP)
    if n % dp:
        raise ValueError(f"a batch of {n} rows does not divide by dp={dp}")
    k = n // dp
    r = axis_index(mesh, DP)
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
    return _tp_forward_local(params, tokens[replica_rows(mesh, tokens.shape[0])], cfg,
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
    rows = tokens[replica_rows(mesh, tokens.shape[0])]
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
