"""The collectives of the parallel layers, over ``torch.distributed``
process groups, each counted where it is issued.

Every call adds one to ``_build.LAUNCHES["collective.<op>"]`` on the host,
as a kernel wrapper counts its launches, so that a captured decode graph
records its collectives at capture and re-adds them on every replay
(``serve/engine.py``). The collectives are issued at every group size, a
group of one rank included: NCCL then captures them into the graph like any
kernel, and the path the card runs at tp = 1 is the path of a wider mesh.

Gathers and the reduce-scatter act on dim 0 of a contiguous buffer (the
layout of ``all_gather_into_tensor`` and ``reduce_scatter_tensor``); other
dims are moved to the front and back. The sums follow the backend's order
(gloo or NCCL), not the JAX package's psum order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch import _build

# all_gather_single and reduce_scatter_single are the newer names of
# all_gather_into_tensor and reduce_scatter_tensor; older torch has only those
_all_gather_base = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_base = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _count(op: str) -> None:
    _build.LAUNCHES[f"collective.{op}"] += 1


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum x over the group, in place; returns x."""
    _count("all_reduce")
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order (JAX's tiled
    all_gather)."""
    n = dist.get_world_size(group)
    _count("all_gather")
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    _all_gather_base(out, x.contiguous(), group=group)
    dim = dim % x.dim()
    if dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Sum x over the group and keep this rank's block of `dim` (JAX's
    tiled psum_scatter); x.shape[dim] must divide by the group size."""
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide by {n}")
    _count("reduce_scatter")
    shape = list(x.shape)
    shape[dim] //= n
    if dim == 0:
        out = x.new_empty(shape)
        _reduce_scatter_base(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
        return out
    # the n blocks of dim to the front, each a contiguous slab of dim 0
    blocks = x.reshape(*shape[:dim], n, *shape[dim:]).movedim(dim, 0).contiguous()
    out = x.new_empty(blocks.shape[1:])
    _reduce_scatter_base(out, blocks.view(n * out.shape[0], *out.shape[1:]),
                         op=dist.ReduceOp.SUM, group=group)
    return out
