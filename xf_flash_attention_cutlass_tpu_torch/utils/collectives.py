"""The collectives of the parallel layers, over ``torch.distributed``
process groups, each counted where it is issued.

Every call adds one to ``_build.LAUNCHES["collective.<op>"]`` on the host,
as a kernel wrapper counts its launches, so that a captured decode graph
records its collectives at capture and re-adds them on every replay
(``serve/engine.py``). The collectives are issued at every group size, a
group of one rank included: NCCL then captures them into the graph like any
kernel, and the path the card runs at tp = 1 is the path of a wider mesh.

Gathers, the reduce-scatter and the all-to-all act on dim 0 of a
contiguous buffer (the layout of ``all_gather_into_tensor``,
``reduce_scatter_tensor`` and ``all_to_all_single``); other dims are moved
to the front and back. The sums follow the backend's order (gloo or NCCL),
not the JAX package's psum order. ``ppermute`` is the pipeline's stage
shift, a ring of paired point-to-point calls; ``ppermute_start`` issues the
ring attention's rotations without waiting for them.
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


def check_transport(x: torch.Tensor, group) -> None:
    """Raise unless the group's backend moves tensors of x's device: CUDA
    tensors need NCCL (a group of "gloo" alone has no CUDA transport)."""
    backend = str(dist.get_backend(group))
    if x.device.type == "cuda" and "nccl" not in backend:
        raise ValueError(f"CUDA tensors on a process group of backend {backend!r}, which has "
                         f"no CUDA transport: initialise it with NCCL (\"cpu:gloo,cuda:nccl\")")


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
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


class _AllGather(torch.autograd.Function):
    """The gather; its backward is the reduce-scatter, unscaled, as the
    transpose of JAX's tiled all_gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        return reduce_scatter(g, group, dim), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' x concatenated along `dim`, in rank order (JAX's tiled
    all_gather). Differentiable."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, group, dim % x.dim())
    return _all_gather(x, group, dim)


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


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(
            f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not divide by {n}")
    _count("all_to_all")
    shape = list(x.shape)
    shape[split_dim] //= n
    # block i of split_dim (for rank i) as the contiguous slab i of dim 0
    blocks = x.reshape(*shape[:split_dim], n, *shape[split_dim:]).movedim(split_dim, 0)
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=group)
    # slab j came from rank j: it goes to offset j of concat_dim
    shape[concat_dim] *= n
    return out.movedim(0, concat_dim).reshape(shape)


class _AllToAll(torch.autograd.Function):
    """The exchange; its backward is the inverse exchange (split and concat
    dims swapped), as the transpose of JAX's tiled all_to_all."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """JAX's tiled all_to_all(x, split_axis=split_dim, concat_axis=concat_dim):
    x is cut into n blocks along split_dim, block i goes to rank i, and the
    blocks received are concatenated along concat_dim in source-rank order
    (rank j's at offset j). Differentiable."""
    dim = x.dim()
    return _AllToAll.apply(x, group, split_dim % dim, concat_dim % dim)


class Pending:
    """The tensors a started ppermute receives; ``wait()`` returns them once
    the transfers are done (on CUDA, once the current stream waits for
    them)."""

    def __init__(self, outs, reqs=()):
        self.outs, self.reqs = tuple(outs), reqs

    def wait(self):
        for req in self.reqs:
            req.wait()
        return self.outs


def ppermute_start(xs, group, shift: int = 1) -> Pending:
    """ppermute of each tensor of xs, all issued at once in one batch
    (``batch_isend_irecv``) and not waited for: the caller runs other work,
    then ``wait()``. Counts one ppermute a tensor. See ``ppermute``."""
    n = dist.get_world_size(group)
    if n == 1 and all(x.device.type == "cpu" for x in xs):
        return Pending(x.clone() for x in xs)
    me = dist.get_rank(group)
    to = dist.get_global_rank(group, (me + shift) % n)
    frm = dist.get_global_rank(group, (me - shift) % n)
    ops, outs = [], []
    for x in xs:
        send = x.contiguous()
        out = torch.empty_like(send)
        _count("ppermute")
        ops += [dist.P2POp(dist.isend, send, to, group), dist.P2POp(dist.irecv, out, frm, group)]
        outs.append(out)
    return Pending(outs, dist.batch_isend_irecv(ops))


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """JAX's ppermute over the group's ring i -> (i + shift) % n: x goes to
    rank (i + shift) % n, and the result is what rank (i - shift) % n sent.
    shift 1 is the pipeline's stage shift, -1 the reverse shift that carries
    the gradients back. One isend / irecv pair in one batch
    (``batch_isend_irecv``), waited for.

    On one rank the ring is a send to self. NCCL takes that inside the batch,
    so a one-rank NCCL group issues it like any other. gloo's transport has
    no pair from a rank to itself (its send fails "Pair is not connected"),
    so on a CPU tensor a group of one returns a copy of x, issues nothing and
    counts nothing."""
    return ppermute_start((x,), group, shift).wait()[0]
