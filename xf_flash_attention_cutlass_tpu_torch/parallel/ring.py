"""Ring attention: context parallelism over a process group, differentiable
(the JAX package's ``parallel/ring.py``).

The sequence axis is sharded over the ranks of a group (the mesh's "cp"
group, ``mesh.get_group("cp")``): rank i holds the (b, h, s_local, d) chunk
i of q, k and v. The K/V chunks rotate around the ring (rank i sends to
i + 1), and the partial (O, LSE) of each hop merges with
``ops/combine.py``'s ``merge_two``, the split-KV combine's algebra.

The backward is a ``torch.autograd.Function`` of its own, as the JAX
package's custom VJP: each hop recomputes its chunk's scores against the
GLOBAL (O, LSE, dO) through ``flash_bwd`` (p = exp(s - LSE) is exactly the
chunk's share of the global softmax), dQ accumulates in f32 on its rank,
and the f32 dK/dV accumulator of a chunk rides the ring one hop behind the
chunk itself, so that every rotation issued inside the loop reads only
values that exist when the hop starts. One delivery rotation at the end
lands each chunk's summed dK/dV on its owner. The LSE cotangent is not
propagated, as in ``ops/flash.py``.

Every hop runs with a static mask, never position arrays, which would
take K7 and K9/K10 to their options' instantiations: the chunks have one
length, so the hop of a rank's own chunk is the causal diagonal, an
earlier chunk is attended in full and a later one is skipped. The zigzag
ring (``ring_attention_zigzag``) balances the causal work: rank i holds
the half-chunks i and 2n-1-i, and each hop is one of three static kinds
(``zigzag_hop_kind``).

The code is in three layers:
- the hops' math, plain functions of one rank's chunks (``ring_hop_fwd``,
  ``ring_hop_bwd``, ``zigzag_hop_fwd``, ``zigzag_hop_bwd``) on ``flash_fwd``
  (K7) and ``flash_bwd`` (K9/K10);
- the schedules (``fwd_schedule``, ``bwd_schedule``), generators of one
  rank's hops: each yields the tensors of a rotation BEFORE the hop's
  kernels and receives a handle whose ``wait()`` gives the rotated tensors
  AFTER them, so that the transfer runs under the compute;
- the transport: ``over_group`` drives one rank's schedule over a process
  group (``collectives.ppermute_start``); ``lockstep`` drives every rank's
  schedule of a ring in one process, as the ranks would run them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch.ops.combine import merge_two
from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import flash_fwd
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import (
    Pending,
    check_transport,
    ppermute_start,
)

# ---- the hops' math ----------------------------------------------------------


def ring_hop_fwd(q, kc, vc, idx: int, src: int, *, causal: bool,
                 softmax_scale: Optional[float]):
    """Rank idx's (O, LSE) over the K/V chunk of rank src, or None where the
    causal mask leaves nothing (src > idx)."""
    if causal and src > idx:
        return None
    return flash_fwd(q, kc, vc, causal=causal and src == idx, softmax_scale=softmax_scale)


def ring_hop_bwd(q, kc, vc, o, lse, do, idx: int, src: int, *, causal: bool,
                 softmax_scale: Optional[float]):
    """Rank idx's (dQ, dK, dV) contribution of the K/V chunk of rank src
    from the global (O, LSE, dO), or None where ring_hop_fwd skips."""
    if causal and src > idx:
        return None
    return flash_bwd(q, kc, vc, o, lse, do, causal=causal and src == idx,
                     softmax_scale=softmax_scale)


def zigzag_hop_kind(idx: int, src: int) -> str:
    """The static kind of rank idx's hop over rank src's chunk. With half
    indices A = idx, B = 2n-1-idx (queries) and C = src, D = 2n-1-src (keys),
    A < n <= B: "diag" (src == idx) the A-C and B-D diagonals and B x C in
    full; "lo" (src < idx) A and B over C in full (D is dead for both); "hi"
    (src > idx) B over C and D in full (A sees neither)."""
    return "diag" if src == idx else ("lo" if src < idx else "hi")


def _halves(x):
    """The two halves of x's sequence axis (dim 2: q, k, v, O and LSE)."""
    sh = x.shape[2] // 2
    return x[:, :, :sh], x[:, :, sh:]


def _stack(a, b):
    return torch.cat([a, b], dim=0)


def zigzag_hop_fwd(q, kc, vc, idx: int, src: int, *, softmax_scale: Optional[float]):
    """Rank idx's (O, LSE) over rank src's zigzag chunk (zigzag_hop_kind)."""
    b = q.shape[0]
    qa, qb = _halves(q)
    kind = zigzag_hop_kind(idx, src)
    if kind == "diag":
        (k_c, k_d), (v_c, v_d) = _halves(kc), _halves(vc)
        o_d, lse_d = flash_fwd(_stack(qa, qb), _stack(k_c, k_d), _stack(v_c, v_d), causal=True,
                               softmax_scale=softmax_scale)
        o_bc, lse_bc = flash_fwd(qb, k_c, v_c, causal=False, softmax_scale=softmax_scale)
        o_b, lse_b = merge_two(o_d[b:], lse_d[b:], o_bc, lse_bc)
        return (torch.cat([o_d[:b].float(), o_b], dim=2),
                torch.cat([lse_d[:b], lse_b], dim=2))
    if kind == "lo":
        k_c, v_c = _halves(kc)[0], _halves(vc)[0]
        return flash_fwd(q, k_c, v_c, causal=False, softmax_scale=softmax_scale)
    o_b, lse_b = flash_fwd(qb, kc, vc, causal=False, softmax_scale=softmax_scale)
    return (torch.cat([torch.zeros(qa.shape, dtype=torch.float32, device=q.device),
                       o_b.float()], dim=2),
            torch.cat([torch.full(qa.shape[:3], -torch.inf, device=q.device), lse_b], dim=2))


def zigzag_hop_bwd(q, kc, vc, o, lse, do, idx: int, src: int, *,
                   softmax_scale: Optional[float]):
    """Rank idx's f32 (dQ, dK, dV) contribution of rank src's zigzag chunk
    from the global (O, LSE, dO) (zigzag_hop_kind)."""
    b = q.shape[0]
    (qa, qb), (oa, ob), (la, lb), (da, db) = _halves(q), _halves(o), _halves(lse), _halves(do)
    kind = zigzag_hop_kind(idx, src)
    if kind == "diag":
        (k_c, k_d), (v_c, v_d) = _halves(kc), _halves(vc)
        dq_d, dk_d, dv_d = flash_bwd(_stack(qa, qb), _stack(k_c, k_d), _stack(v_c, v_d),
                                     _stack(oa, ob), _stack(la, lb), _stack(da, db), causal=True,
                                     softmax_scale=softmax_scale)
        dq_bc, dk_bc, dv_bc = flash_bwd(qb, k_c, v_c, ob, lb, db, causal=False,
                                        softmax_scale=softmax_scale)
        return (torch.cat([dq_d[:b].float(), dq_d[b:].float() + dq_bc.float()], dim=2),
                torch.cat([dk_d[:b].float() + dk_bc.float(), dk_d[b:].float()], dim=2),
                torch.cat([dv_d[:b].float() + dv_bc.float(), dv_d[b:].float()], dim=2))
    if kind == "lo":
        k_c, v_c = _halves(kc)[0], _halves(vc)[0]
        dq, dk_c, dv_c = flash_bwd(q, k_c, v_c, o, lse, do, causal=False,
                                   softmax_scale=softmax_scale)
        zero = torch.zeros(k_c.shape, dtype=torch.float32, device=q.device)
        return (dq.float(), torch.cat([dk_c.float(), zero], dim=2),
                torch.cat([dv_c.float(), zero], dim=2))
    dq_b, dk, dv = flash_bwd(qb, kc, vc, ob, lb, db, causal=False, softmax_scale=softmax_scale)
    zero = torch.zeros(qa.shape, dtype=torch.float32, device=q.device)
    return torch.cat([zero, dq_b.float()], dim=2), dk.float(), dv.float()


# ---- the schedules -----------------------------------------------------------


def fwd_schedule(hop, q, k, v, idx: int, n: int):
    """Rank idx's forward over a ring of n ranks, as a generator: hop(q, kc,
    vc, idx, src) at each hop t (src = (idx - t) % n, the owner of the chunk
    held), the chunk rotated onward before every hop but the last. Returns
    (O in q's dtype, LSE f32)."""
    acc, kc, vc = None, k, v
    for t in range(n):
        moved = (yield kc, vc) if t < n - 1 else None
        part = hop(q, kc, vc, idx, (idx - t) % n)
        if part is not None:
            acc = part if acc is None else merge_two(*acc, *part)
        if moved is not None:
            kc, vc = moved.wait()
    o, lse = acc  # hop 0 is the rank's own chunk, never skipped
    return o.to(q.dtype), lse


def bwd_schedule(hop, q, k, v, o, lse, do, idx: int, n: int):
    """Rank idx's backward over a ring of n ranks, as a generator: at hop t
    the chunk moves on together with the f32 dK/dV accumulator of the chunk
    held at hop t - 1, to which the contribution of that hop is added as it
    leaves (the accumulator starts one position behind, so it arrives at
    each rank with the chunk it belongs to); hop(q, kc, vc, o, lse, do, idx,
    src) gives the contribution of hop t, or None. After n hops a rank holds
    the sum of every contribution but its own last one for chunk (idx + 1)
    % n, and one delivery rotation lands it on its owner. Returns (dQ, dK,
    dV) in the inputs' dtypes."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    zero = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    kc, vc, ak, av, pk, pv = k, v, zero, zero, zero, zero
    for t in range(n):
        moved = yield kc, vc, ak + pk, av + pv
        part = hop(q, kc, vc, o, lse, do, idx, (idx - t) % n)
        if part is None:
            pk, pv = zero, zero
        else:
            dq += part[0].float()
            pk, pv = part[1].float(), part[2].float()
        kc, vc, ak, av = moved.wait()
    dk, dv = (yield ak + pk, av + pv).wait()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---- the transport -----------------------------------------------------------


def _advance(schedule, handle):
    """(done, what the schedule yields next or returns)."""
    try:
        return False, schedule.send(handle)
    except StopIteration as stop:
        return True, stop.value


def over_group(schedule, group):
    """One rank's schedule over a process group: every rotation issued by
    ppermute_start and waited for where the schedule asks. Returns the
    schedule's result."""
    done, out = _advance(schedule, None)
    while not done:
        done, out = _advance(schedule, ppermute_start(out, group))
    return out


def lockstep(schedules):
    """Every rank's schedule of a ring of len(schedules) ranks in one
    process, in turns: at each rotation the tensors rank i yields go to rank
    (i + 1) % n, as over_group moves them between processes. Returns the
    ranks' results in rank order."""
    n = len(schedules)
    steps = [_advance(s, None) for s in schedules]
    while not all(done for done, _ in steps):
        if any(done for done, _ in steps):
            raise RuntimeError("lockstep: the ranks' schedules rotate unequal times")
        sent = [out for _, out in steps]
        steps = [_advance(s, Pending(sent[(i - 1) % n])) for i, s in enumerate(schedules)]
    return [out for _, out in steps]


# ---- the entry points --------------------------------------------------------


class _RingAttention(torch.autograd.Function):
    """The ring's forward and backward schedules over the group: the JAX
    package's custom VJP. The LSE cotangent is not propagated."""

    @staticmethod
    def forward(ctx, q, k, v, group, fwd_hop, bwd_hop):
        idx, n = dist.get_rank(group), dist.get_world_size(group)
        o, lse = over_group(fwd_schedule(fwd_hop, q, k, v, idx, n), group)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = group, bwd_hop
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        group, hop = ctx.args
        idx, n = dist.get_rank(group), dist.get_world_size(group)
        grads = over_group(bwd_schedule(hop, q, k, v, o, lse, do.to(q.dtype), idx, n), group)
        return (*grads, None, None, None)


def ring_attention(
    q: torch.Tensor,  # (b, h, s_local, d): this rank's query chunk
    k: torch.Tensor,  # (b, h_k, s_local, d): this rank's K/V chunk
    v: torch.Tensor,
    group,
    *,
    causal: bool = True,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact, differentiable attention over the sequence that the group's
    ranks hold in rank order (rank i: tokens [i*s_local, (i+1)*s_local)).
    Returns this rank's (O, LSE) chunk. Causal chunks of q and k have one
    length. Causal work is imbalanced (rank i attends i + 1 chunks, so the
    last rank sets the time): ring_attention_zigzag balances it."""
    check_transport(q, group)
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError(f"causal ring chunks of q and k must have one length, got "
                         f"{q.shape[2]} and {k.shape[2]}")
    cfg = dict(causal=bool(causal), softmax_scale=softmax_scale)
    return _RingAttention.apply(q, k, v, group, functools.partial(ring_hop_fwd, **cfg),
                                functools.partial(ring_hop_bwd, **cfg))


def ring_attention_zigzag(
    q: torch.Tensor,  # (b, h, 2*s_half, d): half-chunks i and 2n-1-i, concatenated
    k: torch.Tensor,  # (b, h_k, 2*s_half, d)
    v: torch.Tensor,
    group,
    *,
    softmax_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Balanced causal ring attention with zigzag ownership: rank i of n
    holds the global half-chunks i and 2n-1-i, concatenated (zigzag_permute
    the global sequence before sharding it, zigzag_unpermute after). Exact
    and differentiable; returns this rank's (O, LSE) in the same layout.
    Every rank runs one batched diagonal and one full call at hop 0 and one
    full call at every later hop. Non-causal attention has no imbalance:
    use ring_attention(causal=False)."""
    if q.shape[2] % 2:
        raise ValueError("zigzag chunks hold two halves: local seq must be even")
    check_transport(q, group)
    return _RingAttention.apply(q, k, v, group,
                                functools.partial(zigzag_hop_fwd, softmax_scale=softmax_scale),
                                functools.partial(zigzag_hop_bwd, softmax_scale=softmax_scale))


def _zigzag_order(n: int):
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    return order


def _zigzag_index(s: int, n: int, inverse: bool, device) -> torch.Tensor:
    if s % (2 * n):
        raise ValueError(f"sequence {s} must be a multiple of 2*cp={2 * n}")
    sh = s // (2 * n)
    order = _zigzag_order(n)
    if inverse:
        pos = {c: p for p, c in enumerate(order)}
        order = [pos[c] for c in range(2 * n)]
    return torch.cat([torch.arange(c * sh, (c + 1) * sh, device=device) for c in order])


def zigzag_permute(x: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    """Reorder a GLOBAL sequence axis into zigzag ownership: with 2n
    half-chunks [c_0 .. c_{2n-1}], the contiguous shard of rank i becomes
    [c_i, c_{2n-1-i}]. Apply before sharding over cp; zigzag_unpermute
    inverts (both are static gathers)."""
    return x.index_select(axis, _zigzag_index(x.shape[axis], n, False, x.device))


def zigzag_unpermute(x: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    """Inverse of zigzag_permute."""
    return x.index_select(axis, _zigzag_index(x.shape[axis], n, True, x.device))
