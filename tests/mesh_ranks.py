"""Persistent torch.distributed ranks for the port's mesh tests on the CPU,
and the jobs they run.

A test file starts its ranks once (``Ranks``, spawned processes with one
intra-op thread each) and sends them jobs: each job initialises a gloo
process group of as many ranks as its mesh has, over a FileStore of its
own, builds the mesh with ``make_mesh(**axes, device_type="cpu")``, runs a
function of this module on every rank and destroys the group. Results
come back pickled, one per rank, in rank order. The process group and
every wait have a timeout of seconds, so a rank that fails or hangs fails
the test. The ranks run at a lower CPU priority (``RANK_NICE``), so that
they take the CPUs the other test workers leave idle.

This module imports torch and the port only, never JAX: the ranks import it
to unpickle their jobs.
"""

from __future__ import annotations

import logging
import multiprocessing
import os
import pickle
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.parallel import (
    ep_decode_step,
    ep_prefill_chunk_step,
    make_mesh,
    moe_ep_forward,
    moe_ep_loss_and_grad,
    pp_decode_step,
    pp_forward,
    pp_loss_and_grad,
    shard_ep,
    shard_moe_params,
    shard_pools,
    shard_pp_params,
    shard_pp_pools,
    tp_decode_step,
    tp_dp_decode_step,
    tp_forward,
    tp_loss_and_grad,
    tp_verify_step,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import CP, PP
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import _leaves, gather_to_rank0, shard_params
from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, load_engine, save_engine
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import ppermute

GROUP_TIMEOUT_S = 120  # a collective that waits longer fails its job
JOB_TIMEOUT_S = 240  # the parent's wait for one job's result
# a file that Ranks.run appends "<job> <seconds>" to for every job it runs
# (the longest job bounds the longest wait of a collective in it)
TIMES_ENV = "MESH_RANKS_TIMES"


RANK_NICE = 10  # the ranks yield the CPU to the other test workers' processes


def _rank_main(rank: int, conn) -> None:
    os.nice(RANK_NICE)
    torch.set_num_threads(1)
    while True:
        try:
            job = pickle.loads(conn.recv_bytes())
        except EOFError:
            return
        if job is None:
            return
        fn, args, world, store, dims = job
        try:
            dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                    world_size=world,
                                    timeout=timedelta(seconds=GROUP_TIMEOUT_S))
            try:
                out = ("ok", fn(make_mesh(**dims, device_type="cpu"), *args))
            finally:
                dist.destroy_process_group()
        except Exception:  # reported to the parent, which raises it in the test
            out = ("err", f"rank {rank}:\n{traceback.format_exc()}")
        conn.send_bytes(pickle.dumps(out))


class Ranks:
    """n persistent rank processes; run() sends one job to as many of them
    as its mesh has ranks."""

    def __init__(self, n: int, workdir: str):
        ctx = multiprocessing.get_context("spawn")
        self.workdir, self.jobs = workdir, 0
        self.conns, self.procs = [], []
        for r in range(n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, args=(r, child), daemon=True)
            p.start()
            child.close()
            self.conns.append(parent)
            self.procs.append(p)

    def run(self, fn, *args, **axes):
        """fn(mesh, *args) on every rank of a make_mesh(**axes) mesh; the
        ranks' results in rank order."""
        world = 1
        for n in axes.values():
            world *= n
        if world > len(self.conns):
            raise ValueError(f"a job of {world} ranks on a pool of {len(self.conns)}")
        store = os.path.join(self.workdir, f"store{self.jobs}")
        self.jobs += 1
        msg = pickle.dumps((fn, args, world, store, axes))
        t0 = time.perf_counter()
        for c in self.conns[:world]:
            c.send_bytes(msg)
        outs = []
        for r, c in enumerate(self.conns[:world]):
            if not c.poll(JOB_TIMEOUT_S):
                raise TimeoutError(f"rank {r} gave no result in {JOB_TIMEOUT_S} s")
            outs.append(pickle.loads(c.recv_bytes()))
        if os.environ.get(TIMES_ENV):
            with open(os.environ[TIMES_ENV], "a") as f:
                f.write(f"{fn.__name__} {time.perf_counter() - t0:.3f}\n")
        errors = [v for status, v in outs if status != "ok"]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [v for _, v in outs]

    def close(self) -> None:
        for c in self.conns:
            try:
                c.send_bytes(pickle.dumps(None))
            except OSError:
                pass
        for p in self.procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)


# ---- jobs: fn(mesh, *args), run on every rank ------------------------------

def shards(mesh, params):
    """This rank's shard_params."""
    return shard_params(params, mesh)


def forward(mesh, params, tokens, cfg):
    return tp_forward(shard_params(params, mesh), tokens, cfg, mesh)


def loss_and_grad(mesh, params, tokens, cfg):
    return tp_loss_and_grad(shard_params(params, mesh), tokens, cfg, mesh)


def _step_launches(fn):
    """fn()'s result and the collectives it issued, by name."""
    before = dict(_build.LAUNCHES)
    out = fn()
    return out, {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                 if k.startswith("collective.") and v != before.get(k, 0)}


def decode(mesh, params, tokens, pools, bt, kv_lens, cfg, sp_batch=False, dp_axis=False,
           sampling=None):
    """tp_decode_step on this rank's shards: (tokens, logits, pools,
    collectives issued)."""
    sp = shard_params(params, mesh)
    spools = shard_pools(pools, mesh, dp_axis=dp_axis)
    (tok, logits, out), coll = _step_launches(lambda: tp_decode_step(
        sp, tokens, spools, bt, kv_lens, cfg, mesh, sp_batch=sp_batch, dp_axis=dp_axis,
        **(sampling or {})))
    return tok, logits, out, coll


def dp_decode(mesh, params, tokens, pools, bt, kv_lens, cfg):
    """tp_dp_decode_step on this rank's shards: (tokens, logits)."""
    tok, logits, _ = tp_dp_decode_step(shard_params(params, mesh), tokens,
                                       shard_pools(pools, mesh, dp_axis=True), bt, kv_lens, cfg,
                                       mesh)
    return tok, logits


def verify(mesh, params, tokens, pools, bt, kv_lens, cfg, dp_axis=False):
    sp = shard_params(params, mesh)
    spools = shard_pools(pools, mesh, dp_axis=dp_axis)
    logits, out = tp_verify_step(sp, tokens, spools, bt, kv_lens, cfg, mesh, dp_axis=dp_axis,
                                 sp_batch=True)
    return logits, out


def serve(mesh, params, cfg, ecfg, requests, prefix=None, max_steps=400):
    """A mesh engine over `requests` ({rid: (prompt, max_new, temperature)});
    with `prefix` (tokens) registered as "sys" first and every request on
    it. Returns (results, stats, the pages the prefix held, the free pages
    after it was released)."""
    eng = DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu", mesh=mesh)
    free0 = eng.pool.free_pages()
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    held = free0 - eng.pool.free_pages()
    for rid, (prompt, max_new, temp) in requests.items():
        eng.add_request(rid, prompt, max_new, temperature=temp,
                        prefix_id="sys" if prefix is not None else None)
    results = eng.run(max_steps=max_steps)
    if prefix is not None:
        eng.release_prefix("sys")
    return results, dict(eng.stats), held, eng.pool.free_pages() - free0


def engine_raises(mesh, params, cfg, ecfg):
    """The exception DecodeEngine raises on this mesh, as (type name,
    message); None when it builds."""
    try:
        DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu", mesh=mesh)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def ep_shards(mesh, train_params, engine_params):
    """This rank's shard_moe_params of the training params and shard_ep of
    the engine's params."""
    return shard_moe_params(train_params, mesh), shard_ep(engine_params, {}, mesh)[0]


def ep_forward(mesh, params, tokens, cfg):
    return moe_ep_forward(shard_moe_params(params, mesh), tokens, cfg, mesh)


def ep_loss_and_grad(mesh, params, tokens, cfg):
    return moe_ep_loss_and_grad(shard_moe_params(params, mesh), tokens, cfg, mesh)


def ep_decode(mesh, params, tokens, pools, bt, kv_lens, cfg):
    """ep_decode_step on this rank's shard_ep shards: (tokens, logits,
    pools, collectives issued)."""
    sp, spools = shard_ep(params, pools, mesh)
    (tok, logits, out), coll = _step_launches(
        lambda: ep_decode_step(sp, tokens, spools, bt, kv_lens, cfg, mesh))
    return tok, logits, out, coll


def ep_prefill(mesh, params, tokens, n_prior, n_valid, pools, bt, cfg):
    """ep_prefill_chunk_step on this rank's shard_ep shards: (logits, pools)."""
    sp, spools = shard_ep(params, pools, mesh)
    return ep_prefill_chunk_step(sp, tokens, n_prior, n_valid, spools, bt, cfg, mesh)


def pp_fwd(mesh, params, tokens, cfg, n_micro):
    return pp_forward(shard_pp_params(params, mesh), tokens, cfg, mesh, n_micro)


def pp_grad(mesh, params, tokens, cfg, n_micro):
    return pp_loss_and_grad(shard_pp_params(params, mesh), tokens, cfg, mesh, n_micro)


def pp_decode(mesh, params, tokens, pools, bt, kv_lens, cfg, trash, n_micro=None, quant=None):
    """pp_decode_step on this rank's shards: (tokens, logits, pools,
    collectives issued)."""
    sp, spools = shard_pp_params(params, mesh), shard_pp_pools(pools, mesh)
    (tok, logits, out), coll = _step_launches(lambda: pp_decode_step(
        sp, tokens, spools, bt, kv_lens, cfg, mesh, trash, n_micro, quant))
    return tok, logits, out, coll


def pp_errors(mesh, params, cfg, bad_cfg, tokens, pools, bt, kv_lens):
    """The ValueError messages of pp_forward and pp_loss_and_grad at an
    n_micro that does not divide the batch, and of pp_decode_step at such
    an n_micro and at a bad_cfg whose layers do not divide by pp."""
    sp = shard_pp_params(params, mesh)
    calls = (lambda: pp_forward(sp, tokens, cfg, mesh, 3),
             lambda: pp_loss_and_grad(sp, tokens, cfg, mesh, 3),
             lambda: pp_decode_step(sp, tokens[:, :1], pools, bt, kv_lens, cfg, mesh, 0, 3),
             lambda: pp_decode_step(sp, tokens[:, :1], pools, bt, kv_lens, bad_cfg, mesh, 0))
    out = []
    for call in calls:
        try:
            call()
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    return out


def pp_shift(mesh):
    """Each rank's global rank as a tensor, through ppermute over the pp
    group forward and in reverse: (forward, reverse, collectives issued)."""
    x = torch.full((2, 3), float(dist.get_rank()))
    group = mesh.get_group(PP)
    (fwd, rev), coll = _step_launches(lambda: (ppermute(x, group), ppermute(x, group, -1)))
    return fwd, rev, coll


def live_rows(eng):
    """The (page, row) positions of the KV the engine's requests hold, pages
    in the whole pool's numbering (replica r's local page p at r * (pages
    a replica holds + 1) + p): the decoding requests' cached tokens and the
    in-flight prefills' prefilled ones."""
    page, per_replica = eng.ecfg.page_size, eng.trash_page + 1
    lens = {slot: eng.pool.seq_len(slot) for slot in eng.active}
    for st in eng._prefills:
        if st is not None:
            lens[st["slot"]] = st["base"] + st["done"]
    out = set()
    for slot, n in lens.items():
        row, r = eng._bt_row(slot), slot // eng.mb_local
        out.update((r * per_replica + int(row[t // page]), t % page) for t in range(n))
    return sorted(out)


def save_and_resume(mesh, params, cfg, ecfg, requests, n_steps, save_path, load_path,
                    prefix=None):
    """A mesh engine over `requests` (a prefix registered as "sys" first and
    every request on it, when given) saved after n_steps steps to
    save_path; then the file at load_path loaded onto the mesh and run to
    its end. Returns (the live rows at the save, the loaded engine's whole
    pools as loaded (gathered on rank 0, each a (..., itemsize) uint8
    array; None on the other ranks), its results)."""
    eng = DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu", mesh=mesh)
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    for rid, (prompt, max_new, temp) in requests.items():
        eng.add_request(rid, prompt, max_new, temperature=temp,
                        prefix_id="sys" if prefix is not None else None)
    for _ in range(n_steps):
        eng.step()
    save_engine(eng, save_path)
    rows = live_rows(eng)
    loaded = load_engine(load_path, params=params, dtype=torch.float32, device="cpu", mesh=mesh)
    kspecs = loaded.mesh_specs({}, loaded.pools)[1]
    whole = {k: gather_to_rank0(t, kspecs[k], mesh) for k, t in loaded.pools.items()}
    pools = (None if dist.get_rank() else
             {k: t.unsqueeze(-1).view(torch.uint8).numpy() for k, t in whole.items()})
    return rows, pools, loaded.run(max_steps=400)


class PeakBytes(TorchDispatchMode):
    """The most bytes that tensors made by torch ops while the mode is on
    held at one time: a storage counts from the op that made it (one whose
    inputs do not hold it) until no tensor refers to it; an op's frees are
    seen at the next op."""

    def __init__(self):
        super().__init__()
        self.live, self.now, self.peak = {}, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.now -= n
        inputs = {StorageWeakRef(t.untyped_storage()).cdata
                  for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                ref = StorageWeakRef(t.untyped_storage())
                if ref.cdata not in inputs and ref.cdata not in self.live:
                    n = t.untyped_storage().nbytes()
                    self.live[ref.cdata] = ref, n
                    self.now += n
        self.peak = max(self.peak, self.now)
        return out


def save_peak(mesh, params, cfg, ecfg, requests, n_steps, path):
    """A mesh engine over `requests` saved with its params after n_steps
    steps, under PeakBytes. Returns (the save's peak bytes, the bytes of
    this rank's shards (pools and params), its largest shard's bytes)."""
    eng = DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu", mesh=mesh)
    for rid, (prompt, max_new, temp) in requests.items():
        eng.add_request(rid, prompt, max_new, temperature=temp)
    for _ in range(n_steps):
        eng.step()
    shards = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
              for t in list(eng.pools.values()) + _leaves(eng.params)}
    with PeakBytes() as mode:
        save_engine(eng, path, include_params=True)
    return mode.peak, sum(shards.values()), max(shards.values())


class _Records(logging.Handler):
    """(level name, message) of every record a logger emits."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append((record.levelname, record.getMessage()))


def cp_attention(mesh, fn, q, k, v, kw):
    """fn (ring_attention, ring_attention_zigzag or ulysses_attention) over
    the cp group on this rank's chunk of the global q, k, v (sequence on dim
    2, chunk i on cp rank i), and the gradient of sum(sin(O)) on it: (O,
    LSE, the local loss, (dq, dk, dv), the collectives issued by the
    forward and by the backward, the records parallel/ulysses.py logged)."""
    i, n = mesh.get_local_rank(CP), mesh.size(mesh.mesh_dim_names.index(CP))
    xs = [t.chunk(n, dim=2)[i].clone().requires_grad_(True) for t in (q, k, v)]
    logger = logging.getLogger("xf_flash_attention_cutlass_tpu_torch.parallel.ulysses")
    handler, level = _Records(), logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    try:
        (o, lse), fwd = _step_launches(lambda: fn(*xs, mesh.get_group(CP), **kw))
        loss = torch.sin(o.float()).sum()
        _, bwd = _step_launches(loss.backward)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return (o.detach(), lse, float(loss), tuple(x.grad for x in xs), fwd, bwd,
            handler.records)


def cp_errors(mesh, calls):
    """The ValueError message of fn(q, k, v, cp group, **kwargs) for each
    (fn, (q, k, v), kwargs) of `calls`, None where it raised none."""
    out = []
    for fn, qkv, kwargs in calls:
        try:
            fn(*qkv, mesh.get_group(CP), **kwargs)
        except ValueError as e:
            out.append(str(e))
        else:
            out.append(None)
    return out
