"""Persistent torch.distributed ranks for the port's mesh tests on the CPU,
and the jobs they run.

A test file starts its ranks once (``Ranks``, spawned processes with one
intra-op thread each) and sends them jobs: each job initialises a gloo
process group of as many ranks as its mesh has, over a FileStore of its
own, builds the mesh with ``make_mesh(**axes, device_type="cpu")``, runs a
function of this module on every rank and destroys the group. Results
come back pickled, one per rank, in rank order. The process group and
every wait have a timeout of seconds, so a rank that fails or hangs fails
the test.

This module imports torch and the port only, never JAX: the ranks import it
to unpickle their jobs.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.parallel import (
    make_mesh,
    shard_pools,
    tp_decode_step,
    tp_dp_decode_step,
    tp_forward,
    tp_loss_and_grad,
    tp_verify_step,
)
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import shard_params
from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, load_engine, save_engine

GROUP_TIMEOUT_S = 60  # a collective that waits longer fails its job
JOB_TIMEOUT_S = 150  # the parent's wait for one job's result


def _rank_main(rank: int, conn) -> None:
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
        for c in self.conns[:world]:
            c.send_bytes(msg)
        outs = []
        for r, c in enumerate(self.conns[:world]):
            if not c.poll(JOB_TIMEOUT_S):
                raise TimeoutError(f"rank {r} gave no result in {JOB_TIMEOUT_S} s")
            outs.append(pickle.loads(c.recv_bytes()))
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


def checkpoint_raises(mesh, params, cfg, ecfg, path):
    """save_engine of a mesh engine and load_engine onto a mesh: the
    messages of the NotImplementedErrors they raise."""
    eng = DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu", mesh=mesh)
    out = []
    for call in (lambda: save_engine(eng, path),
                 lambda: load_engine(path, params=params, device="cpu", mesh=mesh)):
        try:
            call()
        except NotImplementedError as e:
            out.append(str(e))
    return out
