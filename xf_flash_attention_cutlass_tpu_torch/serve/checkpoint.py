"""Engine checkpoint / resume, in the JAX package's file format.

``save_engine`` writes what a DecodeEngine needs to continue mid-stream
(the KV pools, the allocator's page maps, the request table, the sampling
step count, the shared prefixes) to one ``.npz``; ``load_engine`` rebuilds
an engine from it that emits the same tokens as the uninterrupted one. Both
packages read and write the same file:

- ``state``: the JSON of cfg (``cfg_class`` names LlamaConfig or MoEConfig),
  the resolved ecfg, ``pools_spec`` / ``pool_keys``, the queue, the active
  and finished requests, ``step_count``, ``trash_page``,
  ``include_params``, ``params_quantized``, the prefixes (pages under
  ``pages_by_replica``), the slots' prefixes, the prefill lanes and the
  tokens of preempted requests;
- ``allocator``: the int32 words of ``PagePool.snapshot``;
- ``sample_base``: the two uint32 words of the JAX engine's threefry key of
  ``ecfg.sample_seed``. The port's sampler keys on ``sample_seed`` and the
  saved step count, so it reads nothing from here;
- ``pool_<k>`` and, with ``include_params=True``, ``params_spec`` and
  ``param_leaf_<i>``: tensors as raw ``uint8`` bytes beside their JAX dtype
  names and shapes (bf16 and fp8 have no numpy dtype, and quantized pools
  must not be re-quantized). Param leaves are flattened in
  ``jax.tree.flatten`` order: dict keys sorted, tuple items in order, None
  no leaf.

The JAX engine stores quantized pools at pages below 128 with padding
(value rows to a multiple of 32, scale lanes to a multiple of 128): the
port pads its tight pools so on save and crops them on load.

Model params are not saved by default (pass ``include_params=True`` for a
self-contained file); they are saved in the caller's form.

A mesh engine (dp x ep x tp, one process a rank) saves the whole pools in
the JAX mesh engine's layout, ``(L, R * (pages_local + 1), h_k, page, d)``
with R = dp * ep replicas, replica r's pages (its trash page last) at
``r * (pages_local + 1)``, and with ``include_params=True`` the whole
params. Every rank calls ``save_engine``; the file is written one leaf at
a time: each leaf's blocks (kv heads over tp, pages over the replicas,
experts over ep) go to rank 0's host, which writes the leaf before it
gathers the next, so no rank holds more than its own shards and rank 0 one
whole leaf besides; the other ranks then wait at a barrier. The layout is
the engine's (``DecodeEngine.mesh_specs``). ``load_engine(..., mesh=)``
reads the file on every rank and keeps this rank's shard of each pool, one
pool at a time. So a file moves between meshes of the same replica count,
and between the packages.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import zipfile
from collections import deque
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from xf_flash_attention_cutlass_tpu_torch.models.llama import PROJ_NAMES, LlamaConfig
from xf_flash_attention_cutlass_tpu_torch.models.moe import MoEConfig
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import _map2, gather_to_rank0, shard_leaf
from xf_flash_attention_cutlass_tpu_torch.serve.engine import (
    DecodeEngine,
    EngineConfig,
    effective_engine_config,
)

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_CONFIGS = {"LlamaConfig": LlamaConfig, "MoEConfig": MoEConfig}
_MASK32 = 0xFFFFFFFF


def _flatten(tree) -> List[torch.Tensor]:
    """The leaves in jax.tree.flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flatten(v)]
    return [] if tree is None else [tree]


def _unflatten(template, leaves):
    """template's structure with its leaves (any non-container) taken from
    the iterator `leaves` in _flatten order."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple):
        return tuple(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_bytes(t: torch.Tensor):
    """(uint8 bytes, [JAX dtype name, shape]) of a tensor."""
    if t.dtype not in _NAMES:
        raise TypeError(f"checkpoint: no dtype name for {t.dtype}")
    flat = t.detach().contiguous().reshape(-1).cpu()
    return flat.view(torch.uint8).numpy(), [_NAMES[t.dtype], list(t.shape)]


def _from_bytes(raw: np.ndarray, spec, device) -> torch.Tensor:
    name, shape = spec
    t = torch.from_numpy(np.ascontiguousarray(raw).view(np.uint8).copy())
    return t.view(_DTYPES[name]).reshape(shape).to(device)


def _stored_rows(ecfg: EngineConfig):
    """(value rows, scale lanes) a page of the JAX engine's quantized pools
    holds: the page padded to a multiple of 32, its scales to 128."""
    rows = -(-ecfg.page_size // 32) * 32
    return rows, -(-rows // 128) * 128


def _caller_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The engine's params with pack_params_for_decode's (w, None) wrappers
    taken off: the form the caller gave."""
    layers = {k: (v[0] if isinstance(v, tuple) and len(v) == 2 and v[1] is None else v)
              for k, v in params["layers"].items()}
    return dict(params, layers=layers)


def _param_template(cfg: LlamaConfig, quantized: bool) -> Dict[str, Any]:
    """The structure of init_params / init_moe_params (quantized: of
    quantize_params / quantize_moe_params), with 0 for every leaf."""
    q = (0, 0) if quantized else 0
    layers = dict(attn_norm=0, mlp_norm=0, **{n: q for n in PROJ_NAMES})
    if isinstance(cfg, MoEConfig):
        layers["router"] = 0
    return dict(embed=0, layers=layers, final_norm=0, lm_head=q)


class _Npz:
    """An .npz written one array at a time, in np.savez's layout (a stored
    ``<key>.npy`` member a key, ``.npz`` added to a path without it): no
    more than one array is held to write the file."""

    def __init__(self, path):
        path = os.fspath(path)
        self.zf = zipfile.ZipFile(path if path.endswith(".npz") else path + ".npz", "w",
                                  compression=zipfile.ZIP_STORED, allowZip64=True)

    def add(self, key: str, array: np.ndarray) -> None:
        with self.zf.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(array), allow_pickle=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.zf.close()


def _with_specs(params, pspecs):
    """(leaf, spec) pairs of params in _flatten order; the spec None off a
    mesh."""
    if pspecs is None:
        return [(t, None) for t in _flatten(params)]
    return [(b.t, b.spec) for b in
            _flatten(_map2(lambda t, sp: SimpleNamespace(t=t, spec=sp), params, pspecs))]


def save_engine(engine: DecodeEngine, path: str, include_params: bool = False) -> None:
    """Checkpoint a DecodeEngine: KV pools, allocator, request state (and
    params with include_params=True) into the .npz at `path`. A mesh
    engine's ranks all call it; rank 0 writes. Tensors go to the file one
    leaf at a time, each gathered whole on rank 0's host only (parallel/tp.py
    gather_to_rank0): no rank holds more on its device than its shards."""
    mesh = engine.mesh
    params = _caller_params(engine.params)
    pspecs, kspecs = engine.mesh_specs(params, engine.pools) if mesh is not None else (None, {})
    writer = mesh is None or dist.get_rank() == 0
    with _Npz(path) if writer else contextlib.nullcontext() as out:
        _write(engine, out, params, pspecs, kspecs, include_params)
    if mesh is not None:
        dist.barrier()


def _write(engine: DecodeEngine, out: Optional[_Npz], params, pspecs, kspecs,
           include_params: bool) -> None:
    """save_engine's body: every rank gathers each leaf in turn; the writer
    (out given) adds it to the file, then the state."""
    ecfg, mesh = engine.ecfg, engine.mesh
    pool_keys = sorted(engine.pools)
    pad = {}
    if ecfg.kv_quant:  # the JAX engine's padded layout of quantized pages (dim 3: rows)
        rows, lanes = _stored_rows(ecfg)
        pad = dict(k=rows, v=rows, k_s=lanes, v_s=lanes)
    pools_spec, leaf_specs = [], []
    for k in pool_keys:
        t = gather_to_rank0(engine.pools[k], kspecs.get(k), mesh,
                            {3: pad[k]} if k in pad else None)
        if out is not None:
            raw, spec = _to_bytes(t)
            out.add(f"pool_{k}", raw)
            pools_spec.append(spec)
    if include_params:
        for i, (leaf, spec) in enumerate(_with_specs(params, pspecs)):
            t = gather_to_rank0(leaf, spec, mesh)
            if out is not None:
                raw, spec = _to_bytes(t)
                out.add(f"param_leaf_{i}", raw)
                leaf_specs.append(spec)
    if out is None:
        return
    wq = params["layers"]["wq"]
    state = dict(
        cfg=dataclasses.asdict(engine.cfg),
        cfg_class=type(engine.cfg).__name__,
        ecfg=dataclasses.asdict(ecfg),
        pools_spec=pools_spec,
        pool_keys=pool_keys,
        queue=[list(entry) for entry in engine.queue],
        active={str(k): v for k, v in engine.active.items()},
        results={str(k): v for k, v in engine.results.items()},
        step_count=engine._step_count,
        trash_page=engine.trash_page,
        include_params=include_params,
        params_quantized=isinstance(wq, tuple),
        prefixes=engine._prefixes,
        slot_prefix={str(k): v for k, v in engine._slot_prefix.items()},
        prefills=engine._prefills,
        preempt_emitted={str(k): v for k, v in engine._preempt_emitted.items()},
    )
    seed = ecfg.sample_seed
    out.add("state", np.frombuffer(json.dumps(state).encode(), np.uint8))
    out.add("allocator", engine.pool.snapshot())
    out.add("sample_base", np.asarray([(seed >> 32) & _MASK32, seed & _MASK32], np.uint32))
    if include_params:
        out.add("params_spec", np.frombuffer(json.dumps(leaf_specs).encode(), np.uint8))


def load_engine(
    path: str,
    params=None,
    cfg: Optional[LlamaConfig] = None,
    ecfg: Optional[EngineConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,  # None: CUDA, raising when it is absent
    mesh=None,  # a mesh (parallel/mesh.py): every rank loads and keeps its shards
) -> DecodeEngine:
    """Rebuild a DecodeEngine from a checkpoint of either package. `params`
    must be given unless the file holds them (include_params=True); on a
    mesh, the whole params, which the engine shards. cfg and ecfg come from
    the file; given, they must match it (ecfg after
    effective_engine_config). A file whose ecfg does not hold a resolved
    pack_small_pages (written before that field existed) is refused. The
    prefill lanes keep their places (a lane prefills into its replica's
    pages). The engine's CUDA graphs are captured at its first decode
    step."""
    with np.load(path, allow_pickle=False) as z:
        state = json.loads(bytes(z["state"].tobytes()).decode())
        cls = _CONFIGS[state.get("cfg_class", "LlamaConfig")]
        saved_cfg = cls(**state["cfg"])
        if "pack_small_pages" not in state["ecfg"]:
            raise ValueError("checkpoint: its ecfg has no pack_small_pages (an old file, "
                             "saved before the resolved page size was stored); not loaded")
        saved_ecfg = EngineConfig(**state["ecfg"])
        if effective_engine_config(saved_ecfg) != saved_ecfg:
            raise ValueError("checkpoint: its ecfg is not resolved; not loaded")
        if cfg is not None and dataclasses.asdict(cfg) != state["cfg"]:
            raise ValueError("cfg does not match the checkpoint")
        if ecfg is not None and effective_engine_config(ecfg) != saved_ecfg:
            raise ValueError("ecfg does not match the checkpoint")
        cfg, ecfg = saved_cfg, saved_ecfg
        if params is None:
            if not state["include_params"]:
                raise ValueError("checkpoint has no params; pass params= to load_engine")
            spec = json.loads(bytes(z["params_spec"].tobytes()).decode())
            template = _param_template(cfg, state.get("params_quantized", False))
            n_leaves = len(_flatten(template))
            if n_leaves != len(spec):
                raise ValueError(
                    f"checkpoint has {len(spec)} param leaves but the {type(cfg).__name__} "
                    f"template has {n_leaves} (params_quantized="
                    f"{state.get('params_quantized', 'unrecorded')})")
            params = _unflatten(template, iter(
                _from_bytes(z[f"param_leaf_{i}"], s, "cpu") for i, s in enumerate(spec)))
        engine = DecodeEngine(params, cfg, ecfg, dtype=dtype, device=device, mesh=mesh)
        pools = {}
        for k, s in zip(state["pool_keys"], state["pools_spec"]):  # one leaf at a time
            t = _from_bytes(z[f"pool_{k}"], s, "cpu")
            if ecfg.kv_quant:  # crop the JAX engine's padding to the tight layout
                t = t.narrow(3, 0, ecfg.page_size)
            if mesh is not None:  # this rank's shard
                t = shard_leaf(t, engine.mesh_specs({}, {k: t})[1][k], mesh)
            pools[k] = t.contiguous().to(engine.device)
        engine.pools = pools
        engine.pool.restore(z["allocator"])
    engine.queue = deque(tuple(e) for e in state["queue"])
    engine.active = {int(k): dict(dict(prefix_id=None), **v) for k, v in state["active"].items()}
    engine.results = {int(k): v for k, v in state["results"].items()}
    engine._step_count = state["step_count"]
    engine.trash_page = state["trash_page"]
    engine._prefixes = state.get("prefixes", {})
    engine._slot_prefix = {int(k): v for k, v in state.get("slot_prefix", {}).items()}
    engine._preempt_emitted = {int(k): v for k, v in state.get("preempt_emitted", {}).items()}
    engine._prefills = [None] * ecfg.prefill_lanes
    for lane, st in enumerate(state.get("prefills", [])):
        engine._prefills[lane] = st
    return engine
