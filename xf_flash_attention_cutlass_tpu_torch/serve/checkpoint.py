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

Checkpoints of a mesh engine are not ported yet: ``save_engine`` of an
engine on a mesh and ``load_engine(..., mesh=...)`` raise
NotImplementedError, and so does loading a file whose shared prefixes lie
in more than one data-parallel replica.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from xf_flash_attention_cutlass_tpu_torch.models.llama import PROJ_NAMES, LlamaConfig
from xf_flash_attention_cutlass_tpu_torch.models.moe import MoEConfig
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


def _pad_to(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """t, zero-padded along `dim` to n entries (on the host when padded)."""
    if t.shape[dim] == n:
        return t
    t = t.detach().cpu()
    shape = list(t.shape)
    shape[dim] = n
    out = torch.zeros(shape, dtype=t.dtype)
    out.narrow(dim, 0, t.shape[dim]).copy_(t)
    return out


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


def save_engine(engine: DecodeEngine, path: str, include_params: bool = False) -> None:
    """Checkpoint a DecodeEngine: KV pools, allocator, request state (and
    params with include_params=True) into the .npz at `path`. Raises
    NotImplementedError for an engine on a mesh."""
    if engine.mesh is not None:
        raise NotImplementedError("not ported yet: checkpoints of a mesh engine (save_engine)")
    ecfg = engine.ecfg
    pool_keys = sorted(engine.pools)
    pools = dict(engine.pools)
    if ecfg.kv_quant:  # the JAX engine's padded layout of quantized pages
        rows, lanes = _stored_rows(ecfg)
        for k in ("k", "v"):
            pools[k] = _pad_to(pools[k], -2, rows)
            pools[k + "_s"] = _pad_to(pools[k + "_s"], -1, lanes)
    packed = {k: _to_bytes(pools[k]) for k in pool_keys}
    params = _caller_params(engine.params)
    wq = params["layers"]["wq"]
    state = dict(
        cfg=dataclasses.asdict(engine.cfg),
        cfg_class=type(engine.cfg).__name__,
        ecfg=dataclasses.asdict(ecfg),
        pools_spec=[packed[k][1] for k in pool_keys],
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
    payload = dict(
        state=np.frombuffer(json.dumps(state).encode(), np.uint8),
        allocator=engine.pool.snapshot(),
        sample_base=np.asarray([(seed >> 32) & _MASK32, seed & _MASK32], np.uint32),
        **{f"pool_{k}": packed[k][0] for k in pool_keys},
    )
    if include_params:
        leaves = [_to_bytes(t) for t in _flatten(params)]
        payload["params_spec"] = np.frombuffer(
            json.dumps([spec for _, spec in leaves]).encode(), np.uint8)
        payload.update({f"param_leaf_{i}": raw for i, (raw, _) in enumerate(leaves)})
    np.savez(path, **payload)


def load_engine(
    path: str,
    params=None,
    cfg: Optional[LlamaConfig] = None,
    ecfg: Optional[EngineConfig] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,  # None: CUDA, raising when it is absent
    mesh=None,
) -> DecodeEngine:
    """Rebuild a DecodeEngine from a checkpoint of either package. `params`
    must be given unless the file holds them (include_params=True). cfg and
    ecfg come from the file; given, they must match it (ecfg after
    effective_engine_config). A file whose ecfg does not hold a resolved
    pack_small_pages (written before that field existed) is refused. The
    engine's CUDA graphs are captured at its first decode step."""
    if mesh is not None:
        raise NotImplementedError("not ported yet: checkpoints of a mesh engine (load_engine)")
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
        engine = DecodeEngine(params, cfg, ecfg, dtype=dtype, device=device)
        pools = {k: _from_bytes(z[f"pool_{k}"], s, engine.device)
                 for k, s in zip(state["pool_keys"], state["pools_spec"])}
        if ecfg.kv_quant:  # crop the JAX engine's padding to the tight layout
            page = ecfg.page_size
            for k in ("k", "v"):
                pools[k] = pools[k][..., :page, :].contiguous()
                pools[k + "_s"] = pools[k + "_s"][..., :page].contiguous()
        engine.pools = pools
        engine.pool.restore(z["allocator"])
    engine.queue = deque(tuple(e) for e in state["queue"])
    engine.active = {int(k): dict(dict(prefix_id=None), **v) for k, v in state["active"].items()}
    engine.results = {int(k): v for k, v in state["results"].items()}
    engine._step_count = state["step_count"]
    engine.trash_page = state["trash_page"]
    engine._prefixes = state.get("prefixes", {})
    for pf in engine._prefixes.values():
        if len(pf["pages_by_replica"]) != 1:
            raise NotImplementedError("not ported yet: checkpoints of a data-parallel mesh "
                                      "engine (prefix pages in more than one replica)")
    engine._slot_prefix = {int(k): v for k, v in state.get("slot_prefix", {}).items()}
    engine._preempt_emitted = {int(k): v for k, v in state.get("preempt_emitted", {}).items()}
    engine._prefills = [None] * ecfg.prefill_lanes
    for i, st in enumerate(x for x in state.get("prefills", []) if x is not None):
        engine._prefills[i] = st
    return engine
