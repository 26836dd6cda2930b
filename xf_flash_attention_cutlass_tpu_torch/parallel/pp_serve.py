"""Pipeline-parallel serving: a greedy decode step over the mesh's "pp"
axis, as the JAX package's ``parallel/pp_serve.py`` runs it.

Each stage holds L / pp layers' weights and the matching slice of the paged
KV pools (the pools lead with the layer axis, so the same "pp" spec shards
them); under tp > 1 the pools' kv heads are also sharded over "tp", the
``parallel/tp_serve.py`` layout inside each stage. One decode step
pipelines the batch through the stages as GPipe microbatches: n_micro
microbatches ride n_micro + pp - 1 lockstep steps, each ending in one stage
shift (``utils/collectives.py`` ``ppermute``). A stage runs the engine's
layer loop (``serve/engine.py`` ``_layer_stack``: K2's append, K1 and its
combine, K3 for every projection) over its own layers and pool shard,
``layer_idx`` counted from its first layer.

The JAX step also runs the fill and drain steps (where a stage holds no
microbatch), on block tables that point at the caller's trash page with
kv_len 1, and discards their outputs. Here those steps compute nothing and
send zeros, so no page is written but the live rows' own: the trash page
is never touched. Each microbatch visits each stage once, so each layer
appends each token once.

After the pipeline the last stage's hidden states are replicated over pp
(a masked all-reduce, the JAX package's psum); every rank then norms them,
projects them through the head (K4; under tp the vocab shards gathered)
and takes the argmax. The norm and the head run microbatch by microbatch,
so every row's logits are those ``decode_core`` gives its microbatch's
rows bit for bit (a row-wise reduction's order can depend on the rows
beside it). Every rank takes the whole batch (no dp rows) and returns it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, rms_norm
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import PP, TP, axis_size
from xf_flash_attention_cutlass_tpu_torch.parallel.pp import _stage
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import _local_cfg, shard_leaf
from xf_flash_attention_cutlass_tpu_torch.serve.engine import _layer_stack, _lm_head, _rope
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import (
    all_gather,
    all_reduce_,
    ppermute,
)


def pp_pool_specs(pools: Dict[str, torch.Tensor], tp: bool = False) -> Dict[str, tuple]:
    """Pool specs: the layer axis (dim 0 of (L, pages, h_k, page[, d])) over
    "pp"; with tp the kv heads (dim 2) over "tp" too."""
    return {name: (PP, None, TP if tp else None) + (None,) * (t.dim() - 3)
            for name, t in pools.items()}


def shard_pp_pools(pools: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's block of every pool: its stage's layers and, where the
    mesh's tp axis has more than one rank, its kv heads. A pool whole on
    this mesh is kept as given."""
    specs = pp_pool_specs(pools, tp=axis_size(mesh, TP) > 1)
    return {name: shard_leaf(t, specs[name], mesh) for name, t in pools.items()}


def pp_decode_step(
    params,
    tokens: torch.Tensor,  # (b, 1), the same on every rank
    pools: Dict[str, torch.Tensor],  # this rank's shard (shard_pp_pools)
    block_tables: torch.Tensor,  # (b, max_pages), global page ids
    kv_lens: torch.Tensor,  # (b,), the lengths after this step
    cfg: LlamaConfig,
    mesh,
    trash_page: int,  # the JAX step's page for its fill and drain steps; never written here
    n_micro: Optional[int] = None,  # microbatches; default pp (a full fill)
    quant: Optional[str] = None,  # the pools' KV quantization ("int8", "fp8_e4m3") or None
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One pipeline-parallel greedy decode step. params: this rank's shards
    (parallel/pp.py shard_pp_params). Appends every row's token into the
    pools in place and returns (next_tokens (b,), logits (b, vocab) f32,
    pools), the pools still this rank's shard. Requires b % n_micro == 0
    and cfg.n_layers % pp == 0."""
    pp_group, pp, idx, group, tp = _stage(mesh)
    b = tokens.shape[0]
    if n_micro is None:
        n_micro = pp
    if b % n_micro:
        raise ValueError(f"n_micro={n_micro} must divide batch {b}")
    if cfg.n_layers % pp:
        raise ValueError(f"pp={pp} must divide n_layers {cfg.n_layers}")
    if (quant is not None) != ("k_s" in pools):
        raise ValueError(f"quant={quant!r}, but the pools {'have' if 'k_s' in pools else 'lack'} "
                         f"scale planes")
    lcfg = _local_cfg(cfg, tp) if tp > 1 else cfg
    mb = b // n_micro
    x_all = params["embed"][tokens.clamp(0, cfg.vocab_size - 1)]  # (b, 1, dim)
    rope = _rope(lcfg, x_all.device)
    blank = x_all.new_zeros((mb, 1, cfg.dim))
    outputs, state = [], blank
    for t in range(n_micro + pp - 1):
        m, out = t - idx, blank
        if 0 <= m < n_micro:
            r = slice(m * mb, (m + 1) * mb)
            kl = kv_lens[r]
            append_pos = (kl - 1).clamp_min(0)
            out = _layer_stack(params["layers"], x_all[r] if idx == 0 else state, pools,
                               block_tables[r], kl, append_pos, append_pos[:, None], lcfg, rope,
                               group)
            if idx == pp - 1:
                outputs.append(out)
        state = ppermute(out, pp_group)
    x = all_reduce_(torch.cat(outputs) if idx == pp - 1 else x_all.new_zeros((b, 1, cfg.dim)),
                    pp_group)
    logits = torch.cat([
        _lm_head(rms_norm(x[m * mb:(m + 1) * mb], params["final_norm"], cfg.rms_eps)[:, 0],
                 params, None) for m in range(n_micro)])
    if group is not None:
        logits = all_gather(logits, group, dim=-1)
    return torch.argmax(logits, dim=-1), logits, pools
