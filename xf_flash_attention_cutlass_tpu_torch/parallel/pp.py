"""Pipeline parallelism: the GPipe microbatch schedule over the mesh's "pp"
axis, on ``torch.distributed``.

Layout, as the JAX package's ``parallel/pp.py`` shards it: the (L, ...)
layer stacks over "pp" on their layer axis, so each rank holds its stage's
L / pp layers; with tp > 1 each stage's weights also carry the Megatron
shards of ``parallel/tp.py``; the embedding, final norm and head are
replicated over pp (stage 0 embeds, the last stage norms and projects),
the head vocab-sharded under tp.

The schedule runs every stage in lockstep, as the JAX package's
``lax.scan`` does: n_micro + pp - 1 steps, and at step t stage i holds
microbatch t - i when that is one (stage 0 takes it from the embedding,
the others from what the previous stage sent). Then every rank shifts its
output one stage on (``utils/collectives.py`` ``ppermute``, the ring
i -> i + 1; stage 0 drops what the last stage sends). A step in which a
stage holds no microbatch (the pipeline's fill and drain) computes nothing
and sends zeros.

The backward pipeline is written out. JAX differentiates scan + ppermute
and gets the reverse shift as the transpose; torch autograd gives the
ranks no shared order of point-to-point calls. So the forward keeps each
microbatch's graph, and the backward runs the same lockstep in reverse
microbatch order: the last stage starts from its microbatch's loss, every
other stage from the output gradient the next stage sent back (the
reverse shift), and each stage sends the gradient of its input on to the
previous one. Stage 0's input is the embedding, whose gradient stays on
the rank. Each rank takes the global batch and computes its dp replica's
rows, as ``parallel/tp.py`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

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
from xf_flash_attention_cutlass_tpu_torch.parallel.mesh import DP, PP, TP, axis_index, axis_size
from xf_flash_attention_cutlass_tpu_torch.parallel.tp import (
    _local_cfg,
    _map2,
    _map_with_path,
    param_partition_specs,
    replica_rows,
    shard_leaf,
)
from xf_flash_attention_cutlass_tpu_torch.utils.collectives import all_reduce_, ppermute

_STAGE_LOCAL = ("layers",)  # the params' entries sharded over pp


def pp_param_partition_specs(params: Dict[str, Any], tp: bool = False) -> Dict[str, Any]:
    """The partition spec of every leaf (parallel/tp.py's form: one entry a
    dim): the layer stacks over "pp" on their layer axis (dim 0), the rest
    replicated. With tp, every leaf's dims past the layer axis as
    parallel/tp.py's param_partition_specs shards them over "tp" (QKV, gate
    and up out-sharded, O and down in-sharded, the lm_head vocab-sharded)."""
    tp_specs = param_partition_specs(params) if tp else None

    def spec_for(path, leaf):
        spec = (None,) * leaf.dim()
        if tp:
            spec = tp_specs
            for p in path:
                spec = spec[p]
        return (PP, *spec[1:]) if path[0] in _STAGE_LOCAL else spec

    return _map_with_path(spec_for, params)


def shard_pp_params(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's shard of every leaf (pp_param_partition_specs, with tp
    where the mesh's tp axis has more than one rank): its stage's layers,
    and under tp its Megatron shard. A leaf whole on this mesh is kept as
    given (pp = tp = 1 copies nothing)."""
    specs = pp_param_partition_specs(params, tp=axis_size(mesh, TP) > 1)
    return _map2(lambda x, s: shard_leaf(x, s, mesh), params, specs)


def _stage(mesh) -> Tuple[Any, int, int, Any, int]:
    """(the pp group, pp, this rank's stage, the tp group or None, tp): the
    tp group only where tp > 1, as the JAX package passes its tp axis."""
    tp = axis_size(mesh, TP)
    return (mesh.get_group(PP), axis_size(mesh, PP), axis_index(mesh, PP),
            mesh.get_group(TP) if tp > 1 else None, tp)


def _microbatch(b: int, n_micro: int) -> int:
    """Rows a microbatch: b / n_micro (the JAX package's error otherwise)."""
    if b % n_micro:
        raise ValueError(f"batch {b} must divide n_micro={n_micro}")
    return b // n_micro


def _per_layer(layers: Dict[str, Any]) -> Dict[str, Any]:
    """Every plain (L, ...) stack split into per-layer views, as
    models/llama.py forward does (one stacked gradient on the backward);
    quantized tuples kept."""
    return {n: v if isinstance(v, tuple) else list(v.unbind(0)) for n, v in layers.items()}


def _stage_apply(layers, x, cfg: LlamaConfig, cos, sin, positions, group) -> torch.Tensor:
    """This stage's layers (a _per_layer dict) over one microbatch (the JAX
    _stage_apply)."""
    for l in range(len(layers["attn_norm"])):
        layer = layer_view(layers, l)
        x = attention_block(layer, x, cfg, cos, sin, positions, group=group)
        x = mlp_block(layer, x, cfg, group=group)
    return x


def _setup(params, tokens, cfg: LlamaConfig, mesh, n_micro: int):
    """The rows of this rank's dp replica, the microbatch size, the config
    of a tp shard, the rotary tables and the positions of one microbatch."""
    rows = tokens[replica_rows(mesh, tokens.shape[0], (DP,))]
    mb = _microbatch(rows.shape[0], n_micro)
    tp = axis_size(mesh, TP)
    lcfg = _local_cfg(cfg, tp) if tp > 1 else cfg
    s = rows.shape[1]
    dev = params["embed"].device
    cos, sin = rotary_frequencies(cfg.head_dim, cfg.max_seq_len, cfg.rope_base, device=dev)
    positions = torch.arange(s, device=dev)[None].expand(mb, s)
    return rows, mb, lcfg, cos, sin, positions


def pp_forward(params, tokens: torch.Tensor, cfg: LlamaConfig, mesh,
               n_micro: int = 4) -> torch.Tensor:
    """The dp x pp (x tp) forward. params: this rank's shards
    (shard_pp_params); tokens: the global (b, s) batch, the same on every
    rank. Returns the logits of this rank's dp replica's rows, (b / dp, s,
    vocab) f32, the same on every rank of the replica: the last stage's
    hidden states are replicated over pp (a masked all-reduce, the JAX
    package's psum), then every rank norms and projects them."""
    pp_group, pp, idx, group, _ = _stage(mesh)
    rows, mb, lcfg, cos, sin, positions = _setup(params, tokens, cfg, mesh, n_micro)
    layers = _per_layer(params["layers"])
    blank = params["embed"].new_zeros((mb, rows.shape[1], cfg.dim))
    outputs, state = [], blank
    for t in range(n_micro + pp - 1):
        m, out = t - idx, blank
        if 0 <= m < n_micro:
            x = params["embed"][rows[m * mb:(m + 1) * mb]] if idx == 0 else state
            out = _stage_apply(layers, x, lcfg, cos, sin, positions, group)
            if idx == pp - 1:
                outputs.append(out)
        state = ppermute(out, pp_group)
    x = torch.cat(outputs) if idx == pp - 1 else blank.new_zeros((rows.shape[0], *blank.shape[1:]))
    x = rms_norm(all_reduce_(x, pp_group), params["final_norm"], cfg.rms_eps)
    logits = _proj(x, params["lm_head"]).float()
    return logits if group is None else gather_vocab(logits, group)


def _microbatch_loss(params, out, targets, cfg: LlamaConfig, group) -> torch.Tensor:
    """The last stage's mean next-token NLL of one microbatch (the JAX
    _pp_loss_local's head: under tp the vocab-sharded logits gathered, the
    cotangent scaled by 1 / tp)."""
    x = rms_norm(out, params["final_norm"], cfg.rms_eps)
    if group is not None:
        x = tp_region_in(x, group)
    logits = _proj(x, params["lm_head"]).float()
    if group is not None:
        logits = gather_vocab(logits, group)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def pp_loss_and_grad(params, tokens: torch.Tensor, cfg: LlamaConfig, mesh,
                     n_micro: int = 4) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One dp x pp (x tp) training step: the loss and the gradients through
    the GPipe schedule, forward then backward (module docstring). params:
    this rank's shards (shard_pp_params); tokens: the global (b, s + 1)
    batch. The loss is the mean over this replica's microbatches of each
    one's mean NLL (equal microbatches: the JAX package's mean over the
    local batch), summed over pp (only the last stage holds it) and
    averaged over dp. Every gradient is averaged over dp; a leaf replicated
    over pp (the embedding's gradient is on stage 0, the final norm's and
    the head's on the last stage) is summed over it; under tp a leaf
    replicated over tp is averaged over it. Returns (loss, grads): grads
    has params' structure, each this rank's shard's gradient (None for a
    leaf that is not floating point)."""
    pp_group, pp, idx, group, tp = _stage(mesh)
    rows, mb, lcfg, cos, sin, positions = _setup(params, tokens[:, :-1], cfg, mesh, n_micro)
    targets = tokens[replica_rows(mesh, tokens.shape[0], (DP,))][:, 1:]
    local = _map_with_path(
        lambda _, x: x.detach().requires_grad_(True) if x.is_floating_point() else x, params)
    blank = params["embed"].new_zeros((mb, rows.shape[1], cfg.dim))
    last = idx == pp - 1
    n_steps = n_micro + pp - 1
    # each microbatch's (stage input leaf or None on stage 0, output or loss)
    saved = [None] * n_micro
    state = blank
    with torch.enable_grad():
        for t in range(n_steps):
            m, send = t - idx, blank
            if 0 <= m < n_micro:
                r = slice(m * mb, (m + 1) * mb)
                x_in = None if idx == 0 else state.detach().requires_grad_(True)
                x = local["embed"][rows[r]] if idx == 0 else x_in
                out = _stage_apply(_per_layer(local["layers"]), x, lcfg, cos, sin, positions,
                                   group)
                if last:
                    saved[m] = x_in, _microbatch_loss(local, out, targets[r], lcfg, group)
                else:
                    saved[m], send = (x_in, out), out.detach()
            state = ppermute(send, pp_group)
        losses = [y.detach() for _, y in saved] if last else []
        for t in range(n_steps):
            m, send = n_micro - 1 - (t - (pp - 1 - idx)), blank
            if 0 <= m < n_micro:
                x_in, y = saved[m]
                saved[m] = None  # the microbatch's graph goes with its backward
                if last:
                    torch.autograd.backward(y / n_micro)
                else:
                    torch.autograd.backward(y, grad_tensors=state)
                if x_in is not None:
                    send = x_in.grad
            state = ppermute(send, pp_group, shift=-1)
    dp_group, dp = mesh.get_group(DP), axis_size(mesh, DP)
    loss = torch.stack(losses).mean() if last else blank.new_zeros((), dtype=torch.float32)
    loss = all_reduce_(all_reduce_(loss, pp_group), dp_group) / dp
    if group is not None:
        loss = all_reduce_(loss, group) / tp

    def fix(x, spec):
        if not x.is_floating_point():
            return None
        g = x.grad if x.grad is not None else torch.zeros_like(x)
        g = all_reduce_(g, dp_group) / dp
        if PP not in spec:
            g = all_reduce_(g, pp_group)
        if group is not None and TP not in spec:
            g = all_reduce_(g, group) / tp
        return g

    return loss, _map2(fix, local, pp_param_partition_specs(params, tp=tp > 1))
