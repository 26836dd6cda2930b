"""PyTorch port vs the JAX package: the Llama ``forward`` and ``loss_fn``
and their gradients (models/llama.py), on tests/test_model.py's tiny f32
config with the JAX parameters converted bit for bit.

Both sides run f32 end to end (the JAX flash kernels in interpret mode, the
port's plain versions), so they differ only in the order of f32 sums:
logits, the loss and every gradient leaf within 1e-5 relative to their
largest magnitude (measured: about 1.2e-6 for the logits and the worst leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.models import llama as jllama
from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    forward,
    loss_fn,
    params_from_jax,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(vocab_size=101, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
            max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.LlamaConfig(**TINY), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, s)).astype(np.int32)


def _rel(got: torch.Tensor, want) -> float:
    want = torch.from_numpy(np.array(want))
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("with_kv_lens", [False, True])
def test_forward_matches_jax(params, with_kv_lens):
    jp, tp = params
    toks = _tokens(1, 2, 33)
    kw_j, kw_t = {}, {}
    if with_kv_lens:  # a padded batch: row 1 holds 20 real tokens
        lens = np.asarray([33, 20], np.int32)
        kw_j, kw_t = dict(kv_lens=jnp.asarray(lens)), dict(kv_lens=torch.from_numpy(lens))
    want = jllama.forward(jp, jnp.asarray(toks), jllama.LlamaConfig(**TINY), **kw_j)
    got = forward(tp, torch.from_numpy(toks), LlamaConfig(**TINY), **kw_t)
    assert got.shape == (2, 33, TINY["vocab_size"]) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


def _with_grad(tree, leaves, path=()):
    """A copy of the params tree whose tensors are fresh leaves that
    require grad, collected by path into `leaves`."""
    if isinstance(tree, dict):
        return {k: _with_grad(v, leaves, path + (k,)) for k, v in tree.items()}
    leaves[path] = tree.detach().clone().requires_grad_(True)
    return leaves[path]


def test_loss_and_every_gradient_match_jax(params):
    jp, tp = params
    toks = _tokens(2, 2, 24)
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(jp, jnp.asarray(toks),
                                                       jllama.LlamaConfig(**TINY))
    leaves = {}
    loss = loss_fn(_with_grad(tp, leaves), torch.from_numpy(toks), LlamaConfig(**TINY))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    jflat = {tuple(k.key for k in path): g
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(jflat) == set(leaves)
    for path, g in zip(leaves, grads):
        assert g.shape == jflat[path].shape, path
        assert torch.isfinite(g).all(), path
        assert _rel(g, jflat[path]) <= 1e-5, path


def test_sgd_step_lowers_the_loss(params):
    _, tp = params
    cfg = LlamaConfig(**TINY)
    toks = torch.from_numpy(_tokens(3, 4, 32))
    leaves = {}
    p = _with_grad(tp, leaves)
    loss0 = loss_fn(p, toks, cfg)
    grads = torch.autograd.grad(loss0, list(leaves.values()))
    with torch.no_grad():
        for t, g in zip(leaves.values(), grads):
            t -= 0.1 * g
        loss1 = loss_fn(p, toks, cfg)
    assert float(loss1) < float(loss0.detach())
