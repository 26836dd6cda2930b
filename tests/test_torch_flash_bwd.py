"""PyTorch port vs the JAX package: the host side of the dense backward's
dK/dV kernels (ops/flash_bwd.py; csrc/flash_bwd.cu K10/K11 on the card).

- ``bwd_block_order`` is the launch order the kernel decodes from its block
  index: every (key tile, kv head, batch) once, key tile 0 first, since
  under a causal mask the first key tiles see the most query rows.
- ``tma_operands`` (ops/flash_fwd.py, shared with K7) hands the kernels
  the model's (b, s, h, d) views as they are and copies only what the
  tensor maps cannot read.
- ``flash_bwd`` on (b, s, h, d) views gives the same bits as on contiguous
  copies, and matches the JAX backward (Pallas interpret mode) under the 3x
  rule with atol 1e-4, as tests/test_torch_flash.py holds it: the port's
  max error against the f32 oracle's gradients (utils/testing.py, held to
  the JAX oracle in tests/test_torch_flash.py) is at most three times the
  JAX kernel's own error, plus 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from xf_flash_attention_cutlass_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import bwd_block_order, flash_bwd
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import tma_operands
from xf_flash_attention_cutlass_tpu_torch.utils.testing import (
    assert_close_2ref,
    flash_attention_oracle,
)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


def _causal_work(n_kt, sq, sk):
    """Query rows that see key tile i under a bottom-right causal mask."""
    return [max(0, min(sq, sk - 64 * i)) for i in range(n_kt)]


@pytest.mark.parametrize("n_kt,h_k,b", [(1, 1, 1), (16, 8, 1), (3, 4, 2), (32, 8, 3)])
def test_bwd_block_order_visits_every_block_once_heaviest_first(n_kt, h_k, b):
    """Every (key tile, kv head, batch) exactly once; the key tiles never
    fall, so under a causal mask the blocks with the most query rows start
    first; the kv heads and batches of one key tile launch together."""
    order = bwd_block_order(n_kt, h_k, b)
    assert len(order) == n_kt * h_k * b
    assert set(order) == {(ik, ihk, ib) for ik in range(n_kt) for ihk in range(h_k)
                          for ib in range(b)}
    tiles = [ik for ik, _, _ in order]
    assert tiles == sorted(tiles) and tiles[0] == 0
    assert [ihk for _, ihk, _ in order[:h_k]] == list(range(h_k))
    work = _causal_work(n_kt, 64 * n_kt, 64 * n_kt)
    rows = [work[ik] for ik in tiles]
    assert rows == sorted(rows, reverse=True)


def test_tma_operands_take_model_views_without_a_copy():
    """The (b, s, h, d) views of q, k, v and dO that the model's backward
    receives reach the kernels as they are, with their strides; a tensor
    whose last dimension is not contiguous or whose row stride is not a
    16-byte multiple is copied to a contiguous one, whose strides are given
    instead."""
    b, s, h, h_k, d = 2, 40, 8, 2, 64
    q, do = (torch.zeros((b, s, h, d), dtype=torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.zeros((b, s, h_k, d), dtype=torch.bfloat16).transpose(1, 2) for _ in range(2))
    views = (q, k, v, do)
    got, strides = tma_operands(*views)
    assert all(a is x for a, x in zip(got, views))
    assert strides == [s * h * d, d, h * d, s * h_k * d, d, h_k * d,
                       s * h_k * d, d, h_k * d, s * h * d, d, h * d]
    odd = torch.zeros((1, 2, 5, 68), dtype=torch.bfloat16)[..., :64]  # rows 136 bytes apart
    cols = torch.zeros((1, 2, 64, 5), dtype=torch.bfloat16).transpose(2, 3)  # d not contiguous
    (o2, c2), st2 = tma_operands(odd, cols)
    for copy, src in ((o2, odd), (c2, cols)):
        assert copy.data_ptr() != src.data_ptr() and copy.is_contiguous()
        assert torch.equal(copy, src)
    assert st2 == [2 * 5 * 64, 5 * 64, 64, 2 * 64 * 5, 64 * 5, 64]


@pytest.mark.parametrize("fused", [None, True])
def test_flash_bwd_on_bshd_views_matches_contiguous_and_jax(fused):
    """dq, dk, dv from (b, s, h, d) views equal those from contiguous copies
    bit for bit, have the inputs' shapes, and match the JAX
    backward on the same residuals under the 3x rule (GQA 2:1, causal,
    kv_lens inside the last key tile)."""
    rng = np.random.default_rng(11)
    b, s, h, h_k, d = 1, 40, 4, 2, 16
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, s, h, d), (b, s, h_k, d), (b, s, h_k, d), (b, s, h, d))]
    jq, jk, jv, jdo = (jnp.swapaxes(jnp.asarray(a, jnp.bfloat16), 1, 2) for a in arrs)
    lens = np.asarray([33], np.int32)
    jo, jl = j_flash_fwd(jq, jk, jv, causal=True, kv_lens=jnp.asarray(lens))
    jg = j_flash_bwd(jq, jk, jv, jo, jl, jdo, causal=True, kv_lens=jnp.asarray(lens),
                     fused=fused)
    # the port's inputs as the model hands them: (b, s, h, d) tensors viewed as BHSD
    views = [_t(jnp.asarray(a, jnp.bfloat16)).transpose(1, 2) for a in arrs]
    q, k, v, do = views
    kw = dict(causal=True, kv_lens=torch.from_numpy(lens))
    o, lse = _t(jo), _t(jl)
    got = flash_bwd(q, k, v, o, lse, do, fused=fused, **kw)
    flat = flash_bwd(*(t.contiguous() for t in (q, k, v)), o, lse, do.contiguous(),
                     fused=fused, **kw)
    xs = [t.float().requires_grad_(True) for t in (q, k, v)]
    out, _ = flash_attention_oracle(*xs, **kw)
    oracle = torch.autograd.grad((out * do.float()).sum(), xs)
    for g, g_flat, ref, jax_g, x in zip(got, flat, oracle, jg, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
        assert torch.equal(g, g_flat)
        assert torch.isfinite(g).all()
        assert_close_2ref(g, ref, _t(jax_g), mult=3.0, atol=1e-4)
