"""PyTorch port vs the JAX package: the host side of the dense backward's
dK/dV kernels (ops/flash_bwd.py; csrc/flash_bwd.cu K10/K11 on the card).

- ``bwd_block_order`` is the launch order the kernel decodes from its block
  index: every (key tile, kv head, batch) once, key tile 0 first, since
  under a causal mask the first key tiles see the most query rows.
- K9 (dQ) decodes its block index as K7 does (``fwd_block_order``): on
  ragged causal shapes the blocks that walk the most key tiles start first.
- ``tma_operands`` (ops/flash_fwd.py, shared with K7) hands the kernels
  the model's (b, s, h, d) views as they are and copies only what the
  tensor maps cannot read.
- ``flash_bwd`` on (b, s, h, d) views gives the same bits as on contiguous
  copies, and matches the JAX backward (Pallas interpret mode) under the 3x
  rule with atol 1e-4, as tests/test_torch_flash.py holds it: the port's
  max error against the f32 oracle's gradients (utils/testing.py, held to
  the JAX oracle in tests/test_torch_flash.py) is at most three times the
  JAX kernel's own error, plus 1e-4. So does ``flash_bwd`` where K9's
  tiling (64-row blocks, 64-key tiles) can break: sq = 1, sk below one tile,
  ragged sq and sk with rows that see no key, GQA 4:1.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from xf_flash_attention_cutlass_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import bwd_block_order, flash_bwd
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import fwd_block_order, tma_operands
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


def _dq_key_tiles(iq, sq, sk):
    """Key tiles K9's block of q tile iq walks under a bottom-right causal
    mask (csrc/flash_common.cuh Mask::key_range, keys [0, k_hi))."""
    k_hi = min(sk, min(64 * iq + 64, sq) - 1 + (sk - sq) + 1)
    return max(0, -(-k_hi // 64))


@pytest.mark.parametrize("sq,sk,h,b", [(1, 700, 8, 1), (40, 33, 4, 2), (300, 1000, 8, 1),
                                       (1000, 300, 4, 2)])
def test_dq_block_order_walks_most_key_tiles_first(sq, sk, h, b):
    """K9's launch order on ragged causal shapes: every (q tile, head,
    batch) once, and the key tiles a block walks never rise along the order,
    so the longest blocks start first and the short ones (rows that see no
    key when sq > sk) fill the tail."""
    n_qt = -(-sq // 64)
    order = fwd_block_order(n_qt, h, b)
    assert sorted(order) == sorted((iq, ih, ib) for iq in range(n_qt) for ih in range(h)
                                   for ib in range(b))
    walked = [_dq_key_tiles(iq, sq, sk) for iq, _, _ in order]
    assert walked == sorted(walked, reverse=True)
    assert walked[0] == _dq_key_tiles(n_qt - 1, sq, sk) > 0


# (b, s_q, s_k, h, h_k) where K9's tiling can break, bf16, d = 16, causal
DQ_TILING = {
    "sq1_gqa4_sk70": (1, 1, 70, 8, 2),
    "sk_below_tile_40x33": (2, 40, 33, 4, 2),
    "ragged_130x70_gqa4": (1, 130, 70, 8, 2),  # rows 0-59 see no key
}


@functools.lru_cache(maxsize=None)
def _dq_tiling_case(name):
    """Inputs (numpy, from a seed), the JAX forward's residuals and the JAX
    two-pass backward's gradients of one DQ_TILING case: one JAX run each."""
    b, sq, sk, h, h_k = DQ_TILING[name]
    rng = np.random.default_rng(sorted(DQ_TILING).index(name))
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, h, sq, 16), (b, h_k, sk, 16), (b, h_k, sk, 16), (b, h, sq, 16))]
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    jo, jl = j_flash_fwd(jq, jk, jv, causal=True)
    jg = j_flash_bwd(jq, jk, jv, jo, jl, jdo, causal=True)
    return arrs, np.array(jo.astype(jnp.float32)), np.array(jl), [np.array(g) for g in jg]


@pytest.mark.parametrize("fused", [None, True])
@pytest.mark.parametrize("name", sorted(DQ_TILING))
def test_flash_bwd_matches_jax_where_dq_tiling_can_break(name, fused):
    """dq, dk, dv of ``flash_bwd`` match the JAX backward on the same
    residuals under the 3x rule, at sq = 1, sk below one tile and ragged
    sq > sk with GQA 4:1; rows that see no key get dq = 0."""
    arrs, jo, jl, jg = _dq_tiling_case(name)
    q, k, v, do = (_t(jnp.asarray(a, jnp.bfloat16)) for a in arrs)
    o = torch.from_numpy(jo).to(torch.bfloat16)
    got = flash_bwd(q, k, v, o, torch.from_numpy(jl), do, causal=True, fused=fused)
    xs = [t.float().requires_grad_(True) for t in (q, k, v)]
    out, _ = flash_attention_oracle(*xs, causal=True)
    oracle = torch.autograd.grad((out * do.float()).sum(), xs)
    for g, ref, jax_g, x in zip(got, oracle, jg, (q, k, v)):
        assert g.shape == x.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g).all()
        assert_close_2ref(g, ref, _t(jax_g), mult=3.0, atol=1e-4)
    sq, sk = q.shape[2], k.shape[2]
    if sq > sk:
        assert (got[0][:, :, : sq - sk] == 0).all()
