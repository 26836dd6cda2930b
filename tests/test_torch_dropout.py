"""Dropout in the PyTorch port, the cases of tests/test_dropout.py and
tests/test_attn_probs.py's sign mask, held to the realized drop fraction and
to replay: the port's mask is a Philox4x32-10 stream keyed by (seed, batch,
q head, row, key), so it cannot give the JAX package's bits (threefry under
interpret, the TPU's generator on the chip). The port runs its plain
versions (CPU tensors); the mask of the plain versions is the one the CUDA
kernels compute (chip_smoke.py holds them to it bit for bit).

- Philox4x32-10 gives the Random123 known-answer vectors.
- The same seed gives the same output, another seed another one; p = 0 is
  the identity.
- With q = k = 0 and v = 1 every output is keep_fraction / (1 - p): the
  realized drop fraction is within 0.01 of p (the reference's tolerance),
  dense and through the paged varlen entry.
- The autograd gradient under dropout matches central finite differences of
  the seeded forward (the JAX test's tolerance, 2e-2 + 5 % of the value),
  and with GQA the dense oracle's given the forward's mask (1e-5 of the
  largest magnitude, f32 rounding): the backward keys the mask by q head.
- Rows that see no key stay 0 with LSE = -inf.
- S_dmask: relu(S_dmask) V / (1 - p) reproduces O, and its negative
  entries are exactly the entries the forward dropped, on every visible
  entry.
"""

import numpy as np
import pytest
import torch

import xf_flash_attention_cutlass_tpu_torch as tx
from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
    attention_mask,
    attention_probs,
    dropout_keep_mask,
    flash_fwd,
    philox4x32_10,
)
from xf_flash_attention_cutlass_tpu_torch.utils.testing import flash_attention_oracle, max_err


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    words = philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_dropout_deterministic():
    q = _rand(0, (1, 2, 256, 64))
    o1, _ = flash_fwd(q, q, q, dropout_p=0.3, dropout_seed=7)
    o2, _ = flash_fwd(q, q, q, dropout_p=0.3, dropout_seed=7)
    o3, _ = flash_fwd(q, q, q, dropout_p=0.3, dropout_seed=8)
    assert max_err(o1, o2) == 0.0
    assert max_err(o1, o3) > 1e-3  # another seed, another mask


def test_dropout_p0_is_identity():
    q = _rand(0, (1, 2, 192, 64))
    o0, _ = flash_fwd(q, q, q, causal=True)
    o1, _ = flash_fwd(q, q, q, causal=True, dropout_p=0.0, dropout_seed=5)
    assert max_err(o0, o1) == 0.0


def test_dropout_fraction():
    p = 0.17
    q = torch.zeros((2, 4, 512, 64))
    v = torch.ones((2, 4, 512, 64))
    o, _ = flash_fwd(q, q, v, dropout_p=p, dropout_seed=3)
    keep_frac = float(o.mean()) * (1.0 - p)
    assert abs((1.0 - keep_frac) - p) < 0.01, keep_frac


def test_dropout_grad_matches_finite_difference():
    q, k, v = (_rand(s, (1, 1, 256, 64), 0.5) for s in (0, 1, 2))
    w = _rand(3, (1, 1, 256, 64))

    def loss(q, k, v):
        o, _ = flash_attention(q, k, v, causal=True, dropout_p=0.25, dropout_seed=11)
        return (o * w).sum()

    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    grads = torch.autograd.grad(loss(*xs), xs)
    rng = np.random.default_rng(0)
    eps = 1e-2
    for i, (x, g) in enumerate(zip((q, k, v), grads)):
        for _ in range(4):
            idx = tuple(int(rng.integers(0, n)) for n in x.shape)
            dx = torch.zeros_like(x)
            dx[idx] = eps
            args_p = [t + dx if j == i else t for j, t in enumerate((q, k, v))]
            args_m = [t - dx if j == i else t for j, t in enumerate((q, k, v))]
            fd = float(loss(*args_p) - loss(*args_m)) / (2 * eps)
            ad = float(g[idx])
            assert abs(ad - fd) < 2e-2 + 0.05 * abs(ad), (i, idx, ad, fd)


@pytest.mark.parametrize("fused", [None, True])
def test_dropout_grad_gqa_replays_the_forward_mask(fused):
    """With GQA the backward must key the mask by each q head of a KV
    head's group: the gradient equals the dense oracle's given the mask of
    the forward's (b, h) plane, within 1e-5 of its largest magnitude."""
    p, seed = 0.3, 21
    b, h, h_k, s, d = 2, 4, 2, 40, 16
    q, k, v, w = (_rand(10 + i, sh) for i, sh in enumerate(
        ((b, h, s, d), (b, h_k, s, d), (b, h_k, s, d), (b, h, s, d))))
    keep = dropout_keep_mask(seed, p, b, h, s, s, "cpu")
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, _ = flash_attention(*xs, causal=True, dropout_p=p, dropout_seed=seed, fused=fused)
    got = torch.autograd.grad((o * w).sum(), xs)
    ys = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o32, _ = flash_attention_oracle(*ys, causal=True, dropout_mask=keep, dropout_p=p)
    want = torch.autograd.grad((o32 * w).sum(), ys)
    assert max_err(o.detach(), o32.detach()) <= 1e-5
    for g, r in zip(got, want):
        assert max_err(g, r) <= 1e-5 * float(r.abs().max())


def test_dropout_causal_masked_stay_zero():
    q, k, v = _rand(0, (1, 1, 256, 64)), _rand(1, (1, 1, 128, 64)), _rand(2, (1, 1, 128, 64))
    o, lse = flash_fwd(q, k, v, causal=True, dropout_p=0.4, dropout_seed=5)
    n_empty = 256 - 128
    assert float(o[:, :, :n_empty].abs().max()) == 0.0
    assert bool(torch.isneginf(lse[:, :, :n_empty]).all())


def test_dropout_paged_varlen_fraction():
    p = 0.17
    h, h_k, d, page = 4, 4, 64, 16
    lens_q, lens_k = [60, 100, 36], [64, 112, 48]
    b = len(lens_q)
    max_pages = max(lens_k) // page + 1
    cu_q = torch.tensor(np.cumsum([0] + lens_q), dtype=torch.int32)
    cu_k = torch.tensor(np.cumsum([0] + lens_k), dtype=torch.int32)
    bt = torch.arange(b * max_pages, dtype=torch.int32).reshape(b, max_pages)
    q = torch.zeros((sum(lens_q), h, d))
    k_cache = torch.zeros((b * max_pages, page, h_k, d))
    v_cache = torch.ones((b * max_pages, page, h_k, d))
    out = tx.flash_attn_varlen_func(q, k_cache, v_cache, cu_q, cu_k, max_seqlen_q=max(lens_q),
                                    max_seqlen_k=max(lens_k), dropout_p=p, block_table=bt,
                                    seqused_k=torch.tensor(lens_k, dtype=torch.int32),
                                    dropout_seed=3)
    keep_frac = float(out.mean()) * (1.0 - p)
    assert abs((1.0 - keep_frac) - p) < 0.01, keep_frac


@pytest.mark.parametrize("h_k", [4, 2])
def test_s_dmask_signs_and_reconstruction(h_k):
    p, seed = 0.3, 9
    b, h, sq, sk, d = 2, 4, 96, 80, 32
    q, k, v = _rand(4, (b, sq, h, d)), _rand(5, (b, sk, h_k, d)), _rand(6, (b, sk, h_k, d))
    out, lse, s_dmask = tx.flash_attn_func(q, k, v, dropout_p=p, causal=True,
                                           return_attn_probs=True, dropout_seed=seed)
    vx = v.transpose(1, 2).repeat_interleave(h // h_k, dim=1)
    o2 = (s_dmask.clamp_min(0.0) @ vx) / (1.0 - p)
    assert max_err(out.transpose(1, 2), o2) < 1e-5
    visible = attention_mask(b, sq, sk, "cpu", causal=True).expand(b, h, sq, sk)
    dropped = ~dropout_keep_mask(seed, p, b, h, sq, sk, "cpu")
    assert torch.equal(torch.signbit(s_dmask) & visible, dropped & visible)
    assert not torch.signbit(s_dmask[~visible]).any()  # masked entries stay +0
    assert abs(float(dropped[visible].float().mean()) - p) < 0.03
    # the oracle, given the mask, agrees with the forward
    o32, _ = flash_attention_oracle(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                    causal=True, dropout_mask=~dropped, dropout_p=p)
    assert max_err(out.transpose(1, 2), o32) < 1e-5


def test_s_dmask_replays_with_positions_and_row_slopes():
    """K8's plain version with explicit positions and per-row ALiBi slopes
    replays the forward: relu(P) V / (1 - p) gives O."""
    p, seed = 0.2, 4
    b, h, s, d = 1, 2, 64, 16
    q, k, v = _rand(7, (b, h, s, d)), _rand(8, (b, h, s, d)), _rand(9, (b, h, s, d))
    pos = torch.arange(s, dtype=torch.int32)[None] % 40  # two segments: 40 + 24 tokens
    seg = (torch.arange(s, dtype=torch.int32)[None] >= 40).int()
    rows = torch.rand((b, h, s), generator=torch.Generator().manual_seed(0)) * 0.2
    kw = dict(causal=True, q_positions=pos, kv_positions=pos, q_segment_ids=seg,
              kv_segment_ids=seg, alibi_row_slopes=rows, dropout_p=p, dropout_seed=seed)
    o, lse = flash_fwd(q, k, v, **kw)
    probs = attention_probs(q, k, lse, **kw)
    assert max_err(o, probs.clamp_min(0.0) @ v / (1.0 - p)) < 1e-5
