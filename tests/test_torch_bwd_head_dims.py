"""PyTorch port vs the JAX package: K8 (the probability plane) and K9-K11
(the dense backward) at head dims other than 64 and 128, and a 2-layer
model's gradient at head dim 96.

On CUDA K8 and K9-K11 take every head dim from 1 to 256, as K7: each is
instantiated at the rungs 64, 128, 192 and 256 and serves d with the
smallest rung >= d, reading the real d through its tensor maps; a width
whose rows are not whole 16-byte chunks takes a zero-padded copy to the
next such width (``attention_probs_padded``, ``flash_bwd_padded``). The
route functions (pure Python) are held here for every d; the padded routes
run on CPU tensors (the padded operands through the plain version, then cut
back to d). Inputs come from numpy seeds; the JAX kernels run as the JAX
package's own tests run them (CPU, Pallas interpret mode: two flash_bwd
calls, one attention_probs call and one jax.value_and_grad of the JAX
model), or through the JAX package's plain reference
(``ops/reference.py::attention_ref`` under ``jax.vjp``). Tolerances: the
backward's 3x rule (three times the low-precision reference's error against
the f32 reference, plus 1e-4), the plane's 2x rule (twice, plus 1e-5), the
model's loss and gradient 1e-5 relative to the JAX model's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.models import llama as jllama
from xf_flash_attention_cutlass_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from xf_flash_attention_cutlass_tpu.ops.flash_fwd import attention_probs as j_attention_probs
from xf_flash_attention_cutlass_tpu.ops.reference import attention_ref
from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, loss_fn, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops import flash_bwd as fb, flash_fwd as ff
from xf_flash_attention_cutlass_tpu_torch.utils.testing import (
    assert_close_2ref,
    flash_attention_oracle,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
WHAT = {"flash_probs": "attention probs (K8)", "flash_bwd.dq": "flash backward (K9-K11)",
        "flash_bwd.dkv": "flash backward (K9-K11)", "flash_bwd.fused": "flash backward (K9-K11)"}


# ---- the route, the rung, the library and the label, for every head dim ------

@pytest.mark.parametrize("dtype", [BF16, F16, F32], ids=["bf16", "f16", "f32"])
def test_k8_k11_route_for_every_head_dim(dtype):
    """For every d in 1..256, K8's and K9-K11's CUDA route: the width run is
    d itself when its rows are whole 16-byte chunks (a multiple of 8 in bf16
    / fp16, of 4 in f32), else the next such width; the rung the smallest of
    64, 128, 192, 256 >= it; the library the 16-bit one of the rung (its
    "_wide" variant above 128) or flash_f32; the launch counted under the
    kernel's dtype label at that width and rung."""
    align = 4 if dtype == F32 else 8
    suffix = {BF16: "", F16: ".f16", F32: ".f32"}[dtype]
    for d in range(1, 257):
        for kernel, what in WHAT.items():
            dm = ff.flash_head_dim(d, dtype, what)
            assert dm % align == 0 and d <= dm < d + align and (dm == d) == (d % align == 0)
            rung = ff.flash_rung(dm)
            assert rung in (64, 128, 192, 256) and rung - 64 < dm <= rung
            src = "flash_probs" if kernel == "flash_probs" else "flash_bwd"
            entry = "flash_probs" if kernel == "flash_probs" else (
                "flash_bwd_dq" if kernel == "flash_bwd.dq" else "flash_bwd_dkv")
            lib, fn = ff.flash_entry(src, entry, dtype, dm)
            if dtype == F32:
                assert (lib, fn) == ("flash_f32", f"xfa_{entry}_f32")
            else:
                assert (lib, fn) == (src + ("_wide" if rung > 128 else ""), f"xfa_{entry}")
            assert lib in _build.SOURCES
            key = _build.head_dim_key(ff.flash_label(kernel, dtype), dm, rung)
            assert key == f"{kernel}{suffix}@d{dm}/D{rung}"


def test_padded_routes_keep_the_real_softmax_scale(monkeypatch):
    """attention_probs_padded and flash_bwd_padded call the kernels' entry
    at the padded width with the softmax scale of the real d, 1 / sqrt(d),
    and cut dq, dk and dv back to d."""
    seen = {}

    def record(name, n_out):
        def fn(q, *a, softmax_scale=None, **kw):
            seen[name] = (q.shape[-1], softmax_scale)
            return q if n_out == 1 else (q, q, q)
        return fn

    monkeypatch.setattr(ff, "attention_probs", record("k8", 1))
    monkeypatch.setattr(fb, "flash_bwd", record("k9_k11", 3))
    x = torch.zeros((1, 2, 3, 59))
    ff.attention_probs_padded(x, x, torch.zeros((1, 2, 3)), 64)
    assert seen["k8"] == (64, 1.0 / math.sqrt(59))
    y = torch.zeros((1, 2, 3, 111))
    grads = fb.flash_bwd_padded(y, y, y, y, torch.zeros((1, 2, 3)), y, 112)
    assert seen["k9_k11"] == (112, 1.0 / math.sqrt(111))
    assert all(g.shape == (1, 2, 3, 111) for g in grads)


# ---- K9-K11 and K8 against the JAX kernels --------------------------------------

def _case(seed, d, b=1, h=2, h_k=1, sq=24, sk=40):
    """bf16 q, k, v, dO (BHSD, GQA 2:1) from a numpy seed, as jax and torch
    arrays, and the port's plain forward's residuals (causal)."""
    rng = np.random.default_rng(seed)
    arrs = [jnp.asarray(rng.standard_normal(s).astype(np.float32), jnp.bfloat16)
            for s in ((b, h, sq, d), (b, h_k, sk, d), (b, h_k, sk, d), (b, h, sq, d))]
    q, k, v, do = (_t(a) for a in arrs)
    o, lse = ff.flash_fwd(q, k, v, causal=True)
    return arrs, (q, k, v, do), (o, lse)


def _oracle_grads(q, k, v, do):
    """The f32 oracle's gradients (utils/testing.py), causal."""
    xs = [t.float().requires_grad_(True) for t in (q, k, v)]
    out, _ = flash_attention_oracle(*xs, causal=True)
    return torch.autograd.grad((out * do.float()).sum(), xs)


@pytest.mark.parametrize("d", [96, 256])
def test_plain_backward_both_schedules_match_jax_kernel(d):
    """The port's plain K9-K11 (two-pass and fused) against the JAX backward
    (interpret mode; it pads d to a multiple of 128 inside) on the same
    residuals, at head dims the CUDA kernels serve on the rungs 128 and 256
    in place: dq, dk, dv under the 3x rule with atol 1e-4 against the f32
    oracle's gradients."""
    (jq, jk, jv, jdo), (q, k, v, do), (o, lse) = _case(60 + d, d)
    assert ff.flash_head_dim(d, BF16) == d
    jg = j_flash_bwd(jq, jk, jv, jnp.asarray(o.float().numpy(), jnp.bfloat16),
                     jnp.asarray(lse.numpy()), jdo, causal=True)
    oracle = _oracle_grads(q, k, v, do)
    for fused in (None, True):
        got = fb.flash_bwd(q, k, v, o, lse, do, causal=True, fused=fused)
        for g, ref, jax_g, x in zip(got, oracle, jg, (q, k, v)):
            assert g.shape == x.shape and g.dtype == BF16
            assert torch.isfinite(g).all()
            assert_close_2ref(g, ref, _t(jax_g), mult=3.0, atol=1e-4)


def test_plain_probs_match_jax_kernel_d96():
    """The port's plain K8 at d = 96 against the JAX plane (interpret mode)
    on the same LSE: the 2x rule with atol 1e-5 against the f32 softmax of
    the causal scores."""
    (jq, jk, _, _), (q, k, _, _), (_, lse) = _case(96, 96)
    got = ff.attention_probs(q, k, lse, causal=True)
    jp = j_attention_probs(jq, jk, jnp.asarray(lse.numpy()), causal=True)
    qf, kf = q.float(), k.float().repeat_interleave(2, dim=1)
    s = qf @ kf.transpose(-1, -2) / math.sqrt(96)
    sq, sk = s.shape[-2:]
    keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + sk - sq
    ref = torch.softmax(s.masked_fill(~keep, -torch.inf), dim=-1)
    assert got.shape == (1, 2, 24, 40) and got.dtype == F32
    assert_close_2ref(got, ref, _t(jp))


# ---- d = 40 and the padded copies against the JAX reference --------------------

def _vjp_reference(arrs, upcast):
    """dq, dk, dv (BHSD) of the JAX package's attention_ref (BSHD, causal
    from the bottom right) under jax.vjp with the cotangent dO: in f32
    (upcast) or in the inputs' dtype (the low-precision reference)."""
    sw = lambda x: jnp.swapaxes(x.astype(jnp.float32) if upcast else x, 1, 2)  # noqa: E731
    q, k, v, do = (sw(a) for a in arrs)

    def f(q, k, v):
        return attention_ref(q, k, v, causal=True, upcast=upcast)[0]

    _, vjp = jax.vjp(f, q, k, v)
    return [_t(jnp.swapaxes(g, 1, 2)).float() for g in vjp(do.astype(q.dtype))]


@pytest.mark.parametrize("d,padded", [(40, False), (59, True), (111, True)])
def test_backward_matches_jax_reference(d, padded):
    """flash_bwd at d = 40 (in place on the rung 64) and flash_bwd_padded at
    59 and 111 (q, k, v, O, dO zero-padded to 64 and 112 through the plain
    version, dq, dk, dv cut back to d) against jax.vjp of the JAX
    reference: dq, dk, dv under the 3x rule with atol 1e-4; the padded
    gradients equal the plain version's at d itself up to f32 rounding."""
    arrs, (q, k, v, do), (o, lse) = _case(70 + d, d)
    dm = ff.flash_head_dim(d, BF16)
    assert (dm > d) == padded
    if padded:
        got = fb.flash_bwd_padded(q, k, v, o, lse, do, dm, causal=True)
        plain = fb.flash_bwd(q, k, v, o, lse, do, causal=True)
        for g, p in zip(got, plain):
            assert float((g.float() - p.float()).abs().max()) <= 2 ** -7 * float(
                p.float().abs().max())
    else:
        got = fb.flash_bwd(q, k, v, o, lse, do, causal=True)
    ref, lp = _vjp_reference(arrs, True), _vjp_reference(arrs, False)
    for g, r, low, x in zip(got, ref, lp, (q, k, v)):
        assert g.shape == x.shape and g.dtype == BF16
        assert_close_2ref(g, r, low, mult=3.0, atol=1e-4)


# ---- a 2-layer model's gradient at d = 96 ---------------------------------------

# dim 192 over 2 heads: head dim 96
D96 = dict(vocab_size=97, dim=192, n_layers=2, n_heads=2, n_kv_heads=2, ffn_dim=128,
           max_seq_len=256)


def _with_grad(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _with_grad(v, leaves, path + (k,)) for k, v in tree.items()}
    leaves[path] = tree.detach().clone().requires_grad_(True)
    return leaves[path]


def test_model_gradient_d96_matches_jax_value_and_grad():
    """A 2-layer f32 model at d = 96 (the K7 forward and the K9/K10 backward
    on the training path, plain versions on the CPU): the loss and the
    port's autograd gradient of every parameter against jax.value_and_grad
    of the JAX model's loss, each within 1e-5 relative (the gradient's
    largest error over its largest JAX entry), as tests/test_torch_model.py
    holds the d = 16 model."""
    jcfg = jllama.LlamaConfig(**D96)
    jp = jllama.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    toks = np.random.default_rng(5).integers(0, D96["vocab_size"], (1, 17)).astype(np.int32)
    jloss, jgrads = jax.value_and_grad(jllama.loss_fn)(jp, jnp.asarray(toks), jcfg)
    cfg = LlamaConfig(**D96)
    assert cfg.head_dim == 96
    leaves = {}
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    loss = loss_fn(_with_grad(tp, leaves), torch.from_numpy(toks), cfg)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    jflat = {tuple(k.key for k in path): g
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(jflat) == set(grads)
    for path, g in grads.items():
        want = _t(jflat[path])
        assert g.shape == want.shape and torch.isfinite(g).all(), path
        err = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= 1e-5, (path, err)
