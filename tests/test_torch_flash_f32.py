"""The dense flash family's f32 path: the plain versions as float64 oracles,
the launch labels, the f32 kernels' entry points, and the allocator's source.

The plain versions (ops/flash_fwd.py ``flash_fwd_ref``,
``attention_probs_ref``, ops/flash_bwd.py ``flash_bwd_ref``) work in
``utils.acc_dtype``: f32 for 16-bit and f32 inputs, f64 for f64 inputs, so a
float64 run of them is the oracle of the f32 kernels on the card
(csrc/flash_f32.cu, which needs nvcc and a GPU). Here, at a tiny GQA
shape with causal, ALiBi and softcap, inputs made with numpy from a seed:
- the f64 plain versions agree with a numpy float64 computation written
  apart (within 1e-12) and closer than the f32 plain versions do;
- they agree with the JAX package's f32 results within 8 f32 ulps of the
  largest magnitude for O and LSE (the rule of tests/test_torch_flash.py),
  one interpret-mode forward, and with ``jax.grad`` of the JAX
  ``flash_attention`` in f32 within 1e-5 absolute for dq, dk and dv.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.ops import flash as jflash
from xf_flash_attention_cutlass_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from xf_flash_attention_cutlass_tpu_torch import _build
from xf_flash_attention_cutlass_tpu_torch.ops.flash_bwd import flash_bwd_ref
from xf_flash_attention_cutlass_tpu_torch.ops.flash_fwd import (
    attention_probs_ref,
    flash_entry,
    flash_fwd_ref,
    flash_label,
)
from xf_flash_attention_cutlass_tpu_torch.serve import allocator
from xf_flash_attention_cutlass_tpu_torch.utils.testing import max_err


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, H, H_K, SQ, SK, D = 1, 4, 2, 24, 40, 16
SLOPES = np.asarray([0.5, 0.25, 0.125, 0.0625], np.float32)
SOFTCAP = 5.0
OPTS = dict(causal=True, softcap=SOFTCAP)


@pytest.fixture(scope="module")
def inputs():
    """q, k, v, dO as float64 numpy arrays holding f32 values (BHSD)."""
    rng = np.random.default_rng(17)
    return [rng.standard_normal(s).astype(np.float32).astype(np.float64)
            for s in ((B, H, SQ, D), (B, H_K, SK, D), (B, H_K, SK, D), (B, H, SQ, D))]


def _numpy_f64(q, k, v, do):
    """Attention forward (O, LSE, P) and backward (dq, dk, dv) in float64
    numpy, written apart from the port: bottom-right causal mask, scores
    q k^T / sqrt(d), tanh softcap, then ALiBi."""
    g = H // H_K
    kx, vx = np.repeat(k, g, axis=1), np.repeat(v, g, axis=1)
    scale = 1.0 / np.sqrt(D)
    raw = q @ np.swapaxes(kx, -1, -2)
    s = np.tanh((q * scale) @ np.swapaxes(kx, -1, -2) / SOFTCAP) * SOFTCAP
    i = np.arange(SQ)[:, None] + (SK - SQ)
    j = np.arange(SK)[None, :]
    s = s - SLOPES.astype(np.float64)[None, :, None, None] * np.abs(i - j)
    keep = j <= i
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l_sum = p.sum(-1, keepdims=True)
    o = (p / l_sum) @ vx
    lse = (m + np.log(l_sum))[..., 0]
    prob = p / l_sum
    # backward, with the scale on the raw product (as the backward kernels)
    th = np.tanh(raw * scale / SOFTCAP)
    dp = do @ np.swapaxes(vx, -1, -2)
    delta = (do * o).sum(-1, keepdims=True)
    ds = prob * (dp - delta) * (1.0 - th * th) * scale
    dq = ds @ kx
    dk = (np.swapaxes(ds, -1, -2) @ q).reshape(B, H_K, g, SK, D).sum(2)
    dv = (np.swapaxes(prob, -1, -2) @ do).reshape(B, H_K, g, SK, D).sum(2)
    return o, lse, prob, dq, dk, dv


def _port(inputs, dtype):
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in inputs)
    kw = dict(OPTS, alibi_slopes=torch.from_numpy(SLOPES))
    o, lse = flash_fwd_ref(q, k, v, **kw)
    prob = attention_probs_ref(q, k, lse, **kw)
    return (o, lse, prob, *flash_bwd_ref(q, k, v, o, lse, do, **kw))


def test_plain_versions_return_f64_for_f64_inputs(inputs):
    outs = _port(inputs, torch.float64)
    assert [t.dtype for t in outs] == [torch.float64] * 6
    assert [tuple(t.shape) for t in outs] == [(B, H, SQ, D), (B, H, SQ), (B, H, SQ, SK),
                                              (B, H, SQ, D), (B, H_K, SK, D), (B, H_K, SK, D)]


@pytest.mark.parametrize("part", ["forward", "backward"])
def test_f64_plain_versions_are_the_closer_oracle(inputs, part):
    """The f64 plain versions are within 1e-12 of the numpy float64
    computation, and closer to it than the f32 plain versions."""
    want = _numpy_f64(*inputs)
    got64, got32 = _port(inputs, torch.float64), _port(inputs, torch.float32)
    idx = range(3) if part == "forward" else range(3, 6)
    for i in idx:
        ref = torch.from_numpy(want[i])
        e64, e32 = max_err(got64[i], ref), max_err(got32[i], ref)
        assert e64 <= 1e-12, (i, e64)
        assert e64 < e32, (i, e64, e32)


def test_f64_plain_forward_within_8_ulps_of_jax(inputs):
    """One interpret-mode JAX forward in f32 against the f64 plain version."""
    q, k, v, _ = (jnp.asarray(a, jnp.float32) for a in inputs)
    jo, jl = j_flash_fwd(q, k, v, alibi_slopes=jnp.asarray(SLOPES), **OPTS)
    to, tl = _port(inputs, torch.float64)[:2]
    ulp = float(np.finfo(np.float32).eps)
    jo, jl = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jl))
    assert max_err(to, jo) <= 8 * ulp * float(jo.abs().max())
    assert max_err(tl, jl) <= 8 * ulp * float(jl.abs().max())


def test_f64_plain_backward_matches_jax_grad(inputs):
    """jax.grad of the JAX flash_attention in f32 against the f64 plain
    backward of the f64 plain forward, within 1e-5 (f32 rounding of sums of
    a few dozen terms of magnitude <= 1)."""
    q, k, v, do = (jnp.asarray(a, jnp.float32) for a in inputs)

    def loss(q, k, v):
        o, _ = jflash.flash_attention(q, k, v, alibi_slopes=jnp.asarray(SLOPES), **OPTS)
        return jnp.sum(o * do)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    tgrads = _port(inputs, torch.float64)[3:]
    for jg, tg in zip(jgrads, tgrads):
        assert max_err(tg, torch.from_numpy(np.array(jg))) <= 1e-5


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_probs", "flash_bwd.dq", "flash_bwd.dkv",
                                    "flash_bwd.fused"])
def test_flash_label_by_dtype(kernel):
    assert flash_label(kernel, torch.bfloat16) == kernel
    assert flash_label(kernel, torch.float16) == kernel + ".f16"
    assert flash_label(kernel, torch.float32) == kernel + ".f32"


def test_f32_entry_points_live_in_their_own_source():
    """f32 goes to csrc/flash_f32.cu's entry points (same arguments as the
    16-bit ones), which _build compiles as a library of its own."""
    assert flash_entry("flash_fwd", "flash_fwd", torch.bfloat16) == ("flash_fwd", "xfa_flash_fwd")
    assert flash_entry("flash_bwd", "flash_bwd_dq", torch.float16) == ("flash_bwd",
                                                                     "xfa_flash_bwd_dq")
    assert "flash_f32" in _build.SOURCES
    with open(os.path.join(_build.CSRC_DIR, "flash_f32.cu")) as f:
        src = f.read()
    for name in ("flash_fwd", "flash_probs", "flash_bwd_dq", "flash_bwd_dkv"):
        lib, fn = flash_entry("flash_bwd" if "bwd" in name else name, name, torch.float32)
        assert lib == "flash_f32" and f'extern "C" int {fn}(' in src


def test_allocator_builds_from_the_package_source():
    pkg = os.path.dirname(os.path.abspath(_build.__file__))
    for path in (allocator._SRC, _build.CSRC_DIR):
        assert os.path.commonpath([pkg, os.path.abspath(path)]) == pkg
    assert os.path.isfile(allocator._SRC)
