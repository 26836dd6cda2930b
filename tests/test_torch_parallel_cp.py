"""PyTorch port vs the JAX package: sequence parallelism (parallel/ring.py,
the ring and the zigzag ring with their backward rings, and
parallel/ulysses.py) on gloo ranks.

The port's side runs in four rank processes started once for the file
(tests/mesh_ranks.py, one intra-op thread each); every job builds its own
cp mesh, and rank i takes chunk i of the global q, k and v. The JAX side
runs here on the CPU devices of tests/conftest.py on a mesh of the same cp,
in interpret mode, once for each of the three functions (one compile of
value_and_grad with O and LSE as its aux). The other cases are held to the
port's dense flash_attention over the whole sequence, which
tests/test_torch_flash*.py hold to the JAX package. Inputs come from numpy
seeds; the loss is sum(sin(O)), as in the JAX package's tests.

Tolerances are the JAX package's for its cp mesh against one device
(tests/test_parallel.py), f32: O, LSE and gradients within 1e-4, the loss
within 1e-6 relative + 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mesh_ranks
from xf_flash_attention_cutlass_tpu.models.llama import scale_grad as j_scale_grad
from xf_flash_attention_cutlass_tpu.parallel import make_mesh as j_make_mesh
from xf_flash_attention_cutlass_tpu.parallel.ring import (
    ring_attention as j_ring_attention,
    ring_attention_zigzag as j_ring_attention_zigzag,
    zigzag_permute as j_zigzag_permute,
    zigzag_unpermute as j_zigzag_unpermute,
)
from xf_flash_attention_cutlass_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, init_params
from xf_flash_attention_cutlass_tpu_torch.ops.flash import flash_attention
from xf_flash_attention_cutlass_tpu_torch.parallel import (
    ring_attention,
    ring_attention_zigzag,
    ulysses_attention,
    zigzag_permute,
    zigzag_unpermute,
)
from xf_flash_attention_cutlass_tpu_torch.parallel import ring
from xf_flash_attention_cutlass_tpu_torch.serve import EngineConfig

TOL = 1e-4
D = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = mesh_ranks.Ranks(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def _inputs(seed, h, h_k, s):
    """Global q (1, h, s, D), k and v (1, h_k, s, D), f32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, heads, s, D), dtype=np.float32) for heads in (h, h_k, h_k)]


def _port(ranks, fn, n, qkv, **kw):
    """fn on n gloo ranks over the global inputs: (O, LSE, loss, grads, the
    collectives of the forward and of the backward, the log records), O,
    LSE and grads concatenated over the ranks, the loss summed, the
    collectives and records rank 0's."""
    outs = ranks.run(mesh_ranks.cp_attention, fn, *map(torch.from_numpy, qkv), kw, cp=n)
    cat = lambda xs: torch.cat(xs, dim=2).numpy()  # noqa: E731
    grads = [cat([o[3][i] for o in outs]) for i in range(3)]
    return (cat([o[0] for o in outs]), cat([o[1] for o in outs]), sum(o[2] for o in outs),
            grads, outs[0][4], outs[0][5], outs[0][6])


def _dense(qkv, **kw):
    """The port's dense flash_attention over the whole sequence: (O, LSE,
    loss, grads)."""
    xs = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    o, lse = flash_attention(*xs, **kw)
    loss = torch.sin(o).sum()
    loss.backward()
    return o.detach().numpy(), lse.numpy(), float(loss.detach()), [x.grad.numpy() for x in xs]


def _jax(fn, n, qkv, **kw):
    """The JAX function on a cp = n mesh of CPU devices, one compile of
    value_and_grad with (O, LSE) as aux: (O, LSE, loss, grads). The loss is
    sum(sin(O)) of the JAX function's O summed in f64: XLA's f32 sum of the
    1e5 terms of a Ulysses case (12 heads) lands 4e-4 from the exact sum,
    which the port's f32 sum keeps within 1e-6."""
    mesh = j_make_mesh(cp=n, devices=jax.devices("cpu")[:n])
    seq = P(None, None, "cp", None)

    def local(q, k, v):
        o, lse = fn(q, k, v, "cp", **kw)
        # the replicated loss through a psum, its n-fold cotangent scaled
        # back, as tests/test_parallel.py does
        loss = jax.lax.psum(jnp.sum(jnp.sin(o.astype(jnp.float32))), "cp")
        return j_scale_grad(loss, 1.0 / jax.lax.axis_size("cp")), (o, lse)

    f = jax.jit(jax.shard_map(
        jax.value_and_grad(local, argnums=(0, 1, 2), has_aux=True), mesh=mesh,
        in_specs=(seq,) * 3, out_specs=((P(), (seq, P(None, None, "cp"))), (seq,) * 3),
        check_vma=False))
    (_, (o, lse)), grads = f(*map(jnp.asarray, qkv))
    o = np.asarray(o)
    return o, np.asarray(lse), float(np.sin(o.astype(np.float64)).sum()), [
        np.asarray(g) for g in grads]


def _assert_close(got, want):
    """(O, LSE, loss, grads) against (O, LSE, loss, grads)."""
    o, lse, loss, grads = got
    wo, wlse, wloss, wgrads = want
    assert np.abs(o - wo).max() < TOL
    assert np.abs(lse - wlse).max() < TOL
    assert abs(loss - wloss) < 1e-6 * abs(wloss) + 1e-4
    for g, wg in zip(grads, wgrads):
        assert np.abs(g - wg).max() < TOL


def _zigzag(qkv, n):
    return [zigzag_permute(torch.from_numpy(x), n, 2).numpy() for x in qkv]


def _unzigzag(out, n):
    """(O, LSE, loss, grads, ...) from the zigzag layout back to sequence order."""
    def back(x):
        return zigzag_unpermute(torch.from_numpy(x), n, 2).numpy()

    o, lse, loss, grads, *rest = out
    return (back(o), back(lse), loss, [back(g) for g in grads], *rest)


# ---- zigzag ownership ---------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_zigzag_permute_matches_jax(n):
    x = np.random.default_rng(0).standard_normal((2, 3, 64, 8), dtype=np.float32)
    y = zigzag_permute(torch.from_numpy(x), n, 2)
    np.testing.assert_array_equal(y.numpy(), np.asarray(j_zigzag_permute(jnp.asarray(x), n, 2)))
    np.testing.assert_array_equal(zigzag_unpermute(y, n, 2).numpy(), x)
    np.testing.assert_array_equal(
        zigzag_unpermute(torch.from_numpy(x), n, 2).numpy(),
        np.asarray(j_zigzag_unpermute(jnp.asarray(x), n, 2)))
    sh = 64 // (2 * n)  # rank 0's shard is [half 0, half 2n-1]
    np.testing.assert_array_equal(y[:, :, sh:2 * sh].numpy(), x[:, :, (2 * n - 1) * sh:])


def test_zigzag_schedule_balanced(monkeypatch):
    """The zigzag ring at n = 8, every rank's schedule in one process
    (ring.lockstep, no ranks): each rank attends exactly two live
    half-planes a hop (a causal call counts half its q x k halves, a full
    call all of them), 2n in all, where the plain causal ring's rank i
    attends 4i + 2; and the result equals the dense causal flash_attention."""
    n, sh = 8, 2
    calls, flash_fwd = [], ring.flash_fwd

    def recorded(q, k, v, **kw):
        calls.append((q.shape[0] * q.shape[2] * k.shape[2], kw["causal"]))
        return flash_fwd(q, k, v, **kw)

    monkeypatch.setattr(ring, "flash_fwd", recorded)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 2 * sh * n))

    def live(schedule_of):
        """Live half-planes of each (rank, hop), from the flash_fwd calls
        each rank's hop made."""
        out = {}
        for i in range(n):
            for t in range(n):
                calls.clear()
                schedule_of(i, t)
                out[i, t] = sum(pairs / sh ** 2 * (0.5 if causal else 1.0)
                                for pairs, causal in calls)
        return out

    zq, zk, zv = (zigzag_permute(x, n, 2).chunk(n, dim=2) for x in (q, k, v))
    zz = live(lambda i, t: ring.zigzag_hop_fwd(zq[i], zk[(i - t) % n], zv[(i - t) % n], i,
                                               (i - t) % n, softmax_scale=None))
    assert all(x == 2.0 for x in zz.values()), zz
    rq, rk, rv = (x.chunk(n, dim=2) for x in (q, k, v))
    plain = live(lambda i, t: ring.ring_hop_fwd(rq[i], rk[(i - t) % n], rv[(i - t) % n], i,
                                                (i - t) % n, causal=True, softmax_scale=None))
    assert [sum(plain[i, t] for t in range(n)) for i in range(n)] == [
        4.0 * i + 2 for i in range(n)]
    # every rank's schedule in lockstep: the ring's rotations in one process
    hop = functools.partial(ring.zigzag_hop_fwd, softmax_scale=None)
    outs = ring.lockstep([ring.fwd_schedule(hop, zq[i], zk[i], zv[i], i, n) for i in range(n)])
    o = zigzag_unpermute(torch.cat([x[0] for x in outs], dim=2), n, 2)
    lse = zigzag_unpermute(torch.cat([x[1] for x in outs], dim=2), n, 2)
    want_o, want_lse = flash_attention(q, k, v, causal=True)
    assert float((o - want_o).abs().max()) < TOL
    assert float((lse - want_lse).abs().max()) < TOL


# ---- the ring -------------------------------------------------------------------

def test_ring_matches_jax(ranks):
    """GQA (4 q / 2 kv heads), causal, cp = 4: O, LSE, the loss and the
    gradients against the JAX ring on the same inputs."""
    qkv = _inputs(2, 4, 2, 4 * 32)
    got = _port(ranks, ring_attention, 4, qkv, causal=True)
    _assert_close(got[:4], _jax(j_ring_attention, 4, qkv, causal=True))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(ranks, causal):
    """cp = 4, 2 heads, 64 tokens a rank, against the dense flash_attention;
    the forward rotates K/V n - 1 times (2 ppermutes each), the backward
    rotates K/V and the dK/dV accumulators at every hop (4) and delivers
    once (2)."""
    qkv = _inputs(3, 2, 2, 4 * 64)
    got = _port(ranks, ring_attention, 4, qkv, causal=causal)
    _assert_close(got[:4], _dense(qkv, causal=causal))
    assert got[4] == {"collective.ppermute": 2 * 3}
    assert got[5] == {"collective.ppermute": 4 * 4 + 2}


# ---- the zigzag ring --------------------------------------------------------------

def test_zigzag_matches_jax(ranks):
    """GQA (4 q / 2 kv heads), cp = 4, 16 tokens a half-chunk: against the
    JAX zigzag ring on the same (zigzag-permuted) inputs."""
    qkv = _zigzag(_inputs(4, 4, 2, 32 * 4), 4)
    got = _port(ranks, ring_attention_zigzag, 4, qkv)
    _assert_close(got[:4], _jax(j_ring_attention_zigzag, 4, qkv))


@pytest.mark.parametrize("n", [2, 4])
def test_zigzag_matches_dense(ranks, n):
    qkv = _inputs(5, 2, 2, 32 * n)
    got = _unzigzag(_port(ranks, ring_attention_zigzag, n, _zigzag(qkv, n)), n)
    _assert_close(got[:4], _dense(qkv, causal=True))
    assert got[4] == {"collective.ppermute": 2 * (n - 1)}
    assert got[5] == {"collective.ppermute": 4 * n + 2}


# ---- Ulysses ----------------------------------------------------------------------

ULYSSES_WARNING = ("WARNING", "ulysses_attention: h_k=3 vs axis size 4 takes the full-KV "
                   "all-gather (O(h_k*s*d) per-device traffic)")


def test_ulysses_matches_jax(ranks):
    """h_k = 3 at cp = 4 (12 q heads): the full-KV gather route, whose
    backward reduce-scatters; against the JAX function on the same inputs,
    and the same warning."""
    qkv = _inputs(6, 12, 3, 4 * 32)
    got = _port(ranks, ulysses_attention, 4, qkv, causal=True)
    _assert_close(got[:4], _jax(j_ulysses, 4, qkv, causal=True))
    assert got[4] == {"collective.all_to_all": 3, "collective.all_gather": 2}
    assert got[5] == {"collective.all_to_all": 2, "collective.reduce_scatter": 2}
    assert got[6] == [ULYSSES_WARNING]


@pytest.mark.parametrize("h_k,kw,a2a,logged", [
    (8, dict(causal=True), 5, []),  # kv heads split by the exchange
    (2, dict(causal=True), 5, []),  # the grouped route: each kv head repeated n / h_k times
    (1, dict(causal=True), 3, [("DEBUG", ULYSSES_WARNING[1].replace("h_k=3", "h_k=1"))]),
    (2, dict(causal=False, window=(16, 8), softcap=5.0), 5, []),
])
def test_ulysses_matches_dense(ranks, h_k, kw, a2a, logged):
    """cp = 4, 8 q heads, 32 tokens a rank, against the dense
    flash_attention with the same options; the exchanges each route issues
    and what it logs."""
    qkv = _inputs(7, 8, h_k, 4 * 32)
    got = _port(ranks, ulysses_attention, 4, qkv, **kw)
    _assert_close(got[:4], _dense(qkv, **kw))
    assert got[4]["collective.all_to_all"] == a2a
    assert got[6] == logged


# ---- one rank, the errors, the engine -----------------------------------------------

@pytest.mark.parametrize("fn,kw", [(ring_attention, dict(causal=True)),
                                   (ring_attention, dict(causal=False)),
                                   (ulysses_attention, dict(causal=True)),
                                   (ring_attention_zigzag, dict())],
                         ids=["ring_causal", "ring", "ulysses", "zigzag"])
def test_cp1_on_gloo(ranks, fn, kw):
    """cp = 1 on gloo (the ring's rotations are copies to self, counted as
    none): the ring and Ulysses equal the dense flash_attention bit for
    bit, as one hop and identity exchanges leave its arithmetic as it is;
    the zigzag ring (its two halves merged in f32) within the tolerance."""
    qkv = _inputs(8, 4, 2, 48)
    got, want = _port(ranks, fn, 1, qkv, **kw), _dense(qkv, causal=kw.get("causal", True))
    if fn is ring_attention_zigzag:
        _assert_close(got[:4], want)
        return
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for g, wg in zip(got[3], want[3]):
        np.testing.assert_array_equal(g, wg)


def test_value_errors_match_jax(ranks):
    """The three ValueErrors of both packages: a global sequence that is
    not a multiple of 2 * cp (zigzag_permute), an odd local length (the
    zigzag ring) and q heads that do not divide by cp (Ulysses); and the
    port's own for causal ring chunks of two lengths."""
    x = np.zeros((1, 2, 12, D), np.float32)
    with pytest.raises(ValueError) as jerr:
        j_zigzag_permute(jnp.asarray(x), 4, 2)
    with pytest.raises(ValueError) as perr:
        zigzag_permute(torch.from_numpy(x), 4, 2)
    assert str(perr.value) == str(jerr.value)
    odd = np.zeros((1, 2, 5, D), np.float32)
    with pytest.raises(ValueError) as jzz:
        j_ring_attention_zigzag(*[jnp.asarray(odd)] * 3, "cp")
    mesh = j_make_mesh(cp=4, devices=jax.devices("cpu")[:4])
    seq = P(None, None, "cp", None)
    six = np.zeros((1, 6, 16, D), np.float32)
    with pytest.raises(ValueError) as july:
        jax.shard_map(lambda q, k, v: j_ulysses(q, k, v, "cp"), mesh=mesh, in_specs=(seq,) * 3,
                      out_specs=(seq, P(None, None, "cp")), check_vma=False)(
            *[jnp.asarray(six)] * 3)
    t = torch.from_numpy
    got = ranks.run(mesh_ranks.cp_errors, [
        (ring_attention_zigzag, (t(odd),) * 3, {}),
        (ulysses_attention, (t(six[:, :, :4]),) * 3, {}),
        (ring_attention, (t(odd), t(x), t(x)), dict(causal=True)),
        (ring_attention, (t(odd), t(x), t(x)), dict(causal=False)),
    ], cp=4)[0]
    assert got[:2] == [str(jzz.value), str(july.value)]
    assert got[2] == "causal ring chunks of q and k must have one length, got 5 and 12"
    assert got[3] is None  # non-causal chunks of two lengths attend in full


def test_engine_refuses_cp_mesh(ranks):
    """The engine serves no sequence shards, as the JAX engine (which reads
    only dp and ep from a mesh): a cp = 2 mesh raises NotImplementedError
    naming the functions that run context parallelism."""
    cfg = LlamaConfig(vocab_size=64, dim=64, n_layers=1, n_heads=4, n_kv_heads=2, ffn_dim=96,
                      max_seq_len=64)
    params = init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    ecfg = EngineConfig(max_batch=2, page_size=16, num_pages=8, max_seq=64, prefill_chunk=16)
    for name, msg in ranks.run(mesh_ranks.engine_raises, params, cfg, ecfg, cp=2):
        assert name == "NotImplementedError"
        for fn in ("parallel.ring_attention", "ring_attention_zigzag", "ulysses_attention"):
            assert fn in msg
        assert "cp = 2" in msg

