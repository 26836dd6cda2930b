"""PyTorch port vs the JAX package: the MoE family (models/moe.py), the
engine serving it, and the reference ops (ops/reference.py,
apply_rotary_single).

Inputs come from numpy seeds; JAX params travel to the port through
params_from_jax, bit for bit. Three JAX engine runs: chunked prefill at
capacity_factor 1.0 (experts overflow), bucketed at 1.25, and the engine
against the port's own recompute at 8.0 (no JAX run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.models import moe as jmoe
from xf_flash_attention_cutlass_tpu.ops import reference as jref
from xf_flash_attention_cutlass_tpu.ops.rotary import (
    apply_rotary_single as j_apply_rotary_single,
    rotary_frequencies as j_rotary_frequencies,
)
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
)
from xf_flash_attention_cutlass_tpu_torch.models import moe
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops import reference
from xf_flash_attention_cutlass_tpu_torch.ops.rotary import (
    apply_rotary_single,
    rotary_frequencies,
)
from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, EngineConfig

# the tiny MoE of the JAX package's tests/test_moe_pp.py
TINY = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
            max_seq_len=512, n_experts=4, top_k=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def jax_params():
    cfg = jmoe.MoEConfig(**TINY)
    return jmoe.init_moe_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)


@pytest.fixture(scope="module")
def jax_qparams(jax_params):
    return jmoe.quantize_moe_params(jax_params)


def _layer0(tree):
    return {k: tuple(x[0] for x in v) if isinstance(v, tuple) else v[0]
            for k, v in tree["layers"].items()}


# ---- the dispatch -----------------------------------------------------------

def _probs(n, E, seed, skew=0.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, E)).astype(np.float32)
    logits[:, 0] += skew  # skew > 0 crowds expert 0
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("n,E,k,capacity,skew", [
    (16, 4, 2, 16, 0.0),  # room for everything: no drop
    (24, 4, 2, 8, 3.0),  # expert 0 overflows
    (40, 8, 2, 4, 0.0),  # capacity below every expert's load
    (12, 2, 1, 4, 0.0),  # one choice, two experts
])
def test_top_k_dispatch_matches_jax(n, E, k, capacity, skew):
    probs = _probs(n, E, seed=n + E, skew=skew)
    jd, jc, ja = jmoe.top_k_dispatch(jnp.asarray(probs), k, capacity)
    d, c, a = moe.top_k_dispatch(_t(probs), k, capacity)
    assert np.array_equal(d.numpy(), np.asarray(jd))
    assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1e-6
    assert abs(float(a) - float(ja)) <= 1e-6
    dropped = n * k - int(d.sum())
    assert (dropped > 0) == (capacity < n)  # the overflow cases do drop


def test_top_k_dispatch_ties_rank_the_lower_expert_first():
    """Equal probabilities: jax.lax.top_k puts the lower index first, and
    so must the port (its stable sort), since the seat order follows."""
    probs = np.full((10, 4), 0.25, np.float32)
    probs[::3] = [0.1, 0.3, 0.3, 0.3]
    for k, capacity in ((2, 8), (1, 3), (3, 16)):
        jd, jc, _ = jmoe.top_k_dispatch(jnp.asarray(probs), k, capacity)
        d, c, _ = moe.top_k_dispatch(_t(probs), k, capacity)
        assert np.array_equal(d.numpy(), np.asarray(jd))
        assert np.abs(c.numpy() - np.asarray(jc)).max() <= 1e-6


def test_expert_capacity_matches_jax():
    for cf in (1.0, 1.25, 8.0):
        cfg, jcfg = moe.MoEConfig(**TINY, capacity_factor=cf), jmoe.MoEConfig(**TINY,
                                                                              capacity_factor=cf)
        for n in (1, 4, 8, 32, 256, 2048):
            assert moe.expert_capacity(cfg, n) == jmoe.expert_capacity(jcfg, n)
    mix = moe.MoEConfig.mixtral8x7b_geometry()
    assert [moe.expert_capacity(mix, n) for n in (8, 256, 2048)] == [8, 80, 640]


# ---- params -----------------------------------------------------------------

def test_params_from_jax_carries_moe_trees(jax_params, jax_qparams):
    for jp in (jax_params, jax_qparams):
        p = params_from_jax(_np_tree(jp))
        jl, tl = jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda x: x.numpy(), p))
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert a.shape == b.shape and np.array_equal(np.asarray(a), b)
    q = params_from_jax(_np_tree(jax_qparams))["layers"]
    assert q["w_gate"][0].shape == (2, 4, 64, 128) and q["w_gate"][0].dtype == torch.int8
    assert q["w_gate"][1].shape == (2, 4, 128) and q["router"].dtype == torch.float32


def test_quantize_moe_params_bit_exact(jax_params, jax_qparams):
    got = moe.quantize_moe_params(params_from_jax(_np_tree(jax_params)))
    want = params_from_jax(_np_tree(jax_qparams))
    for name in moe.ATTN_NAMES + moe.EXPERT_NAMES:
        for a, b in zip(got["layers"][name], want["layers"][name]):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert all(torch.equal(a, b) for a, b in zip(got["lm_head"], want["lm_head"]))


def test_init_quantized_equals_quantized_init():
    """The layer-at-a-time INT8 init draws what init_moe_params draws and
    quantizes it as quantize_moe_params does, bit for bit."""
    cfg = moe.MoEConfig(**TINY)
    a = moe.quantize_moe_params(moe.init_moe_params(torch.Generator().manual_seed(3), cfg))
    b = moe.init_moe_params_quantized(torch.Generator().manual_seed(3), cfg)
    la = jax.tree_util.tree_leaves(a, is_leaf=lambda x: isinstance(x, torch.Tensor))
    lb = jax.tree_util.tree_leaves(b, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert len(la) == len(lb)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---- the MoE MLP and the model ---------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_moe_mlp_block_matches_jax(jax_params, jax_qparams, quantized):
    jp = jax_qparams if quantized else jax_params
    jcfg, cfg = jmoe.MoEConfig(**TINY), moe.MoEConfig(**TINY)
    x = np.random.default_rng(5).standard_normal((2, 12, 64)).astype(np.float32)
    jlayer = _layer0(jp)
    layer = _layer0(params_from_jax(_np_tree(jp)))
    for capacity in (None, 8):  # the default, and one that drops
        jout, jaux = jmoe.moe_mlp_block(jlayer, jnp.asarray(x), jcfg, capacity=capacity)
        out, aux = moe.moe_mlp_block(layer, _t(x), cfg, capacity=capacity)
        assert np.abs(out.numpy() - np.asarray(jout)).max() <= 1e-4
        assert abs(float(aux) - float(jaux)) <= 1e-6
    # uncrowded, the dispatch computes the dense oracle
    out, _ = moe.moe_mlp_block(layer, _t(x), cfg, capacity=2 * 24)
    ref = moe.moe_mlp_block_dense_oracle(layer, _t(x), cfg)
    jref_out = jmoe.moe_mlp_block_dense_oracle(jlayer, jnp.asarray(x), jcfg)
    assert (out - ref).abs().max() <= 1e-5
    assert np.abs(ref.numpy() - np.asarray(jref_out)).max() <= 1e-4


def test_moe_forward_and_loss_grad_match_jax(jax_params):
    """One layer, s = 16: logits within 1e-4 relative, and the gradient of
    moe_loss_fn (cross entropy plus the router's aux loss) against
    jax.grad within 1e-4 relative, leaf by leaf."""
    kw = dict(TINY, n_layers=1)
    jcfg, cfg = jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
    jp = jax.tree_util.tree_map(lambda x: x[:1], jax_params["layers"])
    jp = dict(jax_params, layers=jp)
    tokens = np.random.default_rng(6).integers(0, 97, (1, 17)).astype(np.int32)
    jlogits, _ = jmoe.moe_forward(jp, jnp.asarray(tokens[:, :-1]), jcfg)
    p = params_from_jax(_np_tree(jp))
    logits, _ = moe.moe_forward(p, _t(tokens[:, :-1]).long(), cfg)
    scale = np.abs(np.asarray(jlogits)).max()
    assert np.abs(logits.detach().numpy() - np.asarray(jlogits)).max() <= 1e-4 * scale
    jgrad = jax.grad(jmoe.moe_loss_fn)(jp, jnp.asarray(tokens), jcfg)
    leaves, tdef = jax.tree_util.tree_flatten(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = moe.moe_loss_fn(jax.tree_util.tree_unflatten(tdef, leaves), _t(tokens).long(), cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jmoe.moe_loss_fn(jp, jnp.asarray(tokens), jcfg))) <= 1e-5
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        jg = np.asarray(jg)
        assert np.abs(g.numpy() - jg).max() <= 1e-4 * np.abs(jg).max()


# ---- the engine -------------------------------------------------------------

def _prompts(lens=(40, 50, 61)):
    rng = np.random.default_rng(11)
    return {rid: [int(t) for t in rng.integers(0, 97, n)] for rid, n in enumerate(lens)}


def _serve(eng, prompts, n_new):
    for rid, p in prompts.items():
        eng.add_request(rid, p, n_new)
    return {rid: [int(t) for t in toks] for rid, toks in eng.run().items()}


def _count_drops(monkeypatch):
    """Wrap the port's dispatch to count assignments dropped by capacity."""
    dropped = []
    dispatch = moe.top_k_dispatch

    def counting(probs, top_k, capacity):
        out = dispatch(probs, top_k, capacity)
        dropped.append(probs.shape[0] * top_k - int(out[0].sum()))
        return out

    monkeypatch.setattr(moe, "top_k_dispatch", counting)
    return dropped


@pytest.mark.parametrize("prefill_chunk,capacity_factor", [(32, 1.0), (None, 1.25)])
def test_engine_quantized_moe_matches_jax(jax_qparams, monkeypatch, prefill_chunk,
                                          capacity_factor):
    """The tiny INT8 MoE over int8 KV (page 16, served as 32), greedy, token
    for token against the JAX engine, counters too: chunked prefill (three
    lanes of 32-token chunks with padded tails) at capacity_factor 1.0,
    where experts overflow, and bucketed prefill (padded buckets) at 1.25.

    Every request decodes from the same step to the same step: the JAX
    engine's paged attention returns NaN for a decode row of kv_len 0 (a
    free slot) under its split-KV, and the dense dispatch spreads a NaN row
    to every row (0 x NaN in the einsums), so a batch with a free slot
    cannot be compared. The port's rows of kv_len 0 attend to nothing and
    stay finite (test_engine_moe_matches_its_own_recompute serves such
    batches)."""
    kw = dict(max_batch=3, page_size=16, num_pages=32, max_seq=256, kv_quant="int8",
              prefill_chunk=prefill_chunk, prefill_lanes=3 if prefill_chunk else 1)
    jcfg = jmoe.MoEConfig(**TINY, capacity_factor=capacity_factor)
    cfg = moe.MoEConfig(**TINY, capacity_factor=capacity_factor)
    dropped = _count_drops(monkeypatch)
    teng = DecodeEngine(params_from_jax(_np_tree(jax_qparams)), cfg, EngineConfig(**kw),
                        dtype=torch.float32, device="cpu")
    tout = _serve(teng, _prompts(), 6)
    jeng = JDecodeEngine(jax_qparams, jcfg, JEngineConfig(**kw), dtype=jnp.float32)
    jout = _serve(jeng, _prompts(), 6)
    assert tout == jout
    assert teng.stats == jeng.stats
    if capacity_factor == 1.0:
        assert sum(dropped) > 0  # the run did overflow experts


def test_engine_moe_matches_its_own_recompute(jax_qparams):
    """At capacity_factor 8.0 nothing drops, so the engine (chunked, three
    requests at once) gives the greedy tokens of recomputing moe_forward
    over the whole context, request by request."""
    cfg = moe.MoEConfig(**TINY, capacity_factor=8.0)
    params = params_from_jax(_np_tree(jax_qparams))
    eng = DecodeEngine(params, cfg, EngineConfig(max_batch=3, page_size=16, num_pages=32,
                                                 max_seq=256, prefill_chunk=32),
                       dtype=torch.float32, device="cpu")
    prompts = _prompts((40, 23, 61))
    out = _serve(eng, prompts, 5)
    for rid, prompt in prompts.items():
        toks = list(prompt)
        for _ in range(5):
            logits, _ = moe.moe_forward(params, torch.tensor([toks]), cfg)
            toks.append(int(logits[0, -1].argmax()))
        assert out[rid] == toks[len(prompt):], rid


def test_engine_serves_bf16_moe_on_cpu():
    """bf16 MoE params (plain experts, einsum) serve through the engine."""
    cfg = moe.MoEConfig(**TINY)
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg)
    eng = DecodeEngine(params, cfg, EngineConfig(max_batch=2, page_size=16, num_pages=16,
                                                 max_seq=128), device="cpu")
    out = _serve(eng, {0: [5, 6, 7, 8], 1: list(range(30))}, 4)
    assert all(len(v) == 4 and all(0 <= t < 97 for t in v) for v in out.values())
    assert eng.pools["k"].dtype == torch.bfloat16


# ---- the reference ops ------------------------------------------------------

def test_attention_ref_matches_jax():
    rng = np.random.default_rng(7)
    b, sq, sk, h, h_k, d = 2, 5, 9, 4, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, h_k, d), (b, sk, h_k, d)))
    qpm = np.ones((b, sq), bool)
    qpm[1, 4:] = False
    kpm = np.ones((b, sk), bool)
    kpm[0, 7:] = False
    leftpad = np.asarray([0, 2], np.int32)
    slopes = rng.random((b, h)).astype(np.float32)
    dmask = rng.random((b, h, sq, sk)) > 0.3
    cases = [dict(), dict(causal=True), dict(window_size=(2, 1)), dict(softcap=5.0),
             dict(query_padding_mask=qpm, key_padding_mask=kpm, causal=True),
             dict(key_padding_mask=kpm, window_size=(3, 0), key_leftpad=leftpad),
             dict(dropout_p=0.3, dropout_mask=dmask, reorder_ops=True, softmax_scale=0.2)]
    for kw in cases:
        jkw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
        tkw = {n: (_t(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
        jo, ja = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
        o, a = reference.attention_ref(_t(q), _t(k), _t(v), **tkw)
        assert np.abs(o.numpy() - np.asarray(jo)).max() <= 1e-5, kw
        assert np.abs(a.numpy() - np.asarray(ja)).max() <= 1e-6, kw
    for causal in (False, True):
        kw = dict(query_padding_mask=qpm, key_padding_mask=kpm, causal=causal,
                  key_leftpad=leftpad)
        jb = jref.attn_bias_from_alibi_slopes(jnp.asarray(slopes), sq, sk,
                                              **{n: (jnp.asarray(x) if isinstance(x, np.ndarray)
                                                     else x) for n, x in kw.items()})
        tb = reference.attn_bias_from_alibi_slopes(
            _t(slopes), sq, sk, **{n: (_t(x) if isinstance(x, np.ndarray) else x)
                                   for n, x in kw.items()})
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        jo, _ = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), attn_bias=jb,
                                   causal=causal)
        o, _ = reference.attention_ref(_t(q), _t(k), _t(v), attn_bias=tb, causal=causal)
        assert np.abs(o.numpy() - np.asarray(jo)).max() <= 1e-5
    for window in ((-1, 0), (2, 3), (0, 0)):
        jm = jref.construct_local_mask(sq, sk, window, jnp.asarray(qpm), jnp.asarray(kpm),
                                       jnp.asarray(leftpad))
        tm = reference.construct_local_mask(sq, sk, window, _t(qpm), _t(kpm), _t(leftpad))
        assert np.array_equal(tm.numpy(), np.asarray(jm)), window


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rotary_single_matches_jax(interleaved):
    rng = np.random.default_rng(8)
    jcos, jsin = j_rotary_frequencies(16, 64)
    cos, sin = rotary_frequencies(16, 64)
    x3 = rng.standard_normal((2, 7, 24)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 7)).astype(np.int32)
    for x, p in ((x3, None), (x3, pos), (x3[0], None)):
        jo = j_apply_rotary_single(jnp.asarray(x), jcos, jsin,
                                   None if p is None else jnp.asarray(p), interleaved)
        o = apply_rotary_single(_t(x), cos, sin, None if p is None else _t(p), interleaved)
        assert o.shape == x.shape
        assert np.abs(o.numpy() - np.asarray(jo)).max() <= 1e-5
