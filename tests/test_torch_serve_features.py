"""PyTorch port vs the JAX package: the engine's serving features beyond
greedy per-step decoding — multi-step windows, device-side sampling,
speculative verify and shared prefixes — and the allocator's prefix pages.

Two JAX engine runs: (a) multi_step windows with chunked prefill, an EOS
inside a window and preemption; (b) speculative verify with two prefill
lanes and a registered prefix. Both must give the JAX engine's tokens and
counters. Sampling is compared with the JAX sample_tokens by distribution
(the JAX package draws from threefry keys, the port from Philox counters);
the rest holds the port to itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
    quantize_params as j_quantize_params,
)
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
    PagePool as JPagePool,
)
from xf_flash_attention_cutlass_tpu.serve.engine import sample_tokens as j_sample_tokens
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, EngineConfig, PagePool
from xf_flash_attention_cutlass_tpu_torch.serve.engine import (
    draft_prompt_lookup,
    gumbel_noise,
    sample_tokens,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the tiny model of tests/test_serve.py
TINY = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=512)


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), JLlamaConfig(**TINY), dtype=jnp.float32)


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _engine(params, **kw):
    return DecodeEngine(params, LlamaConfig(**TINY), EngineConfig(**kw), dtype=torch.float32,
                        device="cpu")


def _serve(eng, requests):
    """requests: {rid: (prompt, max_new, temperature, prefix_id)}."""
    for rid, (prompt, n, temp, pid) in requests.items():
        eng.add_request(rid, prompt, n, temperature=temp, prefix_id=pid)
    return {rid: list(toks) for rid, toks in eng.run().items()}


# ---- (a) multi-step windows against the JAX engine ------------------------

def test_multi_step_chunked_eos_preemption_matches_jax(jax_params, params):
    """multi_step = 4 with 32-token chunks: budgets of 30, 13 and 22 tokens,
    an EOS (token 52) that ends request 1 inside a window, and 6 pages for
    three requests, so windows' pre-extension preempts. Tokens and counters
    equal the JAX engine's; the streams equal the port's per-step run."""
    rng = np.random.default_rng(9)
    prompts = {rid: [int(t) for t in rng.integers(0, 97, 17 + 11 * rid)] for rid in range(3)}
    budgets = {0: 30, 1: 13, 2: 22}
    requests = {rid: (prompts[rid], budgets[rid], 0.0, None) for rid in prompts}
    kw = dict(max_batch=3, page_size=16, num_pages=6, max_seq=256, prefill_chunk=32,
              multi_step=4, eos_token=52)
    teng = _engine(params, **kw)
    tout = _serve(teng, requests)
    jeng = JDecodeEngine(jax_params, JLlamaConfig(**TINY), JEngineConfig(**kw),
                         dtype=jnp.float32)
    jout = {rid: [int(t) for t in toks] for rid, toks in _serve(jeng, requests).items()}
    assert tout == jout
    assert teng.stats == jeng.stats
    assert teng.stats["preemptions"] > 0
    assert teng.stats["decode_steps"] > teng.stats["steps"]  # windows ran
    assert len(tout[1]) < budgets[1] and tout[1][-1] == 52  # the EOS, inside a window
    assert teng.pool.free_pages() == kw["num_pages"]
    per_step = _serve(_engine(params, **dict(kw, multi_step=1, num_pages=64)), requests)
    assert tout == per_step


# ---- (b) speculative verify with lanes and a prefix against the JAX engine --

def test_speculative_lanes_prefix_int8_matches_jax(jax_params):
    """speculate_k = 3, two prefill lanes and a 40-token registered prefix
    (one shared 32-token page and an 8-token remainder) over int8 KV with
    int8 weights (page 16 served as page 32): the case of the JAX package's
    test_engine_prefill_lanes_with_prefix_and_spec. Tokens and counters
    equal the JAX engine's; the prefix's page returns on release."""
    jp = j_quantize_params(jax_params)
    kw = dict(max_batch=4, page_size=16, num_pages=128, max_seq=256, prefill_chunk=32,
              prefill_lanes=2, speculate_k=3, kv_quant="int8")
    prefix = [(3 * i + 1) % 97 for i in range(40)]
    requests = {0: ([5, 9, 2, 44], 5, 0.0, "sys"),
                1: ([(5 * i + 2) % 97 for i in range(21)], 5, 0.0, "sys"),
                2: ([7, 7, 7], 5, 0.0, None)}
    teng = DecodeEngine(params_from_jax(jax.tree_util.tree_map(np.asarray, jp)),
                        LlamaConfig(**TINY), EngineConfig(**kw), dtype=torch.float32,
                        device="cpu")
    jeng = JDecodeEngine(jp, JLlamaConfig(**TINY), JEngineConfig(**kw), dtype=jnp.float32)
    outs = {}
    for name, eng in (("port", teng), ("jax", jeng)):
        eng.register_prefix("sys", prefix)
        outs[name] = {rid: [int(t) for t in toks] for rid, toks in _serve(eng, requests).items()}
    assert outs["port"] == outs["jax"]
    assert teng.stats == jeng.stats
    assert teng.stats["spec_steps"] > 0 and teng.stats["drafts_accepted"] > 0
    assert teng._prefixes["sys"]["n_pages"] == 1
    teng.release_prefix("sys")
    assert teng.pool.free_pages() == teng.ecfg.num_pages


# ---- sampling against the JAX sample_tokens, by distribution --------------

def _truncated_softmax(logits, t, top_k, top_p):
    """The exact distribution sample_tokens draws from, in float64."""
    s = logits.astype(np.float64) / max(t, 1e-6)
    order = np.argsort(-s, kind="stable")
    keep = np.ones_like(s, bool)
    if top_k:
        keep[order[top_k:]] = False
    if top_p:
        idx = order[:top_k] if top_k else order
        p = np.exp(s[idx] - s[idx].max())
        p /= p.sum()
        drop = (np.cumsum(p) - p) >= top_p
        keep[idx[drop]] = False
    p = np.where(keep, np.exp(s - s.max()), 0.0)
    return p / p.sum()


def _chi_square_p(draws, probs):
    """The chi-square test's p-value of the draws against probs, the
    categories of expected count < 5 pooled (smallest first)."""
    n = len(draws)
    obs = np.bincount(draws, minlength=len(probs)).astype(float)
    live = np.flatnonzero(probs > 0)
    live = live[np.argsort(probs[live])]
    exp_, o = probs[live] * n, obs[live]
    k = int(np.searchsorted(np.cumsum(exp_), 5.0)) + 1 if exp_[0] < 5 else 0
    if k:  # the smallest categories, pooled until they expect 5 draws
        exp_ = np.concatenate([[exp_[:k].sum()], exp_[k:]])
        o = np.concatenate([[o[:k].sum()], o[k:]])
    return scipy.stats.chisquare(o, exp_).pvalue if len(o) > 1 else 1.0


SAMPLING_MODES = [  # (top_k, top_p, approx_top_k)
    (0, 0.0, True),  # temperature only
    (5, 0.0, True),
    (0, 0.8, True),  # the 128-candidate prefix
    (0, 0.8, False),  # the full-vocabulary sort
    (5, 0.8, False),
]


@pytest.mark.parametrize("top_k,top_p,approx", SAMPLING_MODES)
def test_sample_tokens_distribution_matches_jax(top_k, top_p, approx):
    """2 rows of V = 32 logits at temperatures 0.7 and 1.3, 2000 draws a
    row on each side from one call: the JAX function with the rows tiled
    under one key, the port with step counters 0..1999. Each side's
    frequencies pass a chi-square test against the exact truncated softmax
    (p >= 1e-4), and no draw falls outside the truncated set."""
    n, temps = 2000, np.array([0.7, 1.3], np.float32)
    logits = np.random.default_rng(3).normal(0.0, 1.0, (2, 32)).astype(np.float32)
    tiled, t_tiled = np.tile(logits, (n, 1)), np.tile(temps, n)
    j = np.asarray(j_sample_tokens(jnp.asarray(tiled), jnp.asarray(t_tiled),
                                   jax.random.PRNGKey(11), top_k=top_k, top_p=top_p,
                                   approx_top_k=approx)).reshape(n, 2)
    steps = torch.arange(n).repeat_interleave(2)
    t = sample_tokens(torch.from_numpy(tiled), torch.from_numpy(t_tiled), steps, seed=11,
                      top_k=top_k, top_p=top_p, approx_top_k=approx).numpy().reshape(n, 2)
    for row in range(2):
        probs = _truncated_softmax(logits[row], float(temps[row]), top_k, top_p)
        for side, draws in (("jax", j[:, row]), ("port", t[:, row])):
            assert probs[draws].min() > 0, (side, row)
            assert _chi_square_p(draws, probs) >= 1e-4, (side, row)


def test_sample_tokens_greedy_rows_and_degenerate_truncation():
    """Rows at temperature <= 0 take the argmax; top_k = 1 and a tiny top_p
    leave only the top token at any temperature."""
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.0], [5.0, 0.0, 0.0, 0.0]])
    assert sample_tokens(logits, torch.tensor([0.0, -1.0]), 3, top_k=2).tolist() == [1, 0]
    hot = torch.tensor([5.0, 5.0])
    assert sample_tokens(logits, hot, 3, top_k=1).tolist() == [1, 0]
    for approx in (True, False):
        assert sample_tokens(logits, hot, 3, top_p=1e-6, approx_top_k=approx).tolist() == [1, 0]


def test_gumbel_noise_depends_on_its_counter_only():
    """Noise of (column, row, step, lane) under a seed: a per-row step gives
    each row the draw it has alone at that step, and the lane, the step and
    the seed each change it."""
    per_row = gumbel_noise(3, 8, torch.tensor([4, 9, 4]), 0, 5, "cpu")
    for r, s in enumerate((4, 9, 4)):
        assert torch.equal(per_row[r], gumbel_noise(3, 8, s, 0, 5, "cpu")[r])
    base = gumbel_noise(3, 8, 4, 0, 5, "cpu")
    for other in (gumbel_noise(3, 8, 4, 1, 5, "cpu"), gumbel_noise(3, 8, 5, 0, 5, "cpu"),
                  gumbel_noise(3, 8, 4, 0, 6, "cpu")):
        assert not torch.equal(base, other)
    assert torch.isfinite(base).all()


# ---- the port's features against themselves -------------------------------

def test_multi_step_sampled_matches_per_step_fp8(params):
    """Sampled requests (top_k = 8, temperature 1.3) beside a greedy one
    over fp8 KV: a window of 4 gives the per-step tokens (the sampling
    counter's step is the engine step, in windows as per step)."""
    requests = {0: ([3, 17, 42, 9], 10, 1.3, None), 1: ([5, 9, 2, 33, 8, 1, 60], 7, 1.3, None),
                2: ([11, 4, 4, 80], 9, 0.0, None)}
    kw = dict(max_batch=3, page_size=16, num_pages=64, max_seq=256, top_k=8, sample_seed=5,
              kv_quant="fp8_e4m3")
    outs = {K: _serve(_engine(params, **kw, multi_step=K), requests) for K in (1, 4)}
    assert outs[1] == outs[4]
    assert [len(outs[4][r]) for r in requests] == [10, 7, 9]


def test_sampled_runs_reproducible_and_greedy_rows_unaffected(params):
    """Two runs of one seed give the same sampled tokens, another seed
    others; a greedy request's stream is the same beside a sampled
    neighbour as beside a greedy one."""
    kw = dict(max_batch=2, page_size=16, num_pages=64, max_seq=256, top_k=8, top_p=0.9,
              prefill_chunk=16)
    sampled = {0: ([3, 17, 42, 9], 8, 0.0, None), 1: ([5, 9, 2, 33, 8], 8, 1.3, None)}
    a = _serve(_engine(params, **kw, sample_seed=1), sampled)
    b = _serve(_engine(params, **kw, sample_seed=1), sampled)
    c = _serve(_engine(params, **kw, sample_seed=2), sampled)
    assert a == b
    assert a[1] != c[1]
    greedy = _serve(_engine(params, **kw, sample_seed=1),
                    {0: sampled[0], 1: (sampled[1][0], 8, 0.0, None)})
    assert a[0] == greedy[0] == c[0]
    assert a[1] != greedy[1]


def test_speculative_matches_per_step_greedy(params):
    """speculate_k = 4 over f32 KV with bucketed prefill, prompts with
    repeated n-grams: the per-step greedy tokens, drafts accepted, every
    rejected draft's page returned."""
    rep = [5, 9, 2, 44, 5, 9, 2, 44, 5, 9, 2]
    requests = {0: (rep, 12, 0.0, None), 1: ([7, 7, 7, 7, 7], 9, 0.0, None)}
    kw = dict(max_batch=2, page_size=16, num_pages=64, max_seq=256)
    eng = _engine(params, **kw, speculate_k=4)
    assert _serve(eng, requests) == _serve(_engine(params, **kw), requests)
    assert eng.stats["spec_steps"] > 0 and eng.stats["drafts_accepted"] > 0
    assert eng.pool.free_pages() == kw["num_pages"]


def test_draft_prompt_lookup_matches_jax():
    from xf_flash_attention_cutlass_tpu.serve.engine import draft_prompt_lookup as j_draft

    rng = np.random.default_rng(4)
    for _ in range(50):
        ctx = [int(t) for t in rng.integers(0, 4, int(rng.integers(1, 20)))]
        for n, g in ((0, 3), (2, 3), (3, 2), (4, 1)):
            assert draft_prompt_lookup(ctx, n, g) == j_draft(ctx, n, g)


def test_prefix_release_while_in_use_raises(params):
    """A prefix read by a live request cannot be released; after the
    request retires it can, and its pages return to the pool."""
    eng = _engine(params, max_batch=2, page_size=16, num_pages=32, max_seq=256,
                  prefill_chunk=16)
    eng.register_prefix("sys", list(range(1, 40)))  # two shared pages, 7 tokens left
    assert eng.pool.free_pages() == 30
    eng.add_request(0, [5, 6, 7], 4, prefix_id="sys")
    eng.step()
    assert eng._slot_prefix
    with pytest.raises(RuntimeError, match="in use"):
        eng.release_prefix("sys")
    eng.run()
    eng.release_prefix("sys")
    assert eng.pool.free_pages() == 32
    with pytest.raises(KeyError):
        eng.add_request(1, [1], 2, prefix_id="sys")


def _drive_prefix(pool):
    """Prefix pages, prefixed admission, growth, rollback and release; the
    block tables, lengths, shared pages and free pages it passed through."""
    seen = []

    def snap(*slots):
        bt, sl, n = pool.build_block_tables(8)
        seen.append((bt.tolist(), sl.tolist(), int(n), pool.free_pages(),
                     [pool.shared_pages(s) for s in slots]))

    pages = pool.prefix_alloc(2)
    seen.append(list(pages))
    assert pool.prefix_alloc(40) is None
    a = pool.admit_prefixed(10, 2, 11, 20)
    b = pool.admit(11, 3, 8)
    assert pool.admit_prefixed(12, 2, 7, 9) == -1  # the prompt must cover the prefix
    snap(a, b)
    pool.extend(a, 6)
    snap(a, b)
    assert pool.truncate(a, 7) == -1  # not below the shared region
    pool.truncate(a, 13)
    snap(a, b)
    pool.retire(a)
    snap(a, b)
    pool.prefix_free(pages)
    c = pool.admit_prefixed(13, 0, 5, 9)
    snap(b, c)
    return seen


def test_allocator_prefix_pages_native_python_and_jax_agree():
    want = _drive_prefix(JPagePool(num_pages=12, page_size=4, max_requests=3))
    native = PagePool(num_pages=12, page_size=4, max_requests=3)
    assert native.native
    assert _drive_prefix(native) == want
    assert _drive_prefix(PagePool(num_pages=12, page_size=4, max_requests=3,
                                  backend="python")) == want
