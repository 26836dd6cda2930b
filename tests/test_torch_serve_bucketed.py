"""PyTorch port vs the JAX package: the DecodeEngine with bucketed prefill
(``prefill_chunk=None``, the default): each admitted prompt is padded to a
power-of-two bucket and prefilled whole through dense flash attention
(``serve/engine.py::prefill_core``).

The JAX engine runs as its own tests run it (CPU, Pallas interpret mode);
the port's engine runs its plain PyTorch versions on CPU tensors. Both get
the same weights (the JAX params converted bit for bit) and the same
requests, and must assign the same pages and emit token-identical greedy
streams. Kept in a file of its own so that the test workers give its JAX
engine runs (two) a worker of their own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
)
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
)
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.serve.engine import DecodeEngine, EngineConfig


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


def _port_params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _prompt(n, a, c):
    return [(a * i + c) % TINY["vocab_size"] for i in range(n)]


@pytest.mark.parametrize(
    "kw,prompts",
    [
        # f32 pools at page 16: prompts of 32, 45 and 90 tokens end in the
        # buckets 32 (exactly), 64 and 128
        (dict(max_batch=3, page_size=16, num_pages=32, max_seq=256),
         {0: _prompt(32, 7, 3), 1: _prompt(45, 5, 1), 2: _prompt(90, 3, 2)}),
        # fp8 pools at page 256: one page per prompt, buckets 32 and 128
        (dict(max_batch=2, page_size=256, num_pages=4, max_seq=512, kv_quant="fp8_e4m3"),
         {0: _prompt(20, 11, 4), 1: _prompt(70, 13, 5)}),
    ],
    ids=["f32_page16", "fp8_page256"],
)
def test_bucketed_prefill_token_identical_to_jax(jax_params, kw, prompts):
    n_new = 4
    jeng = JDecodeEngine(jax_params, JLlamaConfig(**TINY), JEngineConfig(**kw),
                         dtype=jnp.float32)
    teng = DecodeEngine(_port_params(jax_params), LlamaConfig(**TINY), EngineConfig(**kw),
                        dtype=torch.float32, device="cpu")
    assert dataclasses.asdict(teng.ecfg) == dataclasses.asdict(jeng.ecfg)
    for eng in (jeng, teng):
        for rid, p in prompts.items():
            eng.add_request(rid, p, n_new)
    # the first step admits and prefills every prompt: the same pages
    jeng.step()
    teng.step()
    mp = teng.ecfg.max_pages_per_seq
    for got, want in zip(teng.pool.build_block_tables(mp), jeng.pool.build_block_tables(mp)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert sorted(teng.active) == sorted(jeng.active)
    assert sorted(teng.first_token_at) == sorted(prompts)  # every first token read back
    assert teng._bucket(32) == jeng._bucket(32) == 32
    assert [teng._bucket(len(p)) for p in prompts.values()] == \
        [jeng._bucket(len(p)) for p in prompts.values()]
    jout, tout = jeng.run(), teng.run()
    for rid in prompts:
        assert len(tout[rid]) == n_new
        assert list(tout[rid]) == list(jout[rid]), rid
    assert teng.stats == jeng.stats
    assert teng.pool.free_pages() == kw["num_pages"]


def test_default_prefill_with_quantized_page256_pools_serves(jax_params):
    """prefill_chunk=None with fp8 pools at page 256 builds (the quantized
    chunk guard reads prefill_chunk only when it is set, as the JAX engine's
    does) and serves."""
    ecfg = EngineConfig(kv_quant="fp8_e4m3", page_size=256, prefill_chunk=None)
    eng = DecodeEngine(_port_params(jax_params), LlamaConfig(**TINY), ecfg,
                       dtype=torch.float32, device="cpu")
    assert eng.pools["k"].dtype == torch.float8_e4m3fn
    eng.add_request(0, [5, 9, 2, 33, 8], 3)
    out = eng.run()
    assert len(out[0]) == 3 and all(0 <= t < TINY["vocab_size"] for t in out[0])
    assert eng.stats["requests_finished"] == 1 and eng.stats["prefill_chunks"] == 0
