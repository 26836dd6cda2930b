"""PyTorch port vs the JAX package: page allocator and the DecodeEngine.

The JAX engine runs as its own tests run it (CPU, Pallas interpret mode);
the port's engine runs its plain PyTorch versions on CPU tensors. Both get
the same weights (the JAX params converted bit for bit) and the same
requests, and must emit token-identical greedy streams.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.serve.allocator import PagePool
from xf_flash_attention_cutlass_tpu_torch.serve.engine import (
    DecodeEngine,
    EngineConfig,
    effective_engine_config,
    sample_tokens,
)

# the tiny model of tests/test_serve.py
TINY = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=512)


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), JLlamaConfig(**TINY), dtype=jnp.float32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _run_both(jparams, ecfg_kw, prompts, n_new):
    """Serve the same requests on both engines; returns (jax, port) engines
    and their results."""
    jeng = JDecodeEngine(jparams, JLlamaConfig(**TINY), JEngineConfig(**ecfg_kw),
                         dtype=jnp.float32)
    teng = DecodeEngine(params_from_jax(_numpy_tree(jparams)), LlamaConfig(**TINY),
                        EngineConfig(**ecfg_kw), dtype=torch.float32, device="cpu")
    for eng in (jeng, teng):
        for rid, p in prompts.items():
            eng.add_request(rid, p, n_new)
    jout, tout = jeng.run(), teng.run()
    return jeng, teng, jout, tout


# ---- allocator ------------------------------------------------------------

def _drive(pool):
    """One admit / extend / truncate / retire sequence; returns the block
    tables, lengths and free-page counts it passed through."""
    seen = []

    def snap():
        bt, sl, n = pool.build_block_tables(6)
        seen.append((bt.tolist(), sl.tolist(), int(n), pool.free_pages()))

    a = pool.admit(10, 9, 20)
    b = pool.admit(11, 3, 8)
    snap()
    pool.extend(a, 4)
    pool.extend(b, 6)
    snap()
    pool.truncate(a, 5)
    snap()
    pool.retire(b)
    c = pool.admit(12, 17, 30)
    assert pool.admit(13, 40, 50) == -1  # out of pages
    snap()
    pool.extend(c, 30)  # OOM: unchanged
    pool.retire(a)
    pool.extend(c, 2)
    snap()
    return seen


def test_allocator_same_pages_as_jax():
    want = _drive(JPagePool(num_pages=9, page_size=4, max_requests=3))
    native = PagePool(num_pages=9, page_size=4, max_requests=3)  # raises if g++ fails
    assert native.native
    assert _drive(native) == want


def test_allocator_python_copy_same_pages():
    pool = PagePool(num_pages=9, page_size=4, max_requests=3, backend="python")
    assert not pool.native
    want = _drive(JPagePool(num_pages=9, page_size=4, max_requests=3))
    assert _drive(pool) == want


# ---- engine ---------------------------------------------------------------

def test_engine_f32_chunked_prefill_preemption_token_identical(jax_params):
    """f32 KV, chunk 32 / page 16: a 33-token prompt takes two chunks, and
    with 4 pages the second request is preempted on its first page growth
    and resumes through prefill."""
    prompts = {
        0: [(7 * i + 3) % 97 for i in range(33)],
        1: [(5 * i + 1) % 97 for i in range(16)],
    }
    kw = dict(max_batch=2, page_size=16, num_pages=4, max_seq=256, prefill_chunk=32)
    jeng, teng, jout, tout = _run_both(jax_params, kw, prompts, 5)
    assert jeng.stats["preemptions"] > 0
    for rid in prompts:
        assert len(tout[rid]) == 5
        assert list(tout[rid]) == list(jout[rid]), rid
    assert teng.stats == jeng.stats
    assert teng.pool.free_pages() == kw["num_pages"]


@pytest.mark.parametrize("kv_quant,int8_weights", [("int8", True), ("fp8_e4m3", False)])
def test_engine_quantized_kv_token_identical(jax_params, kv_quant, int8_weights):
    """int8 KV with int8 weights, and fp8 KV: page 16 is served as page 32
    (effective_engine_config) by both engines; a 40-token prompt takes two
    32-token chunks."""
    params = j_quantize_params(jax_params) if int8_weights else jax_params
    prompts = {
        0: [(3 * i + 2) % 97 for i in range(40)],
        1: [5, 9, 2, 33, 8, 1, 60, 4, 17],
    }
    kw = dict(max_batch=2, page_size=16, num_pages=16, max_seq=256, prefill_chunk=32,
              kv_quant=kv_quant)
    jeng, teng, jout, tout = _run_both(params, kw, prompts, 5)
    assert teng.ecfg.page_size == 32
    assert dataclasses.asdict(teng.ecfg) == dataclasses.asdict(jeng.ecfg)
    assert teng.pools["k"].dtype == (torch.int8 if kv_quant == "int8" else torch.float8_e4m3fn)
    for rid in prompts:
        assert len(tout[rid]) == 5
        assert list(tout[rid]) == list(jout[rid]), rid
    assert teng.stats == jeng.stats


def test_effective_engine_config_matches_jax():
    from xf_flash_attention_cutlass_tpu.serve.engine import (
        effective_engine_config as j_effective,
    )

    for kw in (dict(kv_quant="int8", page_size=16, num_pages=64),
               dict(kv_quant="fp8_e4m3", page_size=8, num_pages=64),
               dict(kv_quant=None, page_size=16, num_pages=64),
               dict(kv_quant="int8", page_size=16, num_pages=64, pack_small_pages=False)):
        got = effective_engine_config(EngineConfig(**kw))
        want = j_effective(JEngineConfig(**kw))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        effective_engine_config(EngineConfig(kv_quant="int8", page_size=16, num_pages=63))


def test_engine_rejects_what_the_slice_does_not_serve(jax_params):
    params = params_from_jax(_numpy_tree(jax_params))
    cfg = LlamaConfig(**TINY)
    base = dict(max_batch=2, page_size=16, num_pages=16, max_seq=256, prefill_chunk=32)
    for extra in (dict(prefill_chunk=None), dict(speculate_k=2), dict(multi_step=2),
                  dict(top_k=5), dict(top_p=0.9)):
        with pytest.raises(NotImplementedError):
            DecodeEngine(params, cfg, EngineConfig(**{**base, **extra}), device="cpu")
    with pytest.raises(NotImplementedError):
        DecodeEngine(params, cfg, EngineConfig(**base), device="cpu", mesh=object())
    moe = dict(params, layers=dict(params["layers"], router=torch.zeros(2, 64, 4)))
    with pytest.raises(NotImplementedError):
        DecodeEngine(moe, cfg, EngineConfig(**base), device="cpu")
    eng = DecodeEngine(params, cfg, EngineConfig(**base), device="cpu")
    with pytest.raises(NotImplementedError):
        eng.add_request(0, [1, 2], 3, temperature=0.7)
    with pytest.raises(NotImplementedError):
        eng.add_request(0, [1, 2], 3, prefix_id="sys")
    with pytest.raises(NotImplementedError):
        eng.register_prefix("sys", [1, 2, 3])
    # the JAX engine's prefill_chunk % 128 rule for quantized page-256 pools
    with pytest.raises(ValueError):
        DecodeEngine(params, cfg, EngineConfig(**{**base, "page_size": 256,
                                                  "kv_quant": "fp8_e4m3"}), device="cpu")


def test_engine_without_cuda_raises_unless_cpu(jax_params):
    params = params_from_jax(_numpy_tree(jax_params))
    ecfg = EngineConfig(max_batch=2, page_size=16, num_pages=16, max_seq=256, prefill_chunk=32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(params, LlamaConfig(**TINY), ecfg)


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py needs a card: without one it exits non-zero and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_sample_tokens_greedy_first_index_on_ties():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0], [5.0, 0.0, 0.0, 5.0]])
    assert sample_tokens(logits).tolist() == [1, 0]


def test_params_from_jax_bit_exact_views():
    tree = {
        "bf16": jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16),
        "fp8": jnp.asarray([0.5, -448.0, 1e-3], jnp.float8_e4m3fn),
        "pair": (jnp.asarray([[1, -2]], jnp.int8), jnp.asarray([0.5], jnp.float32)),
    }
    got = params_from_jax(_numpy_tree(tree))
    assert got["bf16"].dtype == torch.bfloat16
    assert got["bf16"].view(torch.int16).numpy().tolist() == np.asarray(
        tree["bf16"]).view(np.int16).tolist()
    assert got["fp8"].dtype == torch.float8_e4m3fn
    assert got["fp8"].view(torch.uint8).numpy().tolist() == np.asarray(
        tree["fp8"]).view(np.uint8).tolist()
    assert isinstance(got["pair"], tuple) and got["pair"][0].dtype == torch.int8
