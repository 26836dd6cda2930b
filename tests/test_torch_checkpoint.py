"""PyTorch port vs the JAX package: engine checkpoint / resume
(serve/checkpoint.py) and the allocator's snapshot.

The port's versions of the single-device cases of tests/test_checkpoint.py
(a resumed engine continues the exact token stream of the uninterrupted
run; pools byte-exact), and the file shared across packages: a checkpoint
the JAX engine wrote resumes in the port on the JAX engine's own stream,
and one the port wrote resumes in the JAX engine on the port's. Three JAX
engine runs, all bucketed (no chunked prefill in flight at the save).
"""

import dataclasses
import json

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
    load_engine as j_load_engine,
    save_engine as j_save_engine,
)
from xf_flash_attention_cutlass_tpu.serve.allocator import _PyPool as JPyPool
from xf_flash_attention_cutlass_tpu_torch.models import moe
from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
    params_from_jax,
    quantize_params,
)
from xf_flash_attention_cutlass_tpu_torch.serve import (
    DecodeEngine,
    EngineConfig,
    PagePool,
    load_engine,
    save_engine,
)

# the small model of tests/test_checkpoint.py
SMALL = dict(vocab_size=128, dim=64, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=128,
             max_seq_len=512)
REQUESTS = {1: ([3, 5, 7, 11, 13], 8), 2: (list(range(20, 40)), 6), 3: ([9] * 40, 5)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side of these tests is tiny: one intra-op thread keeps it
    from spinning against the other test workers' processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(quantized=False):
    p = init_params(torch.Generator().manual_seed(0), LlamaConfig(**SMALL))
    return quantize_params(p) if quantized else p


def _engine(params, cfg=None, temperature=0.0, requests=REQUESTS, dtype=torch.bfloat16, **kw):
    ecfg = EngineConfig(**dict(dict(max_batch=2, page_size=16, num_pages=64, max_seq=256,
                                    sample_seed=7), **kw))
    eng = DecodeEngine(params, cfg or LlamaConfig(**SMALL), ecfg, dtype=dtype, device="cpu")
    for rid, (prompt, n) in requests.items():
        eng.add_request(rid, prompt, n, temperature=temperature)
    return eng


def _pools_equal(a, b):
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
        for k in a)


def _resume(tmp_path, make, n_steps, include_params=False, load_kw=None):
    """(uninterrupted results, resumed results, the saved engine, the file)."""
    ref = make().run(max_steps=80)
    eng = make()
    for _ in range(n_steps):
        eng.step()
    path = str(tmp_path / "ckpt.npz")
    save_engine(eng, path, include_params=include_params)
    out = load_engine(path, device="cpu", **(load_kw or {})).run(max_steps=80)
    return ref, out, eng, path


# ---- the allocator ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "python"])
def test_pagepool_snapshot_roundtrip(backend):
    pool = PagePool(32, 16, 4, backend=backend)
    s0 = pool.admit(10, 33, 100)
    s1 = pool.admit(11, 5, 50)
    pool.extend(s0, 16)
    snap = pool.snapshot()
    pool.retire(s0)
    pool.admit(12, 64, 64)
    pool.restore(snap)
    bt, sl, n = pool.build_block_tables(8)
    assert n == 2 and sl[s0] == 49 and sl[s1] == 5
    free = pool.free_pages()
    pool.restore(snap)
    assert pool.free_pages() == free
    assert np.array_equal(pool.snapshot(), snap)
    with pytest.raises(ValueError):  # another geometry
        PagePool(16, 16, 4, backend=backend).restore(snap)


def test_pagepool_snapshot_words_match_jax():
    """The native words equal the JAX package's (the same library); the
    Python copy's equal the JAX package's Python allocator's."""
    from xf_flash_attention_cutlass_tpu.serve import PagePool as JPagePool

    pools = [PagePool(24, 8, 3), JPagePool(24, 8, 3), PagePool(24, 8, 3, backend="python"),
             JPyPool(24, 8, 3)]
    for p in pools:
        a = p.admit(1, 20, 40)
        p.admit(2, 9, 9)
        p.extend(a, 13)
        p.retire(a)
        p.admit(3, 30, 31)
    snaps = [p.snapshot() for p in pools]
    assert np.array_equal(snaps[0], snaps[1]) and np.array_equal(snaps[2], snaps[3])


# ---- the port's engine, saved and resumed -----------------------------------

@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_checkpoint_resume(tmp_path, kv_quant):
    params = _params()
    ref, out, eng, path = _resume(tmp_path, lambda: _engine(params, kv_quant=kv_quant), 3,
                                  load_kw=dict(params=params))
    assert out == ref
    eng3 = load_engine(path, params=params, device="cpu")
    assert dataclasses.asdict(eng3.ecfg) == dataclasses.asdict(eng.ecfg)
    assert _pools_equal(eng3.pools, eng.pools)  # byte-exact, never re-quantized
    assert np.array_equal(eng3.pool.snapshot(), eng.pool.snapshot())
    assert load_engine(path, params=params, ecfg=eng.ecfg, device="cpu") is not None


def test_engine_checkpoint_resume_sampled(tmp_path):
    """Seeded sampling survives: the step count is part of the state and
    the sampler keys on the seed, so the resumed stream is exact; the
    params come from the file."""
    params = _params()
    ref, out, _, _ = _resume(tmp_path, lambda: _engine(params, temperature=0.8, top_k=8), 4,
                             include_params=True)
    assert out == ref


def test_engine_checkpoint_resume_with_prefix(tmp_path):
    params = _params()

    def make():
        eng = _engine(params, requests={}, prefill_chunk=16)
        eng.register_prefix("sys", [(5 * i + 2) % 128 for i in range(40)])
        eng.add_request(1, [3, 5, 7], 6, prefix_id="sys")
        eng.add_request(2, [11, 13], 5, prefix_id="sys")
        return eng

    ref = make().run(max_steps=80)
    eng = make()
    for _ in range(5):
        eng.step()
    path = str(tmp_path / "ckpt.npz")
    save_engine(eng, path)
    with np.load(path) as z:  # the JAX layout of a prefix's pages
        state = json.loads(bytes(z["state"].tobytes()).decode())
    pages = eng._prefixes["sys"]["pages_by_replica"]
    assert len(pages) == 1 and state["prefixes"]["sys"]["pages_by_replica"] == pages
    eng2 = load_engine(path, params=params, device="cpu")
    assert eng2._prefixes == eng._prefixes and eng2._slot_prefix == eng._slot_prefix
    assert eng2.run(max_steps=80) == ref


def test_checkpoint_cfg_mismatch(tmp_path):
    params = _params()
    eng = _engine(params)
    eng.step()
    path = str(tmp_path / "ckpt.npz")
    save_engine(eng, path)
    with pytest.raises(ValueError):
        load_engine(path, params=params, ecfg=dataclasses.replace(eng.ecfg, num_pages=32),
                    device="cpu")
    with pytest.raises(ValueError):
        load_engine(path, params=params, cfg=dataclasses.replace(eng.cfg, ffn_dim=64),
                    device="cpu")
    with pytest.raises(ValueError):
        load_engine(path, device="cpu")  # no params saved, none passed
    with pytest.raises(NotImplementedError):
        load_engine(path, params=params, device="cpu", mesh=object())


def test_checkpoint_quantized_params_roundtrip(tmp_path):
    params = _params(quantized=True)
    ref, out, _, path = _resume(tmp_path, lambda: _engine(params, requests={1: REQUESTS[1]}),
                                3, include_params=True)
    assert out == ref
    loaded = load_engine(path, device="cpu").params
    assert isinstance(loaded["layers"]["wq"], tuple) and loaded["layers"]["wq"][1] is not None
    assert torch.equal(loaded["layers"]["w_down"][0], params["layers"]["w_down"][0])


def test_checkpoint_resume_packed_multi_step(tmp_path):
    """Quantized page 16 resolved to 32 (stored resolved), multi-step
    windows of 4 and sampling: the resumed stream is exact, and the caller's
    unresolved ecfg is accepted."""
    params = _params()
    kw = dict(kv_quant="int8", multi_step=4, top_k=8, sample_seed=11)
    requests = {1: ([3, 5, 7, 11, 13], 12), 2: (list(range(20, 33)), 12)}
    make = lambda: _engine(params, temperature=0.7, requests=requests, **kw)  # noqa: E731
    assert make().ecfg.page_size == 32
    ref, out, eng, _ = _resume(tmp_path, make, 2, load_kw=dict(
        params=params, ecfg=EngineConfig(max_batch=2, page_size=16, num_pages=64,
                                         max_seq=256, **kw)))
    assert out == ref


def test_checkpoint_resume_moe(tmp_path):
    """An MoE engine loads as MoEConfig, its params from the file."""
    cfg = moe.MoEConfig(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                        ffn_dim=96, max_seq_len=256, n_experts=4, top_k=2, capacity_factor=8.0)
    params = moe.init_moe_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32)
    requests = {0: ([(3 * i + 5) % 64 for i in range(13)], 6)}
    make = lambda: _engine(params, cfg, requests=requests, dtype=torch.float32,  # noqa: E731
                           num_pages=32, max_seq=128)
    ref, out, _, path = _resume(tmp_path, make, 3, include_params=True,
                                load_kw=dict(dtype=torch.float32))
    assert out == ref
    assert type(load_engine(path, dtype=torch.float32, device="cpu").cfg) is moe.MoEConfig


def test_checkpoint_refuses_an_old_file(tmp_path):
    """A file whose ecfg has no pack_small_pages (saved before the resolved
    page size was stored) is refused, not loaded under today's default."""
    params = _params()
    eng = _engine(params, kv_quant="int8")
    eng.step()
    path = str(tmp_path / "ckpt.npz")
    save_engine(eng, path)
    with np.load(path) as z:
        payload = dict(z)
    state = json.loads(bytes(payload["state"].tobytes()).decode())
    del state["ecfg"]["pack_small_pages"]
    payload["state"] = np.frombuffer(json.dumps(state).encode(), np.uint8)
    old = str(tmp_path / "old.npz")
    np.savez(old, **payload)
    with pytest.raises(ValueError, match="pack_small_pages"):
        load_engine(old, params=params, device="cpu")


# ---- across packages -------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(jax.random.PRNGKey(0), JLlamaConfig(**SMALL), dtype=jnp.float32)


def _jax_engine(jp, **kw):
    ecfg = JEngineConfig(max_batch=2, page_size=16, num_pages=64, max_seq=256, **kw)
    eng = JDecodeEngine(jp, JLlamaConfig(**SMALL), ecfg, dtype=jnp.bfloat16)
    for rid, (prompt, n) in REQUESTS.items():
        eng.add_request(rid, prompt, n)
    return eng


@pytest.mark.parametrize("kv", [dict(), dict(kv_quant="int8", pack_small_pages=False)],
                         ids=["bf16", "int8_page16"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, jax_params, kv):
    """A checkpoint the JAX engine wrote after 3 steps (one request still
    queued) loads in the port, padded int8 page-16 pools cropped to the
    tight layout, and continues with the JAX engine's own stream."""
    jeng = _jax_engine(jax_params, **kv)
    for _ in range(3):
        jeng.step()
    path = str(tmp_path / "jax.npz")
    j_save_engine(jeng, path)
    step_count = jeng._step_count
    want = {rid: [int(t) for t in toks] for rid, toks in jeng.run(max_steps=80).items()}
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    eng = load_engine(path, params=params, device="cpu")
    if kv:
        assert eng.pools["k"].shape[-2] == 16 and eng.pools["k_s"].shape[-1] == 16
    assert len(eng.queue) == 1 and eng._step_count == step_count
    got = eng.run(max_steps=80)
    assert got == want


def test_port_checkpoint_resumes_in_jax(tmp_path, jax_params):
    """A checkpoint the port wrote (bf16 pools, f32 params) loads in the JAX
    load_engine and continues with the port's stream."""
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))
    eng = _engine(params, sample_seed=0)
    for _ in range(3):
        eng.step()
    path = str(tmp_path / "port.npz")
    save_engine(eng, path)
    want = eng.run(max_steps=80)
    jeng = j_load_engine(path, params=jax_params)
    assert np.array_equal(np.asarray(jeng._sample_base), np.asarray(jax.random.PRNGKey(0)))
    got = {rid: [int(t) for t in toks] for rid, toks in jeng.run(max_steps=80).items()}
    assert got == want
