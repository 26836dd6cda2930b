"""PyTorch port vs the JAX package: DecodeEngine on a dp x tp mesh.

The port's mesh engines run in four gloo rank processes started once for
the file (tests/mesh_ranks.py); every rank runs the same requests and must
emit the same streams. Three JAX engine runs on the mesh of the same shape
(tp = 2 with an int8 cache; dp = 2 x tp = 2; tp = 2 serving the MoE
family) are held to the port's mesh engine stream for stream; the other
features are held to the port's own single-device engine, run here. The
models are f32 and tiny (the JAX package's tests/test_parallel.py), so the
streams must be token-identical: greedy ones, and sampled ones where the
batch rows match (dp = 1; the sampler's noise is keyed by the batch row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_ranks
from xf_flash_attention_cutlass_tpu.models import moe as jmoe
from xf_flash_attention_cutlass_tpu.models.llama import (
    LlamaConfig as JLlamaConfig,
    init_params as j_init_params,
)
from xf_flash_attention_cutlass_tpu.parallel import make_mesh as j_make_mesh
from xf_flash_attention_cutlass_tpu.serve import (
    DecodeEngine as JDecodeEngine,
    EngineConfig as JEngineConfig,
)
from xf_flash_attention_cutlass_tpu_torch.models.llama import (
    LlamaConfig,
    params_from_jax,
    quantize_params,
)
from xf_flash_attention_cutlass_tpu_torch.models.moe import MoEConfig, quantize_moe_params
from xf_flash_attention_cutlass_tpu_torch.serve import DecodeEngine, EngineConfig

TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=96,
            max_seq_len=256)
TINY_MOE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128,
                max_seq_len=512, n_experts=4, top_k=2, capacity_factor=8.0)
BASE = dict(max_batch=4, page_size=16, num_pages=64, max_seq=256, prefill_chunk=32,
            prefill_lanes=2)


def _ramp(n, a, b, v=64):
    return [(a * i + b) % v for i in range(n)]


PROMPTS = {0: _ramp(41, 7, 3), 1: [5, 9, 2], 2: _ramp(17, 3, 11), 3: [8, 1, 13, 21, 34]}


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


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def llama():
    jcfg = JLlamaConfig(**TINY)
    jp = j_init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, LlamaConfig(**TINY), params_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def moe():
    jcfg = jmoe.MoEConfig(**TINY_MOE)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, jp, MoEConfig(**TINY_MOE), params_from_jax(_np_tree(jp))


def _requests(prompts, max_new=5, temperature=0.0):
    return {rid: (p, max_new[rid] if isinstance(max_new, dict) else max_new, temperature)
            for rid, p in prompts.items()}


def _mesh_serve(ranks, params, cfg, ecfg, requests, prefix=None, **axes):
    """The mesh engine's (results, stats, prefix pages held, free pages
    after the release); every rank's results must be the same."""
    outs = ranks.run(mesh_ranks.serve, params, cfg, ecfg, requests, prefix, **axes)
    for out in outs[1:]:
        assert out[0] == outs[0][0]
    return outs[0]


def _single(params, cfg, ecfg, requests, prefix=None):
    eng = DecodeEngine(params, cfg, ecfg, dtype=torch.float32, device="cpu")
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    for rid, (prompt, max_new, temp) in requests.items():
        eng.add_request(rid, prompt, max_new, temperature=temp,
                        prefix_id="sys" if prefix is not None else None)
    return eng.run(max_steps=400), dict(eng.stats)


# ---- against the JAX mesh engine (three JAX engine runs) --------------------

CASES = {  # name: (model, axes, engine config, prompts)
    "tp2_int8": ("llama", dict(tp=2), dict(BASE, kv_quant="int8"),
                 {k: PROMPTS[k] for k in (0, 1, 2)}),
    "dp2_tp2": ("llama", dict(dp=2, tp=2), BASE, PROMPTS),
    "tp2_moe": ("moe", dict(tp=2), dict(BASE, max_batch=2),
                {0: _ramp(21, 7, 3, 96), 1: [5, 9, 2]}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_matches_jax(ranks, llama, moe, case):
    """The port's mesh engine and the JAX mesh engine of the same shape
    emit the same greedy streams (and so does the port's single-device
    engine)."""
    kind, axes, ecfg_kw, prompts = CASES[case]
    jcfg, jp, cfg, params = llama if kind == "llama" else moe
    jmesh = j_make_mesh(**axes, devices=jax.devices("cpu")[: 2 * axes.get("dp", 1)])
    jeng = JDecodeEngine(jp, jcfg, JEngineConfig(**ecfg_kw), dtype=jnp.float32, mesh=jmesh)
    for rid, p in prompts.items():
        jeng.add_request(rid, p, 5)
    want = {rid: [int(t) for t in toks] for rid, toks in jeng.run().items()}
    requests = _requests(prompts)
    got, stats, _, _ = _mesh_serve(ranks, params, cfg, EngineConfig(**ecfg_kw), requests, **axes)
    assert got == want
    assert stats["requests_finished"] == len(prompts)
    assert _single(params, cfg, EngineConfig(**ecfg_kw), requests)[0] == want


# ---- against the port's single-device engine --------------------------------

@pytest.mark.parametrize("axes,quant", [(dict(tp=2), None), (dict(dp=2, tp=2), "int8")])
def test_mesh_speculative_matches_single_device(ranks, llama, axes, quant):
    """Speculative verify (speculate_k = 3) on the mesh emits the
    single-device engine's streams and accepts the same drafts."""
    _, _, cfg, params = llama
    ecfg = EngineConfig(**dict(BASE, speculate_k=3, kv_quant=quant))
    requests = _requests({0: _ramp(23, 5, 2), 1: [7, 7, 7, 9]}, max_new=6)
    got, stats, _, _ = _mesh_serve(ranks, params, cfg, ecfg, requests, **axes)
    want, want_stats = _single(params, cfg, ecfg, requests)
    assert got == want
    assert stats["spec_steps"] > 0 and stats["drafts_accepted"] == want_stats["drafts_accepted"]


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_mesh_multi_step_matches_per_step(ranks, llama, dp, temperature):
    """Windows of 4 decode steps on a dp x tp=2 mesh emit the per-step mesh
    engine's streams, greedy and sampled (top-k 8), a request finishing
    mid-window; at dp = 1 also the single-device engine's, whose batch
    rows, and so whose sampling noise, are the same."""
    _, _, cfg, params = llama
    max_new = {0: 9, 1: 6}
    requests = _requests({0: [3, 17, 42, 9], 1: [5, 9, 2, 33, 8, 1, 60]}, max_new, temperature)
    runs = {}
    for K in (1, 4):
        ecfg = EngineConfig(**dict(BASE, max_batch=2, prefill_lanes=dp, multi_step=K,
                                   top_k=8 if temperature else 0, sample_seed=5))
        runs[K], stats, _, _ = _mesh_serve(ranks, params, cfg, ecfg, requests, dp=dp, tp=2)
    assert runs[4] == runs[1]
    assert all(len(runs[4][rid]) == n for rid, n in max_new.items())
    assert stats["decode_steps"] > stats["steps"]  # windows ran
    if dp == 1 or not temperature:
        assert runs[4] == _single(params, cfg, ecfg, requests)[0]


def test_dp_tp_prefix_caching_matches_single_device(ranks, llama):
    """A shared prefix on dp = 2 x tp = 2 is copied into every replica's
    pages (two pages each), requests on either replica read it, and
    release_prefix returns every replica's pages."""
    _, _, cfg, params = llama
    ecfg = EngineConfig(**BASE)
    prefix = _ramp(2 * 16 + 8, 3, 1)
    requests = _requests({0: [9, 4, 63], 1: [15, 2, 8, 30, 1], 2: _ramp(11, 7, 3)})
    got, _, held, freed = _mesh_serve(ranks, params, cfg, ecfg, requests, prefix, dp=2, tp=2)
    assert got == _single(params, cfg, ecfg, requests, prefix)[0]
    assert held == 4 and freed == 0


def test_tp_quantized_moe_matches_single_device(ranks, moe):
    """INT8 experts on tp = 2: the (L, E, f) scales shard with their
    weights, the streams are the single-device engine's."""
    _, _, cfg, params = moe
    qparams = quantize_moe_params(params)
    ecfg = EngineConfig(**dict(BASE, max_batch=2))
    requests = _requests({0: _ramp(21, 7, 3, 96), 1: [5, 9, 2]})
    got, _, _, _ = _mesh_serve(ranks, qparams, cfg, ecfg, requests, tp=2)
    assert got == _single(qparams, cfg, ecfg, requests)[0]


def test_dp_tp_all_features_composed(ranks, llama):
    """Every feature at once on dp = 2 x tp = 2 (the JAX package's composed
    mesh test): a shared prefix, chunked prefill lanes, speculative
    decoding, an int8 cache and int8 weights."""
    _, _, cfg, params = llama
    qparams = quantize_params(params)
    ecfg = EngineConfig(**dict(BASE, speculate_k=3, kv_quant="int8"))
    prefix = _ramp(16 + 5, 3, 1)
    requests = _requests({0: [9, 4, 7, 7, 7, 7], 1: [15, 2, 8]}, max_new=6)
    got, stats, _, _ = _mesh_serve(ranks, qparams, cfg, ecfg, requests, prefix, dp=2, tp=2)
    assert got == _single(qparams, cfg, ecfg, requests, prefix)[0]
    assert stats["spec_steps"] > 0


def test_tp_preemption_matches_single_device(ranks, llama):
    """A pool too small for every request: the mesh engine preempts and
    resumes as the single-device engine does, with the same streams."""
    _, _, cfg, params = llama
    ecfg = EngineConfig(**dict(BASE, num_pages=6))
    requests = _requests({0: _ramp(30, 7, 3), 1: _ramp(30, 3, 11), 2: _ramp(20, 5, 1)},
                         max_new=12)
    got, stats, _, _ = _mesh_serve(ranks, params, cfg, ecfg, requests, tp=2)
    want, want_stats = _single(params, cfg, ecfg, requests)
    assert got == want
    assert stats["preemptions"] == want_stats["preemptions"] > 0


# ---- what raises ------------------------------------------------------------

def test_mesh_requires_chunked_prefill(ranks, llama):
    _, _, cfg, params = llama
    ecfg = EngineConfig(max_batch=2, page_size=16, num_pages=32, max_seq=64)
    for out in ranks.run(mesh_ranks.engine_raises, params, cfg, ecfg, tp=2):
        assert out[0] == "ValueError" and "prefill_chunk" in out[1]


@pytest.mark.parametrize("axis,what", [("ep", "expert parallelism"),
                                       ("pp", "pipeline parallelism"),
                                       ("cp", "context parallelism")])
def test_mesh_axes_not_ported_raise(ranks, moe, axis, what):
    """A mesh with ep, pp or cp > 1 raises NotImplementedError naming what
    is not ported; nothing is served another way."""
    _, _, cfg, params = moe
    for out in ranks.run(mesh_ranks.engine_raises, params, cfg, EngineConfig(**BASE),
                         **{axis: 2}):
        assert out[0] == "NotImplementedError" and what in out[1]


def test_mesh_checkpoint_raises(ranks, llama, tmp_path):
    """save_engine of a mesh engine and load_engine onto a mesh raise."""
    _, _, cfg, params = llama
    path = str(tmp_path / "ckpt.npz")
    for out in ranks.run(mesh_ranks.checkpoint_raises, params, cfg, EngineConfig(**BASE), path,
                         tp=2):
        assert len(out) == 2 and all("mesh" in m for m in out)
