"""PyTorch port vs the JAX package: checkpoints of a mesh engine
(serve/checkpoint.py on a dp / tp / ep mesh), across the packages.

For each mesh the JAX mesh engine runs the requests to the end (the streams
both packages must emit) and, in a second engine, saves after a few steps;
the port's mesh engine (in two gloo rank processes started once for the
file, tests/mesh_ranks.py) saves after as many steps, loads the JAX file
onto its mesh and finishes; the JAX engine loads the port's file onto its
mesh and finishes. Both resumed runs must emit the uninterrupted streams
token for token; the two files must hold the same allocator words (the
same pages in both packages); and each loaded engine's pools must hold the
bytes of the file it loaded on the rows the requests hold (the decoding
requests' cached tokens and the in-flight prefills' prefilled ones: no
value re-quantized or cast on the way). The two files' f32 K/V rows differ
in their last bits (XLA's and torch's projections round apart), so they
are compared within 1e-5 (the JAX package's tolerance for its mesh's
pools, tests/test_moe_ep_serve.py), int8 rows within one step of the grid
and their scales within 1e-5 relative. Three JAX mesh shapes:
- tp = 2, an int8 cache (page 16, stored at 32 with the JAX engine's
  padding), a chunked prefill in flight at the save;
- ep = 2 with the MoE family (the JAX package's tests/test_checkpoint.py
  ep case);
- dp = 2 with a shared prefix copied into both replicas.

The tp and ep meshes' saves are also measured (tests/mesh_ranks.py
PeakBytes): a save gathers one leaf at a time to rank 0's host.
"""

import json

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
    load_engine as j_load_engine,
    save_engine as j_save_engine,
)
from xf_flash_attention_cutlass_tpu_torch.models.llama import LlamaConfig, params_from_jax
from xf_flash_attention_cutlass_tpu_torch.models.moe import MoEConfig
from xf_flash_attention_cutlass_tpu_torch.serve import EngineConfig

# the tiny models of the JAX package's tests/test_parallel.py and
# tests/test_checkpoint.py (its ep case)
TINY = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=4, ffn_dim=96,
            max_seq_len=256)
TINY_MOE = dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=96,
                max_seq_len=256, n_experts=4, top_k=2, capacity_factor=8.0)
BASE = dict(max_batch=4, page_size=16, num_pages=64, max_seq=256, prefill_chunk=32,
            prefill_lanes=2)


def _ramp(n, a, b, v=64):
    return [(a * i + b) % v for i in range(n)]


CASES = {  # name: (model, axes, engine config, prompts, new tokens, steps before the save, prefix)
    "tp2_int8_prefill_in_flight": (
        "llama", dict(tp=2), dict(BASE, kv_quant="int8"),
        {0: _ramp(41, 7, 3), 1: [5, 9, 2], 2: _ramp(17, 3, 11)}, 5, 1, None),
    "ep2_moe": (
        "moe", dict(ep=2), dict(BASE, max_batch=2, num_pages=32, max_seq=128),
        {0: _ramp(19, 3, 5), 1: [7, 2, 9]}, 6, 4, None),
    "dp2_prefix": (
        "llama", dict(dp=2), BASE,
        {0: [9, 4, 63], 1: [15, 2, 8, 30, 1], 2: _ramp(11, 7, 3)}, 5, 3, _ramp(2 * 16 + 8, 3, 1)),
}


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
    pool = mesh_ranks.Ranks(2, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def models():
    """model name: (JAX cfg, JAX f32 params, port cfg, port params)."""
    out = {}
    for name, kw, jcls, jinit, cls in (
            ("llama", TINY, JLlamaConfig, j_init_params, LlamaConfig),
            ("moe", TINY_MOE, jmoe.MoEConfig, jmoe.init_moe_params, MoEConfig)):
        jcfg = jcls(**kw)
        jp = jinit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
        out[name] = jcfg, jp, cls(**kw), params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return out


_ITEMSIZE = {"int8": 1, "float32": 4, "bfloat16": 2, "float8_e4m3fn": 1}


_NP = {"int8": np.int8, "float32": np.float32}


def _file(path):
    """A checkpoint's (pools as uint8 arrays of shape (*shape, itemsize), the
    pools' dtype names, the allocator's words)."""
    with np.load(path) as z:
        state = json.loads(bytes(z["state"].tobytes()).decode())
        specs = dict(zip(state["pool_keys"], state["pools_spec"]))
        pools = {k: z[f"pool_{k}"].reshape(*shape, _ITEMSIZE[dt])
                 for k, (dt, shape) in specs.items()}
        return pools, {k: dt for k, (dt, _) in specs.items()}, z["allocator"]


def _at_rows(pools, rows):
    """Each pool's (page, row) entries of the live rows."""
    pages, cols = np.asarray(rows).T
    return {k: p[:, pages, :, cols] for k, p in pools.items()}


def _bits_equal(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _streams(results):
    return {int(rid): [int(t) for t in toks] for rid, toks in results.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_checkpoints_cross_packages(ranks, models, tmp_path, case):
    """The JAX mesh engine's file resumes on the port's mesh, the port's on
    the JAX mesh, both with the uninterrupted streams; each loaded engine's
    pools hold its file's bytes on the live rows."""
    model, axes, ecfg_kw, prompts, max_new, n_steps, prefix = CASES[case]
    jcfg, jp, cfg, params = models[model]
    jmesh = j_make_mesh(**axes, devices=jax.devices("cpu")[:2])

    def jax_engine():
        eng = JDecodeEngine(jp, jcfg, JEngineConfig(**ecfg_kw), dtype=jnp.float32, mesh=jmesh)
        if prefix is not None:
            eng.register_prefix("sys", prefix)
        for rid, p in prompts.items():
            eng.add_request(rid, p, max_new, prefix_id="sys" if prefix is not None else None)
        return eng

    want = _streams(jax_engine().run())
    jeng = jax_engine()
    for _ in range(n_steps):
        jeng.step()
    if case.endswith("in_flight"):
        assert any(st is not None for st in jeng._prefills)
    jax_file, port_file = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_save_engine(jeng, jax_file)
    requests = {rid: (p, max_new, 0.0) for rid, p in prompts.items()}
    outs = ranks.run(mesh_ranks.save_and_resume, params, cfg, EngineConfig(**ecfg_kw), requests,
                     n_steps, port_file, jax_file, prefix, **axes)
    rows, port_loaded, got = outs[0]
    assert len(rows) > 0 and _streams(outs[1][2]) == _streams(got)
    assert _streams(got) == want
    resumed = j_load_engine(port_file, params=jp, dtype=jnp.float32, mesh=jmesh)
    jax_loaded = {k: np.asarray(v)[..., None].view(np.uint8) for k, v in resumed.pools.items()}
    assert _streams(resumed.run()) == want
    (a, dtypes, a_words), (b, _, b_words) = _file(jax_file), _file(port_file)
    assert np.array_equal(a_words, b_words)
    assert a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in a)
    assert _bits_equal(_at_rows(port_loaded, rows), _at_rows(a, rows))
    assert _bits_equal(_at_rows(jax_loaded, rows), _at_rows(b, rows))
    for k, dt in dtypes.items():  # the two packages' computed rows
        va, vb = (_at_rows(x, rows)[k].view(_NP[dt]).astype(np.float64) for x in (a, b))
        if k.endswith("_s"):  # int8 scales: 1e-5 relative
            assert np.max(np.abs(va - vb) / np.abs(vb)) <= 1e-5, k
        else:
            assert np.max(np.abs(va - vb)) <= (1 if dt == "int8" else 1e-5), k


@pytest.mark.parametrize("case", ["tp2_int8_prefill_in_flight", "ep2_moe"])
def test_mesh_save_holds_one_leaf_at_a_time(ranks, models, tmp_path, case):
    """A save with the params on a tp = 2 or ep = 2 mesh sends each leaf's
    blocks to rank 0's host one leaf at a time: no rank's torch allocations
    during the save reach twice the bytes of its own shards (pools and
    params), and rank 1, which only sends, never holds more than its
    largest shard (on the CPU its blocks are sent in place)."""
    model, axes, ecfg_kw, prompts, max_new, n_steps, _ = CASES[case]
    _, _, cfg, params = models[model]
    requests = {rid: (p, max_new, 0.0) for rid, p in prompts.items()}
    outs = ranks.run(mesh_ranks.save_peak, params, cfg, EngineConfig(**ecfg_kw), requests,
                     n_steps, str(tmp_path / "peak.npz"), **axes)
    for rank, (peak, shards, largest) in enumerate(outs):
        assert 0 < largest and peak < 2 * shards, (rank, peak, shards)
    assert outs[1][0] <= outs[1][2], outs[1]
