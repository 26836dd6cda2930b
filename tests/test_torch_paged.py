"""PyTorch port vs the JAX package: paged attention, paged KV append, the
split combine and rotary embedding (plain versions of csrc/paged_attention.cu
and csrc/paged_append.cu).

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs as its own tests run it (CPU, Pallas interpret mode).

Paged attention is held to the 2x rule of utils/testing.py against the
JAX package's own oracle (ops/reference.py's attention_ref over the pages
gathered and dequantized in jnp): the port's max error against that float32
oracle must be at most twice the JAX kernel's own error against it, plus
1e-5, for O and LSE alike. Appended pools must equal the JAX package's bit
for bit on every row outside the trash page.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xf_flash_attention_cutlass_tpu.ops import combine as jcombine
from xf_flash_attention_cutlass_tpu.ops import paged as jpaged
from xf_flash_attention_cutlass_tpu.ops import paged_append as jappend
from xf_flash_attention_cutlass_tpu.ops import rotary as jrotary
from xf_flash_attention_cutlass_tpu.ops.reference import (
    attention_ref,
    attn_bias_from_alibi_slopes,
    construct_local_mask,
)
from xf_flash_attention_cutlass_tpu.quant.kv import quantize_kv as j_quantize_kv
from xf_flash_attention_cutlass_tpu_torch.models.llama import params_from_jax
from xf_flash_attention_cutlass_tpu_torch.ops import combine, paged, paged_append, rotary
from xf_flash_attention_cutlass_tpu_torch.utils.testing import (
    alibi_slopes_ref,
    assert_close_2ref,
    max_err,
    paged_attention_oracle,
)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype == torch.float32:
        return t.view(torch.int32).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    return _bits(_t(a))


# ---- paged attention --------------------------------------------------------

def _paged_case(seed, *, kv, b=3, sq=1, h=4, h_k=2, d=32, page=16, n_pages=12,
                max_pages=4, layers=None, dead_row=True):
    """Pools, block tables and lengths as numpy/jax arrays. kv: "bf16" | "f32"
    | "int8" | "fp8_e4m3". The last row has kv_len 0 and a trash table."""
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)
    shape = lead + (n_pages + 1, h_k, page, d)
    kf = rng.standard_normal(shape).astype(np.float32)
    vf = rng.standard_normal(shape).astype(np.float32)
    qdt = jnp.float32 if kv == "f32" else jnp.bfloat16
    q = jnp.asarray(rng.standard_normal((b, sq, h, d)), qdt)
    if kv in ("int8", "fp8_e4m3"):
        kq, ks = j_quantize_kv(jnp.asarray(kf), kv)
        vq, vs = j_quantize_kv(jnp.asarray(vf), kv)
        pools = dict(k=kq, v=vq, ks=ks[..., 0], vs=vs[..., 0])
    else:
        pools = dict(k=jnp.asarray(kf, qdt), v=jnp.asarray(vf, qdt), ks=None, vs=None)
    bt = np.stack([rng.permutation(n_pages)[:max_pages] for _ in range(b)]).astype(np.int32)
    lens = rng.integers(sq, max_pages * page + 1, size=b).astype(np.int32)
    if dead_row:
        lens[-1] = 0
        bt[-1] = n_pages
    return q, pools, jnp.asarray(bt), jnp.asarray(lens)


@functools.partial(jax.jit, static_argnames=("layer", "causal", "window", "softcap"))
def _jax_oracle(q, pools, bt, lens, layer, causal=True, window=(-1, -1), softcap=0.0,
                alibi_slopes=None, cache_leftpad=None):
    """The JAX package's float32 oracle, independent of the port: the pages
    each row names gathered in logical order to (b, T, h_k, d) and
    dequantized, keys past kv_len (or before the left pad) masked, then
    attention_ref for O and a logsumexp of the same masked, biased scores
    for LSE (b, h, sq). Compiled as one program: eagerly, each jnp op
    would compile on its own for every new shape."""
    pick = (lambda a: a) if layer is None else (lambda a: a[layer])

    def dense(pool):  # (pages, h_k, page, ...) -> (b, T, h_k, ...)
        g = jnp.swapaxes(pick(pool)[bt], 2, 3)  # (b, max_pages, page, h_k, ...)
        return g.reshape(g.shape[0], -1, *g.shape[3:]).astype(jnp.float32)

    k, v = dense(pools["k"]), dense(pools["v"])
    if pools["ks"] is not None:
        k, v = k * dense(pools["ks"])[..., None], v * dense(pools["vs"])[..., None]
    b, sq, h, d = q.shape
    T = k.shape[1]
    col = jnp.arange(T)[None, :]
    key_mask = col < lens[:, None]
    if cache_leftpad is not None:
        key_mask = key_mask & (col >= cache_leftpad[:, None])
    bias = None
    if alibi_slopes is not None:  # the exact |qpos - kpos| bias of every row
        bias = attn_bias_from_alibi_slopes(alibi_slopes, sq, T, None, key_mask,
                                           causal=False, key_leftpad=cache_leftpad)
    q32 = q.astype(jnp.float32)
    out, _ = attention_ref(q32, k, v, None, key_mask, bias, causal=causal, window_size=window,
                           softcap=softcap, key_leftpad=cache_leftpad)
    s = jnp.einsum("bthd,bshd->bhts", q32 / np.sqrt(d), jnp.repeat(k, h // k.shape[2], axis=2))
    if softcap > 0:
        s = jnp.tanh(s / softcap) * softcap
    s = jnp.where(key_mask[:, None, None, :], s, -jnp.inf)
    if causal:
        window = (window[0], 0)
    if window[0] >= 0 or window[1] >= 0:
        local = construct_local_mask(sq, T, window, None, key_mask, key_leftpad=cache_leftpad)
        s = jnp.where(local, -jnp.inf, s)
    if bias is not None:
        s = s + bias
    return out, jax.nn.logsumexp(s, axis=-1)


def _check_2x(q, pools, bt, lens, layer=None, **kw):
    sc_j = {} if pools["ks"] is None else dict(k_scales=pools["ks"], v_scales=pools["vs"])
    sc_t = {} if pools["ks"] is None else dict(k_scales=_t(pools["ks"]),
                                               v_scales=_t(pools["vs"]))
    jl = {} if layer is None else dict(layer_idx=jnp.int32(layer))
    tl = {} if layer is None else dict(layer_idx=layer)
    jo, jlse = jpaged.paged_attention(q, pools["k"], pools["v"], bt, lens, **sc_j, **jl, **kw)
    tkw = dict(kw)
    if "alibi_slopes" in tkw:
        tkw["alibi_slopes"] = _t(tkw["alibi_slopes"])
    if "cache_leftpad" in tkw:
        tkw["cache_leftpad"] = _t(tkw["cache_leftpad"])
    to, tlse = paged.paged_attention(_t(q), _t(pools["k"]), _t(pools["v"]), _t(bt), _t(lens),
                                     **sc_t, **tl, **tkw)
    okw = {k: v for k, v in kw.items() if k != "num_splits"}
    ro, rlse = (_t(a) for a in _jax_oracle(q, pools, bt, lens, layer, **okw))
    jo, jlse = _t(jo), _t(jlse)
    assert to.shape == jo.shape and to.dtype == jo.dtype and tlse.shape == jlse.shape
    live = np.asarray(lens) > 0
    if not live.all():  # kv_len 0 rows: O = 0, LSE = -inf, no NaN
        assert torch.all(to[~live] == 0) and torch.all(torch.isneginf(tlse[~live]))
    assert torch.isfinite(to).all()
    assert_close_2ref(to, ro, jo)
    finite = torch.isfinite(rlse)
    assert torch.equal(torch.isfinite(tlse), finite)
    assert_close_2ref(tlse[finite], rlse[finite], jlse[finite])
    if to.dtype == torch.float32:  # same f32 arithmetic: a few ulps from JAX's
        ulp = torch.finfo(torch.float32).eps
        assert max_err(to, jo) <= 8 * ulp * float(jo.abs().max())
        assert max_err(tlse[finite], jlse[finite]) <= 8 * ulp * float(jlse[finite].abs().max())
    return to, tlse, jo, jlse


@pytest.mark.parametrize(
    "kv,sq,page,num_splits",
    [
        ("bf16", 1, 16, 1),
        ("bf16", 5, 32, 3),
        ("int8", 1, 32, 3),
        ("int8", 5, 16, 1),
        ("fp8_e4m3", 1, 16, 3),
        ("fp8_e4m3", 5, 32, 1),
        ("f32", 3, 16, 0),
    ],
)
def test_paged_attention_2x_rule(kv, sq, page, num_splits):
    q, pools, bt, lens = _paged_case(10 + sq + page, kv=kv, sq=sq, page=page,
                                     max_pages=64 // page + 1)
    _check_2x(q, pools, bt, lens, num_splits=num_splits)


@pytest.mark.parametrize("kv", ["bf16", "fp8_e4m3"])
def test_paged_attention_layer_idx(kv):
    q, pools, bt, lens = _paged_case(20, kv=kv, sq=2, layers=3)
    _check_2x(q, pools, bt, lens, layer=2, num_splits=2)


@pytest.mark.parametrize(
    "extra",
    [
        dict(window=(7, 0)),
        dict(softcap=5.0),
        dict(alibi="per-head"),
        dict(causal=False, window=(6, 2), cache_leftpad=True),
    ],
)
def test_paged_attention_plain_extras(extra):
    """Window, softcap, ALiBi and leftpad on the plain version (the CUDA
    kernels take them in their options instantiations): they follow the
    JAX semantics."""
    q, pools, bt, lens = _paged_case(30, kv="f32", b=2, sq=4, h=4, h_k=1, dead_row=False)
    kw = dict(extra)
    if kw.pop("alibi", None):
        kw["alibi_slopes"] = jnp.asarray(alibi_slopes_ref(4))
    if kw.pop("cache_leftpad", None):
        kw["cache_leftpad"] = jnp.asarray([3, 0], jnp.int32)
    _check_2x(q, pools, bt, lens, num_splits=1, **kw)


@pytest.mark.parametrize("kv,causal", [("bf16", True), ("fp8_e4m3", True), ("int8", False)])
def test_paged_attention_oracle_matches_jax(kv, causal):
    """The dense oracle that the kernel is held against on the card
    (utils/testing.py) agrees with the JAX package's: in f32 to f32
    rounding, and in the working dtype to within bf16 rounding."""
    q, pools, bt, lens = _paged_case(70, kv=kv, sq=3, max_pages=5)
    sc = {} if pools["ks"] is None else dict(k_scales=_t(pools["ks"]), v_scales=_t(pools["vs"]))
    args = (_t(q), _t(pools["k"]), _t(pools["v"]), _t(bt), _t(lens))
    o32, l32 = paged_attention_oracle(*args, causal=causal, **sc)
    olp, llp = paged_attention_oracle(*args, causal=causal, upcast=False, **sc)
    ro, rlse = (_t(a) for a in _jax_oracle(q, pools, bt, lens, None, causal=causal))
    assert o32.dtype == torch.float32 and olp.dtype == args[0].dtype
    assert max_err(o32, ro) <= 1e-5
    assert torch.equal(torch.isneginf(l32), torch.isneginf(rlse))
    finite = torch.isfinite(rlse)
    assert max_err(l32[finite], rlse[finite]) <= 1e-5
    assert 0 < max_err(olp, ro) <= 0.05 and max_err(llp[finite], rlse[finite]) <= 0.05
    dead = ~torch.from_numpy(np.asarray(lens) > 0)
    assert torch.all(olp[dead] == 0) and torch.all(torch.isneginf(llp[dead]))


def test_num_splits_heuristic_matches_jax():
    for n_work in (1, 7, 64, 100, 132, 200):
        for blocks in (1, 4, 16, 100):
            for max_splits in (1, 8, 128):
                assert paged.num_splits_heuristic(n_work, 132, blocks, max_splits) == \
                    jpaged.num_splits_heuristic(n_work, 132, blocks, max_splits)
    # decode at the Llama-8B batch: 8 rows x 8 KV heads leave SMs idle
    assert paged.resolve_num_splits(0, 8, 8, 4, 16) > 1
    assert paged.resolve_num_splits(3, 8, 8, 4, 16) == 3


@pytest.mark.parametrize(
    "rows,page,d,kv,options,route",
    [
        (4, 256, 128, torch.float8_e4m3fn, False, "decode"),  # decode: sq = 1, group 4
        (16, 256, 128, torch.int8, False, "decode"),  # verify: 4 tokens x group 4
        (17, 256, 128, torch.bfloat16, False, "wgmma"),  # one row past the decode tile
        (1024, 256, 128, torch.float8_e4m3fn, False, "wgmma"),  # a 256-token chunk
        (1024, 16, 64, torch.int8, False, "wgmma"),  # page 16, d = 64
        (1024, 24, 128, torch.bfloat16, False, "wgmma"),  # 8-key TMA boxes
        (1024, 256, 128, torch.float8_e4m3fn, True, "wgmma"),  # an option: its instantiation
        (1024, 12, 128, torch.bfloat16, False, "wmma"),  # a page of no whole box
        (1024, 256, 96, torch.bfloat16, False, "wmma"),  # d = 96
        (1024, 256, 128, torch.float16, False, "wmma"),  # no Hopper kernel for fp16 pools
        (1024, 12, 128, torch.int8, True, "wmma"),  # an option on an odd page
        (1024, 256, 128, torch.float16, True, "wmma"),  # an option on fp16 pools
    ],
)
def test_paged_route(rows, page, d, kv, options, route):
    """paged_route is a pure function of the shapes and the pool dtype (the
    options pick an instantiation and its label, not a kernel); the Hopper
    kernel's row tile (64) is the split heuristic's unit on its route, the
    decode kernel's (16) and the WMMA kernel's (16 or 32) on the others."""
    assert paged.paged_route(rows, page, d, kv) == route
    assert paged.route_label(route, rows, options).endswith(".options") == (
        options and route != "wmma")
    assert paged.route_row_tile(route, rows) == (64 if route == "wgmma" else
                                                 paged.kernel_row_tile(rows))


@pytest.mark.parametrize(
    "rows,page,d,kv,options,route,label",
    [
        (1, 256, 128, torch.bfloat16, False, "decode", "paged_attention.decode"),  # MHA decode
        (4, 16, 64, torch.float8_e4m3fn, False, "decode", "paged_attention.decode"),
        (8, 32, 128, torch.int8, False, "decode", "paged_attention.decode"),  # group 8
        (16, 64, 64, torch.bfloat16, False, "decode", "paged_attention.decode"),  # verify
        (17, 256, 128, torch.float8_e4m3fn, False, "wgmma", "paged_attention.prefill.wgmma"),
        (4, 256, 128, torch.float8_e4m3fn, True, "decode", "paged_attention.decode.options"),
        (4, 12, 128, torch.bfloat16, False, "wmma", "paged_attention.decode.wmma"),  # odd page
        (40, 12, 128, torch.bfloat16, False, "wmma", "paged_attention.prefill.wmma"),
        (17, 64, 64, torch.int8, True, "wgmma", "paged_attention.prefill.options"),
        (4, 12, 128, torch.bfloat16, True, "wmma", "paged_attention.decode.wmma"),  # odd page
        (4, 256, 128, torch.float16, True, "wmma", "paged_attention.decode.wmma"),  # fp16 pools
    ],
)
def test_paged_route_decode(rows, page, d, kv, options, route, label):
    """The decode kernel takes every call of at most 16 query rows a KV head
    on TMA-legal pages of bf16, int8 or fp8, with or without the options
    (counted as `paged_attention.decode.options` with them); an odd page or
    fp16 pools send such a call to the WMMA kernel, counted as
    `paged_attention.decode.wmma` either way."""
    assert paged.paged_route(rows, page, d, kv) == route
    assert paged.route_label(route, rows, options) == label
    assert paged.route_row_tile(route, rows) == {"decode": 16, "wgmma": 64}.get(
        route, paged.kernel_row_tile(rows))


@pytest.mark.parametrize(
    "kv_len,n_splits,max_keys",
    [
        (261, 4, 4096),  # the decode profile's kv_len at the engine's split count
        (1533, 4, 4096),
        (100, 5, 4096),  # more splits than live tiles
        (37, 3, 4096),  # kv_len < 64
        (0, 4, 4096),  # a dead slot
        (5000, 3, 4096),  # kv_len past the table
        (640, 1, 4096),  # one split, whole tiles
        (129, 2, 192),  # a table of three tiles
    ],
)
def test_decode_split_keys_cover_live_keys_once(kv_len, n_splits, max_keys):
    """The decode kernel's split cut (decode_split_keys): every live key in
    exactly one split, in order, each split a run of whole 64-key tiles
    (the last one cut at the live keys), the splits past the live tiles
    empty."""
    runs = paged.decode_split_keys(kv_len, n_splits, max_keys)
    live = min(kv_len, max_keys)
    assert len(runs) == n_splits
    covered = [k for lo, hi in runs for k in range(lo, hi)]
    assert covered == list(range(live))
    tiles = -(-live // 64)
    per = -(-tiles // n_splits) * 64
    for s, (lo, hi) in enumerate(runs):
        assert lo % 64 == 0 or lo == hi == live
        assert hi - lo == max(0, min(per, live - s * per))
    assert sum(hi > lo for lo, hi in runs) == min(n_splits, -(-tiles // max(1, per // 64)))


@pytest.mark.parametrize(
    "kv_len,sq,wl,leftpad,n_splits,max_keys",
    [
        (1500, 1, 1024, None, 4, 4096),  # a window start (the api options' decode)
        (1500, 1, -1, 300, 4, 4096),  # a leftpad
        (1500, 4, 700, 900, 3, 4096),  # both: the leftpad is the later
        (1500, 4, 900, 100, 3, 4096),  # both: the window start is the later
        (200, 1, -1, 201, 4, 4096),  # a leftpad one past kv_len: no visible key
        (1000, 2, -1, 130, 5, 4096),  # a first key inside a tile (128 + 2)
        (5000, 1, 4000, None, 3, 4096),  # kv_len past the table
    ],
)
def test_decode_split_keys_from_the_first_key(kv_len, sq, wl, leftpad, n_splits, max_keys):
    """The decode kernel's split cut with the options: every key a row can
    see (from the first row's window start or the leftpad to the live end)
    in exactly one split, no split starting below the first key's 64-key
    tile, whole tiles from there, and the cut starting where the plain
    version's (first_page with the decode route's 64-key unit) starts."""
    first_key = max(leftpad or 0, kv_len - sq - wl if wl >= 0 else 0)
    runs = paged.decode_split_keys(kv_len, n_splits, max_keys, first_key)
    live = min(kv_len, max_keys)
    tiles = -(-live // 64)
    first_tile = min(first_key // 64, tiles)
    assert len(runs) == n_splits
    covered = [k for lo, hi in runs for k in range(lo, hi)]
    assert covered == list(range(min(first_tile * 64, live), live))
    visible = [k for k in covered if k >= first_key]
    assert visible == list(range(first_key, live))
    for lo, hi in runs:
        assert lo >= min(first_tile * 64, live)
        assert (lo - first_tile * 64) % 64 == 0 or lo == hi == live
    lens = torch.tensor([kv_len])
    n_live = (lens.clamp_max(max_keys) + 63) // 64
    lp = None if leftpad is None else torch.tensor([leftpad], dtype=torch.int32)
    first = paged.first_page(lens, sq, 64, wl, lp, n_live)
    assert int(first[0]) == first_tile
    pps = (n_live - first + n_splits - 1) // n_splits  # the plain version's runs
    assert [(min((int(first[0]) + s * int(pps[0])) * 64, live)) for s in range(n_splits)] == [
        lo for lo, _ in runs]
    if first_key == 0:  # no option: the option-free cut
        assert runs == paged.decode_split_keys(kv_len, n_splits, max_keys)


@pytest.mark.parametrize("b,sq,page,max_pages", [(8, 1, 256, 16), (8, 4, 256, 16),
                                                  (1, 1, 256, 16), (8, 1, 32, 128)])
def test_decode_route_splits_for_engine_shapes(b, sq, page, max_pages):
    """The decode route's split count at the engine's shapes (Llama-8B
    32 / 8 heads, d = 128, fp8 pools, max_seq 4096): the unchanged
    heuristic over b * h_k blocks, the H100's SMs times the kernel's
    resident blocks as cores and the table's width in 64-key tiles."""
    route, splits = paged.paged_plan((b, sq, 32, 128), (32, 257, 8, page, 128),
                                     torch.float8_e4m3fn, max_pages)
    assert route == "decode"
    tiles = max_pages * page // 64
    assert splits == paged.num_splits_heuristic(b * 8, 132 * 2, tiles, paged.MAX_SPLITS)
    assert splits == jpaged.num_splits_heuristic(b * 8, 132 * 2, tiles, 128)
    assert 1 <= splits <= tiles
    if b == 8:  # 64 blocks on 264 resident slots: split
        assert splits > 1
    assert paged.paged_plan((b, sq, 32, 128), (32, 257, 8, page, 128), torch.float8_e4m3fn,
                            max_pages, 7)[1] == 7  # an explicit num_splits wins


def test_combine_splits_ref_matches_combine_partials():
    """The combine kernel's plain version (CPU tensors): combine_partials on
    the caller's (splits, b, sq, h, d) layout, O in the requested dtype and
    LSE moved to (b, h, sq); an empty split contributes nothing, a row whose
    splits are all empty gives O = 0 and LSE = -inf."""
    rng = np.random.default_rng(51)
    o = torch.from_numpy(rng.standard_normal((3, 2, 2, 4, 8)).astype(np.float32))
    lse = torch.from_numpy(rng.standard_normal((3, 2, 2, 4)).astype(np.float32) * 4)
    lse[0, 0, 0, 0] = -np.inf
    lse[:, 1, 1, 2] = -np.inf
    to, tl = paged.combine_splits(o, lse, torch.bfloat16)
    ro, rl = combine.combine_partials(o, lse)
    assert to.shape == (2, 2, 4, 8) and to.dtype == torch.bfloat16 and tl.shape == (2, 4, 2)
    assert torch.equal(to, ro.to(torch.bfloat16))
    assert torch.equal(tl, rl.transpose(1, 2))
    assert torch.all(to[1, 1, 2] == 0) and torch.isneginf(tl[1, 2, 1])
    want = sum(torch.exp(lse[s, 0, 0, 0] - rl[0, 0, 0]) * o[s, 0, 0, 0] for s in (1, 2))
    assert torch.allclose(ro[0, 0, 0], want, rtol=1e-6, atol=1e-6)


def test_paged_attention_decode_route_2x_rule():
    """The decode route's plain version (64-key tile splits) against the JAX
    kernel under the 2x rule: 2 new tokens at group 4 (8 rows), d = 64, page
    16, int8 pools of two layers, a dead row, the heuristic's splits."""
    q, pools, bt, lens = _paged_case(90, kv="int8", b=2, sq=2, h=8, h_k=2, d=64, page=16,
                                     n_pages=10, max_pages=9, layers=2)
    route, splits = paged.paged_plan(q.shape, pools["k"].shape, torch.int8, bt.shape[1])
    assert route == "decode" and splits > 1
    _check_2x(q, pools, bt, lens, layer=1, num_splits=0)


def test_paged_attention_decode_route_options_2x_rule():
    """The decode route with all four options (window start, softcap, ALiBi
    per (b, h), leftpad) on its plain version (64-key tile splits from the
    first visible key's tile) against the JAX kernel under the 2x rule: 2
    new tokens at group 4 (8 rows), d = 64, page 16, int8 pools of two
    layers, the heuristic's splits (more than one), a leftpad inside a tile
    and one past the window start, and a dead row."""
    q, pools, bt, lens = _paged_case(91, kv="int8", b=3, sq=2, h=8, h_k=2, d=64, page=16,
                                     n_pages=26, max_pages=12, layers=2)
    lens = jnp.asarray([180, 150, 0], jnp.int32)
    slopes = alibi_slopes_ref(8)[None] * np.asarray([[1.0], [0.5], [2.0]])  # (b, h)
    kw = dict(window=(70, 0), softcap=5.0, alibi_slopes=jnp.asarray(slopes, jnp.float32),
              cache_leftpad=jnp.asarray([37, 100, 0], jnp.int32))
    tkw = dict(kw, alibi_slopes=_t(kw["alibi_slopes"]), cache_leftpad=_t(kw["cache_leftpad"]))
    route, splits = paged.paged_plan(q.shape, pools["k"].shape, torch.int8, bt.shape[1], **tkw)
    assert route == "decode" and splits > 1
    _check_2x(q, pools, bt, lens, layer=1, num_splits=0, **kw)


def test_paged_alibi_with_leftpad_needs_no_leftpad_term():
    """ALiBi with a leftpad: the port's plain version takes slope * |qpos -
    kcol| (no leftpad term, as the kernels do), the JAX oracle counts both
    positions from the leftpad. On every key a row sees (kcol >= leftpad)
    the two distances agree, so O and LSE agree to f32 rounding, causal and
    not, with leftpads inside a row's window and past a short row's start."""
    q, pools, bt, lens = _paged_case(92, kv="f32", b=3, sq=4, h=4, h_k=2, d=32, dead_row=False)
    lens = jnp.asarray([60, 33, 9], jnp.int32)
    slopes = jnp.asarray(alibi_slopes_ref(4) * 4.0)  # steep: a wrong distance shows
    leftpad = jnp.asarray([21, 0, 7], jnp.int32)
    for causal in (True, False):
        o, lse = paged.paged_attention(_t(q), _t(pools["k"]), _t(pools["v"]), _t(bt), _t(lens),
                                       causal=causal, alibi_slopes=_t(slopes),
                                       cache_leftpad=_t(leftpad))
        ro, rlse = (_t(a) for a in _jax_oracle(q, pools, bt, lens, None, causal=causal,
                                               alibi_slopes=slopes, cache_leftpad=leftpad))
        assert max_err(o, ro) <= 1e-5
        assert torch.equal(torch.isfinite(lse), torch.isfinite(rlse))
        finite = torch.isfinite(rlse)
        assert max_err(lse[finite], rlse[finite]) <= 1e-5


@pytest.mark.parametrize(
    "kw,options",
    [
        (dict(causal=True), False),
        (dict(causal=False), False),  # non-causal is option-free
        (dict(causal=False, window=(-1, 0)), False),  # a right window of 0: causal
        (dict(causal=True, window=(7, 0)), True),
        (dict(causal=False, window=(-1, 3)), True),
        (dict(causal=True, softcap=5.0), True),
        (dict(causal=True, alibi_slopes=torch.ones(4)), True),
        (dict(causal=True, cache_leftpad=torch.zeros(2, dtype=torch.int32)), True),
    ],
)
def test_paged_plan_options_and_splits(kw, options):
    """paged_plan: a chunk of 40 tokens at group 2 (80 rows) takes the
    Hopper kernel with or without the options (an option asks for its
    options instantiation, counted apart), and the heuristic counts blocks
    of its row tile."""
    full = dict(causal=True, window=(-1, -1), softcap=0.0, alibi_slopes=None,
                cache_leftpad=None)
    full.update(kw)
    assert paged.has_options(**full) == options
    route, splits = paged.paged_plan((2, 40, 4, 64), (3, 9, 2, 16, 64), torch.float8_e4m3fn,
                                     12, 0, **kw)
    assert route == "wgmma"
    assert paged.route_label(route, 80, options) == (
        "paged_attention.prefill.options" if options else "paged_attention.prefill.wgmma")
    tile = 64
    assert splits == paged.resolve_num_splits(0, 2, 2, 80, 12, tile)
    assert splits == paged.num_splits_heuristic(2 * 2 * -(-80 // tile), paged.NUM_SMS, 12,
                                                paged.MAX_SPLITS)


def test_paged_attention_wgmma_shape_2x_rule():
    """The shapes the Hopper route takes on the card: 40 new tokens at group
    2 (80 rows, a second row tile of 16), page 16, fp8 pools of two layers,
    a dead row, the heuristic's splits; the plain version against the JAX
    kernel under the 2x rule."""
    q, pools, bt, lens = _paged_case(80, kv="fp8_e4m3", b=2, sq=40, h=4, h_k=2, d=64,
                                     page=16, n_pages=8, max_pages=6, layers=2)
    route, _ = paged.paged_plan(q.shape, pools["k"].shape, torch.float8_e4m3fn, bt.shape[1])
    assert route == "wgmma"
    _check_2x(q, pools, bt, lens, layer=1, num_splits=0)


# ---- paged append -----------------------------------------------------------

def _append_case(seed, *, qdt, b, sq, page, h_k=2, d=128, n_pages=10, layers=2):
    rng = np.random.default_rng(seed)
    shape = (layers, n_pages + 1, h_k, page, d)
    quant = qdt in ("int8", "fp8_e4m3")
    jdt = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn, "bf16": jnp.bfloat16}[qdt]
    pools = dict(k=jnp.zeros(shape, jdt), v=jnp.zeros(shape, jdt))
    if quant:
        pools["ks"] = jnp.zeros(shape[:-1], jnp.float32)
        pools["vs"] = jnp.zeros(shape[:-1], jnp.float32)
    perm = rng.permutation(n_pages)
    per = n_pages // b
    bt = np.full((b, 4), n_pages, np.int32)  # trash tail
    for i in range(b):
        bt[i, :per] = perm[i * per:(i + 1) * per]
    kn = (rng.standard_normal((b, sq, h_k, d)) * 3).astype(np.float32)
    vn = rng.standard_normal((b, sq, h_k, d)).astype(np.float32)
    kn[0, 0, 0] = 0.0  # amax 0: scale 1
    return pools, bt, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16)


def _check_append(pools, bt, kn, vn, positions, mode, n_pages):
    quant = "ks" in pools
    jsc = dict(k_scales=pools["ks"], v_scales=pools["vs"]) if quant else {}
    # compiled, as the JAX engine runs it (see quant/kv.py of the port)
    j_append = jax.jit(functools.partial(jappend.paged_append, mode=mode))
    jout = j_append(pools["k"], pools["v"], kn, vn, jnp.asarray(bt), jnp.asarray(positions),
                    layer_idx=jnp.int32(1), **jsc)
    tp = {k: _t(v) for k, v in pools.items()}
    tsc = dict(k_scales=tp["ks"], v_scales=tp["vs"]) if quant else {}
    tout = paged_append.paged_append(tp["k"], tp["v"], _t(kn), _t(vn), _t(bt),
                                     _t(positions), layer_idx=1, **tsc)
    assert tout[0] is tp["k"]  # updated in place, returned as given
    for got, want in zip(tout, jout):
        np.testing.assert_array_equal(_bits(got[:, :n_pages]), _jbits(want[:, :n_pages]))
    assert torch.count_nonzero(tout[0][1, :n_pages].float()) > 0


@pytest.mark.parametrize("qdt", ["int8", "fp8_e4m3", "bf16"])
def test_paged_append_decode_unaligned_bit_exact(qdt):
    """sq = 1 at scattered positions, page 128: the JAX decode kernel."""
    pools, bt, kn, vn = _append_case(40, qdt=qdt, b=3, sq=1, page=128, n_pages=9)
    _check_append(pools, bt, kn, vn, np.asarray([5, 200, 383], np.int32), "decode", 9)


@pytest.mark.parametrize("qdt", ["int8", "fp8_e4m3"])
def test_paged_append_chunk_bit_exact(qdt):
    """A 128-token chunk for two lanes at page-aligned positions: the JAX
    prefill kernel."""
    pools, bt, kn, vn = _append_case(41, qdt=qdt, b=2, sq=128, page=128, n_pages=8)
    _check_append(pools, bt, kn, vn, np.asarray([0, 128], np.int32), "auto", 8)


def test_paged_append_verify_style_and_small_page_bit_exact():
    """sq > 1 at unaligned positions (the JAX per-token verify path), and a
    page-16 int8 pool (the JAX scatter fallback): one port kernel for both."""
    pools, bt, kn, vn = _append_case(42, qdt="fp8_e4m3", b=2, sq=3, page=128, n_pages=8)
    _check_append(pools, bt, kn, vn, np.asarray([126, 300], np.int32), "decode", 8)
    pools, bt, kn, vn = _append_case(43, qdt="int8", b=2, sq=5, page=16, d=32, n_pages=8)
    _check_append(pools, bt, kn, vn, np.asarray([14, 33], np.int32), "decode", 8)


@pytest.mark.parametrize("qdt", ["int8", "fp8_e4m3"])
def test_paged_append_d64_chunk_crosses_pages_and_the_table_bit_exact(qdt):
    """d = 64 (a half-warp a row in the CUDA kernel), page 16, 6-token chunks
    at unaligned positions: row 0 crosses a page boundary inside its two
    live pages, row 1 crosses from its last live page into the table's trash
    tail. Bit-exact against the JAX per-token path on every page but the
    trash page. Then a chunk that runs past the table's last entry: its
    tokens there are dropped, so the pools equal those of the chunk's
    in-table head alone."""
    pools, bt, kn, vn = _append_case(45, qdt=qdt, b=2, sq=6, page=16, d=64, n_pages=4)
    assert (bt[:, 2:] == 4).all()  # two live pages a row, then the trash page
    _check_append(pools, bt, kn, vn, np.asarray([12, 28], np.int32), "decode", 4)
    tp = {n: _t(x) for n, x in pools.items()}
    sc = dict(k_scales=tp["ks"], v_scales=tp["vs"])
    want = {n: x.clone() for n, x in tp.items()}
    pos = torch.tensor([62, 60], dtype=torch.int32)  # tokens 64.. sit past entry 3
    paged_append.paged_append(tp["k"], tp["v"], _t(kn), _t(vn), _t(bt), pos, layer_idx=1, **sc)
    head = dict(k_scales=want["ks"], v_scales=want["vs"])
    for i, n in enumerate((2, 4)):  # each row's tokens below position 64
        paged_append.paged_append(want["k"], want["v"], _t(kn)[i:i + 1, :n],
                                  _t(vn)[i:i + 1, :n], _t(bt)[i:i + 1], pos[i:i + 1],
                                  layer_idx=1, **head)
    for n in tp:
        np.testing.assert_array_equal(_bits(tp[n]), _bits(want[n]))


@pytest.mark.parametrize("qdt", ["int8", "fp8_e4m3"])
def test_paged_append_page32_scale_planes_match_jax_k6(qdt, monkeypatch):
    """Quantized prefill into page-32 pools: the JAX package routes it through
    _prefill_append_padded, whose _scale_write_kernel (K6) writes whole
    128-lane per-page scale planes; the port's one append kernel writes each
    token's scale into its page's plane row by row. Two 64-token rows at
    page-aligned positions: the same live pool bytes, and the same scales in
    the live columns [0, 32) of JAX's planes."""
    routed = []
    padded = jappend._prefill_append_padded
    monkeypatch.setattr(jappend, "_prefill_append_padded",
                        lambda *a, **k: routed.append(1) or padded(*a, **k))
    rng = np.random.default_rng(44)
    b, sq, h_k, d, page, n_pages, layers = 2, 64, 2, 128, 32, 8, 2
    jdt = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}[qdt]
    shape = (layers, n_pages + 1, h_k, page, d)
    bt = np.full((b, 4), n_pages, np.int32)  # trash tail
    bt[:, :3] = rng.permutation(n_pages)[:6].reshape(b, 3)
    kn = jnp.asarray(rng.standard_normal((b, sq, h_k, d)) * 3, jnp.bfloat16)
    vn = jnp.asarray(rng.standard_normal((b, sq, h_k, d)), jnp.bfloat16)
    pos = np.asarray([32, 0], np.int32)
    jout = jax.jit(jappend.paged_append)(
        jnp.zeros(shape, jdt), jnp.zeros(shape, jdt), kn, vn, jnp.asarray(bt), jnp.asarray(pos),
        k_scales=jnp.zeros(shape[:-2] + (128,), jnp.float32),
        v_scales=jnp.zeros(shape[:-2] + (128,), jnp.float32), layer_idx=jnp.int32(1))
    assert routed  # the JAX append took the K6 route
    tdt = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn}[qdt]
    tpools = (torch.zeros(shape, dtype=tdt), torch.zeros(shape, dtype=tdt),
              torch.zeros(shape[:-1]), torch.zeros(shape[:-1]))
    tout = paged_append.paged_append(tpools[0], tpools[1], _t(kn), _t(vn), _t(bt), _t(pos),
                                     k_scales=tpools[2], v_scales=tpools[3], layer_idx=1)
    live = np.concatenate([bt[0, 1:3], bt[1, :2]])  # the pages the two rows wrote
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(_bits(got[1, live]), _jbits(want[1, live]))
    for got, want in zip(tout[2:], jout[2:]):
        np.testing.assert_array_equal(_bits(got[1, live]), _jbits(want[1, live, :, :page]))
    assert torch.count_nonzero(tout[0][1, live].float()) > 0


# ---- combine and rotary ------------------------------------------------------

def test_combine_partials_and_merge_two_match_jax():
    rng = np.random.default_rng(50)
    o = rng.standard_normal((3, 2, 5, 8)).astype(np.float32)
    lse = rng.standard_normal((3, 2, 5)).astype(np.float32) * 4
    lse[0, 0, 0] = -np.inf  # one empty split
    lse[:, 1, 2] = -np.inf  # all splits empty
    jo, jl = jcombine.combine_partials(jnp.asarray(o), jnp.asarray(lse))
    to, tl = combine.combine_partials(torch.from_numpy(o), torch.from_numpy(lse))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
    assert torch.all(to[1, 2] == 0) and torch.isneginf(tl[1, 2])
    jo, jl = jcombine.merge_two(*(jnp.asarray(a) for a in (o[0], lse[0], o[1], lse[1])))
    to, tl = combine.merge_two(*(torch.from_numpy(a) for a in (o[0], lse[0], o[1], lse[1])))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rotary_matches_jax(interleaved):
    rng = np.random.default_rng(60)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 70, (2, 5)).astype(np.int32)
    jc, js = jrotary.rotary_frequencies(12, 64, 10000.0)  # rotary_dim < head_dim
    tc, ts = rotary.rotary_frequencies(12, 64, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    want = jrotary.apply_rotary(jnp.asarray(x), jc, js, jnp.asarray(pos), interleaved)
    got = rotary.apply_rotary(torch.from_numpy(x), _t(jc), _t(js), torch.from_numpy(pos),
                              interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., 12:].numpy(), x[..., 12:])  # tail untouched
