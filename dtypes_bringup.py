"""Bring-up of the fp16 and f32 instantiations of K1, the append kernel and
K3/K4 on one H100, in stages, before the whole chip_smoke.py.

    python3 dtypes_bringup.py [--stages build,quick,phase] [--out DIR]

`build` compiles paged_attention.cu, paged_append.cu and qmm.cu alone (one
nvcc each, in parallel, and K1's and K3's fp16 variants) and prints the
seconds and, per library, how many ptxas lines report spills; `quick` holds each new instantiation
against its plain version at small shapes (the append bit for bit, K1 and K3
to the plain version within the 2x rule's tolerance) and prints one line per
case; `phase` runs chip_smoke.py's `dtype_kernels` phase (the Llama-8B
shapes, timed) and its refusals. Exits 1 when a case failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def build():
    from xf_flash_attention_cutlass_tpu_torch import _build

    _build.SOURCES = ("paged_attention", "paged_attention_f16", "paged_append", "qmm", "qmm_f16")
    t0 = time.perf_counter()
    try:
        _build.build_all()
    except RuntimeError as e:
        print(str(e)[-20000:], flush=True)
        raise
    spills = {}
    for name in _build.SOURCES:
        with open(os.path.join(_build.BUILD_DIR, f"{name}.log")) as f:
            spills[name] = sum(1 for line in f if "bytes spill" in line
                               and not line.strip().startswith("0 bytes spill")
                               and " 0 bytes spill stores, 0 bytes spill loads" not in line)
    print(json.dumps({"build_s": time.perf_counter() - t0, "lines_with_spills": spills}),
          flush=True)


def quick(checks):
    from xf_flash_attention_cutlass_tpu_torch.ops.paged import paged_attention, paged_attention_ref
    from xf_flash_attention_cutlass_tpu_torch.ops.paged_append import (
        paged_append,
        paged_append_ref,
    )
    from xf_flash_attention_cutlass_tpu_torch.quant.kv import quantize_kv
    from xf_flash_attention_cutlass_tpu_torch.quant.linear import (
        _qmm_cuda,
        quantize_weight,
        quantized_matmul_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    # the append: rows of each dtype into each pool
    for rows in (torch.float16, torch.float32, torch.bfloat16):
        for pool in (rows, torch.int8, torch.float8_e4m3fn):
            for b, sq, d, page in ((8, 1, 128, 256), (1, 100, 64, 32), (2, 9, 66, 16)):
                h_k, n_pages = 2, 12
                shape = (n_pages + 1, h_k, page, d)
                kp = torch.zeros(shape, dtype=pool, device="cuda")
                vp = torch.zeros_like(kp)
                quant = pool in (torch.int8, torch.float8_e4m3fn)
                ks = torch.zeros(shape[:-1], device="cuda") if quant else None
                vs = torch.zeros_like(ks) if quant else None
                per = n_pages // b  # distinct pages per row
                perm = torch.randperm(n_pages, generator=gen, device="cuda").int()
                bt = perm[:b * per].reshape(b, per).contiguous()
                pos = torch.randint(0, page, (b,), generator=gen, device="cuda").int()
                kn = (torch.randn((b, sq, h_k, d), generator=gen, device="cuda") * 3).to(rows)
                vn = torch.randn((b, sq, h_k, d), generator=gen, device="cuda").to(rows)
                ref = [None if t is None else t.clone() for t in (kp, vp, ks, vs)]
                sc = dict(k_scales=ks, v_scales=vs) if quant else {}
                paged_append(kp, vp, kn, vn, bt, pos, **sc)
                paged_append_ref(ref[0], ref[1], kn, vn, bt, pos, ref[2], ref[3])
                torch.cuda.synchronize()
                eq = all(torch.equal(a[:n_pages].view(torch.uint8), w[:n_pages].view(torch.uint8))
                         for a, w in zip((kp, vp, ks, vs), ref) if a is not None)
                checks.append((f"append[{rows}->{pool},b={b},sq={sq},d={d}]", eq, 0.0))
    # K1: fp16 over fp16/int8/fp8 (decode, chunk, an odd page), f32 over f32/int8/fp8
    for q_dt, pools in ((torch.float16, (torch.float16, torch.int8, torch.float8_e4m3fn)),
                        (torch.float32, (torch.float32, torch.int8, torch.float8_e4m3fn))):
        for kv in pools:
            for b, sq, h, h_k, d, page, opts in ((4, 1, 8, 2, 128, 256, {}),
                                                (1, 40, 8, 2, 64, 64, {}),
                                                (2, 1, 8, 2, 128, 12, {}),
                                                (2, 3, 8, 2, 128, 32,
                                                 dict(softcap=20.0, window=(50, -1)))):
                n_pages, mp = 40, 16
                x = torch.randn((n_pages + 1, h_k, page, d), generator=gen, device="cuda")
                y = torch.randn((n_pages + 1, h_k, page, d), generator=gen, device="cuda")
                if kv in (torch.int8, torch.float8_e4m3fn):
                    name = "int8" if kv == torch.int8 else "fp8_e4m3"
                    kp, ks = quantize_kv(x, name)
                    vp, vs = quantize_kv(y, name)
                    sc = dict(k_scales=ks[..., 0].contiguous(), v_scales=vs[..., 0].contiguous())
                else:
                    kp, vp, sc = x.to(kv), y.to(kv), {}
                bt = torch.stack([torch.randperm(n_pages, generator=gen, device="cuda")[:mp]
                                  for _ in range(b)]).int()
                lens = torch.randint(sq, min(mp * page, 700), (b,), generator=gen,
                                     device="cuda").int()
                q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(q_dt)
                o, lse = paged_attention(q, kp, vp, bt, lens, **sc, **opts)
                o_ref, lse_ref = paged_attention_ref(q.cpu(), kp.cpu(), vp.cpu(), bt.cpu(),
                                                     lens.cpu(), num_splits=1,
                                                     **{k: v.cpu() for k, v in sc.items()},
                                                     **opts)
                err = float((o.float().cpu() - o_ref.float()).abs().max())
                lerr = float((lse.cpu() - lse_ref).abs().max())
                tol = 2e-2 if q_dt == torch.float16 else 1e-5
                checks.append((f"k1[{q_dt}/{kv},b={b},sq={sq},page={page},{sorted(opts)}]",
                               err <= tol and lerr <= 1e-3 and bool(torch.isfinite(o).all()),
                               err))
    # K3/K4: fp16 over fp16/int8/fp8 at m = 8, 256 and ragged 17; f32 over f32/int8/fp8
    for x_dt, ws in ((torch.float16, (torch.float16, torch.int8, torch.float8_e4m3fn)),
                     (torch.float32, (torch.float32, torch.int8, torch.float8_e4m3fn))):
        for w_dt in ws:
            for m, k, n in ((8, 4096, 1024), (256, 4096, 1024), (17, 200, 300), (1, 512, 136)):
                w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
                if w_dt in (torch.int8, torch.float8_e4m3fn):
                    wq, s = quantize_weight(w, w_dt)
                else:
                    wq, s = w.to(w_dt), None
                x = torch.randn((m, k), generator=gen, device="cuda").to(x_dt)
                y = _qmm_cuda(x, wq, s, "qmm.single")
                y_ref = quantized_matmul_ref(x, wq, s)
                y64 = x.double() @ wq.double()
                if s is not None:
                    y64 = y64 * s.double()
                err = float((y.double() - y64).abs().max())
                lp = float((y_ref.double() - y64).abs().max())
                checks.append((f"k3[{x_dt}/{w_dt},m={m},k={k},n={n}]", err <= 2 * lp + 1e-5,
                               err))
    for name, ok, err in checks:
        print(json.dumps(dict(case=name, ok=ok, max_abs_err=err)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", default="build,quick")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dtypes_bringup.py: no CUDA device")
    stages = args.stages.split(",")
    checks = []
    if "build" in stages:
        build()
    if "quick" in stages:
        quick(checks)
    if "phase" in stages:
        import chip_smoke

        sys.exit(chip_smoke.dtypes_phase_alone(args.out))
    bad = [c[0] for c in checks if not c[1]]
    print(json.dumps({"failed": bad, "n_checks": len(checks)}), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
