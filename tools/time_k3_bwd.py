#!/usr/bin/env python3
"""K3-bwd-dkv in f32 on the card: the package's route (the FFMA kernel of
csrc/flash_attn_bwd_f32.cu) beside the SIMT kernel it replaced and
SDPA's backward, at the SFT step's ViT shape.

    python3 tools/time_k3_bwd.py [--rounds 2]
        [--variant="[nvcc flags] [copy.cu]"]

Builds csrc/flash_attn_bwd_f32.cu and csrc/flash_attn_bwd.cu, prints the
FFMA kernel's ptxas report (registers, spills) and its SASS mix (FFMA
and shared-memory loads, whole and by innermost loop:
chip_smoke.sass_mix). At chip_smoke.K3_TRAIN (1, 4224, 16, 64; 80 pad
tokens in segment 0), on chip_smoke.py's inputs (seed 0), the route and
the SIMT kernel (which f32 at D = 64 no longer reaches) are checked
against flash_attention_bwd_plain (chip_smoke.TRAIN_BWD_TOL, the route
twice and bitwise equal), then both are timed as device time
(chip_smoke.graph_ms) in `--rounds` rounds of SIMT, f32, f32, SIMT, and
SDPA's backward once (a yardstick the port never calls). With
`--variant`, a second build of the kernel (with the nvcc flags given,
and from a modified copy of the source with the same C entry in place
of csrc/flash_attn_bwd_f32.cu where a .cu path is given; its headers are
read from csrc/) has its ptxas report and SASS mix printed, is checked
like the route, and is timed in the same rounds (SIMT, f32, variant,
variant, f32, SIMT): the way to probe a change to the kernel. Prints one
JSON line, then the nvidia-smi line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kernel_probe import build_variant, sass_report  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", default=None, metavar="ARGS",
                    help="also time a variant build: nvcc flags and an "
                    "optional .cu source, in one string")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k3_bwd: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops import _build
    from wedetect_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    res = sass_report(C, _build.build("flash_attn_bwd_f32"))
    _build.build("flash_attn_bwd")
    variant = None
    if args.variant:
        vlib, vpath = build_variant(args.variant.split(),
                                    "flash_attn_bwd_f32")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        vlib.flash_attention_bwd_dkv_f32.argtypes = ([p] * 10 + [i] * 5
                                                     + [f, p])
        vlib.flash_attention_bwd_dkv_f32.restype = ctypes.c_int
        res["variant"] = {"spec": args.variant, **sass_report(C, vpath)}

    dev = torch.device("cuda")
    dtype = torch.float32
    b, l, h, d, n_real, causal = C.K3_TRAIN
    (q, k, v, o, lse, do), kw = C.k3_bwd_run(dev, C.K3_TRAIN, dtype, seed=0)
    seg = kw["q_segment_ids"]
    delta = fa.row_delta(o, do)
    assert fa.dkv_route(dtype, d) == "f32"
    new = lambda: fa.flash_attention_bwd_dkv(  # noqa: E731
        q, k, v, do, lse, delta, **kw)
    old = lambda: C.simt_dkv(q, k, v, do, lse, delta, **kw)  # noqa: E731
    if args.variant:
        def variant():
            dk, dv = torch.empty_like(k), torch.empty_like(v)
            fa._launch_bwd("flash_attention_bwd_dkv_f32",
                           vlib.flash_attention_bwd_dkv_f32, q, k, v, do, lse,
                           delta, (dk, dv), q.shape, kw)
            return dk, dv
    launches = fa.flash_attention_bwd_dkv_f32.launches
    got, again = new(), new()
    simt = old()
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_dkv_f32.launches == launches + 2
    _, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    tol = C.TRAIN_BWD_TOL[dtype]
    res["rel_err"] = {n: C.rel_err(g, w) for n, g, w in
                      (("dk", got[0], pdk), ("dv", got[1], pdv))}
    res["simt_rel_err"] = {n: C.rel_err(g, w) for n, g, w in
                           (("dk", simt[0], pdk), ("dv", simt[1], pdv))}
    res["deterministic"] = all(C.bitwise_equal(a, a2)
                               for a, a2 in zip(got, again))
    ok = (res["deterministic"] and max(res["rel_err"].values()) <= tol
          and max(res["simt_rel_err"].values()) <= tol)
    if variant is not None:
        vg, vg2 = variant(), variant()
        torch.cuda.synchronize()
        var = res["variant"]
        var["rel_err"] = {n: C.rel_err(g, w) for n, g, w in
                          (("dk", vg[0], pdk), ("dv", vg[1], pdv))}
        var["deterministic"] = all(C.bitwise_equal(a, a2)
                                   for a, a2 in zip(vg, vg2))
        ok = ok and var["deterministic"] and max(
            var["rel_err"].values()) <= tol
        del vg, vg2
    del got, again, simt, pdk, pdv

    pairs = b * (n_real * n_real + (l - n_real) ** 2)
    res.update(C.attn_bwd_bound(h, d, pairs, q.numel(), k.numel(), b * l * h,
                                dtype, "dkdv"))
    res["rule_tiles_walked"] = int(fa.dkv_walk_map(l, causal, seg, seg,
                                                   lse).sum())
    order = (old, new, variant, variant, new, old) if variant else (
        old, new, new, old)
    turns = [[C.graph_ms(fn) for fn in order] for _ in range(args.rounds)]
    n = len(order)
    res["simt_ms"] = [t for r in turns for t in (r[0], r[n - 1])]
    res["f32_ms"] = [t for r in turns for t in (r[1], r[n - 2])]
    if variant is not None:
        res["variant"]["ms"] = [t for r in turns for t in r[2:4]]
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    res["sdpa_bwd_ms"] = C.sdpa_bwd_ms(q, k, v, mask, do, iters=5,
                                       timer=C.graph_ms)
    res["ok"] = ok
    print(json.dumps({"shape": list(C.K3_TRAIN), **res}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
