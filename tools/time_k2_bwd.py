#!/usr/bin/env python3
"""K2-bwd-dq in f32 on the card: the package's route (the FFMA kernel
gqa_flash_bwd_dq_f32 of csrc/flash_gqa_bwd_f32.cu) beside the SIMT
kernel it replaced and SDPA's backward, at the SFT step's decoder shape.

    python3 tools/time_k2_bwd.py [--rounds 2]
        [--variant="[nvcc flags] [copy.cu]"]

Builds csrc/flash_gqa_bwd_f32.cu and csrc/flash_attn_bwd.cu, prints the
FFMA library's ptxas report (registers, spills) and its SASS mix (FFMA
and shared-memory loads, whole and by innermost loop:
chip_smoke.sass_mix). At chip_smoke.K2_TRAIN (1, 2048, 16, 128 |
2048, 8; the last 795 keys invalid), on chip_smoke.py's inputs (seed 0),
the route and the SIMT kernel (which f32 at D = 128 no longer reaches)
are checked against the plain dq (chip_smoke.TRAIN_BWD_TOL, the route
twice and bitwise equal), the key tiles each row block walked are read
back from the kernel and compared with the skip rule's map
(ops/flash_gqa.dq_walk_map), then both kernels are timed as device time
(chip_smoke.graph_ms) in `--rounds` rounds of SIMT, f32, f32, SIMT, and
SDPA's backward once (a yardstick the port never calls). With
`--variant`, a second build of the source (with the nvcc flags given,
and from a modified copy of it with the same C entries where a .cu path
is given, e.g. with kQR = 32 for 32-row blocks; its headers are read
from csrc/) has its ptxas report and SASS mix printed, is checked
like the route, and is timed in the same rounds (SIMT, f32, variant,
variant, f32, SIMT): the way to probe a change to the kernel. Prints one
JSON line, then the nvidia-smi line. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
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
        print("time_k2_bwd: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops import _build
    from wedetect_tpu_torch.ops import flash_gqa as fg

    torch.backends.cuda.matmul.allow_tf32 = False
    res = sass_report(C, _build.build("flash_gqa_bwd_f32"))
    _build.build("flash_attn_bwd")
    variant = None
    if args.variant:
        vlib, vpath = build_variant(args.variant.split(), "flash_gqa_bwd_f32")
        fg.type_bwd_f32(vlib)
        res["variant"] = {"spec": args.variant, **sass_report(C, vpath)}

    dev = torch.device("cuda")
    dtype = torch.float32
    b, s, lk, h, kvh, d, causal, holes = C.K2_TRAIN
    g = h // kvh
    (q, k, v, valid, o, lse, do), kw = C.k2_bwd_run(dev, C.K2_TRAIN, dtype,
                                                    seed=0)
    delta = fg.row_delta(o, do, kvh)
    assert fg.dq_route(dtype, d, g) == "f32"
    new = lambda: fg.gqa_flash_bwd_dq(  # noqa: E731
        q, k, v, valid, do, lse, delta, **kw)
    old = lambda: C.simt_dq(q, k, v, valid, do, lse, delta, **kw)  # noqa
    if args.variant:
        def variant():
            dq = torch.empty_like(q)
            fg._launch_bwd("gqa_flash_bwd_dq", vlib.gqa_flash_bwd_dq_f32, q,
                           k, v, valid, do, lse, delta, (dq,), causal,
                           kw["sm_scale"], None)
            return dq
    launches = fg.gqa_flash_bwd_dq_f32.launches
    got, again = new(), new()
    simt = old()
    torch.cuda.synchronize()
    assert fg.gqa_flash_bwd_dq_f32.launches == launches + 2
    pdq, _, _ = fg.gqa_flash_attention_bwd_plain(q, k, v, valid, o, lse, do,
                                                 causal, kw["sm_scale"])
    tol = C.TRAIN_BWD_TOL[dtype]
    res["rel_err"] = C.rel_err(got, pdq)
    res["max_abs_err"] = float((got - pdq).abs().max())
    res["simt_rel_err"] = C.rel_err(simt, pdq)
    res["deterministic"] = C.bitwise_equal(got, again)
    ok = (res["deterministic"] and res["rel_err"] <= tol
          and res["simt_rel_err"] <= tol)
    if variant is not None:
        vg, vg2 = variant(), variant()
        torch.cuda.synchronize()
        var = res["variant"]
        var["rel_err"] = C.rel_err(vg, pdq)
        var["deterministic"] = C.bitwise_equal(vg, vg2)
        ok = ok and var["deterministic"] and var["rel_err"] <= tol
        del vg, vg2
    del got, again, simt, pdq

    # the walk, read back from the kernel and counted by the rule
    nrt = -(-s * g // fg.DQ_F32_ROWS)
    walked = torch.zeros((b, kvh, nrt), dtype=torch.int32, device=dev)
    fg.gqa_flash_bwd_dq_f32(q, k, v, valid, do, lse, delta,
                            torch.empty_like(q), walked=walked, **kw)
    rule = fg.dq_walk_map(s, lk, g, causal, valid, lse)
    res["tiles_walked"] = int(walked.sum())
    res["rule_tiles_walked"] = int(rule.sum())
    res["rule_tiles_scanned"] = int(fg.dq_walk_map(
        s, lk, g, causal, valid, torch.full_like(lse, float("-inf"))).sum())
    res["walk_matches_rule"] = torch.equal(walked, rule.sum(-1).int())
    ok = ok and res["walk_matches_rule"]

    pairs = C.k2_visible_pairs(s, lk, causal, valid)
    res.update(C.attn_bwd_bound(h, d, pairs, q.numel(), k.numel(), b * s * h,
                                dtype, "dq"))
    order = (old, new, variant, variant, new, old) if variant else (
        old, new, new, old)
    turns = [[C.graph_ms(fn) for fn in order] for _ in range(args.rounds)]
    n = len(order)
    res["simt_ms"] = [t for r in turns for t in (r[0], r[n - 1])]
    res["f32_ms"] = [t for r in turns for t in (r[1], r[n - 2])]
    if variant is not None:
        res["variant"]["ms"] = [t for r in turns for t in r[2:4]]
    mask = C.k2_mask(valid, s, lk)
    res["sdpa_bwd_ms"] = C.sdpa_bwd_ms(q, k, v, mask, do, iters=5,
                                       timer=C.graph_ms)
    res["ok"] = ok
    print(json.dumps({"shape": list(C.K2_TRAIN[:6]), **res}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
