#!/usr/bin/env python3
"""K2's time on the card, split into device time and host time, beside
SDPA's, at the Ref path's prefix and suffix shapes and the SFT step's
decoder shape; and, with --variant, a modified build of the f32 kernel
timed in turns with the route's.

    python3 tools/time_k2.py [--iters 50] [--dtype bfloat16 float32]
        [--shapes prefix suffix train] [--rounds 2]
        [--variant="[nvcc flags] [copy.cu]"]

For each shape (chip_smoke.K2_PREFIX, K2_SUFFIX, K2_TRAIN) and type, on
chip_smoke.py's inputs (seed 0), prints one JSON line:
- `ms`: CUDA events around `--iters` back-to-back calls of
  gqa_flash_attention, per call (chip_smoke.py's `call_ms`; when the host
  enqueues slower than the card runs, this is the host's rate);
- `device_ms`: the union of the card's kernel intervals per call under
  torch.profiler (the kernel alone);
- `graph_ms`: chip_smoke.graph_ms, the calls replayed from a CUDA graph
  (chip_smoke.py's `ms` for K2; it should read as `device_ms`);
- `host_ms`: wall time per call of enqueueing the calls, no sync;
- the same four for SDPA (`sdpa_*`, chip_smoke.sdpa_gqa; a yardstick
  the port never calls), and chip_smoke's bound.
With `--variant`, a second build of csrc/flash_gqa_f32.cu (with the nvcc
flags given, and from a modified copy with the same C entries where a
.cu path is given, e.g. with kWideK = 64; a change that takes a tile
past 227 KB of shared memory, such as kStages = 3 for the narrow one,
is refused at launch; its headers are read from csrc/) has its ptxas
report and SASS mix printed beside
the route's, and at each f32 shape, in the tile the route takes there
(ops/flash_gqa.fwd_f32_tile), is held to the plain version (K_TOL, lse
1e-3, two launches bitwise equal), has its walk read back and compared
with the skip rule's map in its own tiles (ops/flash_gqa.fwd_walk_map),
and is timed as device time (graph_ms) in `--rounds` rounds of route,
variant, variant, route: the way to probe a change to the kernel. One
JSON line a shape (`"variant"`), then the nvidia-smi line. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from kernel_probe import build_variant, sass_report  # noqa: E402


def split(fn, iters):
    """(events ms, device ms, host ms, graph ms) per call of fn."""
    import chip_smoke as C
    from profile_detect_torch import busy_ms
    from torch.profiler import ProfilerActivity, profile

    ms = C.cuda_ms(fn, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return ms, busy_ms(prof.events()) / iters, host, C.graph_ms(fn)


def variant_turns(C, fg, vlib, q, k, v, valid, rounds):
    """The variant library's kernel at one causal f32 shape: held to the
    plain version, its walk read back, and timed in turns with the route
    (route, variant, variant, route)."""
    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(d)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, _ = fg.fwd_f32_tile(b, s, g, kvh, sms)
    keys = vlib.gqa_flash_fwd_f32_keys(rows)
    walked = torch.zeros((b, kvh, -(-s * g // rows)), dtype=torch.int32,
                         device=q.device)

    def var(walked=None):
        return fg._launch_fwd("gqa_flash_attention", vlib.gqa_flash_fwd_f32,
                              q, k, v, valid, True, scale, rows,
                              None if walked is None else walked.data_ptr())

    o, lse = var(walked)
    o2, lse2 = var()
    po, plse = fg.gqa_flash_attention_plain(q, k, v, causal=True,
                                            kv_valid=valid, sm_scale=scale,
                                            return_lse=True)
    rule = fg.fwd_walk_map(s, lk, g, kvh, True, valid, rows=rows, keys=keys)
    res = {"rows": rows, "keys": keys,
           "max_abs_err": float((o - po).abs().max()),
           "lse_err": float((lse - plse).abs().max()),
           "deterministic": C.bitwise_equal(o, o2)
           and C.bitwise_equal(lse, lse2),
           "tiles_walked": int(walked.sum()),
           "walk_matches_rule": torch.equal(walked, rule.sum(-1).int())}
    res["ok"] = (res["deterministic"] and res["walk_matches_rule"]
                 and C.kernel_close(o, po, torch.float32)
                 and res["lse_err"] <= 1e-3
                 and torch.equal(lse <= -1e29, plse <= -1e29))
    del o, o2, lse, lse2, po, plse
    route = lambda: fg.gqa_flash_fwd_f32(q, k, v, valid, True,  # noqa
                                         scale)
    turns = [[C.graph_ms(f) for f in (route, var, var, route)]
             for _ in range(rounds)]
    res["route_ms"] = [t for r in turns for t in (r[0], r[3])]
    res["variant_ms"] = [t for r in turns for t in r[1:3]]
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    p.add_argument("--shapes", nargs="+", default=["prefix", "suffix",
                                                   "train"])
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--variant", default=None, metavar="ARGS",
                   help="also time a variant build of the f32 kernel: nvcc "
                   "flags and an optional .cu source, in one string")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k2: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops import _build
    from wedetect_tpu_torch.ops import flash_gqa as fg

    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    vlib = None
    if args.variant:
        route = sass_report(C, _build.build("flash_gqa_f32"))
        vlib, vpath = build_variant(args.variant.split(), "flash_gqa_f32")
        fg.type_fwd_f32(vlib)
        print(json.dumps({"route": route, "variant": {
            "spec": args.variant, **sass_report(C, vpath)}}), flush=True)
    dev = torch.device("cuda")
    shapes = {"prefix": C.K2_PREFIX, "suffix": C.K2_SUFFIX,
              "train": C.K2_TRAIN}
    for name in args.shapes:
        case = shapes[name]
        b, s, lk, h, kvh, d, causal, holes = case
        for dt in args.dtype:
            dtype = getattr(torch, dt)
            q, k, v, valid = C.k2_case(dev, *case, dtype=dtype, seed=0)
            mask = C.k2_mask(valid, s, lk)
            r = {"shape": name, "dtype": dt,
                 "route": fg.fwd_route(dtype, d, h // kvh),
                 **C.attn_bound(h, d, C.k2_visible_pairs(s, lk, causal,
                                                         valid),
                                q.numel() + 2 * k.numel(), q.numel(),
                                b * s * h, dtype)}
            r["ms"], r["device_ms"], r["host_ms"], r["graph_ms"] = split(
                lambda: fg.gqa_flash_attention(q, k, v, causal=True,
                                               kv_valid=valid), args.iters)
            (r["sdpa_ms"], r["sdpa_device_ms"], r["sdpa_host_ms"],
             r["sdpa_graph_ms"]) = split(
                lambda: C.sdpa_gqa(q, k, v, mask), args.iters)
            if vlib is not None and r["route"] == "f32":
                r["variant"] = variant_turns(C, fg, vlib, q, k, v, valid,
                                             args.rounds)
                ok = ok and r["variant"]["ok"]
            print(json.dumps(r), flush=True)
            del q, k, v, valid, mask
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
