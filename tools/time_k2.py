#!/usr/bin/env python3
"""K2's time on the card, split into device time and host time, beside
SDPA's, at the Ref path's prefix and suffix shapes.

    python3 tools/time_k2.py [--iters 50] [--dtype bfloat16 float32]

For each shape (chip_smoke.K2_PREFIX, K2_SUFFIX) and type, on
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
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k2: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops.flash_gqa import gqa_flash_attention

    dev = torch.device("cuda")
    for name, case in (("prefix", C.K2_PREFIX), ("suffix", C.K2_SUFFIX)):
        b, s, lk, h, kvh, d, causal, holes = case
        for dt in args.dtype:
            dtype = getattr(torch, dt)
            q, k, v, valid = C.k2_case(dev, *case, dtype=dtype, seed=0)
            qpos = lk - s + torch.arange(s, device=dev)
            mask = (valid.bool()[:, None, None, :]
                    & (torch.arange(lk, device=dev)[None, :]
                       <= qpos[:, None])[None, None])
            r = {"shape": name, "dtype": dt,
                 **C.attn_bound(h, d, C.k2_visible_pairs(s, lk, causal,
                                                         valid),
                                q.numel() + 2 * k.numel(), q.numel(),
                                b * s * h, dtype)}
            r["ms"], r["device_ms"], r["host_ms"], r["graph_ms"] = split(
                lambda: gqa_flash_attention(q, k, v, causal=True,
                                            kv_valid=valid), args.iters)
            (r["sdpa_ms"], r["sdpa_device_ms"], r["sdpa_host_ms"],
             r["sdpa_graph_ms"]) = split(
                lambda: C.sdpa_gqa(q, k, v, mask), args.iters)
            print(json.dumps(r), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
