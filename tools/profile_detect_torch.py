#!/usr/bin/env python3
"""Where the port's detect step spends its time on the card.

    python3 tools/profile_detect_torch.py [--batch 8] [--bf16] [--table F]

Builds full-width WeDetect-Base (640x640, K = 1203, random weights and
random class embeddings, the head calibrated to a trained checkpoint's
score profile by chip_smoke.calibrate_head), then runs Detector.__call__ under torch.profiler and
prints one JSON line: wall time per call, device busy time per call
(the union of kernel intervals on the card) and so the device's idle
share, and the ops with the most device time. --table writes the full
profiler table to file F. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3   # us -> ms


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--table", default="",
                   help="write the full profiler table to this file")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_detect_torch: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.configs import TEXT_BASE
    from wedetect_tpu_torch.models.api import Detector
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kw = dict(compute_dtype="bfloat16") if args.bf16 else {}
    det = Detector.from_random("base", seed=0, device=dev,
                               num_classes=C.N_CLASSES, **kw)
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((C.N_CLASSES, TEXT_BASE.head_out), generator=g,
                    device=dev)
    det.reparameterize([str(i) for i in range(C.N_CLASSES)], embeds=w)
    h, wd = det.cfg.img_size
    images = list(torch.randint(
        0, 256, (args.batch, h, wd, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(2)).numpy())
    C.calibrate_head(det, np.stack(images), det._text_embeds,
                     det.cfg.test.score_thr)
    det(images)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            det(images)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.iters
    events = prof.events()
    busy = busy_ms(events) / args.iters
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=40)
    name = "bf16" if args.bf16 else "f32"
    if args.table:
        with open(args.table, "w") as f:
            f.write(table)
    top = sorted(prof.key_averages(),
                 key=lambda e: e.self_device_time_total, reverse=True)[:12]
    print(json.dumps({
        "profile": name, "batch": args.batch, "wall_ms": wall,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1 - busy / wall) if wall else None,
        "top": [{"op": e.key[:60], "device_ms":
                 e.self_device_time_total / 1e3 / args.iters,
                 "calls": e.count // args.iters} for e in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
