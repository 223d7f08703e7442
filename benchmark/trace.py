"""The profiled phase of a traced run: `torch.profiler` over a few
calls, reduced to the device's busy time, kernel times by name, and the
longest idle gaps named by what the host was doing.

The calls run with named ranges (`bench.<stage>`, from the entry's
`ranges()`) and no synchronising wrappers, so the device's timeline is
the window's own.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

TOP = 10


def union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi) outside every span."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def host_label(t: float, cpu: List[Tuple[float, float, str]]) -> str:
    """The innermost benchmark range and the innermost host op that
    cover time t."""
    rng, op = "", "idle"
    rng_start = op_start = float("-inf")
    for s, e, name in cpu:
        if s <= t < e:
            if name.startswith("bench."):
                if s >= rng_start:
                    rng, rng_start = name[6:], s
            elif s >= op_start:
                op, op_start = name, s
    return f"{rng}/{op}" if rng else op


def reduce(kernels: List[Tuple[float, float, str]],
           cpu: List[Tuple[float, float, str]], lo: float, hi: float
           ) -> dict:
    """kernels and cpu: (start_us, end_us, name). Returns busy_s,
    window_s, per-kernel seconds and the breakdown lists."""
    spans = [(s, e) for s, e, _ in kernels]
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in kernels:
        by_name[name] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    cpu = sorted(cpu)
    named = defaultdict(float)
    for s, e in idle:
        named[host_label(s, cpu)] += (e - s) / 1e6
    return {"busy_s": union_seconds(spans) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "kernels": dict(by_name),
            "breakdown": {
                "device_ops": [[n[:200], v] for n, v in ops],
                "idle_gaps": [[n[:200], v] for n, v in sorted(
                    named.items(), key=lambda kv: -kv[1])[:TOP]]}}


def profile(call, n: int, ranges, dev) -> dict:
    """Run call(0..n-1) under torch.profiler inside `ranges()` (the
    entry's named ranges) and reduce the trace."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with ranges(), torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("bench.window"):
            t0 = time.perf_counter()
            for j in range(n):
                call(j)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    kernels, cpu = [], []
    lo = hi = None
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                "bench."):
            # a range's own events on the device span its kernels; they
            # are no device work of their own
            if e.device_type != torch.autograd.DeviceType.CUDA:
                cpu.append((tr.start, tr.end, e.name))
                if e.name == "bench.window":
                    lo, hi = tr.start, tr.end
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((tr.start, tr.end, e.name))
        else:
            cpu.append((tr.start, tr.end, e.name))
            if e.name == "bench.window":
                lo, hi = tr.start, tr.end
    if lo is None:
        lo = min(s for s, _, _ in kernels + cpu)
        hi = lo + wall * 1e6
    out = reduce(kernels, cpu, lo, hi)
    out["calls"] = n
    return out
