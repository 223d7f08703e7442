"""The benchmark's driver: one cell, one seed, one window.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Everything that belongs to one cell is found by name:

- `BENCHMARK.json` (the checkout's root): the cell's configuration,
  traffic mix, chips and metrics;
- `benchmark/workloads/<cell>.json`: the entry that drives the program
  (`benchmark/entries/<entry>.py`) and the cell's correctness limits;
- `benchmark/configs/<config>.json`: the sizes as run;
- `benchmark/traffic/<traffic>.json`: the mix's parameters, whose
  `kind` names its generator, `benchmark/traffic/<kind>.py`;
- `benchmark/metrics/<metric>.py`: one reader a metric, `read(run)`,
  which returns a number or None (nothing to read: left out).

A run: set-up (timed by phase), a closed-loop window of `seconds`
(one client; each call is sent when the last returns), and with
`--trace 1` a span phase (the benchmark's own wrappers, synchronised)
and a profiled phase (`torch.profiler`, no wrappers but named ranges).
Then the program is freed and the plain reference checks a sample of
the window's answers, drawn from the seed. The last line of standard
output is the result; the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
OUT_DIR = ROOT / "build" / "benchmark"
# top-level module names the process may not hold once the window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "wedetect_tpu")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def forbidden_modules(modules=None) -> List[str]:
    """Names in sys.modules whose top-level name (before the first dot)
    is one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile of every value (inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    spec: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}.get(name)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(root / conf["file"])
    here = root / BENCH_DIR.name
    traffic = load_json(here / "traffic" / f"{wl['traffic']}.json")
    spec = load_json(here / "workloads" / f"{name}.json")
    return Cell(name=name, chips=wl["chips"], config=config,
                traffic=traffic, spec=spec,
                end_to_end=[m for m in bench["end_to_end"]
                            if applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if applies(m, name)])


class Phases:
    """Wall seconds of each set-up phase, in order."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    seconds: float = 0.0                 # the window's length
    calls: int = 0
    items: int = 0
    latencies_ms: List[float] = field(default_factory=list)
    setup_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional[dict] = None         # the profiled phase (trace.py)
    info: dict = field(default_factory=dict)   # the entry's shapes


def reader(name: str, root: Path = ROOT):
    """The `read` of benchmark/metrics/<name>.py, loaded by its path (a
    metric's name may hold dots)."""
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_module(cell: Cell):
    return importlib.import_module(f"benchmark.entries.{cell.spec['entry']}")


def traffic_module(cell: Cell):
    return importlib.import_module(f"benchmark.traffic.{cell.traffic['kind']}")


def device_info(dev) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def device_init(dev):
    """The CUDA context and the first convolution and matmul of each
    type, which load cuDNN and cuBLAS: the process's cost, whichever
    computes first (in a run, the reference's calibration), so it is
    paid here and counted in set-up."""
    import torch

    if dev.type != "cuda":
        return
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones((1, 8, 8, 8), device=dev, dtype=dt)
        torch.nn.functional.conv2d(x, torch.ones((8, 8, 3, 3), device=dev,
                                                 dtype=dt))
        x.flatten(1) @ x.flatten(1).T
    sync(dev)


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_window(session, run: Run, seconds: float, keep: set, dev):
    """The closed loop: calls back to back for `seconds`; the outputs of
    the calls in `keep` are kept for the check."""
    outputs, failed = {}, 0
    t0 = time.perf_counter()
    i = 0
    while True:
        start = time.perf_counter()
        if start - t0 >= seconds:
            break
        try:
            items, out = session.call(i)
        except Exception as e:          # a failed call counts, the loop goes on
            print(f"call {i} failed: {e!r}", file=sys.stderr)
            failed += 1
            items, out = 0, None
        end = time.perf_counter()
        run.latencies_ms.append((end - start) * 1e3)
        run.items += items
        if i in keep and out is not None:
            outputs[i] = out
        i += 1
    run.seconds = time.perf_counter() - t0
    run.calls = i
    # sampled calls the window did not reach are made after it, untimed
    for j in sorted(keep):
        if j >= i:
            try:
                outputs[j] = session.call(j)[1]
            except Exception as e:
                print(f"call {j} failed: {e!r}", file=sys.stderr)
                failed += 1
    return outputs, failed


def traced_phases(session, run: Run, dev, first: int):
    """The span phase and then the profiled phase, over the same calls."""
    from benchmark import trace

    n = session.trace_calls
    with session.spans() as rec:
        for j in range(n):
            session.call(first + j)
        sync(dev)
    run.spans, run.counters = rec.spans, rec.counters
    run.trace = trace.profile(lambda j: session.call(first + j), n,
                              session.ranges, dev)


def run_cell(name: str, seed: int, seconds: float, trace: int, device: str,
             t_start: float, overrides: Optional[dict] = None,
             control: bool = False, faults=None,
             record: Optional[dict] = None) -> dict:
    """One run of a cell. Returns the result line's object (with the
    compared numbers under "check", last). With `control`, the entry's
    control (the reference in fp8) answers the sampled calls in the
    program's place, and no window runs. `record`, where given, gets
    the run's record (write_record) as well."""
    phases = Phases()
    with phases("imports"):
        import numpy as np
        import torch
    cell = load_cell(name)
    for part, kw in (overrides or {}).items():
        target = cell.traffic if part == "traffic" else cell.config[part]
        target.update(kw)
    dev = torch.device(device)
    with phases("device_init"):
        device_init(dev)
    entry = entry_module(cell)
    ctx = dict(cell=cell, seed=seed, device=dev, phases=phases,
               faults=faults or {}, traffic=traffic_module(cell))
    session = entry.setup(**ctx)
    ctx["info"] = session.info
    run = Run(cell=cell, info=session.info)
    keep = session.check_sample(np.random.default_rng(seed))
    failed = 0
    if not control:
        with phases("warmup"):
            session.warmup()
            sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        # the reference's own work at set-up (the head's calibration) is
        # not the program's set-up
        run.setup_s = (time.perf_counter() - t_start
                       - phases.seconds.get("reference", 0.0))
        outputs, failed = run_window(session, run, seconds, keep, dev)
        if trace:
            traced_phases(session, run, dev, run.calls)
    device = device_info(dev)
    inputs = {i: session.inputs_of(i) for i in keep}
    session.close()
    del session
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if control:
        with phases("control"):
            outputs = entry.control(ctx, inputs)
    inputs = {i: inputs[i] for i in outputs}
    with phases("check"):
        numbers = entry.check(ctx, inputs, outputs)
    limits = cell.spec["limits"]
    checked = {k: {"value": v, "limit": limits[k]}
               for k, v in numbers.items() if k in limits}
    # answers that never came or could not be read: an exact count
    checked["missing_answers"] = {"value": sum(
        v for k, v in numbers.items()
        if k.endswith(("missing", "malformed"))), "limit": 0}
    correct = (failed == 0 and len(outputs) > 0
               and len(checked) == len(limits) + 1
               and all(c["value"] <= c["limit"] for c in checked.values()))
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted if not control else ():
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.calls,
              "failed": failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = run.trace["breakdown"]
    rec = write_record(cell, seed, trace, phases, run, numbers)
    if record is not None:
        record.update(rec)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    result["check"] = checked
    return result


def write_record(cell, seed, trace, phases, run, numbers):
    """The run's set-up split and its readings, under build/benchmark/."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lat = sorted(run.latencies_ms)
    rec = {"workload": cell.name, "seed": seed, "trace": trace,
           "setup_s": run.setup_s, "setup_phases_s": phases.seconds,
           "calls": run.calls, "items": run.items,
           "window_s": run.seconds, "check": numbers,
           "latency_ms": {"min": lat[0], "p50": percentile(lat, 50),
                          "p90": percentile(lat, 90),
                          "p95": percentile(lat, 95), "max": lat[-1],
                          "first": run.latencies_ms[:5]} if lat else {},
           "counters": run.counters,
           "calibration": run.info.get("calibration")}
    with open(OUT_DIR / f"{cell.name}-last.json", "w") as f:
        json.dump(rec, f, indent=1)
    return rec


# ------------------------------------------------------- reader helpers
def span_ms_per_call(run: Run, name: str) -> Optional[float]:
    """The span's milliseconds a call of the span phase, or None where
    no call went through it."""
    calls = run.counters.get("calls", 0)
    if not calls or name not in run.spans:
        return None
    return sum(run.spans[name]) / calls


def kernel_seconds(run: Run, names) -> float:
    """Device seconds of the profiled phase's kernels whose name holds
    any of `names`."""
    if run.trace is None:
        return 0.0
    return sum(s for k, s in run.trace["kernels"].items()
               if any(n in k for n in names))


def idle_pct(run: Run) -> Optional[float]:
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
