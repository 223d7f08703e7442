#!/usr/bin/env python3
"""Readings for the limits of a cell's correctness check: the numbers
compared, on many seeds, from the program as the configuration states
it, from the control (the plain reference in fp8, the precision below
the configurations' bfloat16, in the program's place:
benchmark/reference/lowp.py), and from the program with a planted
fault (benchmark/faults.py). The benchmark's runs never run the control
or a fault; this tool runs them one seed after another in one process
(each seed makes its own weights and inputs), the program's runs with a
short window each at the cell's own load and sizes, and prints one
JSON line a run.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3
        [--control-seeds 4,5,6] [--fault selection --fault-seeds 7,8]
        [--seconds 5]
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.run import cache_env  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    cache_env()
    import torch

    from benchmark.harness import run_cell

    if not torch.cuda.is_available():
        raise SystemExit("readings need a CUDA card")
    from benchmark.faults import FAULTS

    def seeds(text, kind):
        return [(int(s), kind) for s in text.split(",") if s]

    plan = (seeds(a.seeds, "program") + seeds(a.control_seeds, "control")
            + seeds(a.fault_seeds, a.fault))
    for seed, kind in plan:
        t0 = time.perf_counter()
        with (FAULTS[kind]() if kind in FAULTS
              else contextlib.nullcontext()):
            rec = {}
            r = run_cell(a.workload, seed, a.seconds, 0, "cuda", t0,
                         control=kind == "control", record=rec)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "run": kind, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "readings": rec["check"],
                          "metrics": {k: v["value"] for k, v in
                                      r["metrics"].items()},
                          "setup_phases_s": rec["setup_phases_s"],
                          "run_s": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
