#!/usr/bin/env python3
"""K1, the row top-k, on the card: the package's kernel
(csrc/row_topk.cu) beside torch.topk at the detect path's shape.

    python3 tools/time_k1.py [--rounds 2]
        [--variant="[nvcc flags] [copy.cu]"]

Builds csrc/row_topk.cu and prints its ptxas report (registers, stack,
spills). At (B * 8400, 1203) = (67200, 1203), t = 64, on two inputs --
chip_smoke.k1_sparse_inputs (the detect path's regime: at most 63
candidates a row, most rows none) and chip_smoke.k1_inputs (most rows
hold more than t candidates: the dense branch) -- the kernel is held
bitwise to row_topk_plain (vals and cls) and its branch counts are
read back, then it is timed as device time (chip_smoke.graph_ms) in
`--rounds` rounds of kernel, topk, topk, kernel (torch.topk is a
yardstick the port never calls). With `--variant`, a second build (the
nvcc flags given, and a modified copy of the source with the same C
entry `row_topk_f32` in place of csrc/row_topk.cu where a .cu path is
given) has its ptxas report printed, is checked the same way, and is
timed in the same rounds (kernel, variant, topk, topk, variant,
kernel). An earlier design of the kernel is timed so, from a copy kept
under the gitignored build/:

    git show <commit>:wedetect_tpu_torch/csrc/row_topk.cu \\
        > build/row_topk_old.cu
    python3 tools/time_k1.py --variant=build/row_topk_old.cu

Prints one JSON line, then the nvidia-smi line. Needs a CUDA card.
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

from kernel_probe import build_variant  # noqa: E402


def ptxas_report(lib_path) -> list:
    """The ptxas lines of a library's build log (registers, stack,
    spills)."""
    return [ln.strip() for ln in lib_path.with_suffix(".log").read_text()
            .splitlines() if "ptxas info" in ln or "spill" in ln]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", default=None, metavar="ARGS",
                    help="also time a variant build: nvcc flags and an "
                    "optional .cu source, in one string")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k1: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops import _build
    from wedetect_tpu_torch.ops.row_topk import row_topk, row_topk_plain

    res = {"ptxas": ptxas_report(_build.build("row_topk"))}
    variant_fn = None
    if args.variant:
        vlib, vpath = build_variant(args.variant.split(), "row_topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        vlib.row_topk_f32.argtypes = [p, p, p, i, i, i, p]
        vlib.row_topk_f32.restype = ctypes.c_int
        res["variant"] = {"spec": args.variant, "ptxas": ptxas_report(vpath)}

        def variant_fn(x, t):
            r, k = x.shape
            vals = torch.empty((r, t), dtype=torch.float32, device=x.device)
            cls = torch.empty((r, t), dtype=torch.int32, device=x.device)
            err = vlib.row_topk_f32(x.data_ptr(), vals.data_ptr(),
                                    cls.data_ptr(), r, k, t,
                                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant: launch failed ({err})")
            return vals, cls

    dev = torch.device("cuda")
    rows, k, t = C.BATCH * 8400, C.N_CLASSES, C.T_ROW
    ok = True
    for name, x in (("sparse", C.k1_sparse_inputs(rows, k, dev, seed=1)),
                    ("dense", C.k1_inputs(rows, k, dev))):
        case = C.k1_check(x, t)
        case["bound_ms"] = C.k1_bound(rows, k, t, case["branches"])[
            "bound_ms"]
        ok = ok and case["match_plain"] and case["branches_match"]
        fns = {"kernel": lambda: row_topk(x, t),
               "topk": lambda: torch.topk(x, t, dim=1)}
        order = ["kernel", "topk", "topk", "kernel"]
        if variant_fn is not None:
            vv, vc = variant_fn(x, t)
            pv, pc = row_topk_plain(x, t)
            case["variant_match_plain"] = (C.bitwise_equal(vv, pv)
                                           and C.bitwise_equal(vc, pc))
            ok = ok and case["variant_match_plain"]
            del vv, vc, pv, pc
            fns["variant"] = lambda: variant_fn(x, t)
            order = ["kernel", "variant", "topk", "topk", "variant",
                     "kernel"]
        times = {name_: [] for name_ in fns}
        for _ in range(args.rounds):
            for fn in order:
                times[fn].append(C.graph_ms(fns[fn]))
        case.update({f"{fn}_ms": v for fn, v in times.items()})
        res[name] = case
        del x
    res["ok"] = ok
    print(json.dumps({"shape": [rows, k, t], **res}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
