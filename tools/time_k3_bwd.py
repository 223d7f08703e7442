#!/usr/bin/env python3
"""K3-bwd in f32 on the card: the package's route for dq or dk/dv (the
FFMA kernels of csrc/flash_attn_bwd_f32.cu) beside the SIMT kernel it
replaced and SDPA's backward, at the SFT step's ViT shape.

    python3 tools/time_k3_bwd.py [--kernel dq|dkv] [--rounds 2]
        [--variant="[nvcc flags] [copy.cu]"] [--variant-tile RxK]

Builds csrc/flash_attn_bwd_f32.cu and csrc/flash_attn_bwd.cu, prints the
FFMA library's ptxas report (registers, spills) and its SASS mix (FFMA
and shared-memory loads, whole and by innermost loop:
chip_smoke.sass_mix). At chip_smoke.K3_TRAIN (1, 4224, 16, 64; 80 pad
tokens in segment 0), on chip_smoke.py's inputs (seed 0), the route of
`--kernel` (default dkv) and the SIMT kernel (which f32 at D = 64 no
longer reaches) are checked against flash_attention_bwd_plain
(chip_smoke.TRAIN_BWD_TOL, the route twice and bitwise equal), the
route's walk is read back through its `walked` counts and held to the
skip rule's map (dq_walk_map, dkv_walk_map), then both are timed as
device time (chip_smoke.graph_ms) in `--rounds` rounds of SIMT, f32,
f32, SIMT, and SDPA's backward once (a yardstick the port never calls)
beside the f32 pair (the other product's route timed once). With
`--variant`, a second build of the library (with the nvcc flags given,
and from a modified copy of the source with the same C entries in place
of csrc/flash_attn_bwd_f32.cu where a .cu path is given; its headers
are read from csrc/) has its ptxas report and SASS mix printed, is
checked like the route (its walk read back too, held to the rule's map
in its own tile: `--variant-tile`, rows x keys, say 64x64 for a dq copy
with kQR = 64; the route's by default), and is timed in the same rounds
(SIMT, f32, variant, variant, f32, SIMT): the way to probe a change to
either kernel. Prints one JSON line, then the nvidia-smi
line. Needs a CUDA card.
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

# per product: the plain backward's outputs it checks and the bound's
# kind
GRADS = {"dq": ("dq",), "dkv": ("dk", "dv")}
BOUND_KIND = {"dq": "dq", "dkv": "dkdv"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("dq", "dkv"), default="dkv")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", default=None, metavar="ARGS",
                    help="also time a variant build: nvcc flags and an "
                    "optional .cu source, in one string")
    ap.add_argument("--variant-tile", default=None, metavar="RxK",
                    help="the variant's tile, rows x keys, for its walk "
                    "(default: the route's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k3_bwd: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops import _build
    from wedetect_tpu_torch.ops import flash_attention as fa

    product = args.kernel
    other = "dq" if product == "dkv" else "dkv"
    torch.backends.cuda.matmul.allow_tf32 = False
    res = sass_report(C, _build.build("flash_attn_bwd_f32"))
    _build.build("flash_attn_bwd")
    entry = f"flash_attention_bwd_{product}_f32"
    vfn = None
    if args.variant:
        vlib, vpath = build_variant(args.variant.split(),
                                    "flash_attn_bwd_f32")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        vfn = getattr(vlib, entry)
        vfn.argtypes = [p] * (8 + len(GRADS[product])) + [i] * 5 + [f, p, p]
        vfn.restype = ctypes.c_int
        res["variant"] = {"spec": args.variant, **sass_report(C, vpath)}

    dev = torch.device("cuda")
    dtype = torch.float32
    b, l, h, d, n_real, causal = C.K3_TRAIN
    (q, k, v, o, lse, do), kw = C.k3_bwd_run(dev, C.K3_TRAIN, dtype, seed=0)
    seg = kw["q_segment_ids"]
    delta = fa.row_delta(o, do)
    assert fa.dq_route(dtype, d) == "f32" and fa.dkv_route(dtype, d) == "f32"
    route = getattr(fa, f"flash_attention_bwd_{product}")
    new = lambda: route(q, k, v, do, lse, delta, **kw)  # noqa: E731
    simt = C.simt_k3_dq if product == "dq" else C.simt_dkv
    old = lambda: simt(q, k, v, do, lse, delta, **kw)  # noqa: E731

    def rule_for(rows, keys):
        """Tiles walked a block by the skip rule in a rows x keys tile."""
        m = fa.dkv_walk_map(l, causal, seg, seg, lse, rows=rows, keys=keys)
        return (m.transpose(-1, -2) if product == "dq" else m).sum(-1).int()

    rule = rule_for(*((fa.DQ_F32_ROWS, fa.DQ_F32_KEYS) if product == "dq"
                      else (fa.DKV_F32_ROWS, fa.DKV_F32_KEYS)))
    vrule = rule if args.variant_tile is None else rule_for(
        *map(int, args.variant_tile.split("x")))

    def as_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def variant(walked=None):
        outs = tuple(torch.empty_like(q) for _ in GRADS[product])
        fa._launch_bwd(entry, vfn, q, k, v, do, lse, delta, outs, q.shape,
                       kw, None if walked is None else walked.data_ptr())
        return outs

    def walk_of(fn, want):
        walked = torch.zeros_like(want)
        fn(walked)
        torch.cuda.synchronize()
        return torch.equal(walked, want), int(walked.sum())

    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    want = plain[:1] if product == "dq" else plain[1:]
    del plain
    tol = C.TRAIN_BWD_TOL[dtype]
    f32 = getattr(fa, entry)
    launches = f32.launches
    got, again = as_tuple(new()), as_tuple(new())
    ref = as_tuple(old())
    torch.cuda.synchronize()
    assert f32.launches == launches + 2
    res["rel_err"] = {n: C.rel_err(g, w)
                      for n, g, w in zip(GRADS[product], got, want)}
    res["simt_rel_err"] = {n: C.rel_err(g, w)
                           for n, g, w in zip(GRADS[product], ref, want)}
    res["deterministic"] = all(C.bitwise_equal(a, a2)
                               for a, a2 in zip(got, again))
    res["walk_matches_rule"], res["tiles_walked"] = walk_of(
        lambda w: f32(q, k, v, do, lse, delta, walked=w, **kw), rule)
    ok = (res["deterministic"] and res["walk_matches_rule"]
          and max(res["rel_err"].values()) <= tol
          and max(res["simt_rel_err"].values()) <= tol)
    if vfn is not None:
        vg, vg2 = variant(), variant()
        torch.cuda.synchronize()
        var = res["variant"]
        var["rel_err"] = {n: C.rel_err(g, w)
                          for n, g, w in zip(GRADS[product], vg, want)}
        var["deterministic"] = all(C.bitwise_equal(a, a2)
                                   for a, a2 in zip(vg, vg2))
        var["walk_matches_rule"], var["tiles_walked"] = walk_of(variant,
                                                                 vrule)
        ok = ok and var["deterministic"] and var["walk_matches_rule"] \
            and max(var["rel_err"].values()) <= tol
        del vg, vg2
    del got, again, ref, want

    pairs = b * (n_real * n_real + (l - n_real) ** 2)
    res.update(C.attn_bwd_bound(h, d, pairs, q.numel(), k.numel(), b * l * h,
                                dtype, BOUND_KIND[product]))
    res["rule_tiles_walked"] = int(rule.sum())
    order = (old, new, variant, variant, new, old) if vfn else (
        old, new, new, old)
    turns = [[C.graph_ms(fn) for fn in order] for _ in range(args.rounds)]
    n = len(order)
    res["simt_ms"] = [t for r in turns for t in (r[0], r[n - 1])]
    res["f32_ms"] = [t for r in turns for t in (r[1], r[n - 2])]
    if vfn is not None:
        res["variant"]["ms"] = [t for r in turns for t in r[2:4]]
    other_fn = getattr(fa, f"flash_attention_bwd_{other}")
    res[f"{other}_route_ms"] = C.graph_ms(
        lambda: other_fn(q, k, v, do, lse, delta, **kw))
    mask = (seg[:, :, None] == seg[:, None, :])[:, None]
    res["sdpa_bwd_ms"] = C.sdpa_bwd_ms(q, k, v, mask, do, iters=5,
                                       timer=C.graph_ms)
    pair = min(res["f32_ms"]) + res[f"{other}_route_ms"]
    res["pair_ms"], res["pair_over_sdpa"] = pair, pair / res["sdpa_bwd_ms"]
    res["ok"] = ok
    print(json.dumps({"kernel": product, "shape": list(C.K3_TRAIN), **res}),
          flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
