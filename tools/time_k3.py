#!/usr/bin/env python3
"""K3's forward on the card: the package's route beside the SIMT kernel
it replaced and SDPA, at the ViT's shapes; and, with --variant, a
modified build of the f32 kernel timed in the same rounds.

    python3 tools/time_k3.py [--dtype bfloat16|float32] [--rounds 2]
        [--variant="[nvcc flags] [copy.cu]"]

At chip_smoke.K3_VIT (1, 1280, 16, 64; 80 pad tokens) and K3_TRAIN
(1, 4224, 16, 64; 80 pad), on chip_smoke.py's inputs (seed 0), in the
type `--dtype` (bfloat16 by default), the route (bf16: the wgmma kernel
of csrc/flash_attn_sm90.cu; f32: the FFMA kernel of
csrc/flash_attn_f32.cu) and the SIMT kernel (csrc/flash_attn.cu, which
neither type reaches at D = 64 any more) are checked against
flash_attention_plain (chip_smoke.K_TOL, lse within 1e-3), then all are
timed as device time (chip_smoke.graph_ms) in `--rounds` rounds, the
order reversed each round (simt, route, sdpa, sdpa, route, simt). SDPA
with a boolean mask is a yardstick the port never calls. In f32 the
route's walk is read back and held to the skip rule's map
(ops/flash_attention.fwd_walk_map), and the f32 kernel in the tile the
route does not take at that shape (ops/flash_attention.fwd_f32_tile) is
checked and timed in the same rounds ("other_tile").

With `--variant` (f32 only), a second build of csrc/flash_attn_f32.cu
(with the nvcc flags given, and from a modified copy with the same C
entries where a .cu path is given, e.g. with kR = 64 or kSUnroll = 2;
its headers are read from csrc/) has its ptxas report and SASS mix
printed beside the route's, is held at each shape to the plain version
(K_TOL, lse 1e-3, two launches bitwise equal) in the route's tile, has
its walk read back and compared with the skip rule's map in that tile
(with its own keys a tile, from its flash_attention_fwd_f32_keys entry),
and is timed in the same rounds, beside the route: the way to probe a
change to the kernel.

Prints one JSON line per shape, then (bf16) the blocks of the wgmma
kernel an SM holds (the CUDA occupancy calculator on the compiled
kernel), then the nvidia-smi line. Needs a CUDA card.
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
sys.path.insert(0, os.path.join(ROOT, "tools"))

from kernel_probe import build_variant, sass_report  # noqa: E402


def blocks_per_sm() -> int:
    from wedetect_tpu_torch.ops import flash_attention as fa

    fn = fa._sm90_lib().flash_attention_fwd_sm90_blocks_per_sm
    n = ctypes.c_int(0)
    err = fn(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"occupancy query failed with error {err}")
    return n.value


def check(C, o, lse, po, plse, dtype) -> dict:
    """An output against the plain version's: errors and the verdict."""
    lse_err = float((lse - plse).abs().max())
    return {"max_abs_err": float((o.float() - po.float()).abs().max()),
            "lse_err": lse_err,
            "match": C.kernel_close(o, po, dtype) and lse_err <= 1e-3
            and torch.equal(lse <= -1e29, plse <= -1e29)}


def walk(fa, fn, q, kw, rows, keys) -> dict:
    """A f32 forward's walk read back (fn takes `walked`) against the skip
    rule's map in its tile."""
    b, l, h, _ = q.shape
    rule = fa.fwd_walk_map(l, kw["causal"], kw["q_segment_ids"],
                           kw["kv_segment_ids"], rows=rows,
                           keys=keys).to(q.device)
    walked = torch.zeros((b, h, rule.shape[2]), dtype=torch.int32,
                         device=q.device)
    fn(walked)
    torch.cuda.synchronize()
    return {"rows": rows, "keys": keys, "tiles_walked": int(walked.sum()),
            "walk_matches_rule": torch.equal(
                walked, rule.sum(-1).int().expand(b, h, -1))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variant", default=None, metavar="ARGS",
                    help="also time a variant build of the f32 kernel: nvcc "
                    "flags and an optional .cu source, in one string")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k3: no CUDA device", file=sys.stderr)
        return 1
    if args.variant and args.dtype != "float32":
        print("time_k3: --variant builds the f32 kernel (--dtype float32)",
              file=sys.stderr)
        return 2
    import chip_smoke as C
    from wedetect_tpu_torch.ops import _build
    from wedetect_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    vlib = None
    if args.variant:
        route = sass_report(C, _build.build("flash_attn_f32"))
        vlib, vpath = build_variant(args.variant.split(), "flash_attn_f32")
        fa.type_fwd_f32(vlib)
        print(json.dumps({"route": route, "variant": {
            "spec": args.variant, **sass_report(C, vpath)}}), flush=True)
    dev = torch.device("cuda")
    ok = True
    for shape, case in (("vit", C.K3_VIT), ("train", C.K3_TRAIN)):
        b, l, h, d, n_real, causal = case
        q, k, v, seg = C.k3_case(dev, *case, dtype=dtype, seed=0)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
                  sm_scale=d ** -0.5)
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]
        calls = {
            "simt": lambda: C.simt_k3_fwd(q, k, v, seg, causal,
                                          d ** -0.5),
            "route": lambda: fa.flash_attention(q, k, v, return_lse=True,
                                                **kw),
            "sdpa": lambda: C.sdpa_gqa(q, k, v, mask)}
        rows, _ = fa.fwd_f32_tile(b, l, h, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        other = next(n for n in fa.FWD_F32_TILES if n != rows)
        if dtype == torch.float32:
            calls["other_tile"] = lambda: fa.flash_attention_fwd_f32(
                q, k, v, rows=other, **kw)
        if vlib is not None:
            def variant(walked=None):
                return fa._launch_fwd(
                    "variant", vlib.flash_attention_fwd_f32, q, k, v, seg,
                    seg, causal, d ** -0.5, rows,
                    None if walked is None else walked.data_ptr())

            calls["variant"] = variant
        po, plse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        r = {"shape": shape, "case": list(case), "dtype": args.dtype,
             "route": fa.fwd_route(dtype, d), "errors": {}}
        if dtype == torch.float32:
            r["tile_rows"] = rows
        for name in ("simt", "route", "other_tile", "variant"):
            if name not in calls:
                continue
            o, lse = calls[name]()
            o2, lse2 = calls[name]()
            torch.cuda.synchronize()
            r["errors"][name] = check(C, o, lse, po, plse, dtype)
            r["errors"][name]["deterministic"] = (
                C.bitwise_equal(o, o2) and C.bitwise_equal(lse, lse2))
            ok = ok and r["errors"][name]["match"]
            del o, lse, o2, lse2
        if dtype == torch.float32:
            r["walk"] = {"route": walk(
                fa, lambda w: fa.flash_attention_fwd_f32(q, k, v, walked=w,
                                                         **kw),
                q, kw, rows, fa.FWD_F32_TILES[rows])}
            if vlib is not None:
                r["walk"]["variant"] = walk(
                    fa, calls["variant"], q, kw, rows,
                    vlib.flash_attention_fwd_f32_keys(rows))
            ok = ok and all(w["walk_matches_rule"]
                            for w in r["walk"].values())
            ok = ok and all(e["deterministic"]
                            for n, e in r["errors"].items() if n != "simt")
        pairs = b * (n_real * n_real + (l - n_real) ** 2)
        r.update(C.attn_bound(h, d, pairs, 3 * q.numel(), q.numel(),
                              b * l * h, dtype))
        r["graph_ms"] = {name: [] for name in calls}
        order = list(calls)
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                r["graph_ms"][name].append(C.graph_ms(calls[name]))
        print(json.dumps(r), flush=True)
        del q, k, v, seg, mask, po, plse
    if dtype == torch.bfloat16:
        print(json.dumps({"flash_attention_fwd_sm90_blocks_per_sm":
                          blocks_per_sm()}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
