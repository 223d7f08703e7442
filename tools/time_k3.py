#!/usr/bin/env python3
"""K3's bf16 forward on the card: the package's route (the wgmma kernel
of csrc/flash_attn_sm90.cu) beside the SIMT kernel it replaced and SDPA,
at the ViT's shapes.

    python3 tools/time_k3.py [--rounds 2]

At chip_smoke.K3_VIT (1, 1280, 16, 64; 80 pad tokens) and K3_TRAIN
(1, 4224, 16, 64; 80 pad), on chip_smoke.py's inputs (seed 0), the
route and the SIMT kernel (csrc/flash_attn.cu, which bf16 at D = 64 no
longer reaches) are checked against flash_attention_plain
(chip_smoke.K_TOL, lse within 1e-3), then all three are timed as device
time (chip_smoke.graph_ms) in `--rounds` rounds, the order reversed each
round (a, b, c, c, b, a). SDPA with a boolean mask is a yardstick the
port never calls. Prints one JSON line per shape, then the blocks of the
wgmma kernel an SM holds (the CUDA occupancy calculator on the compiled
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


def blocks_per_sm() -> int:
    from wedetect_tpu_torch.ops import flash_attention as fa

    fn = fa._sm90_lib().flash_attention_fwd_sm90_blocks_per_sm
    n = ctypes.c_int(0)
    err = fn(ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"occupancy query failed with error {err}")
    return n.value


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_k3: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    ok = True
    for shape, case in (("vit", C.K3_VIT), ("train", C.K3_TRAIN)):
        b, l, h, d, n_real, causal = case
        q, k, v, seg = C.k3_case(dev, *case, dtype=torch.bfloat16, seed=0)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
                  sm_scale=d ** -0.5)
        mask = (seg[:, :, None] == seg[:, None, :])[:, None]
        calls = {
            "route": lambda: fa.flash_attention(q, k, v, **kw),
            "simt": lambda: fa._launch_fwd(
                "simt", fa._lib().flash_attention_fwd, q, k, v, seg, seg,
                causal, d ** -0.5, 1),
            "sdpa": lambda: C.sdpa_gqa(q, k, v, mask)}
        po, plse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        r = {"shape": shape, "case": list(case),
             "route": fa.fwd_route(q.dtype, d), "errors": {}}
        for name in ("route", "simt"):
            o, lse = (fa.flash_attention(q, k, v, return_lse=True, **kw)
                      if name == "route" else calls[name]())
            torch.cuda.synchronize()
            lse_err = float((lse - plse).abs().max())
            r["errors"][name] = {
                "max_abs_err": float((o.float() - po.float()).abs().max()),
                "lse_err": lse_err,
                "match": C.kernel_close(o, po, torch.bfloat16)
                and lse_err <= 1e-3}
            ok = ok and r["errors"][name]["match"]
        pairs = b * (n_real * n_real + (l - n_real) ** 2)
        r.update(C.attn_bound(h, d, pairs, 3 * q.numel(), q.numel(),
                              b * l * h, torch.bfloat16))
        r["graph_ms"] = {name: [] for name in calls}
        order = list(calls)
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                r["graph_ms"][name].append(C.graph_ms(calls[name]))
        print(json.dumps(r), flush=True)
    print(json.dumps({"flash_attention_fwd_sm90_blocks_per_sm":
                      blocks_per_sm()}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
