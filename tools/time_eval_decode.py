#!/usr/bin/env python3
"""Detection evaluation on the card with the native JPEG decoder and
with cv2, in turns: what the decoder costs or saves end to end.

    python3 tools/time_eval_decode.py [--rounds 1] [--out FILE]

chip_smoke.py's eval set (write_eval_dataset: 50 seeded JPEGs of
480-1000 px, LVIS over 1203 classes), WeDetect-Base 640x640, B = 8,
random weights and a seeded unit text bank, the head calibrated as the
eval phase's (eval_calibrate). Each round runs eval/runner.evaluate_coco
(LVIS) in f32 and in bf16, through the native decoder
(native.decode_letterbox: cv2's libjpeg-turbo and the C++ letterbox),
through it with fast_decode (libjpeg's DCT-scaled decode), and with it
switched off, so that every file takes data/loader.letterbox_file's cv2
path (cv2.imread + ops/letterbox.preprocess_image), in the order
native, cv2, fast, fast, cv2, native. Each run's img/s, loader wait a
batch, detect ms and evaluator share (chip_smoke.eval_split), and its
mAP; the decoders' mAPs may differ (their pixels do, by 1-3 LSB).
Prints one JSON line a run, then a summary line, then the nvidia-smi
line; `--out` also writes the runs as JSON. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def cv2_decode():
    """native.decode_letterbox switched off: every file through cv2."""
    from wedetect_tpu_torch import native

    saved = native.decode_letterbox
    native.decode_letterbox = lambda *args, **kw: None
    try:
        yield
    finally:
        native.decode_letterbox = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_eval_decode: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from wedetect_tpu_torch.data.coco import CocoDetDataset
    from wedetect_tpu_torch.data.loader import EvalLoader
    from wedetect_tpu_torch.eval.runner import evaluate_coco
    from wedetect_tpu_torch.models.api import Detector

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    bank = torch.nn.functional.normalize(
        torch.randn(C.N_CLASSES, 768, generator=g), dim=-1)
    runs = []
    with tempfile.TemporaryDirectory(prefix="wedetect_evdec_") as tmp:
        root = Path(tmp)
        lvis, _ = C.write_eval_dataset(root, C.EVAL_IMAGES, C.N_CLASSES,
                                       C.EVAL_COCO_CLASSES)
        ds = CocoDetDataset(lvis, str(root))
        det = Detector.from_random("base", seed=0, device=dev,
                                   num_classes=C.N_CLASSES)
        det.reparameterize(ds.class_names, embeds=bank)
        cfg, w = det.cfg, det._text_embeds
        batches = [b["images"] for b in EvalLoader(ds, cfg.img_size,
                                                   C.BATCH)]
        C.eval_calibrate(det, batches, w, cfg.test.score_thr)
        del batches

        def run(decoder, c):
            det.cfg = det.model.cfg = c
            t = {}
            t0 = time.perf_counter()
            with (cv2_decode() if decoder == "cv2"
                  else C.fast_decode_loader() if decoder == "fast"
                  else contextlib.nullcontext()):
                m = evaluate_coco(c, det.model, ds, w, batch_size=C.BATCH,
                                  timings=t, lvis=True)
            t["wall_ms"] = (time.perf_counter() - t0) * 1e3
            return {"decoder": decoder, "dtype": c.compute_dtype,
                    "mAP": m["mAP"], "AP50": m["AP50"], **C.eval_split(t)}

        types = (cfg, dataclasses.replace(cfg, compute_dtype="bfloat16"))
        for c in types:                      # warm-up: cuDNN, K1's build
            run("native", c)
        for _ in range(args.rounds):
            for decoder in ("native", "cv2", "fast", "fast", "cv2",
                            "native"):
                for c in types:
                    r = run(decoder, c)
                    runs.append(r)
                    C.emit({"run": len(runs), **r})
    summary = {}
    for decoder in ("native", "fast", "cv2"):
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in runs if r["decoder"] == decoder
                  and r["dtype"] == dtype]
            summary[f"{decoder}_{dtype}"] = {
                k: [r[k] for r in rs] for k in
                ("img_per_s", "loader_wait_ms_per_batch", "detect_ms",
                 "host_eval_share")}
    C.emit({"images": C.EVAL_IMAGES,
            "summary": summary})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs,
                                              "summary": summary}))
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
