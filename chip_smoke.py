#!/usr/bin/env python3
"""Drive the PyTorch port (`wedetect_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   card name and power limit (nvidia-smi), TF32 flags (both
            set off: the f32 runs are true f32).
2. build    nvcc builds every kernel of the port (csrc/*.cu), all
            sources at once, into build/kernels/; ptxas's report.
3. k1       the row top-k kernel against its plain PyTorch version at
            the detect path's shape (B*8400, 1203), t = 64, on rows
            with -inf masks, ties and full masks, plus edge shapes
            (both kernel paths, K not a multiple of 32); vals and cls
            must agree bitwise. Times the kernel, the plain version
            and torch.topk (a yardstick only).
4. text     the full XLM-R base text tower, random init, on 1203 random
            token-id prompts -> (1203, 768) unit vectors; 8 prompts
            checked against the same tower on the CPU.
5. detect   WeDetect-Base at full width (depths 3/3/27/3, dims
            128..1024, neck repeats 12), 640x640, K = 1203, random
            init, biases calibrated as a trained checkpoint's are (at
            most 63 candidates per anchor above score_thr), B = 8
            images through Detector.__call__, with K1's launch count
            read around that call; the sparse selection from the kernel
            against the plain version on the same scores; f32 and bf16
            step times.
6. parity   a miniature detector on the card against the same weights
            on the CPU (forward to 1e-3; NMS slots exact on the same
            scores, through the kernel on the card).
7. uni      WeDetect-Uni-Base forward_raw at B = 1.

Then the kernels line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA card, or without the rest
of the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores
T_ROW = 64                  # ops/nms.ROW_TOPK_T
N_CLASSES = 1203            # LVIS vocabulary
BATCH = 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean wall time of fn() over iters calls, synchronized."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phases
def phase_device():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "nvidia_smi": nvidia_smi(),
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from wedetect_tpu_torch.ops import _build

    names = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    secs = time.perf_counter() - t0
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip(), flush=True)
    emit({"phase": "build", "kernels": names, "seconds": secs})


def k1_inputs(rows: int, k: int, dev, seed: int = 0) -> torch.Tensor:
    """Thresholded-score-like rows: a per-row share of lanes masked to
    -inf (from none to all), every 5th row quantized to 4 levels (ties),
    every 97th row fully masked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((rows, k), generator=g, device=dev)
    keep = torch.rand((rows, 1), generator=g, device=dev)
    mask = torch.rand((rows, k), generator=g, device=dev) < keep
    ties = torch.arange(rows, device=dev)[:, None] % 5 == 0
    x = torch.where(ties, torch.floor(x * 4) / 4, x)
    x = torch.where(mask, x, float("-inf"))
    x[::97] = float("-inf")
    return x.contiguous()


def phase_k1(dev, rows: int, k: int, timing: bool = True):
    from wedetect_tpu_torch.ops.row_topk import row_topk, row_topk_plain

    checks = []
    for r, kk, t in ((rows, k, T_ROW), (333, 37, 37), (256, 80, 64),
                     (256, 1280, 64), (200, 2000, 64), (64, 33, 1)):
        x = k1_inputs(r, kk, dev, seed=kk)
        kv, kc = row_topk(x, t)
        pv, pc = row_topk_plain(x, t)
        same = bitwise_equal(kv, pv) and bitwise_equal(kc, pc)
        checks.append({"rows": r, "k": kk, "t": t, "match": same})
        if not same:
            emit({"phase": "k1", "checks": checks})
            raise AssertionError(f"row_topk disagrees at {(r, kk, t)}")
    x = k1_inputs(rows, k, dev)
    kv, _ = row_topk(x, T_ROW)
    pv, _ = row_topk_plain(x, T_ROW)
    fin = torch.isfinite(pv)
    max_abs_err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    res = {"rows": rows, "k": k, "t": T_ROW, "max_abs_err": max_abs_err,
           "checks": checks}
    # the least time the card could take: each input byte read once,
    # each output byte written once; t*K compare-selects per row
    nbytes = rows * k * 4 + rows * T_ROW * 8
    ops = rows * k * T_ROW
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    res.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               bytes=nbytes, compare_selects=ops)
    if timing:
        res["ms"] = cuda_ms(lambda: row_topk(x, T_ROW), iters=20)
        res["plain_ms"] = cuda_ms(lambda: row_topk_plain(x, T_ROW), iters=3,
                                  warmup=1)
        res["library_ms"] = cuda_ms(lambda: torch.topk(x, T_ROW, dim=1),
                                    iters=20)
    emit({"phase": "k1", **res})
    return res


def phase_text(dev, cfg, n_prompts: int, seq: int = 16):
    from wedetect_tpu_torch.models.api import build_text_tower

    tower = build_text_tower(cfg, dev, seed=0)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(3, cfg.vocab_size, (n_prompts, seq), generator=g)
    lens = torch.randint(3, seq + 1, (n_prompts,), generator=g)
    pos = torch.arange(seq)[None, :]
    ids[:, 0] = 0                                         # <s>
    ids = torch.where(pos == lens[:, None] - 1, 2, ids)   # </s>
    mask = (pos < lens[:, None]).to(torch.int32)
    ids = torch.where(mask.bool(), ids, cfg.pad_token_id)
    ids_d, mask_d = ids.to(dev), mask.to(dev)
    with torch.inference_mode():
        emb = tower(ids_d, mask_d)
        torch.cuda.synchronize()
        ms = host_ms(lambda: tower(ids_d, mask_d), iters=3)
        norms = torch.linalg.vector_norm(emb, dim=-1)
        assert emb.shape == (n_prompts, cfg.head_out), emb.shape
        assert torch.isfinite(emb).all()
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-4)
        cpu = build_text_tower(cfg, "cpu")
        cpu.load_state_dict(tower.state_dict())
        ref = cpu(ids[:8], mask[:8])
        err = float((emb[:8].cpu() - ref).abs().max())
        assert err < 1e-4, err
    emit({"phase": "text", "prompts": n_prompts, "seq": seq,
          "shape": list(emb.shape), "ms": ms, "cpu_max_abs_err": err})
    return emb


@contextlib.contextmanager
def plain_row_topk():
    """Route ops/nms through row_topk_plain (the reference side of a
    comparison)."""
    from wedetect_tpu_torch.ops import nms
    from wedetect_tpu_torch.ops.row_topk import row_topk_plain

    saved = nms.row_topk
    nms.row_topk = row_topk_plain
    try:
        yield
    finally:
        nms.row_topk = saved


def calibrate_head(det, images, w, score_thr: float):
    """Give the random head a trained checkpoint's score profile: scale
    every level's logit_scale so the logits spread by about 2 across
    classes, then shift every level's bias so the largest per-anchor
    64th logit sits just below logit(score_thr). No anchor then holds
    more than 63 candidates, the selection takes its sparse (row top-k)
    branch, and the highest-scoring anchors keep up to 63 each."""
    from wedetect_tpu_torch.models import wedetect as W

    heads = det.model.bbox_head.cls_contrasts
    logits = W.forward_raw(det.cfg, det.model, images, w).logits.float()
    scale = math.log(2.0 / float(logits.std(dim=-1).mean()))
    with torch.no_grad():
        for c in heads:
            c.logit_scale += scale
    logits = W.forward_raw(det.cfg, det.model, images, w).logits.float()
    kth = torch.topk(logits, T_ROW, dim=-1).values[..., -1]
    shift = math.log(score_thr / (1 - score_thr)) - float(kth.max()) - 0.01
    with torch.no_grad():
        for c in heads:
            c.bias += shift
    return scale, shift


def check_detections(results, size: int, k: int, thr: float, dims: int):
    n = 0
    for r in results:
        b = r["bboxes"]
        assert np.isfinite(b).all() and (b >= 0).all() and (b <= size).all()
        assert ((r["labels"] >= 0) & (r["labels"] < k)).all()
        assert ((r["scores"] > thr) & (r["scores"] <= 1)).all()
        assert r["embeddings"].shape == (len(b), dims)
        n += len(b)
    return n


def phase_detect(dev, size: str, k: int, batch: int, text_embeds,
                 timing: bool = True, **cfg_kw):
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.ops import nms
    from wedetect_tpu_torch.ops.row_topk import row_topk

    det = Detector.from_random(size, seed=0, device=dev, num_classes=k,
                               **cfg_kw)
    det.reparameterize([f"class_{i}" for i in range(k)], embeds=text_embeds)
    cfg = det.cfg
    h, w = cfg.img_size
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (batch, h, w, 3), generator=g,
                           dtype=torch.uint8).numpy()
    thr = cfg.test.score_thr
    scale, shift = calibrate_head(det, images, det._text_embeds, thr)

    # the sparse selection through the kernel vs the plain version
    dec = W.forward_raw(cfg, det.model, images, det._text_embeds)
    per_anchor = int((dec.scores > thr).sum(-1).max())
    assert per_anchor < T_ROW, per_anchor
    nms_pre = min(cfg.test.nms_pre, cfg.num_anchors * k)
    with torch.inference_mode():
        got = nms._batched_select_topk(dec.scores, thr, nms_pre, None, T_ROW)
        with plain_row_topk():
            want = nms._batched_select_topk(dec.scores, thr, nms_pre, None,
                                            T_ROW)
    sel_match = all(bitwise_equal(a, b) for a, b in zip(got, want))
    assert sel_match, "sparse selection: kernel != plain"
    n_cand = int((dec.scores > thr).sum())
    del dec, got, want

    # the main path: Detector.__call__, K1's count read around it
    row_topk.launches = 0
    results = det(list(images), score_thr=thr)
    launches = row_topk.launches
    assert launches > 0, "the detect path did not launch row_topk"
    n_det = check_detections(results, max(h, w), k, thr, cfg.embed_dims)
    slots = W.detect_step(cfg, det.model, images, det._text_embeds,
                          np.ones((batch, 2), np.float32),
                          np.zeros((batch, 4), np.float32),
                          np.full((batch, 2), h, np.float32))
    assert slots.boxes.shape == (batch, cfg.test.max_per_img, 4)
    assert slots.embeds.shape == (batch, cfg.test.max_per_img,
                                  cfg.embed_dims)
    res = {"size": size, "k": k, "batch": batch, "img": [h, w],
           "logit_scale_shift": scale, "bias_shift": shift,
           "max_candidates_per_anchor": per_anchor,
           "candidates": n_cand, "sparse_selection_match": sel_match,
           "row_topk_launches": launches, "detections": n_det,
           "valid_slots": int(slots.valid.sum())}
    if timing:
        call = lambda: det(list(images), score_thr=thr)  # noqa: E731
        sf = np.ones((batch, 2), np.float32)
        pad = np.zeros((batch, 4), np.float32)
        ori = np.full((batch, 2), h, np.float32)
        step = lambda: W.detect_step(  # noqa: E731
            cfg, det.model, images, det._text_embeds, sf, pad, ori)
        fwd = lambda: W.forward_raw(  # noqa: E731
            cfg, det.model, images, det._text_embeds)
        args = [torch.from_numpy(a).to(dev) for a in (sf, pad, ori)]
        for name, c in (("f32", cfg), ("bf16", dataclasses.replace(
                cfg, compute_dtype="bfloat16"))):
            det.cfg = det.model.cfg = c
            dec = fwd()
            row_topk.launches = 0
            r = res[name] = {"call_ms": host_ms(call, 5)}
            r["row_topk_launches_per_call"] = row_topk.launches / 6
            r["detect_step_ms"] = host_ms(step, 5)
            r["forward_raw_ms"] = host_ms(fwd, 5)
            r["postprocess_ms"] = host_ms(
                lambda: W.postprocess(c, dec, *args), 5)
            r["img_per_s"] = batch * 1e3 / r["call_ms"]
            del dec
        det.cfg = det.model.cfg = cfg
    emit({"phase": "detect", **res})
    return res


def phase_parity(dev):
    """A miniature detector on `dev` against the same weights on the
    CPU: forward to 1e-3; NMS slots exact on identical scores."""
    from wedetect_tpu_torch.configs import ModelCfg, TestCfg
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.ops import nms

    cfg = ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                   neck_scale=0.25, neck_repeats=2,
                   head_in_channels=(32, 64, 128), embed_dims=32,
                   img_size=(64, 64), text=None, num_classes=8,
                   test=TestCfg(nms_pre=256, max_per_img=16, score_thr=0.3))
    cpu = W.init_variables(cfg, seed=3, device="cpu")
    card = W.init_variables(cfg, seed=3, device=dev)
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                           dtype=torch.uint8).numpy()
    w = torch.randn((8, 32), generator=g).numpy()
    a = W.forward_raw(cfg, cpu, images, w)
    b = W.forward_raw(cfg, card, images, w)
    err = float((a.logits - b.logits.cpu()).abs().max())
    assert err < 1e-3, err
    saved = nms.TOPK_THRESHOLD_MIN_N
    nms.TOPK_THRESHOLD_MIN_N = 1   # route this tiny case through K1
    try:
        sf = np.ones((2, 2), np.float32)
        pad = np.zeros((2, 4), np.float32)
        ori = np.full((2, 2), 64, np.float32)
        dec_cpu = W.DetectorOutputs(*(x.cpu() for x in b))
        ta = W.postprocess(cfg, dec_cpu, *(torch.from_numpy(x)
                                           for x in (sf, pad, ori)))
        tb = W.postprocess(cfg, b, *(torch.from_numpy(x).to(dev)
                                     for x in (sf, pad, ori)))
    finally:
        nms.TOPK_THRESHOLD_MIN_N = saved
    same = all(bitwise_equal(x, y.cpu()) for x, y in zip(ta, tb))
    assert same, "NMS slots differ between the card and the CPU"
    emit({"phase": "parity", "forward_max_abs_err": err,
          "nms_slots_match": same, "valid": int(ta.valid.sum())})


def phase_uni(dev):
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.models.api import Detector

    det = Detector.from_random("uni_base", seed=0, device=dev)
    cfg = det.cfg
    h, w = cfg.img_size
    images = np.zeros((1, h, w, 3), np.uint8)
    out = W.forward_raw(cfg, det.model, images)
    assert out.scores.shape == (1, cfg.num_anchors, cfg.num_prompts)
    assert torch.isfinite(out.scores).all() and torch.isfinite(out.boxes).all()
    ms = host_ms(lambda: W.forward_raw(cfg, det.model, images), 5)
    emit({"phase": "uni", "scores_shape": list(out.scores.shape),
          "forward_raw_ms": ms})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from wedetect_tpu_torch.configs import TEXT_BASE

    dev = torch.device("cuda")
    phase_device()
    phase_build()
    k1 = phase_k1(dev, BATCH * 8400, N_CLASSES)
    text_embeds = phase_text(dev, TEXT_BASE, N_CLASSES)
    detect = phase_detect(dev, "base", N_CLASSES, BATCH, text_embeds)
    phase_parity(dev)
    phase_uni(dev)
    emit({"kernels": [{
        "name": "row_topk", "route": "cuda",
        "source": "wedetect_tpu_torch/csrc/row_topk.cu",
        "replaces": "wedetect_tpu/ops/pallas_topk.py:46",
        "launches": detect["row_topk_launches"],
        "max_abs_err": k1["max_abs_err"], "tolerance": 0.0, "match": True,
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"]}]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
