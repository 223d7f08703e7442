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
4. k2       the grouped-KV flash kernel against gqa_flash_attention_plain
            at the Ref path's prefix (1, 384, 16, 128 | 384, 8) and
            suffix (8, 256, 16, 128 | 640, 8) shapes with kv_valid
            holes, on the JAX test grid and on fully masked rows, f32
            (atol 1e-4) and bf16 (atol 2e-3 + rtol 1e-2: one bf16 ulp
            of |O| at every magnitude), O and lse; times the
            kernel, the plain version and SDPA with enable_gqa and a
            boolean mask (a yardstick only).
5. k3       the same for the ViT's flash kernel at (1, 1280, 16, 64)
            with 80 pad tokens in segment 0, and square causal.
6. text     the full XLM-R base text tower, random init, on 1203 random
            token-id prompts -> (1203, 768) unit vectors; 8 prompts
            checked against the same tower on the CPU.
7. detect   WeDetect-Base at full width (depths 3/3/27/3, dims
            128..1024, neck repeats 12), 640x640, K = 1203, random
            init, biases calibrated as a trained checkpoint's are (at
            most 63 candidates per anchor above score_thr), B = 8
            images through Detector.__call__, with K1's launch count
            read around that call; the sparse selection from the kernel
            against the plain version on the same scores; f32 and bf16
            step times.
8. parity   a miniature detector on the card against the same weights
            on the CPU (forward to 1e-3; NMS slots exact on the same
            scores, through the kernel on the card).
9. uni      WeDetect-Uni-Base forward_raw at B = 1.
10. ref_parity  a miniature Ref (head_dim 128) on the card, through K2
            and K3, against the same weights on the CPU (logits 1e-5).
11. ref     WeDetect-Ref at ref_2b's full width (ViT 24 x 1024, decoder
            28 x 2048, 16 q / 8 kv heads, vocab 151936), random init
            from seed 0 on the card: the top 100 proposals of a random
            Uni-Base on a seeded 480x640 image, 8 queries through a
            character-level stub tokenizer, RefScorer.score with prefix
            sharing. Scores (8, 100) finite in (0, 1); K2 = 56 and
            K3 = 24 launches counted around the call; the pre-sigmoid
            logits agree with the same call through the kernels' plain
            versions (REF_LOGIT_TOL), while a control through the plain
            versions with one key masked in every attention call must
            miss that limit; the joint path (prefix_sharing=False)
            agrees with the split one (f32 limit). ms per call, prefix
            and suffix stage ms, f32 and bf16.

12. k2_bwd the grouped-KV backward kernels (K2-bwd-dq, K2-bwd-dkdv)
            against gqa_flash_attention_bwd_plain at the training path's
            decoder shape (1, 2048, 16, 128 | 2048, 8), square causal,
            the last 795 keys invalid, and on the JAX test grid, f32 and
            bf16: dq, dk, dv within a limit relative to each gradient's
            largest entry (TRAIN_BWD_TOL); a control through the plain
            backward with one 64-key tile dropped must miss it; the two
            kernels run twice and agree bitwise. Times each kernel, the
            plain backward and SDPA's backward (autograd.grad through
            scaled_dot_product_attention minus its forward; a yardstick).
13. k3_bwd the same for the ViT's backward kernels (K3-bwd-dq,
            K3-bwd-dkv) at (1, 4224, 16, 64) with 80 pad tokens in
            segment 0, and square causal.
14. train_parity  a miniature Ref (head_dim 128) takes one stage-3
            ref_sft_step on the card and one on the CPU from the same
            weights: loss, grad_norm and every gradient within 1e-5
            (relative), the updated parameters too (TRAIN_PARAM_RULE);
            every parameter has a gradient on the card; K2 = K2-bwd-dq =
            K2-bwd-dkdv = layers and K3 = K3-bwd-dq = K3-bwd-dkv = depth.
15. train_grad  one stage-3 loss and gradient at ref_2b's full width
            (random weights) at the --grid-tokens 256 bucket (ViT and
            decoder L = 1024), through the kernels and through the plain
            forward and backward versions: the loss difference, the
            relative L2 error of each parameter group's gradient and of
            grad_norm within TRAIN_GRAD_TOL, and a control with one key
            tile dropped in every backward call that must miss it.
16. train   cli/train_ref.train_ref_loop, stage 3, ref_2b at full width
            in f32 with the CLI defaults (--grid-tokens 1024: ViT
            L = 4144 padded to 4224; --seq-buckets 1024 2048 4096: L =
            2048; 100 proposals; lr 1e-5 cosine; ref_optimizer, vision
            frozen): the seeded image, two seeded ground-truth boxes and
            the Uni proposals -> soft labels -> 3 SFT steps. Finite
            losses, the vision tower bitwise unchanged, out_proj and the
            decoder changed, launches per step as in train_parity; ms
            per step (steps 2-3) and peak card memory.

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
BF16_OPS_PER_S = 989e12     # bf16 dense, tensor cores
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
            r = res[name] = {"call_ms": host_ms(call, 3)}
            r["row_topk_launches_per_call"] = row_topk.launches / 4
            r["detect_step_ms"] = host_ms(step, 3)
            r["forward_raw_ms"] = host_ms(fwd, 3)
            r["postprocess_ms"] = host_ms(
                lambda: W.postprocess(c, dec, *args), 3)
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


# ------------------------------------------------------- K2 and K3
def attn_bound(h, d, pairs, elems_in, elems_out, rows, dtype):
    """The least time for an attention forward: 4*H*D FLOPs per visible
    (query, key) pair (pairs summed over the batch) at the type's peak,
    against q, k, v read once and O and lse written once at the memory
    rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (elems_in + elems_out) * size + rows * 4
    flops = 4.0 * h * d * pairs
    peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "flops": flops, "bytes": nbytes}


def k2_case(dev, b, s, lk, h, kvh, d, causal, holes, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for shape in ((b, s, h, d), (b, lk, kvh, d),
                             (b, lk, kvh, d)))
    valid = torch.ones((b, lk), dtype=torch.int32, device=dev)
    for lo, hi in holes:
        valid[:, lo:hi] = 0
    return q, k, v, valid


def k2_visible_pairs(s, lk, causal, valid):
    qpos = (lk - s if causal else 0) + torch.arange(s, device=valid.device)
    kpos = torch.arange(lk, device=valid.device)
    ok = valid.bool()[:, None, :]
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])[None]
    return int(ok.sum())


# the Ref path's shapes (ref_2b, a 480x640 image, <= 8 queries): the
# prefix (332 real tokens padded to 384) and the suffix rows (prefix +
# 256 suffix slots, a short query's tail padded)
K2_PREFIX = (1, 384, 384, 16, 8, 128, True, ((332, 384),))
K2_SUFFIX = (8, 256, 640, 16, 8, 128, True, ((332, 384), (600, 640)))
K2_GRID = [  # tests/test_flash_gqa.py's grid, and fully masked rows
    (2, 128, 384, 4, 2, 128, True, ()),
    (1, 128, 128, 4, 1, 128, True, ()),
    (2, 128, 640, 8, 2, 128, True, ((312, 320), (635, 640))),
    (1, 256, 256, 8, 8, 128, False, ((120, 128), (251, 256))),
    (1, 128, 512, 16, 8, 128, True, ((248, 256), (507, 512))),
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),
]
# (atol, rtol) of kernel vs plain. f32: summation order only. bf16:
# both round the same f32 value to bf16, at most one bf16 ulp of |O|
# apart, and 2e-3 + 1e-2 |O| is above one ulp at every magnitude
K_TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (2e-3, 1e-2)}


def kernel_close(o, po, dtype) -> bool:
    atol, rtol = K_TOL[dtype]
    return torch.allclose(o.float(), po.float(), atol=atol, rtol=rtol)


def sdpa_gqa(q, k, v, mask):
    """The library yardstick: one scaled_dot_product_attention call over
    the same grouped KV with a boolean mask (the port never calls it)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True).transpose(1, 2)


def phase_k2(dev, timing: bool = True):
    from wedetect_tpu_torch.ops.flash_gqa import (gqa_flash_attention,
                                                  gqa_flash_attention_plain)

    checks, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate([K2_PREFIX, K2_SUFFIX, *K2_GRID]):
            b, s, lk, h, kvh, d, causal, holes = case
            q, k, v, valid = k2_case(dev, *case, dtype=dtype, seed=i)
            o, lse = gqa_flash_attention(q, k, v, causal=causal,
                                         kv_valid=valid, return_lse=True)
            torch.cuda.synchronize()
            po, plse = gqa_flash_attention_plain(
                q, k, v, causal=causal, kv_valid=valid, return_lse=True)
            err = float((o.float() - po.float()).abs().max())
            lse_err = float((lse - plse).abs().max())
            ok = kernel_close(o, po, dtype) and lse_err <= 1e-3
            checks.append({"shape": [b, s, lk, h, kvh, d], "causal": causal,
                           "dtype": str(dtype)[6:], "max_abs_err": err,
                           "lse_err": lse_err, "match": ok})
            if not ok:
                emit({"phase": "k2", "checks": checks})
                raise AssertionError(f"K2 disagrees at {case} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    res = {"checks": checks,
           "max_abs_err_f32": worst[torch.float32],
           "max_abs_err_bf16": worst[torch.bfloat16]}
    if timing:
        for name, case in (("prefix", K2_PREFIX), ("suffix", K2_SUFFIX)):
            b, s, lk, h, kvh, d, causal, holes = case
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, valid = k2_case(dev, *case, dtype=dtype, seed=0)
                pairs = k2_visible_pairs(s, lk, causal, valid)
                qpos = lk - s + torch.arange(s, device=dev)
                mask = (valid.bool()[:, None, None, :]
                        & (torch.arange(lk, device=dev)[None, :]
                           <= qpos[:, None])[None, None])
                r = attn_bound(h, d, pairs, q.numel() + 2 * k.numel(),
                               q.numel(), b * s * h, dtype)
                r["ms"] = cuda_ms(lambda: gqa_flash_attention(
                    q, k, v, causal=True, kv_valid=valid), iters=10)
                r["plain_ms"] = cuda_ms(lambda: gqa_flash_attention_plain(
                    q, k, v, causal=True, kv_valid=valid), iters=3,
                    warmup=1)
                r["library_ms"] = cuda_ms(lambda: sdpa_gqa(q, k, v, mask),
                                          iters=10)
                r["visible_pairs"] = pairs
                res[f"{name}_{str(dtype)[6:]}"] = r
    emit({"phase": "k2", **res})
    return res


K3_VIT = (1, 1280, 16, 64, 1200, False)      # 480x640: 1200 real tokens
K3_CASES = [K3_VIT, (1, 1280, 16, 64, 1280, True), (2, 256, 4, 128, 200,
                                                      False)]


def k3_case(dev, b, l, h, d, n_real, causal, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    seg = (torch.arange(l, device=dev) < n_real).to(torch.int32)
    return q, k, v, seg[None].expand(b, l).contiguous()


def phase_k3(dev, timing: bool = True):
    from wedetect_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    checks, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(K3_CASES):
            b, l, h, d, n_real, causal = case
            q, k, v, seg = k3_case(dev, *case, dtype=dtype, seed=i)
            kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
                      sm_scale=d ** -0.5, return_lse=True)
            o, lse = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            po, plse = flash_attention_plain(q, k, v, **kw)
            err = float((o[:, :n_real].float()
                         - po[:, :n_real].float()).abs().max())
            pad_err = float((o.float() - po.float()).abs().max())
            lse_err = float((lse - plse).abs().max())
            ok = kernel_close(o, po, dtype) and lse_err <= 1e-3
            checks.append({"shape": [b, l, h, d], "real": n_real,
                           "causal": causal, "dtype": str(dtype)[6:],
                           "max_abs_err": err, "all_rows_err": pad_err,
                           "lse_err": lse_err, "match": ok})
            if not ok:
                emit({"phase": "k3", "checks": checks})
                raise AssertionError(f"K3 disagrees at {case} {dtype}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    res = {"checks": checks, "max_abs_err_f32": worst[torch.float32],
           "max_abs_err_bf16": worst[torch.bfloat16]}
    if timing:
        b, l, h, d, n_real, causal = K3_VIT
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, seg = k3_case(dev, *K3_VIT, dtype=dtype, seed=0)
            pairs = b * (n_real * n_real + (l - n_real) ** 2)
            mask = (seg[:, :, None] == seg[:, None, :])[:, None]
            r = attn_bound(h, d, pairs, 3 * q.numel(), q.numel(),
                           b * l * h, dtype)
            kw = dict(q_segment_ids=seg, kv_segment_ids=seg,
                      sm_scale=d ** -0.5)
            r["ms"] = cuda_ms(lambda: flash_attention(q, k, v, **kw),
                              iters=10)
            r["plain_ms"] = cuda_ms(lambda: flash_attention_plain(
                q, k, v, **kw), iters=3, warmup=1)
            r["library_ms"] = cuda_ms(lambda: sdpa_gqa(q, k, v, mask),
                                      iters=10)
            res[f"vit_{str(dtype)[6:]}"] = r
    emit({"phase": "k3", **res})
    return res


# ---------------------------------------------------------------- Ref
class CharTok:
    """Stub tokenizer: one id per character, clear of Qwen's special ids
    (151643 and up), no truncation."""

    def encode(self, text, add_special_tokens=False):
        return [1000 + ord(ch) % 5000 for ch in text]


REF_QUERIES = ["the red car on the left", "a person", "dog",
               "the largest window", "a bicycle near the wall",
               "white cup", "the man in a blue shirt", "tree"]


# pre-sigmoid logits, kernels vs plain versions at full width (logits
# span -4.76..-3.89 here), each limit between the H100 readings of the
# kernels (f32 6.7e-6, bf16 0.063) and of the control below (f32 0.150,
# bf16 0.174). The bf16 gap is narrow: bf16 rounding through 52 layers
# moves the logits almost as far as a dropped key tile; k2 and k3 hold
# the bf16 kernels tightly
REF_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
# the control's wrong attention: one 64-key tile masked in every call
REF_CONTROL_DROP = slice(64, 128)


class PlainFn(torch.autograd.Function):
    """A kernel's plain forward and plain backward as one autograd op:
    fwd(q, k, v) -> (O, lse); bwd(q, k, v, O, lse, dO) -> grads."""

    @staticmethod
    def forward(ctx, fwd, bwd, q, k, v):
        o, lse = fwd(q, k, v)
        ctx.bwd = bwd
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (None, None, *ctx.bwd(q, k, v, o, lse, do.contiguous()))


def _dropped_valid(k, kv_valid, drop):
    if drop is None:
        return kv_valid
    kv = (torch.ones(k.shape[:2], dtype=torch.int32, device=k.device)
          if kv_valid is None else kv_valid.clone())
    kv[:, drop] = 0
    return kv


def _dropped_segs(q, seg, drop):
    if drop is None:
        return seg
    seg = (torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
           if seg is None else seg.clone())
    seg[:, drop] = -1
    return seg


@contextlib.contextmanager
def plain_attention(drop: slice | None = None,
                    bwd_drop: slice | None = None):
    """Route the attention dispatch through K2's and K3's plain forward
    and plain backward versions (the reference side of a comparison).
    With `drop`, those key positions are masked in every call, forward
    and backward; with `bwd_drop`, in every backward call only: wrong
    attention or wrong gradients, the controls that show a comparison
    can fail."""
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    def gqa(q, k, v, *, causal=True, kv_valid=None, sm_scale=None):
        scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
        kv = _dropped_valid(k, kv_valid, drop)
        kvb = _dropped_valid(k, kv, bwd_drop)
        return PlainFn.apply(
            lambda q, k, v: fg.gqa_flash_attention_plain(
                q, k, v, causal=causal, kv_valid=kv, sm_scale=scale,
                return_lse=True),
            lambda q, k, v, o, lse, do: fg.gqa_flash_attention_bwd_plain(
                q, k, v, kvb, o, lse, do, causal, scale), q, k, v)

    def flash(q, k, v, *, q_segment_ids=None, kv_segment_ids=None,
              causal=False, sm_scale=1.0):
        qs = q_segment_ids
        if (drop is not None or bwd_drop is not None) and qs is None:
            qs = torch.zeros(q.shape[:2], dtype=torch.int32,
                             device=q.device)
            kv_segment_ids = qs
        ks = _dropped_segs(q, kv_segment_ids, drop)
        ksb = _dropped_segs(q, ks, bwd_drop)
        return PlainFn.apply(
            lambda q, k, v: fa.flash_attention_plain(
                q, k, v, q_segment_ids=qs, kv_segment_ids=ks, causal=causal,
                sm_scale=sm_scale, return_lse=True),
            lambda q, k, v, o, lse, do: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, q_segment_ids=qs, kv_segment_ids=ksb,
                causal=causal, sm_scale=sm_scale), q, k, v)

    saved = fg.gqa_flash_attention, fa.flash_attention
    fg.gqa_flash_attention, fa.flash_attention = gqa, flash
    try:
        yield
    finally:
        fg.gqa_flash_attention, fa.flash_attention = saved


def _stage_timer(ref_api, acc):
    """Wrap ref_api's prefix and suffix steps with synchronized host
    clocks (only for the stage breakdown)."""
    def wrap(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            acc[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run
    return {n: wrap(n, getattr(ref_api, f"ref_{n}_step"))
            for n in ("prefix", "suffix")}


def _flash_counters():
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    return {"k2": fg.gqa_flash_attention, "k2_bwd_dq": fg.gqa_flash_bwd_dq,
            "k2_bwd_dkdv": fg.gqa_flash_bwd_dkdv, "k3": fa.flash_attention,
            "k3_bwd_dq": fa.flash_attention_bwd_dq,
            "k3_bwd_dkv": fa.flash_attention_bwd_dkv}


def launch_counts(reset: bool = False):
    """The launch counts of the six attention kernels (set to 0 first
    with `reset`)."""
    counters = _flash_counters()
    if reset:
        for fn in counters.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in counters.items()}


def expected_counts(k2=0, k3=0, k2_bwd=0, k3_bwd=0):
    return {"k2": k2, "k2_bwd_dq": k2_bwd, "k2_bwd_dkdv": k2_bwd, "k3": k3,
            "k3_bwd_dq": k3_bwd, "k3_bwd_dkv": k3_bwd}


def ref_inputs(dev):
    """The Ref phase's inputs: a seeded 480x640 image and the top 100
    proposals of a random Uni-Base on it (score_thr 0, as the Ref CLI
    asks for them)."""
    from wedetect_tpu_torch.models.api import Detector

    g = torch.Generator().manual_seed(3)
    image = torch.randint(0, 256, (480, 640, 3), generator=g,
                          dtype=torch.uint8).numpy()
    uni = Detector.from_random("uni_base", seed=0, device=dev)
    return image, uni([image], score_thr=0.0)[0]["bboxes"][:100]


def phase_ref(dev, inputs, cfg=None, timing: bool = True):
    """ref_2b (or `cfg`) at full width, random weights, through
    RefScorer.score on a 480x640 image (`inputs`: ref_inputs)."""
    from wedetect_tpu_torch.models import ref_api
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    image, boxes = inputs
    n = len(boxes)
    assert n > 0, "no proposals"
    t0 = time.perf_counter()
    model = init_ref_variables(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    res = {"params": sum(p.numel() for p in model.parameters()),
           "init_s": time.perf_counter() - t0, "proposals": n,
           "queries": len(REF_QUERIES)}
    tok = CharTok()
    for name in ("float32", "bfloat16"):
        scorer = ref_api.RefScorer(cfg=cfg, model=model, tokenizer=tok,
                                   dtype=name, device=dev)
        launch_counts(reset=True)
        scores = scorer.score(image, boxes, REF_QUERIES)
        counts = launch_counts()
        assert scores.shape == (len(REF_QUERIES), n), scores.shape
        assert np.isfinite(scores).all()
        assert ((scores > 0) & (scores < 1)).all()
        assert counts == expected_counts(k2=2 * cfg.text.layers,
                                         k3=cfg.vision.depth), counts
        logits = scorer.logits(image, boxes, REF_QUERIES)
        with plain_attention():
            plain = scorer.logits(image, boxes, REF_QUERIES)
        with plain_attention(drop=REF_CONTROL_DROP):
            wrong = scorer.logits(image, boxes, REF_QUERIES)
        tol = REF_LOGIT_TOL[name]
        r = res[name] = {
            "launches": counts, "tolerance": tol,
            "plain_logit_max_abs_err": float(np.abs(logits - plain).max()),
            "control_logit_max_abs_err": float(np.abs(wrong - plain).max()),
            "plain_logit_mean_abs_err": float(np.abs(logits - plain).mean()),
            "control_logit_mean_abs_err": float(
                np.abs(wrong - plain).mean()),
            "logit_range": [float(plain.min()), float(plain.max())],
            "score_range": [float(scores.min()), float(scores.max())]}
        ok = r["plain_logit_max_abs_err"] <= tol < r[
            "control_logit_max_abs_err"]
        if name == "float32":
            joint = ref_api.RefScorer(cfg=cfg, model=model, tokenizer=tok,
                                      prefix_sharing=False, device=dev)
            launch_counts(reset=True)
            jl = joint.logits(image, boxes, REF_QUERIES)
            r["joint_launches"] = launch_counts()
            r["joint_logit_max_abs_err"] = float(np.abs(jl - logits).max())
            ok = (ok and r["joint_logit_max_abs_err"] <= tol
                  and r["joint_launches"]["k2"] == cfg.text.layers)
            if ok and timing:
                r["joint_score_ms"] = host_ms(
                    lambda: joint.score(image, boxes, REF_QUERIES), 2)
        if not ok:
            emit({"phase": "ref", "dtype": name, **r})
            raise AssertionError(f"Ref {name}: logits out of limits")
        if timing:
            call = lambda: scorer.score(image, boxes, REF_QUERIES)  # noqa
            r["score_ms"] = host_ms(call, 3)
            with plain_attention():
                r["plain_score_ms"] = host_ms(call, 2)
            acc = {"prefix": [], "suffix": []}
            saved = ref_api.ref_prefix_step, ref_api.ref_suffix_step
            timed = _stage_timer(ref_api, acc)
            ref_api.ref_prefix_step = timed["prefix"]
            ref_api.ref_suffix_step = timed["suffix"]
            try:
                for _ in range(3):
                    call()
            finally:
                ref_api.ref_prefix_step, ref_api.ref_suffix_step = saved
            r["prefix_stage_ms"] = float(np.mean(acc["prefix"]))
            r["suffix_stage_ms"] = float(np.mean(acc["suffix"]))
        emit({"phase": "ref", "dtype": name, **r})
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "ref_model", "params": res["params"],
          "init_s": res["init_s"], "proposals": n,
          "peak_mem_gb": res["peak_mem_gb"]})
    return res


def phase_ref_parity(dev):
    """A miniature Ref (head_dim 128, so K2 tiles) on the card through
    both kernels against the same weights on the CPU (einsum)."""
    from wedetect_tpu_torch.models.ref import (init_ref_variables,
                                               ref_score_step)
    from wedetect_tpu_torch.nn.qwen3vl import (RefCfg, RefTextCfg,
                                               RefVisionCfg,
                                               get_rope_index_single_image)

    cfg = RefCfg(
        vision=RefVisionCfg(depth=2, hidden=128, heads=2, intermediate=256,
                            patch=4, temporal_patch=2, merge=2,
                            out_hidden=256, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, head_dim=128, intermediate=512,
                        rope_theta=1000.0),
        image_token_id=120, vision_start_token_id=122, object_token_id=123)
    cpu = init_ref_variables(cfg, seed=5, device="cpu")
    card = init_ref_variables(cfg, seed=5, device=dev)
    card.load_state_dict(cpu.state_dict())
    gh, gw, l = 8, 12, 128
    rng = np.random.default_rng(6)
    patches = rng.standard_normal((gh * gw, 96)).astype(np.float32)
    seq = np.concatenate([[1, 2, 122], np.full(24, 120), [7, 9],
                          np.full(3, 123), [2]])
    ids = np.zeros((2, l), np.int32)
    ids[:, :len(seq)] = seq
    mask = np.zeros((2, l), np.int32)
    mask[0, :len(seq)] = 1
    mask[1, :len(seq) - 1] = 1
    pos = np.stack([get_rope_index_single_image(ids[0], 120, gh, gw, 2)] * 2,
                   axis=1).astype(np.int32)
    obj = np.tile(np.nonzero(seq == 123)[0], (2, 1)).astype(np.int32)
    boxes = np.array([[2, 2, 30, 20], [10, 5, 47, 31], [0, 0, 48, 32]],
                     np.float32)
    args = (patches, ids, mask, pos, 3, boxes,
            np.array([48.0, 32.0], np.float32), obj)
    launch_counts(reset=True)
    got = ref_score_step(card, gh, gw, *args)
    counts = launch_counts()
    want = ref_score_step(cpu, gh, gw, *args)
    err = float((got.cpu() - want).abs().max())
    assert counts == expected_counts(k2=2, k3=2), counts
    assert err < 1e-5, err
    emit({"phase": "ref_parity", "logits_max_abs_err": err,
          "launches": counts})


# --------------------------------------------------- K2-bwd and K3-bwd
def attn_bwd_bound(h, d, pairs, q_elems, kv_elems, rows, dtype, kind):
    """The least time for a backward kernel: 6*H*D (dq) or 8*H*D (dk/dv)
    FLOPs per visible (query, key) pair at the type's peak, against q,
    k, v, dO, lse and delta read once and the gradients written once at
    the memory rate."""
    size = torch.tensor([], dtype=dtype).element_size()
    out = q_elems if kind == "dq" else 2 * kv_elems
    nbytes = (2 * q_elems + 2 * kv_elems + out) * size + 2 * rows * 4
    flops = (6.0 if kind == "dq" else 8.0) * h * d * pairs
    peak = F32_OPS_PER_S if dtype == torch.float32 else BF16_OPS_PER_S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "flops": flops, "bytes": nbytes}


# gradient error / the gradient's largest entry, kernel vs plain: f32
# the summation order only, bf16 a bf16 ulp (2^-8) of p or ds in a few
# terms; each limit sits between the kernels' readings and the
# dropped-tile control's
TRAIN_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_CONTROL_DROP = slice(64, 128)
# the training path's decoder attention (ref_2b, --seq-buckets 2048 at
# ~1253 real tokens: the last 795 keys invalid) and its ViT attention
# (--grid-tokens 1024: 4144 tokens padded to 4224)
K2_TRAIN = (1, 2048, 2048, 16, 8, 128, True, ((1253, 2048),))
K3_TRAIN = (1, 4224, 16, 64, 4144, False)


def rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def sdpa_bwd_ms(q, k, v, mask, do, iters):
    """SDPA's backward alone: autograd.grad through the forward, minus
    the forward (a yardstick; the port never calls it)."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        o = sdpa_gqa(qs, ks, vs, mask)
        torch.autograd.grad(o, (qs, ks, vs), do)

    both = cuda_ms(fwd_bwd, iters=iters)
    fwd = cuda_ms(lambda: sdpa_gqa(qs, ks, vs, mask), iters=iters)
    return both - fwd


def check_bwd(name, got, again, plain, control, dtype):
    """Each gradient within TRAIN_BWD_TOL of the plain one (relative to
    its largest entry), repeats bitwise, the control outside the limit."""
    tol = TRAIN_BWD_TOL[dtype]
    errs = [rel_err(g, w) for g, w in zip(got, plain)]
    ctrl = [rel_err(c, w) for c, w in zip(control, plain)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = same and max(errs) <= tol < max(ctrl)
    res = {"dtype": str(dtype)[6:], "rel_err": dict(zip("qkv", errs)),
           "max_abs_err": max(float((g.float() - w.float()).abs().max())
                              for g, w in zip(got, plain)),
           "control_rel_err": dict(zip("qkv", ctrl)), "tolerance": tol,
           "deterministic": same, "match": ok}
    if not ok:
        emit({"phase": name, **res})
        raise AssertionError(f"{name}: backward out of limits at {dtype}")
    return res


def k2_bwd_run(dev, case, dtype, seed):
    from wedetect_tpu_torch.ops import flash_gqa as fg

    b, s, lk, h, kvh, d, causal, holes = case
    q, k, v, valid = k2_case(dev, *case, dtype=dtype, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
    scale = d ** -0.5
    o, lse = fg.gqa_flash_attention_plain(q, k, v, causal=causal,
                                          kv_valid=valid, sm_scale=scale,
                                          return_lse=True)
    args = (q, k, v, valid, o, lse, do)
    kw = dict(causal=causal, sm_scale=scale)
    return args, kw


def phase_k2_bwd(dev, timing: bool = True):
    from wedetect_tpu_torch.ops import flash_gqa as fg

    checks = []
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate([K2_TRAIN, *K2_GRID[:5]]):
            args, kw = k2_bwd_run(dev, case, dtype, seed=i)
            q, k, v, valid, o, lse, do = args
            got = fg.gqa_flash_attention_bwd(*args, **kw)
            again = fg.gqa_flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            plain = fg.gqa_flash_attention_bwd_plain(*args, kw["causal"],
                                                     kw["sm_scale"])
            control = fg.gqa_flash_attention_bwd_plain(
                q, k, v, _dropped_valid(k, valid, BWD_CONTROL_DROP), o, lse,
                do, kw["causal"], kw["sm_scale"])
            r = check_bwd("k2_bwd", got, again, plain, control, dtype)
            checks.append({"shape": list(case[:6]), "causal": case[6], **r})
            worst[dtype] = max(worst.get(dtype, 0.0),
                               max(r["rel_err"].values()))
            if i == 0:
                worst[(dtype, "abs")] = r["max_abs_err"]
            del got, again, plain, control
    res = {"checks": checks, "max_rel_err_f32": worst[torch.float32],
           "max_rel_err_bf16": worst[torch.bfloat16],
           "max_abs_err_f32": worst[(torch.float32, "abs")],
           "max_abs_err_bf16": worst[(torch.bfloat16, "abs")]}
    if timing:
        b, s, lk, h, kvh, d, causal, holes = K2_TRAIN
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = k2_bwd_run(dev, K2_TRAIN, dtype, seed=0)
            q, k, v, valid, o, lse, do = args
            pairs = k2_visible_pairs(s, lk, causal, valid)
            delta = fg.row_delta(o, do, kvh)
            qpos = lk - s + torch.arange(s, device=dev)
            mask = (valid.bool()[:, None, None, :]
                    & (torch.arange(lk, device=dev)[None, :]
                       <= qpos[:, None])[None, None])
            plain_ms = cuda_ms(lambda: fg.gqa_flash_attention_bwd_plain(
                *args, causal, kw["sm_scale"]), iters=2, warmup=1)
            lib_ms = sdpa_bwd_ms(q, k, v, mask, do, iters=5)
            for kind, fn in (("dq", fg.gqa_flash_bwd_dq),
                             ("dkdv", fg.gqa_flash_bwd_dkdv)):
                r = attn_bwd_bound(h, d, pairs, q.numel(), k.numel(),
                                   b * s * h, dtype, kind)
                r["ms"] = cuda_ms(lambda: fn(q, k, v, valid, do, lse, delta,
                                             **kw), iters=5)
                r["plain_ms"] = plain_ms
                r["library_ms"] = lib_ms
                r["visible_pairs"] = pairs
                res[f"{kind}_{str(dtype)[6:]}"] = r
    emit({"phase": "k2_bwd", **res})
    return res


def k3_bwd_run(dev, case, dtype, seed):
    from wedetect_tpu_torch.ops import flash_attention as fa

    b, l, h, d, n_real, causal = case
    q, k, v, seg = k3_case(dev, *case, dtype=dtype, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((b, l, h, d), generator=g, device=dev).to(dtype)
    do[:, n_real:] = 0                   # the ViT drops its pad rows
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=d ** -0.5)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


def phase_k3_bwd(dev, timing: bool = True):
    from wedetect_tpu_torch.ops import flash_attention as fa

    checks = []
    worst = {}
    cases = [K3_TRAIN, (1, 1280, 16, 64, 1280, True), (2, 256, 4, 128, 200,
                                                        False)]
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(cases):
            args, kw = k3_bwd_run(dev, case, dtype, seed=i)
            got = fa.flash_attention_bwd(*args, **kw)
            again = fa.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            plain = fa.flash_attention_bwd_plain(*args, **kw)
            ckw = dict(kw, kv_segment_ids=_dropped_segs(
                args[0], kw["kv_segment_ids"], BWD_CONTROL_DROP))
            control = fa.flash_attention_bwd_plain(*args, **ckw)
            r = check_bwd("k3_bwd", got, again, plain, control, dtype)
            checks.append({"shape": list(case[:4]), "real": case[4],
                           "causal": case[5], **r})
            worst[dtype] = max(worst.get(dtype, 0.0),
                               max(r["rel_err"].values()))
            if i == 0:
                worst[(dtype, "abs")] = r["max_abs_err"]
            del got, again, plain, control
    res = {"checks": checks, "max_rel_err_f32": worst[torch.float32],
           "max_rel_err_bf16": worst[torch.bfloat16],
           "max_abs_err_f32": worst[(torch.float32, "abs")],
           "max_abs_err_bf16": worst[(torch.bfloat16, "abs")]}
    if timing:
        b, l, h, d, n_real, causal = K3_TRAIN
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = k3_bwd_run(dev, K3_TRAIN, dtype, seed=0)
            q, k, v, o, lse, do = args
            seg = kw["q_segment_ids"]
            pairs = b * (n_real * n_real + (l - n_real) ** 2)
            delta = fa.row_delta(o, do)
            mask = (seg[:, :, None] == seg[:, None, :])[:, None]
            plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                *args, **kw), iters=2, warmup=1)
            lib_ms = sdpa_bwd_ms(q, k, v, mask, do, iters=5)
            for kind, fn in (("dq", fa.flash_attention_bwd_dq),
                             ("dkv", fa.flash_attention_bwd_dkv)):
                r = attn_bwd_bound(h, d, pairs, q.numel(), k.numel(),
                                   b * l * h, dtype,
                                   "dq" if kind == "dq" else "dkdv")
                r["ms"] = cuda_ms(lambda: fn(q, k, v, do, lse, delta, **kw),
                                  iters=5)
                r["plain_ms"] = plain_ms
                r["library_ms"] = lib_ms
                r["visible_pairs"] = pairs
                res[f"{kind}_{str(dtype)[6:]}"] = r
    emit({"phase": "k3_bwd", **res})
    return res


# ----------------------------------------------------------- training
TRAIN_LR = 1e-5
# gradient (and grad_norm) error of the full-width stage-3 step, kernels
# vs the plain versions: relative L2 per parameter group; between the
# kernels' reading and the dropped-tile control's
TRAIN_GRAD_TOL = 1e-4
# seeded ground-truth boxes of the training sample (x0, y0, x1, y1) in
# the 480x640 image
TRAIN_GT = [[112.0, 96.0, 304.0, 288.0], [380.0, 150.0, 620.0, 420.0]]


def grad_groups(name: str) -> str:
    if name.startswith("model.visual."):
        return "vision"
    if name.startswith("model.language_model.embed_tokens"):
        return "embed"
    if name.startswith("model.language_model."):
        return "decoder"
    if name.startswith("out_proj"):
        return "out_proj"
    return "extras"


def param_close(got, want, mult):
    """TRAIN_PARAM_RULE: within 1e-5 relative (+1e-6) on all but 0.1% of
    the entries, and every entry within 2 * lr * mult (Adam divides each
    entry by its own size, so a near-zero gradient whose sign differs in
    the last bits moves the parameter by up to lr * mult)."""
    err = (got.float() - want.float()).abs()
    loose = err > 1e-6 + 1e-5 * want.float().abs()
    return (float(loose.float().mean()) <= 1e-3
            and float(err.max()) <= 2 * TRAIN_LR * mult + 1e-6)


def mini_ref_cfg():
    from wedetect_tpu_torch.nn.qwen3vl import RefCfg, RefTextCfg, RefVisionCfg

    return RefCfg(
        vision=RefVisionCfg(depth=2, hidden=128, heads=2, intermediate=256,
                            patch=4, temporal_patch=2, merge=2,
                            out_hidden=256, num_pos_emb=64,
                            deepstack_idx=(0, 1)),
        text=RefTextCfg(vocab_size=256, hidden=256, layers=2, heads=4,
                        kv_heads=2, head_dim=128, intermediate=512,
                        rope_theta=1000.0),
        image_token_id=120, vision_start_token_id=122, object_token_id=123)


def phase_train_parity(dev):
    """Stage-3 steps of a miniature Ref on the card and on the CPU: the
    first step's loss, grad_norm, gradients and updated parameters, and
    the second step's loss."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image
    from wedetect_tpu_torch.train.ref_sft import ref_optimizer, ref_sft_step
    from wedetect_tpu_torch.train.train_step import TrainState

    cfg = mini_ref_cfg()
    cpu = init_ref_variables(cfg, seed=7, device="cpu")
    card = init_ref_variables(cfg, seed=7, device=dev)
    card.load_state_dict(cpu.state_dict())
    gh, gw, l = 8, 12, 128
    rng = np.random.default_rng(8)
    patches = rng.standard_normal((gh * gw, 96)).astype(np.float32)
    seq = np.concatenate([[1, 2, 122], np.full(24, 120), [7, 9],
                          np.full(3, 123), [2]])
    ids = np.zeros((1, l), np.int32)
    ids[0, :len(seq)] = seq
    mask = (np.arange(l) < len(seq)).astype(np.int32)[None]
    pos = get_rope_index_single_image(ids[0], 120, gh, gw, 2)[:, None]
    obj = np.nonzero(seq == 123)[0][None].astype(np.int32)
    boxes = np.array([[2, 2, 30, 20], [10, 5, 47, 31], [0, 0, 48, 32]],
                     np.float32)
    labels = np.array([[0.8, 0.0, 0.6]], np.float32)
    valid = np.ones((1, 3), np.float32)
    args = (patches, ids, mask, pos, 3, boxes,
            np.array([48.0, 32.0], np.float32), obj, labels, valid)
    states = [TrainState.create(m, ref_optimizer(m, base_lr=TRAIN_LR))
              for m in (card, cpu)]
    launch_counts(reset=True)
    _, got = ref_sft_step(cfg, gh, gw, states[0], *args)
    counts = launch_counts()
    _, want = ref_sft_step(cfg, gh, gw, states[1], *args)
    res = {"launches": counts}
    for key in ("loss", "grad_norm"):
        res[f"{key}_rel_err"] = abs(float(got[key]) - float(want[key])) / \
            abs(float(want[key]))
    missing = [n for n, p in card.named_parameters() if p.grad is None]
    grad_err = param_bad = 0.0
    bad = []
    for (n, p), q, m in zip(card.named_parameters(), cpu.parameters(),
                            states[0].tx.mults):
        if p.grad is not None:
            e = rel_err(p.grad.cpu(), q.grad)
            grad_err = max(grad_err, e)
            if e > 1e-5:
                bad.append(n)
        if not param_close(p.detach().cpu(), q.detach(), m):
            param_bad += 1
            bad.append(n)
    res.update(grad_max_rel_err=grad_err, params_out_of_rule=param_bad,
               params=sum(1 for _ in card.parameters()),
               without_grad=missing)
    # a second step from the updated parameters: its loss too
    losses = [float(ref_sft_step(cfg, gh, gw, st, *args)[1]["loss"])
              for st in states]
    res["step2_loss_rel_err"] = abs(losses[0] - losses[1]) / abs(losses[1])
    ok = (not missing and not bad and res["loss_rel_err"] <= 1e-5
          and res["grad_norm_rel_err"] <= 1e-5
          and res["step2_loss_rel_err"] <= 1e-5
          and counts == expected_counts(k2=cfg.text.layers,
                                        k3=cfg.vision.depth,
                                        k2_bwd=cfg.text.layers,
                                        k3_bwd=cfg.vision.depth))
    emit({"phase": "train_parity", **res, "out_of_limits": bad})
    if not ok:
        raise AssertionError("train_parity: card step != CPU step")


def ref_sft_dataset(cfg, image, proposals, grid_tokens: int):
    """The stage-3 dataset of the training phases: one seeded image (read
    from memory), two seeded ground-truth boxes, the Uni proposals."""
    from wedetect_tpu_torch.data.sft_chat import ReferringSftDataset
    from wedetect_tpu_torch.data.vision_process import make_grid_buckets

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    data, props = os.path.join(root, "stage3.json"), \
        os.path.join(root, "proposals.json")
    with open(data, "w") as f:
        json.dump([{"image": "image0", "class_name": REF_QUERIES[0],
                    "bounding_boxes": TRAIN_GT}], f)
    with open(props, "w") as f:
        json.dump({"image0": np.asarray(proposals).tolist()}, f)
    return ReferringSftDataset(
        data, props, CharTok(), image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        object_token_id=cfg.object_token_id, max_proposals=100,
        grid_buckets=make_grid_buckets(total_tokens=grid_tokens),
        patch=cfg.vision.patch, merge=cfg.vision.merge, seed=0,
        image_reader={"image0": image}.__getitem__)


def stage3_loss_grads(model, b):
    """ref_sft_step's loss and gradients, without the update."""
    from wedetect_tpu_torch.models.ref import sigmoid_focal_loss

    dev = model.device
    gh, gw = b["grid"]
    model.zero_grad(set_to_none=True)
    logits = model(b["patches"], b["input_ids"], b["attn_mask"],
                   b["position_ids"], b["boxes"], b["ori_wh"],
                   b["visual_start"], b["object_positions"], grid_h=gh,
                   grid_w=gw)
    loss = sigmoid_focal_loss(
        logits.reshape(-1),
        torch.as_tensor(b["soft_labels"], device=dev).reshape(-1),
        valid=torch.as_tensor(b["valid"], device=dev).reshape(-1))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def group_errors(got, want):
    """Relative L2 error of each parameter group's gradient and of the
    global norm."""
    num, den = {}, {}
    for n, w in want.items():
        grp = grad_groups(n)
        num[grp] = num.get(grp, 0.0) + float((got[n] - w).double().square()
                                             .sum())
        den[grp] = den.get(grp, 0.0) + float(w.double().square().sum())
    errs = {grp: math.sqrt(num[grp] / max(den[grp], 1e-300)) for grp in num}
    gn_got = math.sqrt(sum(float(g.double().square().sum())
                           for g in got.values()))
    gn_want = math.sqrt(sum(den.values()))
    errs["grad_norm"] = abs(gn_got - gn_want) / gn_want
    return errs


def phase_train_grad(dev, image, proposals, cfg=None,
                     grid_tokens: int = 256):
    from wedetect_tpu_torch.cli.train_ref import build_step_inputs
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    ds = ref_sft_dataset(cfg, image, proposals, grid_tokens=grid_tokens)
    b = build_step_inputs(cfg, ds.sample(0), 3, (1024, 2048, 4096), 100,
                          151643)
    model = init_ref_variables(cfg, seed=0, device=dev)
    launch_counts(reset=True)
    loss_k, gk = stage3_loss_grads(model, b)
    counts = launch_counts()
    with plain_attention():
        loss_p, gp = stage3_loss_grads(model, b)
    errs = group_errors(gk, gp)
    del gk
    with plain_attention(bwd_drop=BWD_CONTROL_DROP):
        loss_c, gc = stage3_loss_grads(model, b)
    ctrl = group_errors(gc, gp)
    del gc, gp, model
    torch.cuda.empty_cache()
    gh, gw = b["grid"]
    res = {"grid": [gh, gw], "vit_tokens": gh * gw,
           "seq_len": int(b["input_ids"].shape[1]),
           "real_tokens": int(b["attn_mask"].sum()), "launches": counts,
           "loss": loss_k, "loss_abs_diff": abs(loss_k - loss_p),
           "control_loss_abs_diff": abs(loss_c - loss_p),
           "rel_l2_err": errs, "control_rel_l2_err": ctrl,
           "tolerance": TRAIN_GRAD_TOL}
    ok = (max(errs.values()) <= TRAIN_GRAD_TOL < max(ctrl.values())
          and counts == expected_counts(k2=cfg.text.layers,
                                        k3=cfg.vision.depth,
                                        k2_bwd=cfg.text.layers,
                                        k3_bwd=cfg.vision.depth))
    emit({"phase": "train_grad", **res})
    if not ok:
        raise AssertionError("train_grad: kernel gradients out of limits")
    return res


def phase_train(dev, image, proposals, cfg=None, grid_tokens: int = 1024,
                steps: int = 3):
    """train_ref_loop, stage 3, at ref_2b's full width with the CLI
    defaults."""
    from wedetect_tpu_torch.cli.train_ref import train_ref_loop
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b
    from wedetect_tpu_torch.train.optimizer import make_lr_schedule
    from wedetect_tpu_torch.train.ref_sft import ref_optimizer
    from wedetect_tpu_torch.train.train_step import TrainState

    cfg = cfg or ref_2b()
    ds = ref_sft_dataset(cfg, image, proposals, grid_tokens=grid_tokens)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=dev)
    tx = ref_optimizer(model, base_lr=TRAIN_LR,
                       lr_schedule=make_lr_schedule(TRAIN_LR, steps))
    state = TrainState.create(model, tx)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.startswith("model.visual.") or n in (
                 "out_proj.weight",
                 "model.language_model.layers.0.mlp.down_proj.weight")}
    logs = []
    launch_counts(reset=True)
    state = train_ref_loop(cfg, state, ds, 3, steps,
                           seq_buckets=(1024, 2048, 4096),
                           max_proposals=100, pad_token_id=151643,
                           log_every=1, seed=0,
                           log_fn=lambda s, m: logs.append(m))
    counts = launch_counts()
    torch.cuda.synchronize()
    params = dict(model.named_parameters())
    vision_same = all(torch.equal(params[n].detach(), w)
                      for n, w in watch.items()
                      if n.startswith("model.visual."))
    changed = {n: not torch.equal(params[n].detach(), watch[n])
               for n in ("out_proj.weight",
                         "model.language_model.layers.0.mlp.down_proj.weight")}
    losses = [m["loss"] for m in logs]
    step_ms = [1e3 / m["steps_per_s"] for m in logs]
    res = {"grid_tokens": grid_tokens, "steps": steps, "losses": losses,
           "step_ms": step_ms, "ms_per_step": float(np.mean(step_ms[1:])),
           "launches_per_step": {k: v / steps for k, v in counts.items()},
           "vision_unchanged": vision_same, "changed": changed,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "optimizer_count": state.tx.count}
    per_step = expected_counts(k2=cfg.text.layers, k3=cfg.vision.depth,
                               k2_bwd=cfg.text.layers,
                               k3_bwd=cfg.vision.depth)
    ok = (len(losses) == steps and all(np.isfinite(losses)) and vision_same
          and all(changed.values())
          and counts == {k: v * steps for k, v in per_step.items()})
    emit({"phase": "train", **res})
    if not ok:
        raise AssertionError("train: the SFT loop broke its checks")
    del state, model, tx, watch, params
    torch.cuda.empty_cache()
    return res, counts


def kernel_entry(name, source, replaces, launches, k, timing):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err_f32"],
            "max_abs_err_bf16": k["max_abs_err_bf16"],
            "tolerance": {str(t)[6:]: {"atol": a, "rtol": r}
                          for t, (a, r) in K_TOL.items()},
            "match": True, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


def bwd_kernel_entry(name, replaces, launches, k, timing):
    return {"name": name, "route": "cuda",
            "source": "wedetect_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": k["max_abs_err_f32"],
            "max_abs_err_bf16": k["max_abs_err_bf16"],
            "max_rel_err": k["max_rel_err_f32"],
            "max_rel_err_bf16": k["max_rel_err_bf16"],
            "tolerance": {str(t)[6:]: {"rel_to_max": v}
                          for t, v in TRAIN_BWD_TOL.items()},
            "match": True, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


STOCK_FA = "jax/experimental/pallas/ops/tpu/flash_attention.py"


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
    k2 = phase_k2(dev)
    k3 = phase_k3(dev)
    text_embeds = phase_text(dev, TEXT_BASE, N_CLASSES)
    detect = phase_detect(dev, "base", N_CLASSES, BATCH, text_embeds)
    del text_embeds
    phase_parity(dev)
    phase_uni(dev)
    phase_ref_parity(dev)
    image, proposals = ref_inputs(dev)
    ref = phase_ref(dev, (image, proposals))
    launches = ref["float32"]["launches"]
    k2_bwd = phase_k2_bwd(dev)
    k3_bwd = phase_k3_bwd(dev)
    phase_train_parity(dev)
    phase_train_grad(dev, image, proposals)
    _, train_counts = phase_train(dev, image, proposals)
    emit({"kernels": [
        {"name": "row_topk", "route": "cuda",
         "source": "wedetect_tpu_torch/csrc/row_topk.cu",
         "replaces": "wedetect_tpu/ops/pallas_topk.py:46",
         "launches": detect["row_topk_launches"],
         "max_abs_err": k1["max_abs_err"], "max_abs_err_bf16": None,
         "tolerance": 0.0, "match": True,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        # K2 timed at the suffix shape, K3 at the ViT shape, both f32
        kernel_entry("gqa_flash_fwd", "wedetect_tpu_torch/csrc/flash_attn.cu",
                     "wedetect_tpu/ops/flash_gqa.py:86", launches["k2"],
                     k2, k2["suffix_float32"]),
        kernel_entry("flash_attention_fwd",
                     "wedetect_tpu_torch/csrc/flash_attn.cu",
                     "wedetect_tpu/ops/attention.py:126", launches["k3"],
                     k3, k3["vit_float32"]),
        # the backward kernels' launches from the train phase, their
        # times at its shapes (decoder and ViT), f32
        bwd_kernel_entry("gqa_flash_bwd_dq",
                         "wedetect_tpu/ops/flash_gqa.py:169",
                         train_counts["k2_bwd_dq"], k2_bwd,
                         k2_bwd["dq_float32"]),
        bwd_kernel_entry("gqa_flash_bwd_dkdv",
                         "wedetect_tpu/ops/flash_gqa.py:212",
                         train_counts["k2_bwd_dkdv"], k2_bwd,
                         k2_bwd["dkdv_float32"]),
        bwd_kernel_entry("flash_attention_bwd_dq", f"{STOCK_FA}:1146",
                         train_counts["k3_bwd_dq"], k3_bwd,
                         k3_bwd["dq_float32"]),
        bwd_kernel_entry("flash_attention_bwd_dkv", f"{STOCK_FA}:796",
                         train_counts["k3_bwd_dkv"], k3_bwd,
                         k3_bwd["dkv_float32"])]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
