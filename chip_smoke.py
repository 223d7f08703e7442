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


@contextlib.contextmanager
def plain_attention(drop: slice | None = None):
    """Route the attention dispatch through K2's and K3's plain versions
    (the reference side of a comparison). With `drop`, those key
    positions are also masked in every call: a wrong attention, the
    control that shows a comparison can fail."""
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    def gqa(q, k, v, *, kv_valid=None, **kw):
        if drop is not None:
            kv_valid = (torch.ones(k.shape[:2], dtype=torch.int32,
                                   device=k.device)
                        if kv_valid is None else kv_valid.clone())
            kv_valid[:, drop] = 0
        return fg.gqa_flash_attention_plain(q, k, v, kv_valid=kv_valid, **kw)

    def flash(q, k, v, *, q_segment_ids=None, kv_segment_ids=None, **kw):
        if drop is not None:
            if q_segment_ids is None:
                q_segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32,
                                            device=q.device)
                kv_segment_ids = q_segment_ids
            kv_segment_ids = kv_segment_ids.clone()
            kv_segment_ids[:, drop] = -1
        return fa.flash_attention_plain(
            q, k, v, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, **kw)

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


def launch_counts(reset: bool = False):
    from wedetect_tpu_torch.ops.flash_attention import flash_attention
    from wedetect_tpu_torch.ops.flash_gqa import gqa_flash_attention

    if reset:
        gqa_flash_attention.launches = flash_attention.launches = 0
    return {"k2": gqa_flash_attention.launches,
            "k3": flash_attention.launches}


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


def phase_ref(dev, cfg=None, timing: bool = True):
    """ref_2b (or `cfg`) at full width, random weights, through
    RefScorer.score on a 480x640 image."""
    from wedetect_tpu_torch.models import ref_api
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    image, boxes = ref_inputs(dev)
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
        assert counts == {"k2": 2 * cfg.text.layers,
                          "k3": cfg.vision.depth}, counts
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
    assert counts == {"k2": 2, "k3": 2}, counts
    assert err < 1e-5, err
    emit({"phase": "ref_parity", "logits_max_abs_err": err,
          "launches": counts})


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
    ref = phase_ref(dev)
    launches = ref["float32"]["launches"]
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
                     k3, k3["vit_float32"])]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
