#!/usr/bin/env python3
"""Drive the PyTorch port (`wedetect_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device   card name and power limit (nvidia-smi), TF32 flags (both
            set off: the f32 runs are true f32).
2. build    nvcc builds every kernel of the port (csrc/*.cu), all
            sources at once, into build/kernels/; ptxas's report. The
            four wgmma libraries (K2's and K3's bf16 forward and
            backward) must show HGMMA (wgmma) and UTMALDG (TMA load)
            instructions in `cuobjdump -sass`; the four FFMA libraries
            (K2-bwd dk/dv and dq and K2's forward in f32 at D = 128,
            K3-bwd dk/dv and dq and K3's forward in f32 at D = 64) their
            count of FFMA, LDS.128 and all LDS, whole and in each
            innermost loop, where every shared-memory load must feed at
            least 8 FFMA, and their registers; none of the eight may
            spill.
3. k1       the row top-k kernel (selection by key) against its plain
            PyTorch version (t rounds of iterative max) and against its
            own rule (row_topk_by_key), vals and cls bitwise, at the
            detect path's shape (B*8400, 1203), t = 64, on k1_inputs
            (masks, ties, full masks: mostly dense rows) and
            k1_sparse_inputs (the path's regime: at most 63 candidates
            a row, most rows none), NaN rows, rows of exactly t and
            t + 1 candidates, t = 7, t = 200 (slots in chunks), and
            edge shapes (register and shared-memory paths up to
            row_topk_max_k, K not a multiple of 32, t = 1, t = K); the
            rows the kernel counts in each branch (no candidate, at most
            t, more than t, a NaN) must equal the input's, and both
            branches must run at full size. Times the kernel and
            torch.topk (a yardstick only) as device time in turns on
            both inputs, and the plain version.
4. k2       the grouped-KV flash kernels against gqa_flash_attention_plain
            at the Ref path's prefix (1, 384, 16, 128 | 384, 8) and
            suffix (8, 256, 16, 128 | 640, 8) shapes with kv_valid
            holes, at cross-image REC's batched prefix (8, 384 | 384)
            and suffix (8, 256 | 640) with the holes differing by row,
            on the JAX test grid, a partial last block and fully
            masked rows, f32 through the FFMA kernel at D = 128 (atol
            1e-4; in turns with the SIMT one it replaced, its walk read
            back at K2_TRAIN) and bf16 through the wgmma + TMA kernel,
            their launches counted
            (atol 2e-3 + rtol 1e-2: one bf16 ulp of |O| at every
            magnitude), O and lse; D = 256 and 384 in both types through
            the SIMT kernel; times the kernels, the plain version
            and SDPA with enable_gqa and a boolean mask (a yardstick
            only). K2's and SDPA's times are device times: 20 calls
            captured in a CUDA graph, replays timed (graph_ms); the
            eager calls' times, host included, beside them.
5. k3       the same for the ViT's flash kernel at (1, 1280, 16, 64)
            with 80 pad tokens in segment 0, at cross-image REC's
            batched ViT (8, 1024, 16, 64; 16 pad), at the training shape
            (1, 4224, 16, 64; 80 pad), square causal, causal with
            segment ids, three segments off the 64-grid, a tail
            (L = 200), D = 128, D = 256 and D = 72 (zero-padded to 128
            for the SIMT kernel): at D = 64 bf16 runs the wgmma + TMA
            kernel (csrc/flash_attn_sm90.cu) and f32 the FFMA kernel
            (csrc/flash_attn_f32.cu), their launches counted per case,
            the other head dims the SIMT one; a control through the
            plain version with one 64-key tile dropped must miss the
            limit in every case. Kernel and SDPA timed alike, as device
            time (graph_ms) and as eager calls, at the ViT's two shapes
            and at D = 256; the f32 kernel also in turns with the SIMT
            one it replaced (SIMT, f32, f32, SIMT), its walk read back
            in the tile the route takes (fwd_f32_tile) and held to
            fwd_walk_map, the other tile timed beside it.
6. text     the full XLM-R base text tower, random init, on 1203 random
            token-id prompts -> (1203, 768) unit vectors; 8 prompts
            checked against the same tower on the CPU.
7. detect   WeDetect-Base at full width (depths 3/3/27/3, dims
            128..1024, neck repeats 12), 640x640, K = 1203, random
            init, biases calibrated as a trained checkpoint's are (at
            most 63 candidates per anchor above score_thr), B = 8
            images through Detector.__call__, with K1's launch count
            read around that call (one); the sparse selection from the
            kernel against the plain version on the same scores, K1 on
            the call's own thresholded scores held to both plain rules
            with its branch counts and timed beside torch.topk (the
            kernels line's path_ms); f32 and bf16 step times.
8. eval     detection evaluation (eval/runner.evaluate_coco, the
            native matcher, the LVIS evaluator, the dump and the three
            CLIs) on a seeded LVIS-format set of 50 JPEGs (sides
            480-1000, 1-20 boxes each, 1203 categories with r/c/f
            frequencies, neg and not-exhaustive domains) with a COCO
            file over 80 categories: WeDetect-Base 640x640, B = 8, the
            head calibrated to the sparse regime; LVIS in f32 and bf16
            with K1 launched once a detect call (7); the f32 run again
            through row_topk_plain (the dump bit for bit, the metrics
            equal); the dump recomputed with the plain Python matcher
            (the metrics exactly); flip TTA (K1 once a call, the dump's
            metrics); cli/test.py at COCO K = 80 in f32 and bf16 (K1
            never); cli/eval_recall.py and cli/extract_embedding.py on
            Uni-Base, 16 images (K1 never). img/s and the host split
            (loader wait, detect, read-back, add_image, summarize) of
            the LVIS and COCO runs.
9. detect_int8  the same detector in its int8 mode (ModelCfg.quant_int8:
            the block MLPs, the neck's Conv+BN convs and the head's tower
            convs through ops/int8.py, torch._int_mm), the head
            calibrated on it, B = 8 through Detector.__call__: K1
            launched once a call; f32 and bf16: the class logits' cosine
            to the float call on the same weights (DET_INT8_COS) and
            their largest error, ms a call, int8 and float in turns.
10. parity   a miniature detector on the card against the same weights
            on the CPU (forward to 1e-3; NMS slots exact on the same
            scores, through the kernel on the card).
11. int8_parity  the int8 ops on the card against the CPU: torch._int_mm
            through the padding rule (rows 1, 16, 17, K and N off the
            multiples of 8) equal to the CPU's int64 product,
            quant_linear and quant_conv2d (3x3, strided, 1x1) bitwise in
            f32 and bf16, a control with one weight scale over the whole
            tensor that must miss; the miniature detector (f32, bf16
            autocast) and Ref in int8, every int8 call on the card equal
            to the CPU's module on its input, bit for bit, the outputs'
            distance to the CPU's reported; torch._int_mm against a bf16
            torch.mm (and quant_linear against F.linear) at the three
            largest int8 GEMMs (INT8_GEMMS), device time, with bounds.
12. uni      WeDetect-Uni-Base forward_raw at B = 1.
13. ref_parity  a miniature Ref (head_dim 128) on the card, through K2
            and K3, against the same weights on the CPU (logits 1e-5).
14. ref     WeDetect-Ref at ref_2b's full width (ViT 24 x 1024, decoder
            28 x 2048, 16 q / 8 kv heads, vocab 151936), random init
            from seed 0 on the card: the top 100 proposals of a random
            Uni-Base on a seeded 480x640 image, 8 queries through a
            character-level stub tokenizer, RefScorer.score with prefix
            sharing. Scores (8, 100) finite in (0, 1); K2 = 56 and
            K3 = 24 launches counted around the call, in bf16 all of
            them on the wgmma kernels, in f32 all on the FFMA kernels;
            the pre-sigmoid
            logits agree with the same call through the kernels' plain
            versions (REF_LOGIT_TOL), while a control through the plain
            versions with one key tile masked in every attention call
            must miss that limit (in bf16 also a limit on the mean
            error, REF_LOGIT_MEAN_TOL); the joint path (prefix_sharing=False)
            agrees with the split one (f32 limit). ms per call, prefix
            and suffix stage ms, f32 and bf16.
15. ref_int8  the same ref_2b call through RefScorer(quant_prefill=True)
            (the ViT's and the decoder's Linears in int8), f32 and bf16:
            K2 = 56 and K3 = 24 launches on the type's routes, the
            logits against the float scorer on the same weights within
            REF_INT8_TOL (max and mean), the model's int8 modules off
            after the call; ms a call, int8 and float in turns.

16. k2_bwd the grouped-KV backward kernels (K2-bwd-dq, K2-bwd-dkdv)
            against gqa_flash_attention_bwd_plain at the training path's
            decoder shape (1, 2048, 16, 128 | 2048, 8), square causal,
            the last 795 keys invalid, on the JAX test grid (fully
            masked rows, S*G = 192), a tile that straddles two
            frontiers (bq*G = 32), D = 256 and 384, f32 and bf16: dq, dk, dv
            within a limit relative to each gradient's largest entry
            (TRAIN_BWD_TOL); a control through the plain backward with
            one 64-key tile dropped must miss it; the two kernels run
            twice and agree bitwise. bf16 at D = 128 runs the wgmma +
            TMA kernels (csrc/flash_gqa_bwd_sm90.cu); f32 at D = 128 the
            FFMA kernels (csrc/flash_gqa_bwd_f32.cu); D = 256 and 384 the
            SIMT ones; each kernel's launches counted on its own route
            (dq by dq_route, dk/dv by dkdv_route), its worst errors kept
            by kernel. Then the bf16 path a user
            calls: loss.backward() through gqa_flash_attention at the
            training shape, the wgmma kernels' launches counted around
            it (the f32 path is the train phases'). Times each kernel
            and SDPA's backward as device time (graph_ms; SDPA's:
            autograd.grad through scaled_dot_product_attention minus
            its forward, a yardstick), the eager calls beside them, and
            the plain backward; at f32 also the SIMT dq and dk/dv
            kernels the FFMA ones replaced (called through their library
            and held to the plain version, the dq one also against the
            dropped-tile control), each pair timed in turns (SIMT, f32,
            f32, SIMT), the tiles each FFMA kernel walked (dk/dv: the
            32-row tiles of each 64-key block; dq: the 32-key tiles of
            each 64-row block), read back from it and held to the skip
            rule's map (dkdv_walk_map, dq_walk_map), against those the
            frontier alone scans.
17. k3_bwd the same for the ViT's backward kernels (K3-bwd-dq,
            K3-bwd-dkv) at (1, 4224, 16, 64) with 80 pad tokens in
            segment 0, square causal, D = 128, three segments with
            boundaries off the 64-grid, a tail (L = 200) and D = 72:
            bf16 at D = 64 runs the wgmma + TMA kernels
            (csrc/flash_attn_bwd_sm90.cu); f32 dq and dk/dv at D = 64
            the FFMA kernels (csrc/flash_attn_bwd_f32.cu, `dq_route`,
            `dkv_route`); the other head dims the SIMT ones; launches
            counted per case and route; loss.backward() through
            flash_attention in bf16 at the training shape, its launches
            counted; device and eager times beside SDPA's backward; at
            f32 also the SIMT dq and dk/dv kernels the FFMA ones
            replaced (through their library, held to the plain version,
            the dq one also against the dropped-tile control), each pair
            timed in turns (SIMT, f32, f32, SIMT), the f32 pair's time
            against SDPA's backward, and the tiles each FFMA kernel
            walked (dq: 128-row x 64-key, dk/dv: 64 x 128), read back
            from it and held to its skip rule's map, against those the
            frontier alone scans.
18. train_parity  a miniature Ref (head_dim 128) takes one stage-3
            ref_sft_step on the card and one on the CPU from the same
            weights: loss, grad_norm and every gradient within 1e-5
            (relative), the updated parameters too (TRAIN_PARAM_RULE);
            every parameter has a gradient on the card; K2 = K2-bwd-dq =
            K2-bwd-dkdv = layers and K3 = K3-bwd-dq = K3-bwd-dkv = depth
            (every forward, dq and dk/dv on the FFMA kernels).
19. train_grad  one stage-3 loss and gradient at ref_2b's full width
            (random weights) at the --grid-tokens 256 bucket (ViT and
            decoder L = 1024), through the kernels and through the plain
            forward and backward versions: the loss difference, the
            relative L2 error of each parameter group's gradient and of
            grad_norm within TRAIN_GRAD_TOL, and a control with one key
            tile dropped in every backward call that must miss it.
20. train   cli/train_ref.train_ref_loop, stage 3, ref_2b at full width
            in f32 with the CLI defaults (--grid-tokens 1024: ViT
            L = 4144 padded to 4224; --seq-buckets 1024 2048 4096: L =
            2048; 100 proposals; lr 1e-5 cosine; ref_optimizer, vision
            frozen): the seeded image, two seeded ground-truth boxes and
            the Uni proposals -> soft labels -> 3 SFT steps. Finite
            losses, the vision tower bitwise unchanged, out_proj and the
            decoder changed, launches per step as in train_parity (28
            each of K2's FFMA forward, dq and dk/dv kernels and 24 each
            of K3's a step, none of the SIMT ones); ms per step (steps
            2-3) and peak card memory.
21. det_train_parity  a miniature detector (mini_cfg's widths at
            128x128) takes one f32 train_step (B = 2, five gts, drop path
            0) on the card and one on the CPU from the same weights: the
            loss and its parts, every gradient and the BN running
            statistics within DET_TRAIN_TOL / DET_STATS_TOL; a control
            step with one gt removed must miss; the card's step run
            twice (its run-to-run drift reported); no kernel of the port
            launches (K1 nor the attention kernels).
22. det_train  cli/train's own build functions (build_config, build_state,
            make_sample_fn) at WeDetect-Base, not cut, 640x640, the CLI
            defaults (B = 16, K = 80, lr 5e-4 constant, weight decay
            0.025, drop path 0, no mosaic or mixup, bf16), random init and
            the random text bank: seeded in-memory 640x640 images with
            1-20 gt boxes each, the class texts sampled per image
            (RandomLoadText), 3 steps through train/loop.run_training.
            Finite losses, num_pos > 0, a backbone tensor, a head tensor
            and a BN running mean changed, K1 launched 0 times; ms a
            step (steps 2-3, the loop's own clock), img/s and peak card
            memory.

23. gen_parity  the miniature Ref (head_dim 128) on the card against the
            same weights on the CPU, f32: the prefill's hidden states
            and KV (every position) within GEN_PREFILL_TOL, with K2 = 2
            and K3 = 2 launches on the FFMA kernels, and a control (one
            masked key unmasked) that must miss; greedy ref_generate,
            ref_generate_spec and a 3-slot GenServer (kv_bits 16 and 8,
            and piggyback) emit the CPU's tokens under the margin rule
            (a divergence only where the CPU's teacher-forced top-2
            margin is within GEN_LOGIT_TOL); the PRNG twin's bits,
            uniforms, categorical draws and the sampler (top-k, top-p)
            on the card bitwise equal to the CPU's.
24. gen     ref_2b at full width, the seeded 480x640 image, one prompt
            (P = 384), 64 new tokens through RefScorer.generate_text in
            f32 and in bf16, greedy: K2 = 28 and K3 = 24 launches a call
            (f32 on the FFMA kernels, bf16 on the wgmma ones), prefill
            ms, decode ms a token, peak GB; speculative decode in f32
            gives greedy's tokens (margin rule), its verify steps; int8
            and int4 decode: the first step's logit cosine against the
            full-precision tree (GEN_COS_LIMIT), and ms a token.
25. serve   ref_2b, GenServer with 8 slots, chunk 16, P = 384, G = 64:
            16 requests with varied prompt tails and caps from 8 to 64.
            f32: every request completes and equals its own
            ref_generate stream (margin rule); chunk 4, pipeline off and
            piggyback emit the same tokens; K2 = 28 and K3 = 24 launches
            an admission. bf16: tokens/s, ms a chunk at full occupancy,
            occupancy, pool GB, peak GB, the launches an admission; the
            int8 KV pool (kv_bits=8) at 0.52x the bf16 pool's bytes,
            every request complete; sampling (T = 0.8, top-k 50, top-p
            0.9) unchanged by the chunk size.
26. quant_gate  ref_2b, random weights, f32: RefScorer.calibrate_decode
            (int4) on 8 requests on the Ref image, K3 = 24 launches a
            prompt (the decoder replay is the einsum); gate_report
            (eval/quant_gate: first-step logit cosine, greedy agreement
            over 16 tokens, REC score deltas) of the plain and the
            calibrated int4 trees on cli/quant_gate's 8 probe prompts;
            one generate_text with the calibrated tree (32 tokens, K2 =
            28, K3 = 24): prefill ms and ms a token.
27. grounding  WeDetect-Ref grounding evaluation at ref_2b's full width,
            random weights, on 20 seeded JPEGs (12 at 480x640, 8 at
            640x480: two grid buckets of make_grid_buckets(256)) with
            Uni-Base proposals, f32 then bf16: RefScorer.score_rec, one
            query an image, query_batch 8 (three fused steps, the last
            landscape chunk padded), K2 = 56 and K3 = 24 a fused step on
            the type's route (the ViT once over (8, 1024, 16, 64), the
            prefix pass over (8, P) rows, one suffix pass on per-row KV),
            its logits within REF_LOGIT_TOL (bf16: and the mean limit) of
            per-image logits(), a control with every suffix row on image
            0's KV missing that limit; score_multi_images on a landscape
            and a portrait image with proposals and a square one for
            context, prefix sharing (K2 = 56, K3 = 72) and joint (K2 =
            28, K3 = 72) within the same limit; the REC and the shared
            multi-image logits also within that limit of the same calls
            through the kernels' plain versions, while the plain versions
            with one key tile masked in every call miss it; f32 ref_generate_multi,
            16 greedy tokens on one image equal to ref_generate's, and on
            two images; cli/eval_grounding --random-init --random-size 2b
            on a refcoco-format set (f32, --grid-tokens 256: three fused
            steps) and a COCO-format set (80 queries an image, 4 images,
            --bf16). ms a fused step, items/s through score_rec and
            through per-image score(), multi-image ms, the CLI's items/s
            and host split, peak GB.

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
import re
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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of fn() per call: `iters` calls captured in one CUDA
    graph, its replays timed with CUDA events. Without the host between
    launches this is the kernels' own time even where eager calls are
    enqueued slower than the card runs them (cuda_ms then reads the
    host's rate)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


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


# the wgmma + TMA libraries: K2's and K3's bf16 forward and backward
SM90_LIBS = ("flash_gqa_sm90", "flash_gqa_bwd_sm90", "flash_attn_sm90",
             "flash_attn_bwd_sm90")
# the FFMA libraries: K2-bwd-dkdv and K2-bwd-dq in f32 at D = 128,
# K3-bwd-dkv and K3-bwd-dq in f32 at D = 64, K2's forward in f32 at
# D = 128, K3's forward in f32 at D = 64
F32_LIBS = ("flash_gqa_bwd_f32", "flash_attn_bwd_f32", "flash_gqa_f32",
            "flash_attn_f32")


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

    def sass_and_spills(name):
        lib = libs[names.index(name)]
        sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                               str(lib)], capture_output=True, text=True,
                              check=True).stdout
        spills[name] = [
            line for line in lib.with_suffix(".log").read_text()
            .splitlines() if "spill" in line and " 0 bytes spill stores, "
            "0 bytes spill loads" not in line]
        return sass

    # the wgmma kernels run on the tensor cores and the TMA, the FFMA
    # kernels' instruction mix is counted whole and by innermost loop,
    # and none of their registers spill
    found, spills = {}, {}
    for name in SM90_LIBS:
        sass = sass_and_spills(name)
        found[name] = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    f32_sass = {name: sass_mix(sass_and_spills(name)) for name in F32_LIBS}
    registers = {name: ptxas_registers(libs[names.index(name)])
                 for name in F32_LIBS}
    emit({"phase": "build", "kernels": names, "seconds": secs,
          "sm90_sass": found, "f32_sass": f32_sass,
          "f32_registers": registers, "spills": spills})
    for name in SM90_LIBS:
        assert all(found[name].values()), f"{name}: SASS lacks {found}"
    for name, bad in spills.items():
        assert not bad, f"{name} spills: {bad}"
    # each FFMA kernel's main loops (the S / dP products, the dV / dK
    # sums) feed at least 8 FFMA from each shared-memory load
    for name, mix in f32_sass.items():
        assert len(mix["loops"]) >= 2 and all(
            m["FFMA"] >= 8 * m["LDS"] for m in mix["loops"]), (name, mix)


def ptxas_registers(lib) -> list:
    """The registers a thread of each kernel in a library uses, from
    ptxas's report beside it."""
    return [int(n) for n in re.findall(r"Used (\d+) registers",
                                        lib.with_suffix(".log").read_text())]


SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z0-9.]+)([^;]*);", re.M)


def _mix(ops) -> dict:
    return {"FFMA": sum(op.split(".")[0] == "FFMA" for op in ops),
            "LDS.128": sum(op.split(".")[0] == "LDS"
                           and "128" in op.split(".") for op in ops),
            "LDS": sum(op.split(".")[0] == "LDS" for op in ops)}


def sass_mix(sass: str) -> dict:
    """FFMA and shared-memory load instructions in a `cuobjdump -sass`
    listing (LDS.128 and every LDS of any width): in the whole listing,
    and in each innermost loop that holds FFMA (a backward BRA's range
    holding no other backward BRA), kernel by kernel (each kernel's
    addresses start at 0) and in address order."""
    lines, body = [], []
    for func in re.split(r"^\s+Function : ", sass, flags=re.M):
        code = [(int(a, 16), op, rest)
                for a, op, rest in SASS_LINE.findall(func)]
        lines += code
        loops = []
        for addr, op, rest in code:
            target = re.match(r"\s*0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target \
                    and int(target.group(1), 16) < addr:
                loops.append((int(target.group(1), 16), addr))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in loops)]
        body += [_mix([op for a, op, _ in code if lo <= a <= hi])
                 for lo, hi in sorted(inner)]
    return {**_mix([op for _, op, _ in lines]),
            "loops": [m for m in body if m["FFMA"]]}


def k1_inputs(rows: int, k: int, dev, seed: int = 0) -> torch.Tensor:
    """Thresholded-score-like rows: a per-row share of lanes masked to
    -inf (from none to all), every 5th row quantized to 4 levels (ties),
    every 97th row fully masked. Most rows hold more than T_ROW
    candidates: the dense branch, which the detect path never takes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((rows, k), generator=g, device=dev)
    keep = torch.rand((rows, 1), generator=g, device=dev)
    mask = torch.rand((rows, k), generator=g, device=dev) < keep
    ties = torch.arange(rows, device=dev)[:, None] % 5 == 0
    x = torch.where(ties, torch.floor(x * 4) / 4, x)
    x = torch.where(mask, x, float("-inf"))
    x[::97] = float("-inf")
    return x.contiguous()


def _first_lanes(n: torch.Tensor, k: int, g, dev) -> torch.Tensor:
    """(rows, k) bool: n[i] lanes of row i, at random classes."""
    r = torch.rand((n.shape[0], k), generator=g, device=dev)
    return r.argsort(dim=1).argsort(dim=1) < n[:, None]


def k1_sparse_inputs(rows: int, k: int, dev, seed: int = 0,
                     t: int = T_ROW) -> torch.Tensor:
    """The detect path's regime (at most t - 1 candidates a row, most
    rows none): one row in 8 holds 1 .. t - 1 values in (0.3, 1) at
    random classes, every third of those quantized to 8 levels (ties)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = torch.randint(1, t, (rows,), generator=g, device=dev)
    n = torch.where(torch.rand((rows,), generator=g, device=dev) < 0.125,
                    n, 0)
    x = 0.3 + 0.7 * torch.rand((rows, k), generator=g, device=dev)
    ties = torch.arange(rows, device=dev)[:, None] % 3 == 0
    x = torch.where(ties, torch.floor(x * 8) / 8, x)
    return torch.where(_first_lanes(n, k, g, dev), x,
                       float("-inf")).contiguous()


def k1_boundary_inputs(rows: int, k: int, dev, seed: int = 0,
                       t: int = T_ROW) -> torch.Tensor:
    """Rows of exactly t and t + 1 candidates in turns (the branch
    boundary), on 3 levels: ties across the cut."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = t + torch.arange(rows, device=dev) % 2
    x = torch.floor(torch.rand((rows, k), generator=g, device=dev) * 3) / 3
    return torch.where(_first_lanes(n, k, g, dev), x,
                       float("-inf")).contiguous()


def k1_nan_inputs(rows: int, k: int, dev, seed: int = 0) -> torch.Tensor:
    """k1_inputs with NaNs: +nan, -nan, a NaN in the last lane, several
    payloads of either sign, each in one row of 5 (the fifth row none)."""
    x = k1_inputs(rows, k, dev, seed)
    bits = x.view(torch.int32)
    g = torch.Generator(device=dev).manual_seed(seed + 1)

    def nan(b):
        return b - 2 ** 32 if b >= 2 ** 31 else b

    bits[0::5, 7] = nan(0x7FC00000)
    bits[1::5, 3] = nan(0xFFC00000)
    bits[2::5, -1] = nan(0x7FC00001)
    rows3 = bits[3::5]
    pos = torch.randint(0, k, (rows3.shape[0], 4), generator=g, device=dev)
    payload = torch.randint(1, 2 ** 23, pos.shape, generator=g, device=dev)
    sign = torch.randint(0, 2, pos.shape, generator=g, device=dev)
    rows3.scatter_(1, pos, ((0x7F800000 | payload) - sign * 2 ** 31)
                   .to(torch.int32))
    return x


def k1_branches(x: torch.Tensor, t: int) -> list:
    """Rows by K1's branch, from the input: no candidate, at most t,
    more than t, a NaN (the order of row_topk's `branches`)."""
    nan = torch.isnan(x).any(dim=1)
    n = (x > float("-inf")).sum(dim=1)
    return [int(((n == 0) & ~nan).sum()),
            int(((n > 0) & (n <= t) & ~nan).sum()),
            int(((n > t) & ~nan).sum()), int(nan.sum())]


def k1_check(x: torch.Tensor, t: int) -> dict:
    """One K1 case: the kernel against row_topk_plain and row_topk_by_key
    (bitwise, vals and cls), and the rows it counted in each branch
    against the input's."""
    from wedetect_tpu_torch.ops.row_topk import (row_topk, row_topk_by_key,
                                                 row_topk_plain)

    branches = torch.zeros(4, dtype=torch.int32, device=x.device)
    kv, kc = row_topk(x, t, branches=branches)
    pv, pc = row_topk_plain(x, t)
    bv, bc = row_topk_by_key(x, t)
    return {"rows": x.shape[0], "k": x.shape[1], "t": t,
            "match_plain": bitwise_equal(kv, pv) and bitwise_equal(kc, pc),
            "match_by_key": bitwise_equal(kv, bv) and bitwise_equal(kc, bc),
            "branches": branches.tolist(),
            "branches_match": branches.tolist() == k1_branches(x, t)}


def k1_timing(x: torch.Tensor, t: int, rounds: int = 2) -> dict:
    """Device time (graph_ms) of the kernel and of torch.topk (a
    yardstick the port never calls) on x, in turns: kernel, topk, topk,
    kernel per round."""
    from wedetect_tpu_torch.ops.row_topk import row_topk

    kern = lambda: row_topk(x, t)  # noqa: E731
    topk = lambda: torch.topk(x, t, dim=1)  # noqa: E731
    turns = [[graph_ms(fn) for fn in (kern, topk, topk, kern)]
             for _ in range(rounds)]
    ms = [v for r in turns for v in (r[0], r[3])]
    lib = [v for r in turns for v in (r[1], r[2])]
    return {"ms": sum(ms) / len(ms), "library_ms": sum(lib) / len(lib),
            "ms_turns": ms, "library_ms_turns": lib}


def k1_bound(rows: int, k: int, t: int, branches: list) -> dict:
    """The least time the card could take: each input byte read once,
    each output byte written once; operations from this input's
    branches (a key and a compare an element, a 64-wide bitonic network
    of 672 compare-exchanges a row with candidates, 4 histogram passes
    over K a row with more than t) at the f32 rate."""
    nbytes = rows * k * 4 + rows * t * 8
    ops = rows * k * 2 + (branches[1] + branches[2]) * 672 * (
        (t + 63) // 64) + branches[2] * 4 * k * 2 * ((t + 63) // 64)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "operations": ops}


def phase_k1(dev, rows: int, k: int, timing: bool = True):
    from wedetect_tpu_torch.ops.row_topk import (row_topk, row_topk_max_k,
                                                 row_topk_plain)

    max_k = row_topk_max_k()
    dense = k1_inputs(rows, k, dev)
    sparse = k1_sparse_inputs(rows, k, dev, seed=1)
    cases = [("dense", dense, T_ROW), ("sparse", sparse, T_ROW),
             ("nan", k1_nan_inputs(1000, k, dev, seed=2), T_ROW),
             ("boundary", k1_boundary_inputs(1000, k, dev, seed=3), T_ROW),
             ("boundary", k1_boundary_inputs(200, 2000, dev, seed=4), T_ROW),
             ("boundary", k1_boundary_inputs(300, 100, dev, seed=5, t=7), 7),
             ("nan", k1_nan_inputs(100, 2000, dev, seed=6), T_ROW),
             ("dense", k1_inputs(256, 300, dev, seed=7), 200)]  # t > 64
    cases += [("dense", k1_inputs(r, kk, dev, seed=kk), t)
              for r, kk, t in ((333, 37, 37), (256, 80, 64), (256, 1280, 64),
                               (200, 2000, 64), (64, 33, 1), (64, max_k, 64))]
    checks = []
    for name, x, t in cases:
        checks.append({"input": name, **k1_check(x, t)})
        c = checks[-1]
        if not (c["match_plain"] and c["match_by_key"]
                and c["branches_match"]):
            emit({"phase": "k1", "checks": checks})
            raise AssertionError(f"row_topk disagrees on {name} "
                                 f"{(c['rows'], c['k'], t)}")
    # both branches of the selection ran on the card
    assert checks[0]["branches"][2] > 0 and checks[1]["branches"][1] > 0
    kv, _ = row_topk(dense, T_ROW)
    pv, _ = row_topk_plain(dense, T_ROW)
    fin = torch.isfinite(pv)
    max_abs_err = float((kv[fin] - pv[fin]).abs().max()) if fin.any() else 0.0
    res = {"rows": rows, "k": k, "t": T_ROW, "max_abs_err": max_abs_err,
           "max_k": max_k, "checks": checks,
           "dense_branches": checks[0]["branches"],
           "sparse_branches": checks[1]["branches"],
           **k1_bound(rows, k, T_ROW, checks[0]["branches"])}
    res["sparse_bound_ms"] = k1_bound(rows, k, T_ROW,
                                      checks[1]["branches"])["bound_ms"]
    if timing:
        res.update(k1_timing(dense, T_ROW))
        sp = k1_timing(sparse, T_ROW)
        res.update({f"sparse_{key}": v for key, v in sp.items()})
        res["plain_ms"] = cuda_ms(lambda: row_topk_plain(dense, T_ROW),
                                  iters=3, warmup=1)
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
    # K1 on the path's own input: the thresholded (B*A, K) scores
    path = torch.where(dec.scores.float() > thr, dec.scores.float(),
                       float("-inf")).reshape(-1, k).contiguous()
    del dec, got, want
    path_check = k1_check(path, T_ROW)
    assert path_check["match_plain"] and path_check["match_by_key"] \
        and path_check["branches_match"], path_check
    assert path_check["branches"][2] == path_check["branches"][3] == 0
    path_res = {"branches": path_check["branches"],
                **k1_bound(*path.shape, T_ROW, path_check["branches"])}
    if timing:
        path_res.update(k1_timing(path, T_ROW))
    del path

    # the main path: Detector.__call__, K1's count read around it
    row_topk.launches = 0
    results = det(list(images), score_thr=thr)
    launches = row_topk.launches
    assert launches == 1, f"the detect call launched row_topk {launches}x"
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
           "k1_path": path_res,
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


# ------------------------------------------------------------- eval
EVAL_IMAGES = 50         # the seeded LVIS-format set: JPEG, sides 480-1000
EVAL_UNI_IMAGES = 16     # eval_recall and extract_embedding
EVAL_COCO_CLASSES = 80
EVAL_KEYS = ("mAP", "AP50", "AP75", "APs", "APm", "APl")
LVIS_KEYS = EVAL_KEYS + ("APr", "APc", "APf")


def write_eval_dataset(root, n: int, k_lvis: int, k_coco: int,
                       sides=(480, 1000), seed: int = 5):
    """n seeded JPEGs (smooth noise, sides in `sides`) with 1-20 boxes
    each, painted in; an LVIS-format file over k_lvis categories (each
    with a frequency r/c/f; per image neg_category_ids among the absent
    ones and, on every fourth, one not_exhaustive_category_ids) and a
    COCO-format file over k_coco categories, the same images and boxes.
    Returns (lvis.json, coco.json)."""
    import cv2

    rng = np.random.default_rng(seed)
    images, lvis_anns, coco_anns = [], [], []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
        small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3),
                             dtype=np.uint8)
        img = cv2.resize(small, (w, h))
        n_gt = int(rng.integers(1, 21))
        cats = rng.integers(0, k_lvis, n_gt)
        for j in range(n_gt):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y):int(y + bh), int(x):int(x + bw)] = rng.integers(
                0, 256, 3)
            box = {"image_id": i + 1, "bbox": [x, y, bw, bh],
                   "area": bw * bh, "iscrowd": 0}
            lvis_anns.append({**box, "id": len(lvis_anns) + 1,
                              "category_id": int(cats[j]) + 1})
            coco_anns.append({**box, "id": len(coco_anns) + 1,
                              "category_id": int(cats[j]) % k_coco + 1})
        name = f"{i:06d}.jpg"
        cv2.imwrite(str(root / name), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        absent = [int(c) + 1 for c in rng.choice(k_lvis, 20, replace=False)
                  if c not in set(cats.tolist())]
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h, "neg_category_ids": absent[:10],
                       "not_exhaustive_category_ids":
                           [int(cats[0]) + 1] if i % 4 == 0 else []})
    freq = rng.choice(["r", "c", "f"], k_lvis)
    paths = []
    for fname, anns, cats in (
            ("lvis.json", lvis_anns,
             [{"id": c + 1, "name": f"lvis_{c}", "frequency": str(freq[c])}
              for c in range(k_lvis)]),
            ("coco.json", coco_anns,
             [{"id": c + 1, "name": f"coco_{c}"} for c in range(k_coco)])):
        (root / fname).write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": cats}))
        paths.append(str(root / fname))
    return paths


def plant_detections(ann_path: str, dump_path: str, cat_ids,
                     seed: int = 6) -> dict:
    """Replace the first half (rounded up) of each image's ground truths
    in ann_path by its top-scoring detections in the dump, each of the
    same class with every side moved by 0-3 px, so that the run's
    detections match ground truth as a trained checkpoint's would;
    neg_category_ids lose the planted classes and a non-empty
    not_exhaustive_category_ids follows the image's new first gt.
    Rewrites ann_path; returns the counts of planted and of all gts."""
    from pathlib import Path

    from wedetect_tpu_torch.eval.dump import load_detections

    path = Path(ann_path)
    ann = json.loads(path.read_text())
    dets = {r["img_id"]: r for r in load_detections(dump_path)}
    rng = np.random.default_rng(seed)
    by_img = {}
    for a in ann["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    planted = 0
    for img in ann["images"]:
        gts, r = by_img.get(img["id"], []), dets.get(img["id"])
        m = 0 if r is None else min((len(gts) + 1) // 2, len(r["scores"]))
        top = (np.argsort(-r["scores"], kind="stable")[:m] if m
               else np.zeros(0, np.int64))
        for a, j in zip(gts, top):
            box, label = r["boxes"][j], r["labels"][j]
            x0, y0, x1, y1 = (np.asarray(box, np.float64)
                              + rng.uniform(-3, 3, 4)).tolist()
            x0, x1 = np.clip(sorted((x0, x1)), 0, img["width"]).tolist()
            y0, y1 = np.clip(sorted((y0, y1)), 0, img["height"]).tolist()
            bw, bh = max(x1 - x0, 1.0), max(y1 - y0, 1.0)
            a.update(bbox=[x0, y0, bw, bh], area=bw * bh,
                     category_id=int(cat_ids[int(label)]))
        planted += m
        present = {a["category_id"] for a in gts}
        img["neg_category_ids"] = [c for c in img.get("neg_category_ids",
                                                      []) if c not in present]
        if img.get("not_exhaustive_category_ids"):
            img["not_exhaustive_category_ids"] = [gts[0]["category_id"]]
    path.write_text(json.dumps(ann))
    return {"planted_gts": planted, "gts": len(ann["annotations"])}


def detection_load(ds, dump_path: str) -> dict:
    """Detections an image in a dump (mean, min, max), and those the LVIS
    domain filter keeps (class among the image's gt or neg classes)."""
    from wedetect_tpu_torch.eval.dump import load_detections

    idx = {it["img_id"]: i for i, it in enumerate(ds.items)}
    n, kept = [], []
    for r in load_detections(dump_path):
        i = idx[r["img_id"]]
        domain = (set(ds.gt_arrays(i)["labels"].tolist())
                  | set(ds.items[i].get("neg_cats", [])))
        n.append(len(r["labels"]))
        kept.append(sum(int(c) in domain for c in r["labels"]))

    def stats(v):
        return {"mean": float(np.mean(v)), "min": int(min(v)),
                "max": int(max(v))}

    return {"dets_per_image": stats(n), "lvis_kept_per_image": stats(kept)}


def eval_calibrate(det, batches, w, thr: float) -> dict:
    """calibrate_head on the first batch, then lower every level's bias
    until no anchor of any batch, nor of its mirror (the TTA view), holds
    T_ROW candidates above thr, in f32 or bf16: every eval call then takes
    the sparse (row top-k) branch."""
    from wedetect_tpu_torch.models import wedetect as W

    scale, shift = calibrate_head(det, batches[0], w, thr)
    cfg, kth = det.cfg, -math.inf
    for c in (cfg, dataclasses.replace(cfg, compute_dtype="bfloat16")):
        det.model.cfg = c
        for x in batches:
            for view in (x, np.ascontiguousarray(x[:, :, ::-1])):
                logits = W.forward_raw(c, det.model, view, w).logits.float()
                kth = max(kth, float(torch.topk(logits, T_ROW, dim=-1)
                                     .values[..., -1].max()))
                del logits
    det.model.cfg = cfg
    extra = min(0.0, math.log(thr / (1 - thr)) - kth - 0.01)
    with torch.no_grad():
        for h in det.model.bbox_head.cls_contrasts:
            h.bias += extra
    return {"logit_scale_shift": scale, "bias_shift": shift,
            "extra_bias_shift": extra, "max_kth_logit": kth}


def same_metric(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or a == b


def metrics_equal(got: dict, want: dict) -> bool:
    return (got.keys() == want.keys()
            and got["per_class"].keys() == want["per_class"].keys()
            and all(same_metric(got["per_class"][c], want["per_class"][c])
                    for c in got["per_class"])
            and all(same_metric(got[k], want[k]) for k in got
                    if k != "per_class"))


def check_metrics(m: dict, keys) -> dict:
    """The headline metrics: each present, finite in [0, 1] or NaN (an
    empty group)."""
    for k in keys:
        v = m[k]
        assert isinstance(v, float) and (math.isnan(v) or 0 <= v <= 1), (k, v)
    return {k: m[k] for k in keys}


def dumps_equal(a: str, b: str) -> bool:
    from wedetect_tpu_torch.eval.dump import load_detections

    ra, rb = load_detections(a), load_detections(b)
    return len(ra) == len(rb) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(ra, rb))


def eval_split(t: dict) -> dict:
    """img/s and the host split of one evaluate_coco call (its own
    timings, host clock): loader wait, detect, read-back, add_image,
    summarize ms, and the evaluator's share (add_image + summarize) of
    the call."""
    from wedetect_tpu_torch.eval.runner import TIMING_KEYS

    return {"images": t["images"], "batches": t["batches"],
            "wall_ms": t["wall_ms"],
            "img_per_s": t["images"] * 1e3 / t["wall_ms"],
            **{k: t[k] for k in TIMING_KEYS},
            "host_eval_share": (t["add_image_ms"] + t["summarize_ms"])
            / t["wall_ms"]}


@contextlib.contextmanager
def timed_runner(calls: list):
    """Route eval/runner.evaluate_coco (as the CLIs call it) through a
    wrapper that asks for its timings and its wall time (host clock, the
    call ends on its last read-back), each call's appended to `calls`."""
    from wedetect_tpu_torch.eval import runner

    saved = runner.evaluate_coco

    def timed(*args, **kw):
        t = {}
        t0 = time.perf_counter()
        out = saved(*args, timings=t, **kw)
        t["wall_ms"] = (time.perf_counter() - t0) * 1e3
        calls.append(t)
        return out

    runner.evaluate_coco = timed
    try:
        yield
    finally:
        runner.evaluate_coco = saved


def phase_eval(dev, text_embeds, size: str = "base", k: int = N_CLASSES,
               batch: int = BATCH, n_images: int = EVAL_IMAGES,
               n_uni: int = EVAL_UNI_IMAGES, sides=(480, 1000), **cfg_kw):
    """Detection evaluation through eval/runner.evaluate_coco and the
    three CLIs on a seeded LVIS-format set (write_eval_dataset), the head
    calibrated to the sparse regime (eval_calibrate). A first f32 pass
    writes half of each image's ground truths from its own detections
    (plant_detections; for COCO, from a first cli/test.py pass), so that
    detections match and the LVIS domain filter keeps them; the
    detections an image and those the filter keeps are recorded.
    (a) LVIS (K = k) in f32 and bf16: K1 launched once a detect call;
        AP50 above 0;
    (b) the f32 run twice with cuDNN deterministic, through K1 and
        through row_topk_plain: the same dump, bit for bit, and the same
        metrics (the timed runs leave cuDNN as cli/test.py does);
    (c) that dump's metrics recomputed with the plain Python matcher
        and with the native one: the run's, exactly;
    (d) flip TTA, f32: K1 once a (2B) detect call; the dump's metrics;
    (e) cli/test.py at COCO K = 80, --random-init, f32 and bf16: K1 never;
        AP50 above 0;
    (f) cli/eval_recall.py and cli/extract_embedding.py on Uni (n_uni
        images): JAX's keys, K1 never (Uni at score_thr 0 is dense).
    img/s and the host split of (a) and (e)."""
    import io
    import tempfile
    from pathlib import Path

    from wedetect_tpu_torch.cli import eval_recall, extract_embedding
    from wedetect_tpu_torch.cli import test as cli_test
    from wedetect_tpu_torch.data.coco import CocoDetDataset
    from wedetect_tpu_torch.data.loader import EvalLoader
    from wedetect_tpu_torch.eval.dump import recompute_metrics
    from wedetect_tpu_torch.eval.runner import evaluate_coco
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.ops.row_topk import row_topk

    tmp = tempfile.TemporaryDirectory(prefix="wedetect_eval_")
    root = Path(tmp.name)
    t0 = time.perf_counter()
    lvis_path, coco_path = write_eval_dataset(root, n_images, k,
                                              EVAL_COCO_CLASSES, sides)
    res = {"card": nvidia_smi(), "images": n_images, "k": k, "batch": batch,
           "write_dataset_s": time.perf_counter() - t0}
    ds = CocoDetDataset(lvis_path, str(root))
    det = Detector.from_random(size, seed=0, device=dev, num_classes=k,
                               **cfg_kw)
    det.reparameterize(ds.class_names, embeds=text_embeds)
    cfg, w = det.cfg, det._text_embeds
    batches = [b["images"] for b in EvalLoader(ds, cfg.img_size, batch)]
    n_calls = len(batches)
    res["calibration"] = eval_calibrate(det, batches, w, cfg.test.score_thr)
    del batches
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False

    def run(c, dump, **kw):
        det.cfg = det.model.cfg = c
        t = {}
        row_topk.launches = 0
        t0 = time.perf_counter()
        m = evaluate_coco(c, det.model, ds, w, batch_size=batch,
                          dump_path=dump and str(root / dump), timings=t,
                          lvis=True, **kw)
        t["wall_ms"] = (time.perf_counter() - t0) * 1e3
        return m, row_topk.launches, t

    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    try:
        # warm-up (cuDNN's choices, K1's build): the f32 pass whose
        # detections are planted as ground truth, one bf16 batch
        run(cfg, "seed.npz")
        res["lvis_planting"] = plant_detections(
            lvis_path, str(root / "seed.npz"), ds.cat_ids)
        ds = CocoDetDataset(lvis_path, str(root))
        run(bf16, None, max_images=batch)
        # (a) LVIS in f32 and bf16
        for name, c in (("f32", cfg), ("bf16", bf16)):
            m, launches, t = run(c, f"{name}.npz")
            assert launches == n_calls, (name, launches, n_calls)
            assert m["AP50"] > 0, (name, m["AP50"])
            res[f"lvis_{name}"] = {"row_topk_launches": launches,
                                   "detect_calls": n_calls,
                                   "metrics": check_metrics(m, LVIS_KEYS),
                                   **detection_load(ds,
                                                    str(root / f"{name}.npz")),
                                   **eval_split(t)}
        # (b) the f32 run through K1 and through its plain version, cuDNN
        # deterministic so that the two differ only in K1
        torch.backends.cudnn.deterministic = True
        m32, launches, _ = run(cfg, "f32_det.npz")
        assert launches == n_calls, ("f32_det", launches, n_calls)
        with plain_row_topk():
            m, launches, _ = run(cfg, "plain.npz")
        torch.backends.cudnn.deterministic = False
        dump_match = dumps_equal(str(root / "f32_det.npz"),
                                 str(root / "plain.npz"))
        assert launches == 0 and dump_match and metrics_equal(m, m32)
        # (c) the plain Python matcher on the same detections
        python_match = metrics_equal(recompute_metrics(
            ds, str(root / "f32_det.npz"), lvis=True, matcher="python"), m32)
        native_match = metrics_equal(recompute_metrics(
            ds, str(root / "f32_det.npz"), lvis=True), m32)
        assert python_match and native_match
        res.update(plain_k1_dump_match=dump_match,
                   python_matcher_match=python_match,
                   native_recompute_match=native_match)
        # (d) flip TTA
        m, launches, t = run(cfg, "tta.npz", tta=True)
        assert launches == n_calls, ("tta", launches, n_calls)
        tta_match = metrics_equal(recompute_metrics(
            ds, str(root / "tta.npz"), lvis=True), m)
        assert tta_match
        res["lvis_tta_f32"] = {"row_topk_launches": launches,
                               "detect_calls": n_calls,
                               "recompute_match": tta_match,
                               "metrics": check_metrics(m, LVIS_KEYS),
                               **eval_split(t)}
        del det
        torch.cuda.empty_cache()
        # (e) cli/test.py at COCO K = 80 (random init), f32 and bf16,
        # after a first f32 pass whose dump is planted as ground truth
        dev_arg = ["--device", str(dev)]
        coco = ["--ann", coco_path, "--img-root", str(root), "--random-init",
                "--size", size, "--batch-size", str(batch), *dev_arg]
        with contextlib.redirect_stdout(io.StringIO()):
            cli_test.main(coco + ["--f32", "--dump", str(root / "coco.npz")])
        res["coco_planting"] = plant_detections(
            coco_path, str(root / "coco.npz"),
            CocoDetDataset(coco_path, str(root)).cat_ids)
        coco_load = detection_load(CocoDetDataset(coco_path, str(root)),
                                   str(root / "coco.npz"))["dets_per_image"]
        for name, flag in (("f32", ["--f32"]), ("bf16", [])):
            calls = []
            row_topk.launches = 0
            with timed_runner(calls), contextlib.redirect_stdout(io.StringIO()):
                m = cli_test.main(coco + [
                    "--out", str(root / f"coco_{name}.json"), *flag])
            assert row_topk.launches == 0, row_topk.launches
            assert m["AP50"] > 0, (name, m["AP50"])
            assert json.loads((root / f"coco_{name}.json").read_text()
                              ).keys() == m.keys()
            res[f"coco_{name}"] = {"row_topk_launches": row_topk.launches,
                                   "metrics": check_metrics(m, EVAL_KEYS),
                                   "dets_per_image": coco_load,
                                   **eval_split(calls[0])}
        # (f) the Uni CLIs
        uni = ["--ann", coco_path, "--img-root", str(root), "--random-init",
               "--size", size, "--max-images", str(n_uni), "--batch-size",
               str(batch), *dev_arg]
        row_topk.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            recall = eval_recall.main(uni)
        recall_s = time.perf_counter() - t0
        assert set(recall) == {"AR@100", "AR@300"}, recall
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            payload = extract_embedding.main(
                uni + ["--out", str(root / "emb.pkl"), "--class-set", "lvis"])
        extract_s = time.perf_counter() - t0
        assert set(payload) == {"image_embedding", "text_embedding",
                                "classnames"}
        assert len(payload["image_embedding"]) == n_uni
        assert all(set(r) == {"image_id", "embedding", "scale", "bias",
                              "scores", "bboxes"}
                   for r in payload["image_embedding"])
        assert payload["text_embedding"].shape == (1203, 768)
        assert row_topk.launches == 0, row_topk.launches
        res["uni"] = {"images": n_uni, "recall": recall, "recall_s": recall_s,
                      "extract_s": extract_s,
                      "proposals": sum(len(r["scores"]) for r in
                                       payload["image_embedding"]),
                      "row_topk_launches": 0}
    finally:
        torch.backends.cudnn.deterministic = saved_det
        tmp.cleanup()
    emit({"phase": "eval", **res})
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


# ------------------------------------------------------------- int8
INT8_OPS_PER_S = 1979e12    # int8 dense, tensor cores
# the three largest int8 GEMMs of the main paths, (M, K, N): the head's
# 3x3 tower conv at P3 (B = 8, 80x80, 256 -> 256, unfolded), the Ref
# decoder's gate/up projection on the suffix rows (8 x 256), ConvNeXt
# stage 0's block MLP (B = 8, 160x160, 128 -> 512)
# the int8 class logits' cosine to the float call's at full width, f32
# and bf16 (a floor: the same direction, nothing broken on the way)
DET_INT8_COS = 0.95
INT8_GEMMS = {"head_p3_tower": (51200, 2304, 256),
              "ref_suffix_gate_up": (2048, 2048, 6144),
              "convnext_s0_mlp": (204800, 128, 512)}


class Int8Calls:
    """Record (module, input, output) of every int8 module's call."""

    def __init__(self, model):
        from wedetect_tpu_torch.ops import int8 as TI

        self.calls = []
        self.hooks = [m.register_forward_hook(
            lambda m_, i_, o_: self.calls.append((m_, i_[0], o_)))
            for m in model.modules()
            if isinstance(m, (TI.QuantLinear, TI.QuantConv2d))]

    def __enter__(self):
        return self.calls

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()


def int8_calls_match_cpu(calls, cpu_model, card_model, autocast=None):
    """Each card call of an int8 module against the same module on the
    CPU fed the card's input: equal bit for bit. Returns the count."""
    cpu_mods = dict(cpu_model.named_modules())
    names = {m: n for n, m in card_model.named_modules()}
    ctx = (torch.autocast("cpu", dtype=autocast) if autocast
           else contextlib.nullcontext())
    for mod, x, out in calls:
        with ctx, torch.inference_mode():
            want = cpu_mods[names[mod]](x.cpu())
        assert bitwise_equal(out.cpu().contiguous(), want.contiguous()), \
            f"int8 call {names[mod]}: card != CPU"
    return len(calls)


def int8_gemm_timing(dev, m, k, n):
    """torch._int_mm against a bf16 torch.mm at (M, K) x (K, N) (device
    time, CUDA graphs), with quant_linear and a bf16 F.linear (the whole
    int8 op: quantize, product, epilogue) beside them; the bounds of the
    int8 and the bf16 products."""
    import torch.nn.functional as F

    from wedetect_tpu_torch.ops import int8 as TI

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a8 = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)
    x = torch.randn((m, k), generator=g, device=dev).bfloat16()
    w = torch.randn((n, k), generator=g, device=dev).bfloat16()
    ops = 2.0 * m * k * n
    res = {"mkn": [m, k, n],
           "int_mm_ms": graph_ms(lambda: torch._int_mm(a8, w8.t())),
           "bf16_mm_ms": graph_ms(lambda: torch.mm(x, w.t())),
           "quant_linear_ms": graph_ms(lambda: TI.quant_linear(x, w)),
           "bf16_linear_ms": graph_ms(lambda: F.linear(x, w)),
           "int8_bound_ms": max(ops / INT8_OPS_PER_S,
                                (m * k + n * k + 4 * m * n)
                                / HBM_BYTES_PER_S) * 1e3,
           "bf16_bound_ms": max(ops / BF16_OPS_PER_S,
                                2 * (m * k + n * k + m * n)
                                / HBM_BYTES_PER_S) * 1e3}
    res["int_mm_over_bf16_mm"] = res["int_mm_ms"] / res["bf16_mm_ms"]
    return res


def phase_int8_parity(dev, timing: bool = True):
    """The int8 ops on the card against the CPU: the int32 sums of
    torch._int_mm through the padding rule equal the CPU's int64 product;
    quant_linear and quant_conv2d equal the CPU's bit for bit in f32 and
    bf16, padding included; a control with one weight scale for the
    whole tensor must miss. Then the miniature detector (f32 and bf16
    autocast) and the miniature Ref in int8: every int8 call on the card
    equal to the CPU's module on the card's input, the outputs reported
    against the CPU's. Times the three largest GEMMs (INT8_GEMMS)."""
    from wedetect_tpu_torch.configs import ModelCfg, TestCfg
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.models.ref import init_ref_variables, \
        ref_score_step
    from wedetect_tpu_torch.ops import int8 as TI

    res = {"int_mm": [], "ops": {}}
    g = torch.Generator().manual_seed(11)
    for m, k, n in ((1, 12, 12), (16, 12, 12), (17, 12, 12), (37, 41, 9),
                    (300, 2304, 256)):
        a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
        a[0], w[0] = 127, -127
        got = TI.int8_matmul(a.to(dev), w.to(dev)).cpu().long()
        ok = torch.equal(got, a.long() @ w.long().T)
        res["int_mm"].append({"mkn": [m, k, n], "exact": ok,
                              "padded": list(TI.int_mm_padded_shape(m, k,
                                                                    n))})
        assert ok, (m, k, n)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 7, 37, generator=g).to(dt)
        w = torch.randn(20, 37, generator=g).to(dt)
        b = torch.randn(20, generator=g)
        want = TI.quant_linear(x, w, b)
        got = TI.quant_linear(x.to(dev), w.to(dev), b.to(dev)).cpu()
        same = {"linear": bitwise_equal(got.float(), want.float())}
        # the control: one weight scale over the whole tensor
        x8, ls = TI._quantize(x.to(dev), -1)
        w8, rs = TI._quantize(w.to(dev), (0, 1))
        y = TI.int8_matmul(x8.reshape(-1, 37), w8).reshape(3, 7, 20)
        ctrl = ((y.float() * ls * rs).to(dt) + b.to(dev).to(dt)).cpu()
        ctrl_err = float((ctrl.float() - want.float()).abs().max())
        xc = torch.randn(2, 6, 9, 7, generator=g).to(dt)
        xc[1] *= 8
        for kk, st in ((3, 1), (3, 2), (1, 1)):
            wc = torch.randn(10, 6, kk, kk, generator=g).to(dt)
            want_c = TI.quant_conv2d(xc, wc, None, st, kk // 2)
            got_c = TI.quant_conv2d(xc.to(dev), wc.to(dev), None, st,
                                    kk // 2).cpu()
            same[f"conv{kk}s{st}"] = bitwise_equal(
                got_c.float().contiguous(), want_c.float().contiguous())
        res["ops"][str(dt)[6:]] = {"bitwise": same,
                                   "control_max_abs_err": ctrl_err}
        assert all(same.values()) and ctrl_err > 0, (dt, same, ctrl_err)

    # the miniature detector in int8, f32 and bf16: card vs CPU
    cfg = ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                   neck_scale=0.25, neck_repeats=2,
                   head_in_channels=(32, 64, 128), embed_dims=32,
                   img_size=(64, 64), text=None, num_classes=8,
                   quant_int8=True,
                   test=TestCfg(nms_pre=256, max_per_img=16, score_thr=0.3))
    cpu = W.init_variables(cfg, seed=3, device="cpu")
    card = W.init_variables(cfg, seed=3, device=dev)
    card.load_state_dict(cpu.state_dict())
    images = torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                           dtype=torch.uint8).numpy()
    w = torch.randn((8, 32), generator=g).numpy()
    res["detector"] = {}
    for name in ("float32", "bfloat16"):
        c = cpu.cfg = card.cfg = dataclasses.replace(cfg,
                                                     compute_dtype=name)
        with Int8Calls(card) as calls:
            b = W.forward_raw(c, card, images, w)
        n = int8_calls_match_cpu(
            calls, cpu, card,
            autocast=torch.bfloat16 if name == "bfloat16" else None)
        a = W.forward_raw(c, cpu, images, w)
        with TI.quant_mode(cpu, False):
            f = W.forward_raw(c, cpu, images, w)
        res["detector"][name] = {
            "int8_calls_equal_cpu": n,
            "logits_max_abs_err": float((a.logits - b.logits.cpu()).abs()
                                        .max()),
            "cpu_int8_vs_float_max_abs": float((a.logits - f.logits).abs()
                                               .max())}
        assert n == 2 * sum(cfg.depths) + sum(
            isinstance(m, TI.QuantConv2d) for m in card.modules())
        assert torch.isfinite(b.logits).all()
    del cpu, card

    # the miniature Ref (phase_ref_parity's) in int8, f32: card vs CPU
    rcfg, gh, gw, args = ref_parity_case()
    rcfg = dataclasses.replace(rcfg, quant_int8=True)
    cpu = init_ref_variables(rcfg, seed=5, device="cpu")
    card = init_ref_variables(rcfg, seed=5, device=dev)
    card.load_state_dict(cpu.state_dict())
    launch_counts(reset=True)
    with Int8Calls(card) as calls:
        got = ref_score_step(card, gh, gw, *args)
    counts = launch_counts()
    n = int8_calls_match_cpu(calls, cpu, card)
    want = ref_score_step(cpu, gh, gw, *args)
    with TI.quant_mode(cpu, False):
        flt = ref_score_step(cpu, gh, gw, *args)
    assert n == 4 * rcfg.vision.depth + 7 * rcfg.text.layers, n
    assert counts == expected_counts(k2=2, k2_f32=2, k3=2, k3_f32=2), counts
    res["ref"] = {"int8_calls_equal_cpu": n, "launches": counts,
                  "logits_max_abs_err": float((got.cpu() - want).abs()
                                              .max()),
                  "cpu_int8_vs_float_max_abs": float((want - flt).abs()
                                                     .max())}
    del cpu, card
    if timing:
        res["gemm"] = {name: int8_gemm_timing(dev, *mkn)
                       for name, mkn in INT8_GEMMS.items()}
    emit({"phase": "int8_parity", **res})
    return res


def phase_detect_int8(dev, size: str, k: int, batch: int, text_embeds,
                      timing: bool = True):
    """The detector's int8 mode (ModelCfg.quant_int8) at full width
    through Detector.__call__: K1 launched once a call (the head
    calibrated on the int8 model, as in detect); the class logits' cosine
    and largest error against the same weights in float (quant_mode off),
    f32 and bf16; ms a call, int8 and float in turns."""
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.ops.int8 import quant_mode
    from wedetect_tpu_torch.ops.row_topk import row_topk

    det = Detector.from_random(size, seed=0, device=dev, num_classes=k,
                               quant_int8=True)
    det.reparameterize([f"class_{i}" for i in range(k)], embeds=text_embeds)
    cfg = det.cfg
    h, w = cfg.img_size
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (batch, h, w, 3), generator=g,
                           dtype=torch.uint8).numpy()
    thr = cfg.test.score_thr
    calibrate_head(det, images, det._text_embeds, thr)
    row_topk.launches = 0
    results = det(list(images), score_thr=thr)
    launches = row_topk.launches
    assert launches == 1, f"the int8 detect call launched row_topk " \
                          f"{launches}x"
    res = {"size": size, "k": k, "batch": batch,
           "row_topk_launches": launches,
           "detections": check_detections(results, max(h, w), k, thr,
                                          cfg.embed_dims)}
    call = lambda: det(list(images), score_thr=thr)  # noqa: E731

    def float_call():
        with quant_mode(det.model, False):
            return det(list(images), score_thr=thr)

    for name, c in (("f32", cfg), ("bf16", dataclasses.replace(
            cfg, compute_dtype="bfloat16"))):
        det.cfg = det.model.cfg = c
        q = W.forward_raw(c, det.model, images, det._text_embeds).logits
        with quant_mode(det.model, False):
            f = W.forward_raw(c, det.model, images,
                              det._text_embeds).logits
        r = res[name] = {
            "logit_cosine": float(cosines(q.reshape(1, -1),
                                          f.reshape(1, -1))[0]),
            "logit_max_abs_err": float((q.float() - f.float()).abs()
                                       .max()),
            "logit_range": [float(f.min()), float(f.max())]}
        del q, f
        assert r["logit_cosine"] > DET_INT8_COS, r
        row_topk.launches = 0
        call()
        r["row_topk_launches_per_call"] = row_topk.launches
        if timing:
            turns = [host_ms(fn, 3) for fn in (float_call, call, call,
                                               float_call)]
            r["call_ms"] = turns[1:3]
            r["float_call_ms"] = turns[::3]
            r["img_per_s"] = batch * 2e3 / sum(turns[1:3])
    det.cfg = det.model.cfg = cfg
    emit({"phase": "detect_int8", **res})
    return res


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
    for lo, hi, *row in holes:      # (lo, hi) every row, (lo, hi, r) row r
        valid[row[0] if row else slice(None), lo:hi] = 0
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
# cross-image REC (grounding phase, a 448x576 bucket, 8 images): the
# batched prefix rows and the suffix rows over per-row prefix KV; the
# real lengths differ by row here, so a per-row mask slip shows
K2_REC_PREFIX = (8, 384, 384, 16, 8, 128, True,
                 tuple((262 + 9 * r, 384, r) for r in range(8)))
K2_REC_SUFFIX = (8, 256, 640, 16, 8, 128, True,
                 tuple((262 + 9 * r, 384, r) for r in range(8))
                 + tuple((600 - 11 * r, 640, r) for r in range(8)))
K2_GRID = [  # tests/test_flash_gqa.py's grid, and fully masked rows
    (2, 128, 384, 4, 2, 128, True, ()),
    (1, 128, 128, 4, 1, 128, True, ()),
    (2, 128, 640, 8, 2, 128, True, ((312, 320), (635, 640))),
    (1, 256, 256, 8, 8, 128, False, ((120, 128), (251, 256))),
    (1, 128, 512, 16, 8, 128, True, ((248, 256), (507, 512))),
    (1, 128, 256, 4, 2, 128, True, ((0, 132),)),
    (2, 96, 384, 4, 2, 128, True, ((200, 216),)),  # S*G = 192: partial
]
# D = 256 (JAX tiles any D % 128 == 0): the SIMT kernels in both types
K2_D256 = [
    (2, 128, 384, 4, 2, 256, True, ((200, 216),)),
    (1, 256, 256, 8, 8, 256, False, ((120, 128),)),
]
# D = 384: the SIMT kernels' 32 x 32 forward and 16 x 16 backward tiles
K2_D384 = (1, 128, 256, 4, 2, 384, True, ((120, 136),))
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


# a forward phase's worst max_abs_err by (type, route): f32 on the FFMA
# kernel (K2 at D = 128) and on the SIMT one, bf16 on the wgmma kernel
# and on the SIMT one
ROUTE_ERRORS = {(torch.float32, "f32"): "max_abs_err_f32",
                (torch.float32, "simt"): "max_abs_err_f32_simt",
                (torch.bfloat16, "sm90"): "max_abs_err_bf16",
                (torch.bfloat16, "simt"): "max_abs_err_bf16_simt"}


def route_errors(worst):
    return {ROUTE_ERRORS[key]: err for key, err in worst.items()}


def simt_fwd(q, k, v, valid, causal, sm_scale):
    """The SIMT forward (csrc/flash_attn.cu) called through its library:
    the kernel f32 at D = 128 ran before gqa_flash_fwd_f32 of
    csrc/flash_gqa_f32.cu (no launch counted): (O, lse)."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    return fg._launch_fwd("gqa_flash_attention", fg._lib().gqa_flash_fwd,
                          q, k, v, valid, causal, sm_scale,
                          int(q.dtype == torch.bfloat16))


def k2_mask(valid, s, lk):
    """SDPA's boolean mask for a causal K2 case: valid keys at or before
    each query's position."""
    qpos = lk - s + torch.arange(s, device=valid.device)
    return (valid.bool()[:, None, None, :]
            & (torch.arange(lk, device=valid.device)[None, :]
               <= qpos[:, None])[None, None])


def phase_k2(dev, timing: bool = True):
    from wedetect_tpu_torch.ops.flash_gqa import (fwd_route,
                                                  gqa_flash_attention,
                                                  gqa_flash_attention_plain,
                                                  gqa_flash_fwd_f32,
                                                  gqa_flash_fwd_sm90)

    checks, worst = [], {}
    cases = [K2_PREFIX, K2_SUFFIX, K2_REC_PREFIX, K2_REC_SUFFIX, K2_TRAIN,
             *K2_GRID, *K2_D256, K2_D384]
    gqa_flash_fwd_sm90.launches = gqa_flash_fwd_f32.launches = 0
    routed = {"sm90": 0, "f32": 0, "simt": 0}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(cases):
            b, s, lk, h, kvh, d, causal, holes = case
            q, k, v, valid = k2_case(dev, *case, dtype=dtype, seed=i)
            o, lse = gqa_flash_attention(q, k, v, causal=causal,
                                         kv_valid=valid, return_lse=True)
            torch.cuda.synchronize()
            po, plse = gqa_flash_attention_plain(
                q, k, v, causal=causal, kv_valid=valid, return_lse=True)
            err = float((o.float() - po.float()).abs().max())
            lse_err = float((lse - plse).abs().max())
            # rows without a visible valid key keep lse <= -1e29 (K2-bwd's
            # skip rule reads it)
            ok = (kernel_close(o, po, dtype) and lse_err <= 1e-3
                  and torch.equal(lse <= -1e29, plse <= -1e29))
            route = fwd_route(dtype, d, h // kvh)
            checks.append({"shape": [b, s, lk, h, kvh, d], "causal": causal,
                           "dtype": str(dtype)[6:], "route": route,
                           "max_abs_err": err, "lse_err": lse_err,
                           "match": ok})
            if not ok:
                emit({"phase": "k2", "checks": checks})
                raise AssertionError(f"K2 disagrees at {case} {dtype}")
            worst[(dtype, route)] = max(worst.get((dtype, route), 0.0), err)
            routed[route] += 1
            del q, k, v, o, lse, po, plse
    # every check at D = 128 ran its type's kernel (bf16 the wgmma one,
    # f32 the FFMA one); D = 256 and 384 the SIMT one
    assert (gqa_flash_fwd_sm90.launches, gqa_flash_fwd_f32.launches) == (
        routed["sm90"], routed["f32"]), (routed, gqa_flash_fwd_sm90.launches,
                                         gqa_flash_fwd_f32.launches)
    res = {"checks": checks, **route_errors(worst)}
    if timing:
        for name, case in (("prefix", K2_PREFIX), ("suffix", K2_SUFFIX),
                           ("train", K2_TRAIN), ("d256", K2_D256[0])):
            b, s, lk, h, kvh, d, causal, holes = case
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, valid = k2_case(dev, *case, dtype=dtype, seed=0)
                pairs = k2_visible_pairs(s, lk, causal, valid)
                mask = k2_mask(valid, s, lk)
                r = attn_bound(h, d, pairs, q.numel() + 2 * k.numel(),
                               q.numel(), b * s * h, dtype)
                # ms and library_ms: device time (graph_ms), the same
                # method for both; *_call_ms: eager calls with the host
                # between them (cuda_ms), the host's rate where it is
                # slower than the card
                call = lambda: gqa_flash_attention(  # noqa: E731
                    q, k, v, causal=True, kv_valid=valid)
                lib = lambda: sdpa_gqa(q, k, v, mask)  # noqa: E731
                r["ms"] = graph_ms(call)
                r["call_ms"] = cuda_ms(call, iters=10)
                r["plain_ms"] = cuda_ms(lambda: gqa_flash_attention_plain(
                    q, k, v, causal=True, kv_valid=valid), iters=3,
                    warmup=1)
                r["library_ms"] = graph_ms(lib)
                r["library_call_ms"] = cuda_ms(lib, iters=10)
                r["visible_pairs"] = pairs
                res[f"{name}_{str(dtype)[6:]}"] = r
                if fwd_route(dtype, d, h // kvh) == "f32":
                    scale = 1.0 / math.sqrt(d)
                    res[f"{name}_simt_float32"] = simt_turns(
                        "K2", lambda: simt_fwd(q, k, v, valid, True, scale),
                        lambda: gqa_flash_attention_plain(
                            q, k, v, causal=True, kv_valid=valid,
                            sm_scale=scale, return_lse=True), r, call)
                if name == "train" and dtype == torch.float32:
                    r.update(k2_walk(q, k, v, valid))
                del q, k, v, valid, mask
    emit({"phase": "k2", **res})
    return res


def simt_turns(kernel, simt, plain, route_timing, call):
    """The SIMT forward an f32 kernel replaced (`simt`, through its
    library), at a timed f32 shape: held to the plain version (`plain`;
    K_TOL, lse 1e-3), and timed in turns with the route (`call`) as
    device time (SIMT, f32, f32, SIMT). Returns its timing entry (the
    route's bound, plain and library times)."""
    o, lse = simt()
    po, plse = plain()
    err = float((o - po).abs().max())
    assert kernel_close(o, po, torch.float32) and float(
        (lse - plse).abs().max()) <= 1e-3, (f"simt {kernel}", err)
    del o, lse, po, plse
    turns = [graph_ms(fn) for fn in (simt, call, call, simt)]
    route_timing["turns_ms"] = {"simt": turns[::3], "f32": turns[1:3]}
    keep = ("bound_ms", "bound_by", "flops", "bytes", "plain_ms",
            "library_ms", "visible_pairs")
    return {**{key: route_timing[key] for key in keep}, "ms": turns[0],
            "turns_ms": turns[::3], "max_abs_err": err}


def k2_walk(q, k, v, valid):
    """The f32 forward's walk at a causal shape, read back from the kernel
    and counted by the skip rule (fwd_walk_map), and the tiles the
    frontier alone scans (the SIMT kernel's walk)."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    b, s, h, d = q.shape
    lk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, _ = fg.fwd_f32_tile(b, s, g, kvh, sms)
    rule = fg.fwd_walk_map(s, lk, g, kvh, True, valid, rows=rows)
    walked = torch.zeros(rule.shape[:3], dtype=torch.int32, device=q.device)
    fg.gqa_flash_fwd_f32(q, k, v, valid, True, 1.0 / math.sqrt(d),
                         walked=walked)
    scanned = fg.fwd_walk_map(s, lk, g, kvh, True, torch.zeros_like(valid),
                              rows=rows)
    res = {"tile_rows": rows, "tiles_walked": int(walked.sum()),
           "rule_tiles_walked": int(rule.sum()),
           "rule_tiles_scanned": int(scanned.sum())}
    assert torch.equal(walked, rule.sum(-1).int()), ("K2 walk != rule", res)
    return res


K3_VIT = (1, 1280, 16, 64, 1200, False)      # 480x640: 1200 real tokens
# cross-image REC's batched ViT (grounding phase): 8 images of the
# 448x576 bucket, 1008 real tokens padded to 1024
K3_REC = (8, 1024, 16, 64, 1008, False)
# the training path's ViT attention (--grid-tokens 1024: 4144 tokens
# padded to 4224)
K3_TRAIN = (1, 4224, 16, 64, 4144, False)
K3_D256 = (1, 1280, 4, 256, 1200, False)
# D = 72: a head dim the SIMT kernels are not built for, zero-padded to
# 128 by the wrappers (ops/flash_attention.simt_head_dim)
K3_D72 = (1, 256, 2, 72, 200, False)
# three segments with boundaries off the 64-grid (ids 1 on [0, 100), 2 on
# [100, 300), 3 on [300, 480), 0 after), where the wgmma kernels take
# their per-element path
K3_THREE_SEGMENTS = (1, 512, 4, 64, ((100, 1), (300, 2), (480, 3)), False)
# the controls' wrong attention: one 64-key tile masked
K3_CONTROL_DROP = slice(64, 128)
K3_CASES = [K3_VIT, K3_REC, K3_TRAIN, (1, 1280, 16, 64, 1280, True),
            (1, 384, 4, 64, ((150, 1), (300, 2)), True),  # causal + ids
            K3_THREE_SEGMENTS, (1, 200, 4, 64, 180, False),  # a tail
            (2, 256, 4, 128, 200, False), K3_D256, (1, 256, 2, 256, 256,
                                                     True), K3_D72]


def k3_case(dev, b, l, h, d, n_real, causal, dtype, seed):
    """q, k, v and segment ids (B, L): n_real real tokens in segment 1
    and pad in 0, or for a tuple of (end, id) runs, each run's id up to
    its end, then 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, l, h, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    seg = torch.zeros(l, dtype=torch.int32, device=dev)
    start = 0
    for end, sid in ((n_real, 1),) if isinstance(n_real, int) else n_real:
        seg[start:end] = sid
        start = end
    return q, k, v, seg[None].expand(b, l).contiguous()


def k3_real(n_real) -> int:
    """The rows a K3 case's caller keeps: up to the end of its last run."""
    return n_real if isinstance(n_real, int) else n_real[-1][0]


def phase_k3(dev, timing: bool = True):
    from wedetect_tpu_torch.ops import flash_attention as fa

    checks, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(K3_CASES):
            b, l, h, d, n_real, causal = case
            route = fa.fwd_route(dtype, d)
            q, k, v, seg = k3_case(dev, *case, dtype=dtype, seed=i)
            kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
                      sm_scale=d ** -0.5, return_lse=True)
            before = launch_counts()
            o, lse = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            after = launch_counts()
            po, plse = fa.flash_attention_plain(q, k, v, **kw)
            # the control: one 64-key tile dropped
            co, _ = fa.flash_attention_plain(
                q, k, v, **dict(kw, kv_segment_ids=_dropped_segs(
                    q, seg, K3_CONTROL_DROP)))
            real = k3_real(n_real)
            err = float((o[:, :real].float()
                         - po[:, :real].float()).abs().max())
            pad_err = float((o.float() - po.float()).abs().max())
            lse_err = float((lse - plse).abs().max())
            control_err = float((co.float() - po.float()).abs().max())
            # at D = 64 bf16 ran the wgmma kernel and f32 the FFMA one,
            # the rest the SIMT one
            launches = {n: after[n] - before[n]
                        for n in ("k3", "k3_sm90", "k3_f32")}
            want = {"k3": 1, "k3_sm90": int(route == "sm90"),
                    "k3_f32": int(route == "f32")}
            ok = (kernel_close(o, po, dtype) and lse_err <= 1e-3
                  and not kernel_close(co, po, dtype) and launches == want)
            checks.append({"shape": [b, l, h, d], "real": n_real,
                           "causal": causal, "dtype": str(dtype)[6:],
                           "route": route, "launches": launches,
                           "max_abs_err": err, "all_rows_err": pad_err,
                           "lse_err": lse_err,
                           "control_max_abs_err": control_err, "match": ok})
            if not ok:
                emit({"phase": "k3", "checks": checks})
                raise AssertionError(f"K3 disagrees at {case} {dtype}")
            worst[(dtype, route)] = max(worst.get((dtype, route), 0.0), err)
            del o, lse, po, plse, co
    res = {"checks": checks, **route_errors(worst)}
    if timing:
        for name, case in (("vit", K3_VIT), ("train", K3_TRAIN),
                           ("d256", K3_D256)):
            b, l, h, d, n_real, causal = case
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, seg = k3_case(dev, *case, dtype=dtype, seed=0)
                pairs = b * (n_real * n_real + (l - n_real) ** 2)
                mask = (seg[:, :, None] == seg[:, None, :])[:, None]
                r = attn_bound(h, d, pairs, 3 * q.numel(), q.numel(),
                               b * l * h, dtype)
                kw = dict(q_segment_ids=seg, kv_segment_ids=seg,
                          sm_scale=d ** -0.5)
                # ms and library_ms: device time (graph_ms), the same
                # method for both; *_call_ms: eager calls with the host
                # between them (cuda_ms)
                call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa
                lib = lambda: sdpa_gqa(q, k, v, mask)  # noqa: E731
                r["route"] = fa.fwd_route(dtype, d)
                r["ms"] = graph_ms(call)
                r["call_ms"] = cuda_ms(call, iters=10)
                r["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
                    q, k, v, **kw), iters=3, warmup=1)
                r["library_ms"] = graph_ms(lib)
                r["library_call_ms"] = cuda_ms(lib, iters=10)
                r["visible_pairs"] = pairs
                res[f"{name}_{str(dtype)[6:]}"] = r
                if r["route"] == "f32":
                    res[f"{name}_simt_float32"] = simt_turns(
                        "K3", lambda: simt_k3_fwd(q, k, v, seg, causal,
                                                  d ** -0.5),
                        lambda: fa.flash_attention_plain(
                            q, k, v, return_lse=True, **kw), r, call)
                    r.update(k3_walk(q, k, v, seg))
                del q, k, v, seg, mask
    emit({"phase": "k3", **res})
    return res


def simt_k3_fwd(q, k, v, seg, causal, sm_scale):
    """The SIMT K3 forward (csrc/flash_attn.cu) called through its library:
    the kernel f32 at D = 64 ran before flash_attention_fwd_f32 of
    csrc/flash_attn_f32.cu (no launch counted): (O, lse)."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    return fa._launch_fwd("flash_attention", fa._lib().flash_attention_fwd,
                          q, k, v, seg, seg, causal, sm_scale,
                          int(q.dtype == torch.bfloat16))


def k3_walk(q, k, v, seg):
    """The f32 forward's walk at a ViT shape (not causal) in the tile the
    route takes there (fwd_f32_tile), read back from the kernel and
    counted by the skip rule (fwd_walk_map, the same for every head), the
    tiles the frontier alone scans (the SIMT kernel's walk), and the
    other tile's device time."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    b, l, h, d = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, _ = fa.fwd_f32_tile(b, l, h, sms)
    rule = fa.fwd_walk_map(l, False, seg, seg, rows=rows).to(q.device)
    walked = torch.zeros((b, h, rule.shape[2]), dtype=torch.int32,
                         device=q.device)
    fa.flash_attention_fwd_f32(q, k, v, seg, seg, False, d ** -0.5,
                               walked=walked)
    res = {"tile_rows": rows, "tiles_walked": int(walked.sum()),
           "rule_tiles_walked": h * int(rule.sum()),
           "rule_tiles_scanned": b * h * rule.shape[2] * rule.shape[3]}
    assert torch.equal(walked, rule.sum(-1).int().expand(b, h, -1)), (
        "K3 walk != rule", res)
    other = next(n for n in fa.FWD_F32_TILES if n != rows)
    res["other_tile"] = {"rows": other, "ms": graph_ms(
        lambda: fa.flash_attention_fwd_f32(q, k, v, seg, seg, False,
                                           d ** -0.5, rows=other))}
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
# bf16 also holds the mean error over all 800 logits, where the margin
# is wider: the H100 read the kernels' mean at 0.0130 and the control's
# at 0.0417; the limit sits between them
REF_LOGIT_MEAN_TOL = {"float32": None, "bfloat16": 0.025}
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

    return {"k2": fg.gqa_flash_attention,
            "k2_sm90": fg.gqa_flash_fwd_sm90,
            "k2_f32": fg.gqa_flash_fwd_f32,
            "k2_bwd_dq": fg.gqa_flash_bwd_dq,
            "k2_bwd_dkdv": fg.gqa_flash_bwd_dkdv,
            "k2_bwd_dq_sm90": fg.gqa_flash_bwd_dq_sm90,
            "k2_bwd_dkdv_sm90": fg.gqa_flash_bwd_dkdv_sm90,
            "k2_bwd_dkdv_f32": fg.gqa_flash_bwd_dkdv_f32,
            "k2_bwd_dq_f32": fg.gqa_flash_bwd_dq_f32,
            "k3": fa.flash_attention,
            "k3_sm90": fa.flash_attention_fwd_sm90,
            "k3_f32": fa.flash_attention_fwd_f32,
            "k3_bwd_dq": fa.flash_attention_bwd_dq,
            "k3_bwd_dkv": fa.flash_attention_bwd_dkv,
            "k3_bwd_dq_sm90": fa.flash_attention_bwd_dq_sm90,
            "k3_bwd_dkv_sm90": fa.flash_attention_bwd_dkv_sm90,
            "k3_bwd_dkv_f32": fa.flash_attention_bwd_dkv_f32,
            "k3_bwd_dq_f32": fa.flash_attention_bwd_dq_f32}


def launch_counts(reset: bool = False):
    """The launch counts of the attention kernels (set to 0 first with
    `reset`): "k2" counts every K2 forward route, "k2_sm90" the bf16
    wgmma one's alone, "k2_f32" the f32 FFMA one's; likewise "k3",
    "k3_sm90" and "k3_f32", "k2_bwd_*" and "k2_bwd_*_sm90", "k3_bwd_*" and
    "k3_bwd_*_sm90"; "k2_bwd_dkdv_f32", "k2_bwd_dq_f32", "k3_bwd_dkv_f32"
    and "k3_bwd_dq_f32" the FFMA kernels' alone."""
    counters = _flash_counters()
    if reset:
        for fn in counters.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in counters.items()}


def expected_counts(k2=0, k3=0, k2_bwd=0, k3_bwd=0, k2_sm90=0,
                    k2_bwd_sm90=0, k3_sm90=0, k3_bwd_sm90=0,
                    k2_bwd_dkdv_f32=0, k2_bwd_dq_f32=0, k3_bwd_dkv_f32=0,
                    k3_bwd_dq_f32=0, k2_f32=0, k3_f32=0):
    return {"k2": k2, "k2_sm90": k2_sm90, "k2_f32": k2_f32,
            "k2_bwd_dq": k2_bwd,
            "k2_bwd_dkdv": k2_bwd, "k2_bwd_dq_sm90": k2_bwd_sm90,
            "k2_bwd_dkdv_sm90": k2_bwd_sm90,
            "k2_bwd_dkdv_f32": k2_bwd_dkdv_f32,
            "k2_bwd_dq_f32": k2_bwd_dq_f32, "k3": k3, "k3_sm90": k3_sm90,
            "k3_f32": k3_f32,
            "k3_bwd_dq": k3_bwd,
            "k3_bwd_dkv": k3_bwd, "k3_bwd_dq_sm90": k3_bwd_sm90,
            "k3_bwd_dkv_sm90": k3_bwd_sm90,
            "k3_bwd_dkv_f32": k3_bwd_dkv_f32,
            "k3_bwd_dq_f32": k3_bwd_dq_f32}


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
        # bf16: every K2 and K3 launch is a wgmma kernel; f32: every K2
        # and K3 launch an FFMA kernel
        k2, k3 = 2 * cfg.text.layers, cfg.vision.depth
        bf16 = name == "bfloat16"
        assert counts == expected_counts(
            k2=k2, k2_sm90=k2 if bf16 else 0, k2_f32=0 if bf16 else k2,
            k3=k3, k3_sm90=k3 if bf16 else 0,
            k3_f32=0 if bf16 else k3), counts
        logits = scorer.logits(image, boxes, REF_QUERIES)
        with plain_attention():
            plain = scorer.logits(image, boxes, REF_QUERIES)
        with plain_attention(drop=REF_CONTROL_DROP):
            wrong = scorer.logits(image, boxes, REF_QUERIES)
        tol, mean_tol = REF_LOGIT_TOL[name], REF_LOGIT_MEAN_TOL[name]
        r = res[name] = {
            "launches": counts, "tolerance": tol, "mean_tolerance": mean_tol,
            "plain_logit_max_abs_err": float(np.abs(logits - plain).max()),
            "control_logit_max_abs_err": float(np.abs(wrong - plain).max()),
            "plain_logit_mean_abs_err": float(np.abs(logits - plain).mean()),
            "control_logit_mean_abs_err": float(
                np.abs(wrong - plain).mean()),
            "logit_range": [float(plain.min()), float(plain.max())],
            "score_range": [float(scores.min()), float(scores.max())]}
        ok = r["plain_logit_max_abs_err"] <= tol < r[
            "control_logit_max_abs_err"]
        if mean_tol is not None:
            ok = ok and r["plain_logit_mean_abs_err"] <= mean_tol < r[
                "control_logit_mean_abs_err"]
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


def ref_parity_case():
    """A miniature Ref (head_dim 128, so K2 tiles) and a joint scoring
    batch on an 8x12-patch image: (cfg, gh, gw, ref_score_step's
    arguments after the grid)."""
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
    return cfg, gh, gw, (patches, ids, mask, pos, 3, boxes,
                         np.array([48.0, 32.0], np.float32), obj)


def phase_ref_parity(dev):
    """A miniature Ref (head_dim 128, so K2 tiles) on the card through
    both kernels against the same weights on the CPU (einsum)."""
    from wedetect_tpu_torch.models.ref import (init_ref_variables,
                                               ref_score_step)

    cfg, gh, gw, args = ref_parity_case()
    cpu = init_ref_variables(cfg, seed=5, device="cpu")
    card = init_ref_variables(cfg, seed=5, device=dev)
    card.load_state_dict(cpu.state_dict())
    launch_counts(reset=True)
    got = ref_score_step(card, gh, gw, *args)
    counts = launch_counts()
    want = ref_score_step(cpu, gh, gw, *args)
    err = float((got.cpu() - want).abs().max())
    assert counts == expected_counts(k2=2, k2_f32=2, k3=2, k3_f32=2), counts
    assert err < 1e-5, err
    emit({"phase": "ref_parity", "logits_max_abs_err": err,
          "launches": counts})


# int8 prefill against the float call, pre-sigmoid logits at ref_2b
# (max and mean over the 800), set before the first reading on the card
REF_INT8_TOL = {"float32": (0.5, 0.1), "bfloat16": (0.5, 0.1)}


def phase_ref_int8(dev, inputs, cfg=None, timing: bool = True):
    """ref_2b's int8 prefill through RefScorer(quant_prefill=True).score,
    f32 and bf16: K2 = 56 and K3 = 24 launches a call on the type's
    routes, the logits against the float scorer on the same weights
    within REF_INT8_TOL, the scorer's int8 modules off again after each
    call; ms a call, int8 and float in turns."""
    from wedetect_tpu_torch.models import ref_api
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b
    from wedetect_tpu_torch.ops import int8 as TI

    cfg = cfg or ref_2b()
    image, boxes = inputs
    torch.cuda.empty_cache()
    model = init_ref_variables(cfg, seed=0, device=dev)
    tok = CharTok()
    res = {"queries": len(REF_QUERIES), "proposals": len(boxes)}
    for name in ("float32", "bfloat16"):
        flt = ref_api.RefScorer(cfg=cfg, model=model, tokenizer=tok,
                                dtype=name, device=dev)
        q = ref_api.RefScorer(cfg=cfg, model=model, tokenizer=tok,
                              dtype=name, device=dev, quant_prefill=True)
        launch_counts(reset=True)
        scores = q.score(image, boxes, REF_QUERIES)
        counts = launch_counts()
        assert np.isfinite(scores).all() and scores.shape == (
            len(REF_QUERIES), len(boxes))
        k2, k3 = 2 * cfg.text.layers, cfg.vision.depth
        bf16 = name == "bfloat16"
        assert counts == expected_counts(
            k2=k2, k2_sm90=k2 if bf16 else 0, k2_f32=0 if bf16 else k2,
            k3=k3, k3_sm90=k3 if bf16 else 0,
            k3_f32=0 if bf16 else k3), counts
        assert not any(m.quant for m in model.modules()
                       if isinstance(m, TI.QuantLinear))
        ql = q.logits(image, boxes, REF_QUERIES)
        fl = flt.logits(image, boxes, REF_QUERIES)
        tol, mean_tol = REF_INT8_TOL[name]
        r = res[name] = {
            "launches": counts, "tolerance": tol, "mean_tolerance": mean_tol,
            "logit_max_abs_err": float(np.abs(ql - fl).max()),
            "logit_mean_abs_err": float(np.abs(ql - fl).mean()),
            "logit_range": [float(fl.min()), float(fl.max())],
            "top1_agree": float((ql.argmax(1) == fl.argmax(1)).mean())}
        if timing:
            turns = [host_ms(lambda s=s: s.score(image, boxes,
                                                 REF_QUERIES), 3)
                     for s in (flt, q, q, flt)]
            r["score_ms"] = turns[1:3]
            r["float_score_ms"] = turns[::3]
        emit({"phase": "ref_int8", "dtype": name, **r})
        assert r["logit_max_abs_err"] <= tol \
            and r["logit_mean_abs_err"] <= mean_tol, r
    del model
    torch.cuda.empty_cache()
    return res


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
# ~1253 real tokens: the last 795 keys invalid); its ViT attention is
# K3_TRAIN
K2_TRAIN = (1, 2048, 2048, 16, 8, 128, True, ((1253, 2048),))
# the backward's further cases: S = 336 has bq = 16, so F moves every 32
# folded rows, inside a 64-row tile of the dk/dv kernel; and D = 256
K2_BWD_MORE = [
    (1, 336, 384, 4, 2, 128, True, ((100, 110),)),
    (1, 128, 256, 4, 2, 256, True, ((120, 136),)),
    (1, 256, 256, 4, 4, 256, False, ()),
    K2_D384,
]


def rel_err(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def sdpa_bwd_ms(q, k, v, mask, do, iters, timer=None):
    """SDPA's backward alone: autograd.grad through the forward, minus
    the forward (a yardstick; the port never calls it). `timer`:
    graph_ms (device time) or, by default, cuda_ms over eager calls."""
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        o = sdpa_gqa(qs, ks, vs, mask)
        torch.autograd.grad(o, (qs, ks, vs), do)

    def fwd():
        sdpa_gqa(qs, ks, vs, mask)

    if timer is None:
        return cuda_ms(fwd_bwd, iters=iters) - cuda_ms(fwd, iters=iters)
    return timer(fwd_bwd) - timer(fwd)


def check_bwd(name, got, again, plain, control, dtype):
    """Each gradient within TRAIN_BWD_TOL of the plain one (relative to
    its largest entry), repeats bitwise, the control outside the limit."""
    tol = TRAIN_BWD_TOL[dtype]
    errs = [rel_err(g, w) for g, w in zip(got, plain)]
    ctrl = [rel_err(c, w) for c, w in zip(control, plain)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = same and max(errs) <= tol < max(ctrl)
    abs_errs = [float((g.float() - w.float()).abs().max())
                for g, w in zip(got, plain)]
    res = {"dtype": str(dtype)[6:], "rel_err": dict(zip("qkv", errs)),
           "abs_err": dict(zip("qkv", abs_errs)),
           "max_abs_err": max(abs_errs),
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


def k2_control_drop(valid):
    """The control's dropped tile: BWD_CONTROL_DROP, or the first later
    64-key tile that holds a valid key (dropping only invalid keys
    changes nothing)."""
    lo = BWD_CONTROL_DROP.start
    while not bool(valid[:, lo:lo + 64].any()):
        lo += 64
    return slice(lo, lo + 64)


# K2-bwd's kernels by (product, route): dq goes by dq_route, dk/dv by
# dkdv_route
K2_BWD_KERNELS = {("dq", "simt"): "gqa_flash_bwd_dq",
                  ("dq", "sm90"): "gqa_flash_bwd_dq_sm90",
                  ("dq", "f32"): "gqa_flash_bwd_dq_f32",
                  ("dkdv", "simt"): "gqa_flash_bwd_dkdv",
                  ("dkdv", "sm90"): "gqa_flash_bwd_dkdv_sm90",
                  ("dkdv", "f32"): "gqa_flash_bwd_dkdv_f32"}


def k2_bwd_launches(counts):
    """K2-bwd's launches by kernel from launch_counts() (or the difference
    of two readings): "k2_bwd_dq" and "k2_bwd_dkdv" count every route, so
    a SIMT kernel's share is its counter's less the other routes'."""
    return {"gqa_flash_bwd_dq": counts["k2_bwd_dq"]
            - counts["k2_bwd_dq_sm90"] - counts["k2_bwd_dq_f32"],
            "gqa_flash_bwd_dq_sm90": counts["k2_bwd_dq_sm90"],
            "gqa_flash_bwd_dq_f32": counts["k2_bwd_dq_f32"],
            "gqa_flash_bwd_dkdv": counts["k2_bwd_dkdv"]
            - counts["k2_bwd_dkdv_sm90"] - counts["k2_bwd_dkdv_f32"],
            "gqa_flash_bwd_dkdv_sm90": counts["k2_bwd_dkdv_sm90"],
            "gqa_flash_bwd_dkdv_f32": counts["k2_bwd_dkdv_f32"]}


def count_delta(before, after):
    return {n: after[n] - before[n] for n in after}


def k2_bwd_routes(dtype, d, g):
    from wedetect_tpu_torch.ops import flash_gqa as fg

    return {"dq": fg.dq_route(dtype, d, g),
            "dkdv": fg.dkdv_route(dtype, d, g)}


def keep_worst(errors, name, dtype, rel, abs_):
    """errors["<kernel>/<dtype>"]: the worst relative and absolute
    gradient errors of that kernel over the cases it ran."""
    e = errors.setdefault(f"{name}/{str(dtype)[6:]}",
                          {"max_rel_err": 0.0, "max_abs_err": 0.0})
    e["max_rel_err"] = max(e["max_rel_err"], rel)
    e["max_abs_err"] = max(e["max_abs_err"], abs_)


def simt_dq(q, k, v, valid, do, lse, delta, *, causal, sm_scale):
    """The SIMT dq kernel (csrc/flash_attn_bwd.cu) called through its
    library: the kernel f32 at D = 128 ran before gqa_flash_bwd_dq_f32 of
    csrc/flash_gqa_bwd_f32.cu (no launch counted)."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    dq = torch.empty_like(q)
    fg._launch_bwd("gqa_flash_bwd_dq", fg._bwd_lib().gqa_flash_bwd_dq, q, k,
                   v, valid, do, lse, delta, (dq,), causal, sm_scale,
                   int(q.dtype == torch.bfloat16))
    return dq


def simt_dkdv(q, k, v, valid, do, lse, delta, *, causal, sm_scale):
    """The SIMT dk/dv kernel (csrc/flash_attn_bwd.cu) called through its
    library: the kernel f32 at D = 128 ran before
    csrc/flash_gqa_bwd_f32.cu (no launch counted)."""
    from wedetect_tpu_torch.ops import flash_gqa as fg

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fg._launch_bwd("gqa_flash_bwd_dkdv", fg._bwd_lib().gqa_flash_bwd_dkdv,
                   q, k, v, valid, do, lse, delta, (dk, dv), causal,
                   sm_scale, int(q.dtype == torch.bfloat16))
    return dk, dv


def phase_k2_bwd(dev, timing: bool = True):
    from wedetect_tpu_torch.ops import flash_gqa as fg

    checks, errors = [], {}
    phase_launches = dict.fromkeys(K2_BWD_KERNELS.values(), 0)
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate([K2_TRAIN, *K2_GRID, *K2_BWD_MORE]):
            b, s, lk, h, kvh, d, causal, holes = case
            routes = k2_bwd_routes(dtype, d, h // kvh)
            args, kw = k2_bwd_run(dev, case, dtype, seed=i)
            q, k, v, valid, o, lse, do = args
            before = launch_counts()
            got = fg.gqa_flash_attention_bwd(*args, **kw)
            again = fg.gqa_flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            after = launch_counts()
            plain = fg.gqa_flash_attention_bwd_plain(*args, kw["causal"],
                                                     kw["sm_scale"])
            drop = k2_control_drop(valid)
            control = fg.gqa_flash_attention_bwd_plain(
                q, k, v, _dropped_valid(k, valid, drop), o, lse, do,
                kw["causal"], kw["sm_scale"])
            r = check_bwd("k2_bwd", got, again, plain, control, dtype)
            # each product's kernel on its route launched twice, the
            # others never
            launched = k2_bwd_launches(count_delta(before, after))
            want = dict.fromkeys(launched, 0)
            for kind in ("dq", "dkdv"):
                want[K2_BWD_KERNELS[(kind, routes[kind])]] = 2
            checks.append({"shape": list(case[:6]), "causal": causal,
                           "routes": routes, "launches": launched,
                           "control_drop": [drop.start, drop.stop], **r})
            assert launched == want, (case, dtype, launched)
            for n, c in launched.items():
                phase_launches[n] += c
            for kind, grads in (("dq", "q"), ("dkdv", "kv")):
                keep_worst(errors, K2_BWD_KERNELS[(kind, routes[kind])],
                           dtype, max(r["rel_err"][x] for x in grads),
                           max(r["abs_err"][x] for x in grads))
            del got, again, plain, control
    res = {"checks": checks, "errors": errors, "launches": phase_launches}

    # the path a user calls: loss.backward() through gqa_flash_attention
    # in bf16 at the training shape (no CLI trains in bf16; f32 is the
    # train phases' path)
    args, kw = k2_bwd_run(dev, K2_TRAIN, torch.bfloat16, seed=0)
    q, k, v, valid, o, lse, do = args
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launch_counts(reset=True)
    out = fg.gqa_flash_attention(*leaves, kv_valid=valid, **kw)
    out.backward(do)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == expected_counts(k2=1, k2_sm90=1, k2_bwd=1,
                                     k2_bwd_sm90=1), counts
    plain = fg.gqa_flash_attention_bwd_plain(*args, kw["causal"],
                                             kw["sm_scale"])
    errs = [rel_err(t.grad, w) for t, w in zip(leaves, plain)]
    res["autograd_bf16"] = {"launches": counts,
                            "rel_err": dict(zip("qkv", errs))}
    assert max(errs) <= TRAIN_BWD_TOL[torch.bfloat16], errs
    del leaves, out, plain

    if timing:
        b, s, lk, h, kvh, d, causal, holes = K2_TRAIN
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = k2_bwd_run(dev, K2_TRAIN, dtype, seed=0)
            q, k, v, valid, o, lse, do = args
            routes = k2_bwd_routes(dtype, d, h // kvh)
            pairs = k2_visible_pairs(s, lk, causal, valid)
            delta = fg.row_delta(o, do, kvh)
            mask = k2_mask(valid, s, lk)
            plain_ms = cuda_ms(lambda: fg.gqa_flash_attention_bwd_plain(
                *args, causal, kw["sm_scale"]), iters=2, warmup=1)
            # ms and library_ms: device time (graph_ms), one method for
            # both; *_call_ms: eager calls (cuda_ms), host between them
            lib_ms = sdpa_bwd_ms(q, k, v, mask, do, iters=5, timer=graph_ms)
            lib_call_ms = sdpa_bwd_ms(q, k, v, mask, do, iters=5)
            kernels = [("dq", fg.gqa_flash_bwd_dq, routes["dq"]),
                       ("dkdv", fg.gqa_flash_bwd_dkdv, routes["dkdv"])]
            # the SIMT kernels the FFMA ones replaced, held to the plain
            # version (dq also against the dropped-tile control)
            pdq = pdk = pdv = None
            if "f32" in routes.values():
                pdq, pdk, pdv = fg.gqa_flash_attention_bwd_plain(
                    *args, causal, kw["sm_scale"])
            if routes["dq"] == "f32":
                got = simt_dq(q, k, v, valid, do, lse, delta, **kw)
                cdq, _, _ = fg.gqa_flash_attention_bwd_plain(
                    q, k, v, _dropped_valid(k, valid, k2_control_drop(valid)),
                    o, lse, do, causal, kw["sm_scale"])
                e, ctrl = rel_err(got, pdq), rel_err(cdq, pdq)
                assert e <= TRAIN_BWD_TOL[dtype] < ctrl, ("simt dq", e, ctrl)
                keep_worst(errors, "gqa_flash_bwd_dq", dtype, e,
                           float((got - pdq).abs().max()))
                res["dq_simt_control_rel_err"] = ctrl
                del got, cdq
                kernels.append(("dq_simt", simt_dq, "simt"))
            if routes["dkdv"] == "f32":
                got = simt_dkdv(q, k, v, valid, do, lse, delta, **kw)
                for w, g_ in zip((pdk, pdv), got):
                    e = rel_err(g_, w)
                    assert e <= TRAIN_BWD_TOL[dtype], ("simt dkdv", e)
                    keep_worst(errors, "gqa_flash_bwd_dkdv", dtype, e,
                               float((g_ - w).abs().max()))
                del got
                kernels.append(("dkdv_simt", simt_dkdv, "simt"))
            del pdq, pdk, pdv
            for kind, fn, route in kernels:
                product = kind.split("_")[0]
                r = attn_bwd_bound(h, d, pairs, q.numel(), k.numel(),
                                   b * s * h, dtype, product)
                call = lambda: fn(q, k, v, valid, do, lse, delta,  # noqa
                                  **kw)
                r["route"] = route
                r["ms"] = graph_ms(call)
                r["call_ms"] = cuda_ms(call, iters=5)
                r["plain_ms"] = plain_ms
                r["library_ms"] = lib_ms
                r["library_call_ms"] = lib_call_ms
                r["visible_pairs"] = pairs
                if route == "f32":
                    # the kernel's tiles as the skip rule counts them
                    # (dk/dv 32 rows x 64 keys, dq 64 x 32): walked, and
                    # scanned by the frontier alone
                    # (every row as if it saw no valid key); each
                    # kernel's walk also read back from the kernel
                    walk_map = (fg.dkdv_walk_map if product == "dkdv"
                                else fg.dq_walk_map)
                    rule = walk_map(s, lk, h // kvh, causal, valid, lse)
                    r["rule_tiles_walked"] = int(rule.sum())
                    r["rule_tiles_scanned"] = int(walk_map(
                        s, lk, h // kvh, causal, valid,
                        torch.full_like(lse, float("-inf"))).sum())
                    walked = torch.zeros(rule.shape[:3], dtype=torch.int32,
                                         device=dev)
                    outs = ((torch.empty_like(q),) if product == "dq"
                            else (torch.empty_like(k), torch.empty_like(v)))
                    getattr(fg, f"gqa_flash_bwd_{product}_f32")(
                        q, k, v, valid, do, lse, delta, *outs,
                        walked=walked, **kw)
                    r["tiles_walked"] = int(walked.sum())
                    assert torch.equal(walked, rule.sum(-1).int()), (
                        f"{product} walk != rule", r["tiles_walked"],
                        r["rule_tiles_walked"])
                res[f"{kind}_{str(dtype)[6:]}"] = r
            # before and after in turns: SIMT, f32, f32, SIMT
            for product, simt in (("dq", simt_dq), ("dkdv", simt_dkdv)):
                if routes[product] != "f32":
                    continue
                new = getattr(fg, f"gqa_flash_bwd_{product}")
                turns = [graph_ms(lambda fn=fn: fn(  # noqa: E731
                    q, k, v, valid, do, lse, delta, **kw))
                    for fn in (simt, new, new, simt)]
                res[f"{product}_turns_float32"] = {"simt_ms": turns[::3],
                                                   "f32_ms": turns[1:3]}
    emit({"phase": "k2_bwd", **res})
    return res


def k3_bwd_run(dev, case, dtype, seed):
    from wedetect_tpu_torch.ops import flash_attention as fa

    b, l, h, d, n_real, causal = case
    q, k, v, seg = k3_case(dev, *case, dtype=dtype, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    do = torch.randn((b, l, h, d), generator=g, device=dev).to(dtype)
    do[seg == 0] = 0                     # the ViT drops its pad rows
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, causal=causal,
              sm_scale=d ** -0.5)
    o, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, lse, do), kw


# K3-bwd's further cases: K3_THREE_SEGMENTS, a tail (L = 200) and D = 72
K3_BWD_MORE = [(1, 1280, 16, 64, 1280, True), (2, 256, 4, 128, 200, False),
               K3_THREE_SEGMENTS, (1, 200, 4, 64, 180, False), K3_D72]


# K3-bwd's kernels by (product, route): dq goes by fa.dq_route, dk/dv by
# fa.dkv_route
K3_BWD_KERNELS = {("dq", "simt"): "flash_attention_bwd_dq",
                  ("dq", "sm90"): "flash_attention_bwd_dq_sm90",
                  ("dq", "f32"): "flash_attention_bwd_dq_f32",
                  ("dkv", "simt"): "flash_attention_bwd_dkv",
                  ("dkv", "sm90"): "flash_attention_bwd_dkv_sm90",
                  ("dkv", "f32"): "flash_attention_bwd_dkv_f32"}


def k3_bwd_launches(counts):
    """K3-bwd's launches by kernel, as k2_bwd_launches."""
    return {"flash_attention_bwd_dq": counts["k3_bwd_dq"]
            - counts["k3_bwd_dq_sm90"] - counts["k3_bwd_dq_f32"],
            "flash_attention_bwd_dq_sm90": counts["k3_bwd_dq_sm90"],
            "flash_attention_bwd_dq_f32": counts["k3_bwd_dq_f32"],
            "flash_attention_bwd_dkv": counts["k3_bwd_dkv"]
            - counts["k3_bwd_dkv_sm90"] - counts["k3_bwd_dkv_f32"],
            "flash_attention_bwd_dkv_sm90": counts["k3_bwd_dkv_sm90"],
            "flash_attention_bwd_dkv_f32": counts["k3_bwd_dkv_f32"]}


def k3_bwd_routes(dtype, d):
    from wedetect_tpu_torch.ops import flash_attention as fa

    return {"dq": fa.dq_route(dtype, d), "dkv": fa.dkv_route(dtype, d)}


def simt_k3_dq(q, k, v, do, lse, delta, **kw):
    """The SIMT dq kernel (csrc/flash_attn_bwd.cu) called through its
    library: the kernel f32 at D = 64 ran before
    flash_attention_bwd_dq_f32 of csrc/flash_attn_bwd_f32.cu (no launch
    counted)."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    dq = torch.empty_like(q)
    fa._launch_bwd("flash_attention_bwd_dq",
                   fa._bwd_lib().flash_attention_bwd_dq, q, k, v, do, lse,
                   delta, (dq,), q.shape, kw, int(q.dtype == torch.bfloat16))
    return dq


def simt_dkv(q, k, v, do, lse, delta, **kw):
    """The SIMT dk/dv kernel (csrc/flash_attn_bwd.cu) called through its
    library: the kernel f32 at D = 64 ran before
    csrc/flash_attn_bwd_f32.cu (no launch counted)."""
    from wedetect_tpu_torch.ops import flash_attention as fa

    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fa._launch_bwd("flash_attention_bwd_dkv",
                   fa._bwd_lib().flash_attention_bwd_dkv, q, k, v, do, lse,
                   delta, (dk, dv), q.shape, kw,
                   int(q.dtype == torch.bfloat16))
    return dk, dv


def phase_k3_bwd(dev, timing: bool = True):
    from wedetect_tpu_torch.ops import flash_attention as fa

    checks, errors = [], {}
    phase_launches = dict.fromkeys(K3_BWD_KERNELS.values(), 0)
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate([K3_TRAIN, *K3_BWD_MORE]):
            routes = k3_bwd_routes(dtype, case[3])
            args, kw = k3_bwd_run(dev, case, dtype, seed=i)
            before = launch_counts()
            got = fa.flash_attention_bwd(*args, **kw)
            again = fa.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            after = launch_counts()
            plain = fa.flash_attention_bwd_plain(*args, **kw)
            ckw = dict(kw, kv_segment_ids=_dropped_segs(
                args[0], kw["kv_segment_ids"], BWD_CONTROL_DROP))
            control = fa.flash_attention_bwd_plain(*args, **ckw)
            r = check_bwd("k3_bwd", got, again, plain, control, dtype)
            # each product's kernel on its route launched twice (bf16 at
            # D = 64: the wgmma pair; f32 at D = 64: the FFMA pair), the
            # others never
            launched = k3_bwd_launches(count_delta(before, after))
            want = dict.fromkeys(launched, 0)
            for kind in ("dq", "dkv"):
                want[K3_BWD_KERNELS[(kind, routes[kind])]] = 2
            checks.append({"shape": list(case[:4]), "real": case[4],
                           "causal": case[5], "routes": routes,
                           "launches": launched, **r})
            assert launched == want, (case, dtype, launched)
            for n, c in launched.items():
                phase_launches[n] += c
            for kind, grads in (("dq", "q"), ("dkv", "kv")):
                keep_worst(errors, K3_BWD_KERNELS[(kind, routes[kind])], dtype,
                           max(r["rel_err"][x] for x in grads),
                           max(r["abs_err"][x] for x in grads))
            del got, again, plain, control
    res = {"checks": checks, "errors": errors, "launches": phase_launches}

    # the path a user calls: loss.backward() through flash_attention in
    # bf16 at the training shape (no CLI trains in bf16)
    args, kw = k3_bwd_run(dev, K3_TRAIN, torch.bfloat16, seed=0)
    q, k, v, o, lse, do = args
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launch_counts(reset=True)
    fa.flash_attention(*leaves, **kw).backward(do)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == expected_counts(k3=1, k3_sm90=1, k3_bwd=1,
                                     k3_bwd_sm90=1), counts
    plain = fa.flash_attention_bwd_plain(*args, **kw)
    errs = [rel_err(t.grad, w) for t, w in zip(leaves, plain)]
    res["autograd_bf16"] = {"launches": counts,
                            "rel_err": dict(zip("qkv", errs))}
    assert max(errs) <= TRAIN_BWD_TOL[torch.bfloat16], errs
    del leaves, plain

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
            # ms and library_ms: device time (graph_ms), one method for
            # both; *_call_ms: eager calls (cuda_ms), host between them
            lib_ms = sdpa_bwd_ms(q, k, v, mask, do, iters=5, timer=graph_ms)
            lib_call_ms = sdpa_bwd_ms(q, k, v, mask, do, iters=5)
            routes = k3_bwd_routes(dtype, d)
            kernels = [("dq", fa.flash_attention_bwd_dq, routes["dq"]),
                       ("dkv", fa.flash_attention_bwd_dkv, routes["dkv"])]
            # the SIMT kernels the FFMA ones replaced, held to the plain
            # version (dq also against the dropped-tile control)
            plain = None
            if "f32" in routes.values():
                plain = fa.flash_attention_bwd_plain(*args, **kw)
            if routes["dq"] == "f32":
                got = simt_k3_dq(q, k, v, do, lse, delta, **kw)
                cdq, _, _ = fa.flash_attention_bwd_plain(*args, **dict(
                    kw, kv_segment_ids=_dropped_segs(q, seg,
                                                     BWD_CONTROL_DROP)))
                e, ctrl = rel_err(got, plain[0]), rel_err(cdq, plain[0])
                assert e <= TRAIN_BWD_TOL[dtype] < ctrl, ("simt dq", e, ctrl)
                keep_worst(errors, "flash_attention_bwd_dq", dtype, e,
                           float((got - plain[0]).abs().max()))
                res["dq_simt_control_rel_err"] = ctrl
                del got, cdq
                kernels.append(("dq_simt", simt_k3_dq, "simt"))
            if routes["dkv"] == "f32":
                got = simt_dkv(q, k, v, do, lse, delta, **kw)
                for w, g_ in zip(plain[1:], got):
                    e = rel_err(g_, w)
                    assert e <= TRAIN_BWD_TOL[dtype], ("simt dkv", e)
                    keep_worst(errors, "flash_attention_bwd_dkv", dtype, e,
                               float((g_ - w).abs().max()))
                del got
                kernels.append(("dkv_simt", simt_dkv, "simt"))
            del plain
            for kind, fn, route in kernels:
                product = kind.split("_")[0]
                r = attn_bwd_bound(h, d, pairs, q.numel(), k.numel(),
                                   b * l * h, dtype,
                                   "dq" if product == "dq" else "dkdv")
                call = lambda: fn(q, k, v, do, lse, delta, **kw)  # noqa
                r["route"] = route
                r["ms"] = graph_ms(call)
                r["call_ms"] = cuda_ms(call, iters=5)
                r["plain_ms"] = plain_ms
                r["library_ms"] = lib_ms
                r["library_call_ms"] = lib_call_ms
                r["visible_pairs"] = pairs
                if route == "f32":
                    # the kernel's tiles (dq 128 rows x 64 keys, dk/dv 64 x
                    # 128) as the skip rule counts them: walked, and
                    # scanned with no skip (every row as if it saw no
                    # key); and the walk read back from the kernel
                    walk_map = (fa.dq_walk_map if product == "dq"
                                else fa.dkv_walk_map)
                    rule = walk_map(l, causal, seg, seg, lse)
                    r["rule_tiles_walked"] = int(rule.sum())
                    r["rule_tiles_scanned"] = int(walk_map(
                        l, causal, seg, seg,
                        torch.full_like(lse, float("-inf"))).sum())
                    walked = torch.zeros(rule.shape[:3], dtype=torch.int32,
                                         device=dev)
                    f32 = getattr(fa, f"flash_attention_bwd_{product}_f32")
                    f32(q, k, v, do, lse, delta, walked=walked, **kw)
                    r["tiles_walked"] = int(walked.sum())
                    assert torch.equal(walked, rule.sum(-1).int()), (
                        f"{product} walk != rule", r["tiles_walked"],
                        r["rule_tiles_walked"])
                res[f"{kind}_{str(dtype)[6:]}"] = r
            # before and after in turns: SIMT, f32, f32, SIMT
            for product, simt in (("dq", simt_k3_dq), ("dkv", simt_dkv)):
                if routes[product] != "f32":
                    continue
                new = getattr(fa, f"flash_attention_bwd_{product}")
                turns = [graph_ms(lambda fn=fn: fn(  # noqa: E731
                    q, k, v, do, lse, delta, **kw))
                    for fn in (simt, new, new, simt)]
                res[f"{product}_turns_{str(dtype)[6:]}"] = {
                    "simt_ms": turns[::3], "f32_ms": turns[1:3]}
            # the pair (dq and dk/dv on their routes) against SDPA's
            # whole backward
            pair = (res[f"dq_{str(dtype)[6:]}"]["ms"]
                    + res[f"dkv_{str(dtype)[6:]}"]["ms"])
            res[f"pair_{str(dtype)[6:]}"] = {"ms": pair, "library_ms": lib_ms,
                                             "over_library": pair / lib_ms}
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
                                        k2_f32=cfg.text.layers,
                                        k3=cfg.vision.depth,
                                        k3_f32=cfg.vision.depth,
                                        k2_bwd=cfg.text.layers,
                                        k3_bwd=cfg.vision.depth,
                                        k2_bwd_dkdv_f32=cfg.text.layers,
                                        k2_bwd_dq_f32=cfg.text.layers,
                                        k3_bwd_dkv_f32=cfg.vision.depth,
                                        k3_bwd_dq_f32=cfg.vision.depth))
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
                                        k2_f32=cfg.text.layers,
                                        k3=cfg.vision.depth,
                                        k3_f32=cfg.vision.depth,
                                        k2_bwd=cfg.text.layers,
                                        k3_bwd=cfg.vision.depth,
                                        k2_bwd_dkdv_f32=cfg.text.layers,
                                        k2_bwd_dq_f32=cfg.text.layers,
                                        k3_bwd_dkv_f32=cfg.vision.depth,
                                        k3_bwd_dq_f32=cfg.vision.depth))
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
                               k2_f32=cfg.text.layers,
                               k3_f32=cfg.vision.depth,
                               k2_bwd=cfg.text.layers,
                               k3_bwd=cfg.vision.depth,
                               k2_bwd_dkdv_f32=cfg.text.layers,
                               k2_bwd_dq_f32=cfg.text.layers,
                               k3_bwd_dkv_f32=cfg.vision.depth,
                               k3_bwd_dq_f32=cfg.vision.depth)
    ok = (len(losses) == steps and all(np.isfinite(losses)) and vision_same
          and all(changed.values())
          and counts == {k: v * steps for k, v in per_step.items()})
    emit({"phase": "train", **res})
    if not ok:
        raise AssertionError("train: the SFT loop broke its checks")
    del state, model, tx, watch, params
    torch.cuda.empty_cache()
    return res, counts


# ------------------------------------------------------ detector training
# one f32 detector train_step, card vs CPU (det_train_parity): the loss
# and its parts within DET_TRAIN_TOL relative; each gradient within
# DET_TRAIN_TOL of its tensor's largest entry, or within one f32 ulp
# (2^-23) of the model's largest entry (a bias ahead of a train-mode BN
# has gradient 0 in exact arithmetic and holds only rounding noise); the
# BN running statistics within DET_STATS_TOL. TF32 is off (phase_device),
# so both sides sum in f32 and differ in order only. cuDNN may pick a
# nondeterministic weight-gradient algorithm (atomic adds): that too
# only reorders f32 sums, a few ulps of the summands. Train-mode BN over
# small maps amplifies such rounding into the gradients (2e-7 relative
# on the input images moves them by 3.9e-5 of a tensor's largest entry
# at 64x64 on the CPU, tests/test_torch_train_det.py); the phase reruns
# the card's step and reports that drift as rerun_errors (0.04-0.05 of
# the limit on an H100, PERF.md §6).
DET_TRAIN_TOL = 1e-4
DET_STATS_TOL = 1e-5
# the card tensors det_train watches move
DET_WATCH = ("backbone.stages.2.0.pwconv1.weight",
             "bbox_head.cls_preds.0.0.weight",
             "neck.Rep_p3.cv1.block.bn.running_mean")


def det_mini_cfg():
    """mini_cfg's widths (tests/test_detector.py:14) at 128x128: at 64x64
    train-mode BN normalizes 8 values a channel at P5, which amplifies
    rounding into the gradients (a BottleRep alpha, one scalar summed
    over the map, came near DET_TRAIN_TOL on an H100); at 128x128, 32
    values, the card stays near 0.2 of it (PERF.md §6)."""
    from wedetect_tpu_torch.configs import ModelCfg

    return ModelCfg(name="mini", depths=(1, 1, 2, 1), dims=(32, 64, 128, 256),
                    neck_scale=0.25, neck_repeats=2,
                    head_in_channels=(32, 64, 128), embed_dims=32,
                    img_size=(128, 128), text=None, num_classes=4)


def det_mini_batch(cfg, drop_gt: bool = False):
    """B = 2 seeded images and text banks, five gts (one removed with
    `drop_gt`), padded to cfg.train.max_gt_per_image."""
    from wedetect_tpu_torch.train.train_step import Batch

    g = cfg.train.max_gt_per_image
    h, w = cfg.img_size
    rng = np.random.default_rng(6)
    gts = [(0, [8, 8, 60, 80], 1), (0, [40, 20, 120, 100], 3),
           (0, [80, 80, 94, 92], 2), (1, [20, 20, 40, 36], 0),
           (1, [60, 12, 124, 72], 2)][:4 if drop_gt else 5]
    gtb = np.zeros((2, g, 4), np.float32)
    gtl = np.zeros((2, g), np.int32)
    gtm = np.zeros((2, g), bool)
    for row, box, label in gts:
        i = int(gtm[row].sum())
        gtb[row, i], gtl[row, i], gtm[row, i] = box, label, True
    return Batch(images=rng.integers(0, 256, (2, h, w, 3), np.uint8),
                 texts=rng.standard_normal((2, 4, 32)).astype(np.float32),
                 gt_bboxes=gtb, gt_labels=gtl, gt_mask=gtm)


def det_step(cfg, model, batch):
    """One train_step: its metrics, gradients and BN statistics (CPU)."""
    from wedetect_tpu_torch.train.train_step import (TrainState,
                                                     det_optimizer,
                                                     train_step)

    state = TrainState.create(model, det_optimizer(model, base_lr=5e-4))
    _, metrics = train_step(cfg, state, batch)
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
             for n, p in model.named_parameters()}
    stats = {n: t.detach().cpu() for n, t in model.state_dict().items()
             if n.endswith(("running_mean", "running_var"))}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def det_step_errors(got, want):
    """The largest relative loss error, the worst gradient error against
    its limit (<= 1 passes) and the largest statistics error."""
    (gm, gg, gs), (wm, wg, ws) = got, want
    loss = max(abs(gm[k] - wm[k]) / abs(wm[k])
               for k in ("loss", "loss_cls", "loss_bbox", "loss_dfl"))
    top = max(float(w.abs().max()) for w in wg.values())
    grad = max(float((gg[n] - w).abs().max())
               / max(DET_TRAIN_TOL * float(w.abs().max()), 2.0 ** -23 * top)
               for n, w in wg.items())
    stats = max(float((gs[n] - w).abs().max()) for n, w in ws.items())
    return {"loss_rel_err": loss, "grad_err_over_limit": grad,
            "stats_max_abs_err": stats, "num_pos": [gm["num_pos"],
                                                    wm["num_pos"]]}


def det_errors_ok(e) -> bool:
    return (e["loss_rel_err"] <= DET_TRAIN_TOL
            and e["grad_err_over_limit"] <= 1.0
            and e["stats_max_abs_err"] <= DET_STATS_TOL
            and e["num_pos"][0] == e["num_pos"][1])


def det_launches(reset: bool = False):
    """K1's launch count and the attention kernels' (reset with
    `reset`)."""
    from wedetect_tpu_torch.ops.row_topk import row_topk

    if reset:
        row_topk.launches = 0
    return {"row_topk": row_topk.launches, **launch_counts(reset)}


def phase_det_train_parity(dev):
    from wedetect_tpu_torch.models import wedetect as W

    cfg = det_mini_cfg()
    cpu = W.init_variables(cfg, seed=5, device="cpu")
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    want = det_step(cfg, cpu, det_mini_batch(cfg))
    card = W.init_variables(cfg, seed=5, device=dev)
    card.load_state_dict(init)
    det_launches(reset=True)
    got = det_step(cfg, card, det_mini_batch(cfg))
    launches = det_launches()
    card.load_state_dict(init)
    again = det_step(cfg, card, det_mini_batch(cfg))
    card.load_state_dict(init)
    control = det_step(cfg, card, det_mini_batch(cfg, drop_gt=True))
    errs, ctrl = det_step_errors(got, want), det_step_errors(control, want)
    res = {"errors": errs, "control_errors": ctrl,
           # the card against itself: cuDNN's run-to-run reordering
           "rerun_errors": det_step_errors(again, got), "launches": launches,
           "tolerance": {"loss_rel": DET_TRAIN_TOL, "grad": DET_TRAIN_TOL,
                         "stats_abs": DET_STATS_TOL},
           "losses": {k: got[0][k] for k in ("loss", "loss_cls",
                                             "loss_bbox", "loss_dfl")}}
    ok = (det_errors_ok(errs) and not det_errors_ok(ctrl)
          and not any(launches.values()))
    emit({"phase": "det_train_parity", **res})
    if not ok:
        raise AssertionError("det_train_parity: card step != CPU step, "
                             "or the control did not miss")


def det_raw_sample(rng, size: int = 640, n_classes: int = 80):
    """A seeded in-memory sample: a size x size uint8 image and 1-20 gt
    boxes (8-320 px a side) with labels in [0, n_classes)."""
    n = int(rng.integers(1, 21))
    wh = rng.uniform(8, size / 2, (n, 2))
    xy = rng.uniform(0, 1, (n, 2)) * (size - wh)
    return {"image": rng.integers(0, 256, (size, size, 3), np.uint8),
            "gt_bboxes": np.concatenate([xy, xy + wh], -1).astype(
                np.float32),
            "gt_labels": rng.integers(0, n_classes, n)}


def phase_det_train(dev, argv=None, steps: int = 3):
    """cli/train's builders at WeDetect-Base with the CLI defaults; 3 steps
    of train/loop.run_training."""
    from wedetect_tpu_torch.cli import train as CLI
    from wedetect_tpu_torch.train.loop import (TrainLoopCfg,
                                               make_batch_iterator,
                                               run_training)

    args = CLI.parse_args(argv or ["--size", "base", "--steps", str(steps),
                                   "--device", str(dev)])
    cfg = CLI.build_config(args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    state, text_encode = CLI.build_state(args, cfg)
    class_texts = [[f"class {i}"] for i in range(args.num_classes)]
    sample_fn = CLI.make_sample_fn(
        args, cfg, lambda rng: det_raw_sample(rng, cfg.img_size[0],
                                              args.num_classes),
        class_texts)
    loop_cfg = TrainLoopCfg(steps=steps, batch_size=args.batch_size,
                            log_every=1)
    batches = make_batch_iterator(cfg, loop_cfg, sample_fn, text_encode,
                                  seed=args.seed)
    sd = state.model.state_dict()
    watch = {n: sd[n].detach().clone() for n in DET_WATCH}
    logs = []
    det_launches(reset=True)
    state = run_training(cfg, state, batches, loop_cfg,
                         log_fn=lambda s, m: logs.append(m))
    torch.cuda.synchronize()
    launches = det_launches()
    sd = state.model.state_dict()
    changed = {n: not torch.equal(sd[n], w) for n, w in watch.items()}
    step_ms = [1e3 * args.batch_size / m["img_per_s"] for m in logs]
    ms = float(np.mean(step_ms[1:]))
    keys = ("loss", "loss_cls", "loss_bbox", "loss_dfl", "num_pos",
            "grad_norm")
    res = {"config": {"size": args.size, "img_size": list(cfg.img_size),
                      "batch_size": args.batch_size,
                      "num_classes": cfg.num_classes, "lr": args.lr,
                      "lr_schedule": args.lr_schedule,
                      "weight_decay": args.weight_decay,
                      "drop_path": args.drop_path,
                      "compute_dtype": cfg.compute_dtype},
           "steps": steps, "losses": [{k: m[k] for k in keys} for m in logs],
           "step_ms": step_ms, "ms_per_step": ms,
           "img_per_s": 1e3 * args.batch_size / ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "allocated_at_start_gb": start_gb, "changed": changed,
           "launches": launches, "optimizer_count": state.tx.count}
    finite = all(np.isfinite(m[k]) for m in logs for k in keys)
    ok = (len(logs) == steps and finite
          and all(m["num_pos"] > 0 for m in logs) and all(changed.values())
          and launches["row_topk"] == 0 and not any(launches.values()))
    emit({"phase": "det_train", **res})
    if not ok:
        raise AssertionError("det_train: the detector training run broke "
                             "its checks")
    del state, batches
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------------ generation, serving
GEN_LOGIT_TOL = 1e-3      # two f32 runs of one model through different
#                           GEMM shapes (or devices) agree to ~1e-5 a logit
GEN_PREFILL_TOL = 1e-4    # card vs CPU prefill hidden states and KV, f32
GEN_BF16_LOGIT_ERR = 0.15  # bound on a bf16 logit's error against f32 at
#                           ref_2b (0.073 on the first step on an H100);
#                           a bf16 stream may part from the f32 one only at
#                           an f32 margin within twice it (two logits off)
GEN_COS_LIMIT = {8: 0.999, 4: 0.98}   # first-step logit cosine, quantized
#                                       LM head alone (tests/test_quant.py)
GEN_DECODE_COS_LIMIT = {8: 0.999, 4: 0.9}   # min cosine over a teacher-
#                           forced block through the quantized layers and
#                           head; 0.9 the JAX quant gate's int4 envelope
#                           for random weights (tests/test_quant_gate.py)
GEN_DECODE_BLOCK = 8      # tokens in that block
GEN_PROMPT = "Describe."  # one stub token a character: P = 384 at 480x640
GEN_EOS, GEN_PAD = 151645, 151643
SERVE_TAILS = "What is in the pict"   # tails of 2-19 stub tokens


def teacher_margins(model, gh, gw, patches, ids, mask, pos, nxt, toks,
                    boxes, ori, vs):
    """Each emitted token's argmax agreement, top-2 margin and gap (the
    top logit less the emitted token's; 0 where it is the argmax) under
    a teacher-forced forward of prompt + tokens (one row, padded to a
    multiple of 128): (argmax ok, margin, gap), each per step."""
    n_p = int(mask.sum())
    toks = [int(t) for t in toks]
    seq = np.concatenate([ids[:n_p], toks]).astype(np.int32)
    spos = np.concatenate([pos[:, :n_p], np.broadcast_to(
        nxt + np.arange(len(toks)), (3, len(toks)))], axis=1)
    l = -(-len(seq) // 128) * 128
    sid = np.zeros((1, l), np.int32)
    sid[0, :len(seq)] = seq
    smask = (np.arange(l) < len(seq)).astype(np.int32)[None]
    sp = np.zeros((3, 1, l), np.int32)
    sp[:, 0, :len(seq)] = spos
    with torch.inference_mode():
        h = model.hidden_states(patches, sid, smask, sp, boxes, ori, vs,
                                np.full((1, 1), -1, np.int32), grid_h=gh,
                                grid_w=gw)
        lg = model.lm_logits(h)[0, n_p - 1:n_p - 1 + len(toks)].float()
        top = torch.topk(lg, 2).values
        own = lg.gather(1, torch.tensor(toks, device=lg.device)[:, None])
    return ((lg.argmax(-1).cpu().numpy() == np.array(toks)),
            (top[:, 0] - top[:, 1]).cpu().numpy(),
            (top[:, 0] - own[:, 0]).cpu().numpy())


def divergence(got, want, margins, tol=GEN_LOGIT_TOL):
    """The margin rule: `got` must equal `want` (the stream whose
    teacher-forced margins are `margins`), except that it may part from
    it at a step whose margin is within `tol`. Returns (ok, tokens
    agreeing, the margin at the first disagreement or None)."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    n = min(len(got), len(want))
    i = next((k for k in range(n) if got[k] != want[k]), None)
    if i is None and len(got) == len(want):
        return True, n, None
    i = n if i is None else i
    m = float(margins[i]) if i < len(margins) else None
    return m is not None and m <= tol, i, m


def trim(toks, eos=GEN_EOS, pad=GEN_PAD):
    out = []
    for t in np.asarray(toks).ravel():
        if t in (eos, pad):
            break
        out.append(int(t))
    return out


def gen_rows(cfg, rng, tails, gh=8, gw=12, p=128):
    """Right-padded prompts of the miniature Ref (tokens 120-123 as in
    phase_ref_parity): (ids (B, P), mask, pos (3, B, P), next_pos (B,))."""
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image

    b = len(tails)
    ids = np.zeros((b, p), np.int32)
    mask = np.zeros((b, p), np.int32)
    pos = np.zeros((3, b, p), np.int32)
    nxt = np.zeros(b, np.int32)
    for r, tail in enumerate(tails):
        seq = np.concatenate([[1, 2, 122], np.full(24, 120),
                              rng.integers(5, 110, tail)]).astype(np.int32)
        ids[r, :len(seq)] = seq
        mask[r, :len(seq)] = 1
        pr = get_rope_index_single_image(seq, 120, gh, gw, 2)
        pos[:, r, :len(seq)] = pr
        nxt[r] = pr.max() + 1
    return ids, mask, pos, nxt


def phase_gen_parity(dev):
    """The miniature Ref's generation and serving on the card against the
    same weights on the CPU (f32)."""
    from wedetect_tpu_torch.models import ref_generate as TG
    from wedetect_tpu_torch.models import ref_speculative as TS
    from wedetect_tpu_torch.models import serve as TSV
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.ops import prng

    cfg = mini_ref_cfg()
    cpu = init_ref_variables(cfg, seed=11, device="cpu")
    card = init_ref_variables(cfg, seed=11, device=dev)
    card.load_state_dict(cpu.state_dict())
    gh, gw, g = 8, 12, 12
    rng = np.random.default_rng(12)
    patches = rng.standard_normal((gh * gw, 96)).astype(np.float32)
    ids, mask, pos, nxt = gen_rows(cfg, rng, (10, 4))
    boxes = np.array([[0, 0, 48, 32]], np.float32)
    ori = np.array([48.0, 32.0], np.float32)
    objp = np.full((2, 1), -1, np.int32)
    eos, pad = 255, 254
    res = {}

    # the prefill, every position (pad rows included)
    def prefill(model, m):
        with torch.inference_mode():
            h, kvs = TG._prefill_hidden_kvs(model, gh, gw, patches, ids, m,
                                            pos, boxes, ori, 3, objp)
        return [h] + [t for kv in kvs for t in kv]

    want = prefill(cpu, mask)
    launch_counts(reset=True)
    got = prefill(card, mask)
    counts = launch_counts()
    wrong = mask.copy()
    wrong[1, int(mask[1].sum())] = 1              # one masked key unmasked
    ctrl = prefill(card, wrong)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want))
    cerr = max(float((a.cpu() - b).abs().max()) for a, b in zip(ctrl, want))
    res["prefill"] = {"max_abs_err": err, "control_max_abs_err": cerr,
                      "tolerance": GEN_PREFILL_TOL, "launches": counts}
    ok = (err <= GEN_PREFILL_TOL < cerr and counts == expected_counts(
        k2=cfg.text.layers, k2_f32=cfg.text.layers, k3=cfg.vision.depth,
        k3_f32=cfg.vision.depth))

    # greedy and speculative decode: tokens and the margin rule
    args = (patches, ids, mask, pos, 3, nxt, boxes, ori, g, eos)
    greedy = [TG.ref_generate(cfg, gh, gw, m, *args, pad_id=pad).cpu()
              .numpy() for m in (card, cpu)]
    sp = [TS.ref_generate_spec(cfg, gh, gw, m, *args, pad, spec_k=4)
          for m in (card, cpu)]
    rows = []
    for r in range(2):
        margins = teacher_margins(cpu, gh, gw, patches, ids[r], mask[r],
                                  pos[:, r], nxt[r],
                                  trim(greedy[1][r], eos, pad), boxes, ori,
                                  3)[1]
        for name, a in (("greedy", greedy[0][r]),
                        ("spec", sp[0][0][r].cpu().numpy()),
                        ("spec_cpu", sp[1][0][r].numpy())):
            d = divergence(trim(a, eos, pad), trim(greedy[1][r], eos, pad),
                           margins)
            rows.append({"row": r, "path": name, "ok": d[0], "agree": d[1],
                         "margin": d[2], "min_margin": float(margins.min())})
            ok = ok and d[0]
    res["decode"] = rows
    res["spec_steps"] = [int(sp[0][1]), int(sp[1][1])]

    # a 3-slot GenServer: 5 requests, classic, int8 KV, piggyback
    reqs = []
    for k in range(5):
        i1, m1, p1, n1 = gen_rows(cfg, rng, (3 + 2 * k,))
        reqs.append((rng.standard_normal((gh * gw, 96)).astype(np.float32),
                     i1[0], m1[0], p1[:, 0], int(n1[0])))
    servers = {}
    for kw in ({}, {"kv_bits": 8}, {"piggyback": True}):
        outs = []
        for m in (card, cpu):
            srv = TSV.GenServer(cfg, gh, gw, m, slots=3, prompt_len=128,
                                max_new=8, chunk=3, eos_id=eos, pad_id=pad,
                                **kw)
            rids = [srv.submit(pa, i, ma, po, 3, n0, boxes_xyxy=boxes,
                               ori_wh=ori) for pa, i, ma, po, n0 in reqs]
            out = srv.run()
            outs.append([list(map(int, out[x])) for x in rids])
        name = "+".join(f"{k}={v}" for k, v in kw.items()) or "classic"
        servers[name] = {"equal": outs[0] == outs[1],
                         "tokens": sum(map(len, outs[1]))}
        if outs[0] != outs[1]:
            for (pa, i, ma, po, n0), a, b in zip(reqs, *outs):
                margins = teacher_margins(cpu, gh, gw, pa, i, ma, po, n0,
                                          b, boxes, ori, 3)[1]
                d = divergence(a, b, margins)
                servers[name].setdefault("divergences", []).append(d)
                ok = ok and d[0]
    res["servers"] = servers

    # the PRNG twin and the sampler on the card, bitwise with the CPU
    seeds = torch.tensor([0, 7, -3, 2**31 - 1], dtype=torch.int32)
    keys = [prng.fold_in(prng.PRNGKey(seeds.to(d)), 5) for d in (dev, "cpu")]
    bits = [prng.random_bits(k, (151936,)).cpu() for k in keys]
    uni = [prng.uniform(k, (151936,)).cpu() for k in keys]
    logits = torch.tensor(rng.standard_normal((4, 151936)).astype(np.float32))
    cat = [prng.categorical(k, logits.to(k.device)).cpu() for k in keys]
    smp = [TSV._sample_rows(logits.to(d), (0.8, 50, 0.9), seeds.to(d),
                            torch.arange(4, device=d)).cpu()
           for d in (dev, "cpu")]
    res["prng"] = {"bits": torch.equal(*bits),
                   "uniform": bitwise_equal(*uni),
                   "categorical": torch.equal(*cat),
                   "sample_rows": torch.equal(*smp)}
    ok = ok and all(res["prng"].values())
    emit({"phase": "gen_parity", **res})
    if not ok:
        raise AssertionError("gen_parity: the card's generation or serving "
                             "differs from the CPU's")


def gen_prompt(scorer, image, prompt, p_pad=0):
    """RefScorer's generation layout of one request as arrays."""
    patches, gh, gw, ids, mask, pos, vs, w, h = scorer._build_gen_prompt(
        image, prompt, GEN_PAD, p_pad)
    return dict(patches=patches, gh=gh, gw=gw, ids=ids, mask=mask, pos=pos,
                vs=vs, nxt=int(pos.max()) + 1,
                boxes=np.array([[0, 0, w, h]], np.float32),
                ori=np.array([w, h], np.float32))


def gen_call(cfg, model, b, new_tokens, **kw):
    from wedetect_tpu_torch.models.ref_generate import ref_generate

    return ref_generate(cfg, b["gh"], b["gw"], model, b["patches"],
                        b["ids"][None], b["mask"][None], b["pos"][:, None],
                        b["vs"], np.array([b["nxt"]], np.int32), b["boxes"],
                        b["ori"], new_tokens, GEN_EOS, pad_id=GEN_PAD, **kw)


def block_logits(cfg, dp, hidden, kvs, mask, nxt, toks):
    """Teacher-forced logits (K, vocab), f32, of one prompt's first K
    emitted tokens through the decode tree dp's layers and LM head, from
    the prompt's prefill KV: the speculative verify block
    (ref_speculative._decode_layer_block), row j after token j."""
    from wedetect_tpu_torch.models import ref_generate as TG
    from wedetect_tpu_torch.models.quant import prepare_decode_params
    from wedetect_tpu_torch.models.ref_speculative import _decode_layer_block
    from wedetect_tpu_torch.nn.qwen3vl import interleaved_mrope_cos_sin

    c, dev, k = cfg.text, hidden.device, len(toks)
    dp = prepare_decode_params(dp)
    p_len = mask.shape[-1]
    caches = TG._new_caches(kvs, k)
    x = dp["embed"][torch.tensor(toks, device=dev)][None].to(hidden.dtype)
    posk = (nxt + torch.arange(k, device=dev)).reshape(1, 1, k)
    cos, sin = interleaved_mrope_cos_sin(posk.expand(3, 1, k), c)
    jk = torch.arange(k, device=dev)
    att = torch.cat([torch.tensor(mask, device=dev).bool()[None]
                     .expand(k, p_len), jk[None] <= jk[:, None]], dim=1)
    with torch.inference_mode():
        for i in range(c.layers):
            kc, vc = caches[i]
            x = _decode_layer_block(dp["text"][f"layer{i}"], c, x, cos, sin,
                                    kc, vc, (p_len + jk)[None], att[None])
        return TG._lm_logits(dp, TG._rms(x, dp["text"]["norm"],
                                         c.rms_eps)[0])


def cosines(a, b):
    """Row-wise cosine of two (K, V) logit blocks, in f64."""
    a, b = a.double(), b.double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).cpu()


def phase_gen(dev, image, cfg=None, new_tokens: int = 64):
    """ref_2b generation at full width through RefScorer.generate_text:
    f32 held to a teacher-forced forward, speculative to greedy, int8 and
    int4 logits to the full tree's, bf16 to the f32 stream."""
    from wedetect_tpu_torch.models import quant
    from wedetect_tpu_torch.models import ref_generate as TG
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.models.ref_speculative import ref_generate_spec
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=dev)
    tok = CharTok()
    res = {"new_tokens": new_tokens}
    ok = True
    for name in ("float32", "bfloat16"):
        scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok, dtype=name,
                           device=dev)
        b = gen_prompt(scorer, image, GEN_PROMPT)
        launch_counts(reset=True)
        text = scorer.generate_text(image, GEN_PROMPT,
                                    max_new_tokens=new_tokens,
                                    eos_token_id=GEN_EOS,
                                    pad_token_id=GEN_PAD)
        counts = launch_counts()
        toks = trim(gen_call(cfg, model, b, new_tokens)[0].cpu().numpy())
        bf16 = name == "bfloat16"
        k2, k3 = cfg.text.layers, cfg.vision.depth
        want = expected_counts(k2=k2, k2_sm90=k2 if bf16 else 0,
                               k2_f32=0 if bf16 else k2, k3=k3,
                               k3_sm90=k3 if bf16 else 0,
                               k3_f32=0 if bf16 else k3)

        def prefill():
            with torch.inference_mode():
                return TG._prefill_hidden_kvs(
                    model, b["gh"], b["gw"], b["patches"], b["ids"][None],
                    b["mask"][None], b["pos"][:, None], b["boxes"], b["ori"],
                    b["vs"], np.full((1, 1), -1, np.int32))

        prefill_ms = host_ms(prefill, 3)
        call_ms = host_ms(lambda: scorer.generate_text(
            image, GEN_PROMPT, max_new_tokens=new_tokens,
            eos_token_id=GEN_EOS, pad_token_id=GEN_PAD), 2)
        r = res[name] = {
            "prompt_len": int(b["mask"].sum()), "bucket": len(b["ids"]),
            "launches": counts, "tokens": len(text),
            "text_equals_direct_call": list(text) == toks,
            "prefill_ms": prefill_ms, "call_ms": call_ms,
            "decode_ms_per_token": (call_ms - prefill_ms) / new_tokens}
        ok = ok and counts == want and r["text_equals_direct_call"] \
            and len(text) > 0
        hidden, kvs = prefill()
        full = quant.decode_params(model)
        h = hidden[0, int(b["mask"].sum()) - 1][None]
        with torch.inference_mode():
            lf = TG._lm_logits(full, h)[0]
        if not bf16:
            # each emitted token the teacher-forced argmax, or short of
            # it by at most GEN_LOGIT_TOL (the margin rule)
            acc, margins, gaps = teacher_margins(
                model, b["gh"], b["gw"], b["patches"], b["ids"], b["mask"],
                b["pos"], b["nxt"], toks, b["boxes"], b["ori"], b["vs"])
            r["teacher_argmax_agree"] = int(acc.sum())
            r["teacher_max_gap"] = float(gaps.max())
            r["min_margin"] = float(margins.min())
            ok = ok and r["teacher_max_gap"] <= GEN_LOGIT_TOL
            spec, steps = ref_generate_spec(
                cfg, b["gh"], b["gw"], model, b["patches"], b["ids"][None],
                b["mask"][None], b["pos"][:, None], b["vs"],
                np.array([b["nxt"]], np.int32), b["boxes"], b["ori"],
                new_tokens, GEN_EOS, GEN_PAD)
            d = divergence(trim(spec[0].cpu().numpy()), toks, margins)
            r["speculative"] = {"ok": d[0], "agree": d[1], "margin": d[2],
                                "verify_steps": int(steps)}
            ok = ok and d[0]
            # the quantized trees: the head alone on the prefill's last
            # state, and a teacher-forced block of the f32 stream's tokens
            # through the quantized layers and head from the same KV
            toks32, margins32, lf32 = toks, margins, lf
            blk = toks[:GEN_DECODE_BLOCK]
            nxt = torch.tensor(b["nxt"], device=dev)
            lb = lb32 = block_logits(cfg, full, hidden, kvs, b["mask"], nxt,
                                     blk)
            for bits in (8, 4):
                q = quant.quantize_decode_params(model, bits=bits)
                with torch.inference_mode():
                    lq = TG._lm_logits(q, h)[0]
                cos = float(cosines(lf[None], lq[None])[0])
                cos_dec = float(cosines(lb, block_logits(
                    cfg, q, hidden, kvs, b["mask"], nxt, blk)).min())
                q_ms = host_ms(lambda: gen_call(cfg, model, b, 16,
                                                decode_params=q), 1)
                r[f"int{bits}"] = {"cosine": cos,
                                   "limit": GEN_COS_LIMIT[bits],
                                   "decode_cosine_min": cos_dec,
                                   "decode_limit":
                                       GEN_DECODE_COS_LIMIT[bits],
                                   "decode_block": len(blk),
                                   "bytes": quant.quantized_bytes(q),
                                   "call_ms_16": q_ms,
                                   "decode_ms_per_token":
                                       (q_ms - prefill_ms) / 16}
                ok = ok and cos > GEN_COS_LIMIT[bits] \
                    and cos_dec > GEN_DECODE_COS_LIMIT[bits]
                del q
        else:
            # bf16 against f32: the logits of the first step and of the
            # f32 stream's teacher-forced block within GEN_BF16_LOGIT_ERR,
            # the stream parting only at an f32 margin within twice it
            lb = block_logits(cfg, full, hidden, kvs, b["mask"], nxt, blk)
            err = max(float((lf - lf32).abs().max()),
                      float((lb - lb32).abs().max()))
            d = divergence(toks, toks32, margins32, 2 * GEN_BF16_LOGIT_ERR)
            r["vs_float32"] = {"ok": d[0], "agree": d[1], "margin": d[2],
                               "logit_max_abs_err": err,
                               "logit_err_limit": GEN_BF16_LOGIT_ERR,
                               "margin_limit": 2 * GEN_BF16_LOGIT_ERR}
            ok = ok and d[0] and err <= GEN_BF16_LOGIT_ERR
        del hidden, kvs
        emit({"phase": "gen", "dtype": name, **r})
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "gen_model", "peak_mem_gb": res["peak_mem_gb"]})
    if not ok:
        raise AssertionError("gen: generation broke its checks")
    del model
    torch.cuda.empty_cache()
    return res


def serve_requests(scorer, image, n, p, g):
    """n requests of varied prompt tails, padded to p, and their caps
    (8 to g)."""
    out = []
    for i in range(n):
        prompt = SERVE_TAILS[:1 + (5 * i) % 18] + "?"      # P <= 384
        b = gen_prompt(scorer, image, prompt, p_pad=p)
        b["cap"] = 8 + (37 * i) % (g - 7)
        out.append(b)
    return out


def complete(toks, reqs) -> bool:
    """Every request returned tokens, at most its cap of them."""
    return len(toks) == len(reqs) and all(
        0 < len(t) <= b["cap"] for t, b in zip(toks, reqs))


def serve_run(cfg, model, reqs, slots, p, g, chunk, pipeline=True, **kw):
    """One GenServer drained over reqs: (tokens a request, stats, wall
    ms, pool bytes, launch counts)."""
    from wedetect_tpu_torch.models.serve import GenServer

    b0 = reqs[0]
    srv = GenServer(cfg, b0["gh"], b0["gw"], model, slots=slots,
                    prompt_len=p, max_new=g, chunk=chunk, eos_id=GEN_EOS,
                    pad_id=GEN_PAD, **kw)
    rids = [srv.submit(b["patches"], b["ids"], b["mask"], b["pos"], b["vs"],
                       b["nxt"], boxes_xyxy=b["boxes"], ori_wh=b["ori"],
                       seed=1000 + k, max_new=b["cap"])
            for k, b in enumerate(reqs)]
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t0 = time.perf_counter()
    out = srv.run(pipeline=pipeline)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    return ([list(map(int, out[r])) for r in rids], dict(srv.stats), ms,
            srv.pool_bytes(), counts, srv)


def phase_serve(dev, image, cfg=None, slots: int = 8, chunk: int = 16,
                p: int = 384, g: int = 64, n_req: int = 16):
    """ref_2b continuous batching at full width through GenServer."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=dev)
    tok = CharTok()
    k2, k3 = cfg.text.layers, cfg.vision.depth
    res = {"config": {"slots": slots, "chunk": chunk, "prompt_len": p,
                      "max_new": g, "requests": n_req}}
    ok = True

    # f32: every request against its own ref_generate stream
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok, device=dev)
    reqs = serve_requests(scorer, image, n_req, p, g)
    base, st, ms, _, counts, _ = serve_run(cfg, model, reqs, slots, p, g,
                                           chunk)
    admits = st["admits"]
    r = res["float32"] = {
        "stats": st, "wall_ms": ms, "tokens": sum(map(len, base)),
        "complete": complete(base, reqs),
        "launches_per_admit": {k: v / admits for k, v in counts.items()
                               if "bwd" not in k}}
    ok = ok and r["complete"] and counts == expected_counts(
        k2=k2 * admits, k2_f32=k2 * admits, k3=k3 * admits,
        k3_f32=k3 * admits)
    div, refs = [], []
    for b, toks in zip(reqs, base):
        want = trim(gen_call(cfg, model, b, b["cap"])[0].cpu().numpy())
        margins = teacher_margins(model, b["gh"], b["gw"], b["patches"],
                                  b["ids"], b["mask"], b["pos"], b["nxt"],
                                  want, b["boxes"], b["ori"], b["vs"])[1]
        refs.append((want, margins))
        d = divergence(toks, want, margins)
        div.append({"ok": d[0], "agree": d[1], "margin": d[2],
                    "min_margin": float(margins.min())})
        ok = ok and d[0]
    r["vs_ref_generate"] = div
    for name, kw in (("chunk4", dict(chunk=4)),
                     ("no_pipeline", dict(pipeline=False)),
                     ("piggyback", dict(piggyback=True))):
        kw = {"chunk": chunk, **kw}
        toks, st2, ms2, _, _, _ = serve_run(cfg, model, reqs, slots, p, g,
                                            **kw)
        r[name] = {"equal": toks == base, "wall_ms": ms2, "stats": st2}
        if toks != base:
            r[name]["divergences"] = [
                divergence(a, b_, teacher_margins(
                    model, q["gh"], q["gw"], q["patches"], q["ids"],
                    q["mask"], q["pos"], q["nxt"], b_, q["boxes"], q["ori"],
                    q["vs"])[1])
                for a, b_, q in zip(toks, base, reqs)]
            ok = ok and name == "piggyback" and all(
                d[0] for d in r[name]["divergences"])
    emit({"phase": "serve", "dtype": "float32", **r})

    # bf16: throughput, the int8 KV pool, sampling's schedule invariance
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                       dtype="bfloat16", device=dev)
    toks, st, ms, pool, counts, _ = serve_run(cfg, model, reqs, slots, p, g,
                                              chunk)
    admits = st["admits"]
    delivered = sum(map(len, toks))
    r = res["bfloat16"] = {
        "stats": st, "wall_ms": ms, "tokens": delivered,
        "tokens_per_s": delivered / ms * 1e3,
        "ms_per_chunk_run": ms / st["chunks"],
        "occupancy": delivered / (st["chunks"] * chunk * slots),
        "pool_gb": pool / 1e9,
        "complete": complete(toks, reqs),
        "launches_per_admit": {k: v / admits for k, v in counts.items()
                               if "bwd" not in k}}
    ok = ok and r["complete"] and counts == expected_counts(
        k2=k2 * admits, k2_sm90=k2 * admits, k3=k3 * admits,
        k3_sm90=k3 * admits)
    # each bf16 request against its f32 ref_generate stream: a parting
    # only at an f32 margin within 2 * GEN_BF16_LOGIT_ERR
    div = [divergence(t, want, margins, 2 * GEN_BF16_LOGIT_ERR)
           for t, (want, margins) in zip(toks, refs)]
    r["vs_float32"] = {"ok": all(d[0] for d in div),
                       "agree": [d[1] for d in div],
                       "margin": [d[2] for d in div],
                       "margin_limit": 2 * GEN_BF16_LOGIT_ERR}
    ok = ok and r["vs_float32"]["ok"]
    # ms a chunk at full occupancy: 8 requests of G tokens, all admitted
    full = [dict(b, cap=g) for b in reqs[:slots]]
    _, _, _, _, _, srv = serve_run(cfg, model, full[:1], slots, p, g, chunk)
    for b in full:
        srv.submit(b["patches"], b["ids"], b["mask"], b["pos"], b["vs"],
                   b["nxt"], boxes_xyxy=b["boxes"], ori_wh=b["ori"])
    srv._admit_queued()
    r["ms_per_chunk_full"] = host_ms(
        lambda: srv._collect(*srv._dispatch_chunk()), 3, warmup=0)
    r["ms_per_step_full"] = r["ms_per_chunk_full"] / chunk
    del srv
    toks8, st8, ms8, pool8, _, _ = serve_run(cfg, model, reqs, slots, p, g,
                                             chunk, kv_bits=8)
    r["kv8"] = {"pool_gb": pool8 / 1e9, "pool_ratio": pool8 / pool,
                "complete": complete(toks8, reqs),
                "wall_ms": ms8, "tokens_per_s": sum(map(len, toks8))
                / ms8 * 1e3, "tokens_equal_bf16": sum(
                    a == b_ for a, b_ in zip(toks8, toks))}
    ok = ok and r["kv8"]["complete"] and 0.5 < r["kv8"]["pool_ratio"] < 0.55
    sampling = dict(temperature=0.8, top_k=50, top_p=0.9)
    sa = serve_run(cfg, model, reqs, slots, p, g, chunk, **sampling)
    sb = serve_run(cfg, model, reqs, slots, p, g, 4, **sampling)
    r["sampled"] = {"equal_chunk16_chunk4": sa[0] == sb[0],
                    "tokens": sum(map(len, sa[0])),
                    "distinct": len({t for x in sa[0] for t in x}),
                    "tokens_per_s": sum(map(len, sa[0])) / sa[2] * 1e3}
    ok = ok and sa[0] == sb[0]
    res["peak_mem_gb"] = r["peak_mem_gb"] = \
        torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "serve", "dtype": "bfloat16", **r})
    if not ok:
        raise AssertionError("serve: the serving engine broke its checks")
    del model, scorer
    torch.cuda.empty_cache()
    return res


def phase_quant_gate(dev, image, cfg=None, n_calib: int = 8,
                     n_prompts: int = 8, max_new: int = 16,
                     new_tokens: int = 32):
    """ref_2b, random weights, f32: RefScorer.calibrate_decode on n_calib
    requests on the Ref image (K3 = 24 launches a prompt; the decoder
    replay runs the einsum, no K2), then eval/quant_gate.gate_report of
    the plain and the calibrated int4 trees (cli/quant_gate's probe
    prompts, REC grid and queries), then one generate_text with the
    calibrated tree: ms a token. Each report finite, its first-step
    logit cosines above GEN_DECODE_COS_LIMIT[4] (the int4 envelope for
    random weights)."""
    from wedetect_tpu_torch.cli import quant_gate as QG
    from wedetect_tpu_torch.eval.quant_gate import gate_report
    from wedetect_tpu_torch.models import quant
    from wedetect_tpu_torch.models import ref_generate as TG
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    torch.cuda.empty_cache()
    model = init_ref_variables(cfg, seed=0, device=dev)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=CharTok(),
                       device=dev, quantize_decode="int4")
    reqs = QG.calib_requests(image, n_calib)
    launch_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calib = scorer.calibrate_decode(reqs, pad_token_id=GEN_PAD)
    torch.cuda.synchronize()
    res = {"calib_prompts": n_calib,
           "calibrate_ms": (time.perf_counter() - t0) * 1e3,
           "calib_launches": launch_counts()}
    k3 = cfg.vision.depth
    assert res["calib_launches"] == expected_counts(
        k3=k3 * n_calib, k3_f32=k3 * n_calib), res["calib_launches"]
    rms = [calib["lm_head"]] + [v for layer in calib["text"].values()
                                for v in layer.values()]
    assert all(np.isfinite(a).all() and (a > 0).all() for a in rms)
    gh, gw, gen, rec, _ = QG.scorer_batches(scorer, image, n_prompts, 0,
                                            GEN_PAD)
    for name, tree in (("plain", quant.quantize_decode_params(model, 4)),
                       ("calibrated", scorer.decode_tree())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = gate_report(cfg, gh, gw, model, tree, gen, rec, max_new,
                          GEN_EOS, GEN_PAD)
        torch.cuda.synchronize()
        rep["ms"] = (time.perf_counter() - t0) * 1e3
        res[name] = rep
        assert rep["n_prompts"] == n_prompts
        assert all(np.isfinite(v) for v in (
            rep["logit_cos_min"], rep["rec"]["max_abs_delta"]))
        assert rep["logit_cos_min"] > GEN_DECODE_COS_LIMIT[4], rep
    # one int4 generate_text with the calibrated tree
    b = gen_prompt(scorer, image, GEN_PROMPT)

    def prefill():
        with torch.inference_mode():
            return TG._prefill_hidden_kvs(
                model, b["gh"], b["gw"], b["patches"], b["ids"][None],
                b["mask"][None], b["pos"][:, None], b["boxes"], b["ori"],
                b["vs"], np.full((1, 1), -1, np.int32))

    launch_counts(reset=True)
    text = scorer.generate_text(image, GEN_PROMPT,
                                max_new_tokens=new_tokens,
                                eos_token_id=GEN_EOS, pad_token_id=GEN_PAD)
    counts = launch_counts()
    assert counts == expected_counts(k2=cfg.text.layers,
                                     k2_f32=cfg.text.layers, k3=k3,
                                     k3_f32=k3), counts
    assert len(text) > 0
    prefill_ms = host_ms(prefill, 3)
    call_ms = host_ms(lambda: scorer.generate_text(
        image, GEN_PROMPT, max_new_tokens=new_tokens, eos_token_id=GEN_EOS,
        pad_token_id=GEN_PAD), 2)
    res["generate"] = {"launches": counts, "tokens": len(text),
                       "prefill_ms": prefill_ms, "call_ms": call_ms,
                       "decode_ms_per_token":
                           (call_ms - prefill_ms) / new_tokens}
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "quant_gate", **res})
    del model, scorer
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------- grounding
GROUND_IMAGES = 20              # the first 12 landscape, then 8 portrait
GROUND_SIZES = ((480, 640), (640, 480))
GROUND_GRID_TOKENS = 256        # make_grid_buckets: 448x576 and 576x448
GROUND_QUERY_BATCH = 8
GROUND_GEN_TOKENS = 16


def write_grounding_dataset(root, n: int, sizes, k_coco: int,
                            seed: int = 8):
    """n seeded JPEGs painted as write_eval_dataset paints them (smooth
    noise, 1-8 flat boxes), the first 3/5 at sizes[0], the rest at
    sizes[1]; a refcoco-format file (one expression an image, REF_QUERIES
    in turn, the first painted box its gt) and a COCO-format file over
    k_coco categories. Returns (refcoco.json, coco.json, file names)."""
    import cv2

    rng = np.random.default_rng(seed)
    images, coco_anns, refs, names = [], [], [], []
    for i in range(n):
        h, w = sizes[0] if i < n * 3 // 5 else sizes[1]
        small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3),
                             dtype=np.uint8)
        img = cv2.resize(small, (w, h))
        boxes = []
        for j in range(int(rng.integers(1, 9))):
            bw, bh = rng.uniform(16, w / 2), rng.uniform(16, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            img[int(y):int(y + bh), int(x):int(x + bw)] = rng.integers(
                0, 256, 3)
            boxes.append([x, y, x + bw, y + bh])
            coco_anns.append({"id": len(coco_anns) + 1, "image_id": i + 1,
                              "category_id": int(rng.integers(k_coco)) + 1,
                              "bbox": [x, y, bw, bh], "area": bw * bh,
                              "iscrowd": 0})
        name = f"g{i:04d}.jpg"
        cv2.imwrite(str(root / name), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
        names.append(name)
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
        refs.append({"id": i + 1, "image": name, "bounding_boxes": [boxes[0]],
                     "conversations": [{"value": "<image>"}, {
                         "value": REF_QUERIES[i % len(REF_QUERIES)]}]})
    (root / "refcoco_val.json").write_text(json.dumps(refs))
    (root / "coco.json").write_text(json.dumps(
        {"images": images, "annotations": coco_anns,
         "categories": [{"id": c + 1, "name": f"coco_{c}"}
                        for c in range(k_coco)]}))
    return str(root / "refcoco_val.json"), str(root / "coco.json"), names


def uni_proposals(dev, images, n: int = 100):
    """Each image's top n proposals of a random Uni-Base (score_thr 0, as
    ref_inputs takes them)."""
    from wedetect_tpu_torch.models.api import Detector

    uni = Detector.from_random("uni_base", seed=0, device=dev)
    out = []
    for i in range(0, len(images), BATCH):
        out += [r["bboxes"][:n] for r in uni(images[i:i + BATCH],
                                             score_thr=0.0)]
    return out


def rec_step_image0_kv(model, *args):
    """ref_rec_batch_step with every suffix row given image 0's prefix KV:
    the control that per-row KV must tell apart."""
    from wedetect_tpu_torch.models import ref as R

    stage = R.RefModules.suffix_stage

    def image0(self, obj, kvs, *a):
        kvs = tuple((k[:1].expand_as(k), v[:1].expand_as(v))
                    for k, v in kvs)
        return stage(self, obj, kvs, *a)

    R.RefModules.suffix_stage = image0
    try:
        return R.ref_rec_batch_step(model, *args)
    finally:
        R.RefModules.suffix_stage = stage


@contextlib.contextmanager
def rec_steps(calls: list, step=None, sync: bool = False):
    """Route RefScorer's fused REC steps through `step` (default the
    real one), appending each call's launch counts (and, with `sync`,
    its synchronized ms) to calls."""
    from wedetect_tpu_torch.models import ref_api

    saved = ref_api.ref_rec_batch_step
    fn = step or saved

    def run(*a, **kw):
        before = launch_counts()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        if sync:
            torch.cuda.synchronize()
        after = launch_counts()
        calls.append({"ms": (time.perf_counter() - t0) * 1e3,
                      "launches": {k: after[k] - before[k] for k in after}})
        return out

    ref_api.ref_rec_batch_step = run
    try:
        yield
    finally:
        ref_api.ref_rec_batch_step = saved


def route_counts(dtype: str, k2: int = 0, k3: int = 0) -> dict:
    """expected_counts with every K2 and K3 launch on the type's route:
    f32 on the FFMA kernels, bf16 on the wgmma ones, none on SIMT."""
    bf16 = dtype == "bfloat16"
    return expected_counts(k2=k2, k2_sm90=k2 if bf16 else 0,
                           k2_f32=0 if bf16 else k2, k3=k3,
                           k3_sm90=k3 if bf16 else 0,
                           k3_f32=0 if bf16 else k3)


def nonzero(counts: dict) -> dict:
    """The launch counts that are not 0."""
    return {k: v for k, v in counts.items() if v}


def plain_kernel_control(fn):
    """fn() through K2's and K3's plain versions, and through them with
    REF_CONTROL_DROP's key tile masked in every call (the control):
    (plain, dropped). Fails if either ran a kernel."""
    launch_counts(reset=True)
    with plain_attention():
        plain = fn()
    with plain_attention(drop=REF_CONTROL_DROP):
        dropped = fn()
    ran = nonzero(launch_counts())
    assert not ran, ("a kernel ran on the plain side", ran)
    return plain, dropped


def logit_errors(got, want) -> dict:
    d = np.abs(np.concatenate([np.ravel(g) for g in got])
               - np.concatenate([np.ravel(w) for w in want]))
    return {"max": float(d.max()), "mean": float(d.mean())}


def within_limit(err: dict, name: str) -> bool:
    """REF_LOGIT_TOL on the largest error, and in bf16 REF_LOGIT_MEAN_TOL
    on the mean."""
    mean_tol = REF_LOGIT_MEAN_TOL[name]
    return err["max"] <= REF_LOGIT_TOL[name] and (
        mean_tol is None or err["mean"] <= mean_tol)


def phase_grounding(dev, cfg=None, n_images: int = GROUND_IMAGES,
                    sizes=GROUND_SIZES, grid_tokens: int = GROUND_GRID_TOKENS,
                    cli_size: str = "2b", proposals_fn=uni_proposals,
                    timing: bool = True):
    """WeDetect-Ref grounding evaluation at ref_2b's full width (or
    `cfg`), random weights, on n_images seeded JPEGs in two grid buckets
    (write_grounding_dataset) with Uni-Base proposals, f32 then bf16:
    (a) RefScorer.score_rec, one query an image, query_batch 8 (the
        landscape bucket's last chunk padded): K2 = 56 and K3 = 24 a
        fused step, all on the type's route; the logits within
        REF_LOGIT_TOL (bf16: and REF_LOGIT_MEAN_TOL) of per-image
        logits(), while the control that gives every suffix row image
        0's prefix KV misses that limit;
    (b) score_multi_images on a landscape and a portrait image with
        proposals and a square one for context: prefix sharing (K2 = 56,
        K3 = 24 an image) and the joint path (K2 = 28, K3 = 24 an image)
        agree within the same limit;
    (a, b) the REC and the shared multi-image logits within that limit
        of the same calls through K2's and K3's plain versions, while
        the plain versions with REF_CONTROL_DROP's key tile masked miss
        it (plain_kernel_control);
    (c) f32: ref_generate_multi, 16 greedy tokens on one image, equal to
        ref_generate's (K2 = 28, K3 = 24), and on two images;
    (d) cli/eval_grounding --random-init on the refcoco-format set (f32,
        --grid-tokens: K2 = 56 and K3 = 24 a fused step) and on the
        COCO-format set (80 queries an image, --bf16).
    ms a fused step, items/s through score_rec and through per-image
    score(), multi-image ms, the CLI's items/s and host split, peak GB."""
    import io
    import tempfile
    from pathlib import Path

    from wedetect_tpu_torch.cli import eval_grounding
    from wedetect_tpu_torch.data.loader import load_image_rgb
    from wedetect_tpu_torch.data.vision_process import make_grid_buckets
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.TemporaryDirectory(prefix="wedetect_ground_")
    root = Path(tmp.name)
    ref_path, coco_path, names = write_grounding_dataset(
        root, n_images, sizes, EVAL_COCO_CLASSES)
    images = [load_image_rgb(str(root / n)) for n in names]
    props = proposals_fn(dev, images)
    (root / "proposals.json").write_text(json.dumps(
        {n: np.asarray(p).tolist() for n, p in zip(names, props)}))
    samples = [(im, p, REF_QUERIES[i % len(REF_QUERIES)])
               for i, (im, p) in enumerate(zip(images, props))]
    buckets = tuple(make_grid_buckets(grid_tokens,
                                      cfg.vision.patch * cfg.vision.merge))
    n_big = n_images * 3 // 5
    n_steps = (-(-n_big // GROUND_QUERY_BATCH)
               - (-(n_images - n_big) // GROUND_QUERY_BATCH))
    # the multi-image conversation: landscape and portrait with proposals,
    # a square crop for context only
    multi_imgs = [images[0], images[-1],
                  np.ascontiguousarray(images[1][:, :sizes[0][0]])]
    multi_props = [props[0], props[-1], None]
    k2, k3 = 2 * cfg.text.layers, cfg.vision.depth
    model = init_ref_variables(cfg, seed=0, device=dev)
    tok = CharTok()
    res = {"card": nvidia_smi(), "samples": n_images, "sizes": sizes,
           "grid_tokens": grid_tokens, "fused_steps": n_steps,
           "proposals": [len(p) for p in props]}
    for name in ("float32", "bfloat16"):
        scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok, dtype=name,
                           grid_buckets=buckets,
                           query_batch=GROUND_QUERY_BATCH, device=dev)
        # (a) cross-image REC against per-image scoring and the control
        calls = []
        with rec_steps(calls):
            rec = scorer.rec_logits(samples)
        assert len(calls) == n_steps, (len(calls), n_steps)
        for c in calls:
            assert c["launches"] == route_counts(name, k2, k3), c
        assert all(r.shape == (len(p),) and np.isfinite(r).all()
                   for r, p in zip(rec, props))
        per_image = [scorer.logits(im, p, [q])[0] for im, p, q in samples]
        with rec_steps([], step=rec_step_image0_kv):
            wrong = scorer.rec_logits(samples)
        err = logit_errors(rec, per_image)
        control = logit_errors(wrong, per_image)
        r = res[name] = {
            "rec_step_launches": nonzero(calls[0]["launches"]),
            "tolerance": REF_LOGIT_TOL[name],
            "mean_tolerance": REF_LOGIT_MEAN_TOL[name],
            "rec_vs_per_image": err, "image0_kv_control": control,
            "logit_range": [float(min(x.min() for x in per_image)),
                            float(max(x.max() for x in per_image))]}
        ok = within_limit(err, name) and not within_limit(control, name)
        launch_counts(reset=True)
        shared = scorer.multi_image_logits(multi_imgs, multi_props,
                                           REF_QUERIES)
        counts = launch_counts()
        # (a, b) the kernels at these shapes against their plain versions
        # (the batched ViT, the (B, P) prefix rows, the per-row suffix,
        # the multi-image sequences), and the control with one key tile
        # dropped, which must miss
        for key, fn, got in (
                ("rec", lambda: scorer.rec_logits(samples), rec),
                ("multi", lambda: scorer.multi_image_logits(
                    multi_imgs, multi_props, REF_QUERIES), shared)):
            plain, dropped = plain_kernel_control(fn)
            r[f"{key}_vs_plain"] = logit_errors(got, plain)
            r[f"{key}_dropped_tile_control"] = logit_errors(dropped, plain)
            ok = (ok and within_limit(r[f"{key}_vs_plain"], name)
                  and not within_limit(r[f"{key}_dropped_tile_control"],
                                       name))
        # (b) several images in one conversation, shared prefix and joint
        joint = RefScorer(cfg=cfg, model=model, tokenizer=tok, dtype=name,
                          grid_buckets=buckets, prefix_sharing=False,
                          query_batch=GROUND_QUERY_BATCH, device=dev)
        launch_counts(reset=True)
        jl = joint.multi_image_logits(multi_imgs, multi_props, REF_QUERIES)
        joint_counts = launch_counts()
        assert counts == route_counts(name, k2, 3 * k3), counts
        assert joint_counts == route_counts(name, k2 // 2, 3 * k3), \
            joint_counts
        r["multi_launches"] = nonzero(counts)
        r["multi_joint_launches"] = nonzero(joint_counts)
        assert [x.shape for x in shared] == [(len(REF_QUERIES), len(p))
                                             for p in multi_props[:2]]
        r["multi_shared_vs_joint"] = logit_errors(shared, jl)
        ok = ok and within_limit(r["multi_shared_vs_joint"], name)
        if not ok:
            emit({"phase": "grounding", "dtype": name, **r})
            raise AssertionError(f"grounding {name}: logits out of limits")
        if timing:
            timed = []
            with rec_steps(timed, sync=True):
                scorer.rec_logits(samples)
            r["rec_step_ms"] = [c["ms"] for c in timed]
            ms = host_ms(lambda: scorer.score_rec(samples), 2)
            r["score_rec_items_per_s"] = n_images / ms * 1e3
            ms = host_ms(lambda: [scorer.score(im, p, [q])
                                  for im, p, q in samples], 1)
            r["per_image_score_items_per_s"] = n_images / ms * 1e3
            r["multi_ms"] = host_ms(lambda: scorer.score_multi_images(
                multi_imgs, multi_props, REF_QUERIES), 2)
            r["multi_joint_ms"] = host_ms(lambda: joint.score_multi_images(
                multi_imgs, multi_props, REF_QUERIES), 2)
        if name == "float32":
            r["generate"] = grounding_generate(cfg, scorer, multi_imgs,
                                               timing)
        emit({"phase": "grounding", "dtype": name, **r})
    del model, scorer, joint
    torch.cuda.empty_cache()
    # (d) the CLI on both sets, its own random ref model
    common = ["--random-init", "--random-size", cli_size, "--device",
              str(dev), "--img-root", str(root), "--proposals",
              str(root / "proposals.json"), "--grid-tokens",
              str(grid_tokens), "--batch-queries", str(GROUND_QUERY_BATCH)]
    try:
        for ds, extra, metric in (
                ("refcoco", ["--ann", ref_path, "--num_select", "20"],
                 "refcoco_val"),
                ("coco", ["--ann", coco_path, "--max-items", "4", "--bf16"],
                 "coco")):
            calls, t = [], {}
            launch_counts(reset=True)
            with rec_steps(calls), contextlib.redirect_stdout(io.StringIO()):
                out = eval_grounding.main(common + ["--dataset", ds, *extra,
                                                    "--out",
                                                    str(root / f"{ds}.json")],
                                          timings=t)
            counts = launch_counts()
            assert json.loads((root / f"{ds}.json").read_text()).keys() \
                == out.keys() == {metric}, out
            vals = [v for v in out[metric].values()
                    if isinstance(v, float)]
            assert vals and all(math.isnan(v) or 0 <= v <= 1 for v in vals)
            if ds == "refcoco":
                assert len(calls) == n_steps, (len(calls), n_steps)
                assert counts == route_counts(
                    "float32", k2 * n_steps, k3 * n_steps), counts
            else:
                # per image: one prefix stage, a suffix stage a query batch
                batches = 1 + -(-EVAL_COCO_CLASSES // GROUND_QUERY_BATCH)
                assert not calls and counts == route_counts(
                    "bfloat16", k2 // 2 * batches * t["items"],
                    k3 * t["items"]), counts
            res[f"cli_{ds}"] = {
                "items": t["items"], "items_per_s": t["items"] / t["wall_ms"]
                * 1e3, "wall_ms": t["wall_ms"], "fused_steps": len(calls),
                "launches": nonzero(counts), "metrics": out[metric],
                **{k: t.get(k, 0.0) for k in eval_grounding.TIMING_KEYS}}
    finally:
        tmp.cleanup()
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "grounding", **{k: v for k, v in res.items()
                                   if k not in ("float32", "bfloat16")}})
    return res


def grounding_generate(cfg, scorer, imgs, timing: bool) -> dict:
    """ref_generate_multi in f32: on one image, the tokens of
    ref_generate (the generation phase's prompt layout); on the first two
    images, valid tokens. K2 = 28 and K3 = 24 an image."""
    from wedetect_tpu_torch.models.ref_generate import ref_generate_multi
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_multi

    model, m = scorer.model, cfg.vision.merge
    b = gen_prompt(scorer, imgs[0], GEN_PROMPT)
    single = gen_call(cfg, model, b, GROUND_GEN_TOKENS)

    def one():
        return ref_generate_multi(
            cfg, ((b["gh"], b["gw"]),), model, (b["patches"],),
            b["ids"][None], b["mask"][None], b["pos"][:, None], (None,),
            (b["ori"],), (b["vs"],), np.array([b["nxt"]], np.int32),
            GROUND_GEN_TOKENS, GEN_EOS, pad_id=GEN_PAD)

    launch_counts(reset=True)
    multi = one()
    counts = launch_counts()
    k2, k3 = cfg.text.layers, cfg.vision.depth
    assert counts == route_counts("float32", k2, k3), counts
    assert torch.equal(multi, single), (multi, single)
    # two images, caption only
    pix, grids, ori = [], [], []
    for im in imgs[:2]:
        p, gh, gw = scorer._prep_patches(im)
        pix.append(p)
        grids.append((gh, gw))
        ori.append(np.array([im.shape[1], im.shape[0]], np.float32))
    tail = scorer.tokenizer.encode(
        GEN_PROMPT + "<|im_end|>\n<|im_start|>assistant\n")
    ids = np.concatenate([scorer.build_prefix_multi(
        [(gh // m) * (gw // m) for gh, gw in grids]),
        np.array(tail, np.int32)])
    img_pos = np.nonzero(ids == cfg.image_token_id)[0]
    starts = (int(img_pos[0]), int(img_pos[(grids[0][0] // m)
                                           * (grids[0][1] // m)]))
    p_real = len(ids)
    p_pad = -(-p_real // 128) * 128
    pos = np.zeros((3, 1, p_pad), np.int32)
    pos[:, 0, :p_real] = get_rope_index_multi(ids, cfg.image_token_id,
                                              grids, m)
    mask = (np.arange(p_pad) < p_real).astype(np.int32)[None]
    ids = np.pad(ids, (0, p_pad - p_real), constant_values=GEN_PAD)[None]
    nxt = np.array([pos.max() + 1], np.int32)

    def two():
        return ref_generate_multi(cfg, tuple(grids), model, pix, ids, mask,
                                  pos, (None, None), ori, starts, nxt,
                                  GROUND_GEN_TOKENS, GEN_EOS, pad_id=GEN_PAD)

    launch_counts(reset=True)
    toks = two()
    counts2 = launch_counts()
    assert counts2 == route_counts("float32", k2, 2 * k3), counts2
    assert toks.shape == (1, GROUND_GEN_TOKENS)
    assert ((toks >= 0) & (toks < cfg.text.vocab_size)).all()
    out = {"tokens_equal_ref_generate": True,
           "launches_one_image": nonzero(counts),
           "launches_two_images": nonzero(counts2), "prompt_two_images": p_pad}
    if timing:
        out["one_image_ms"] = host_ms(one, 2)
        out["two_images_ms"] = host_ms(two, 2)
    return out


# a forward kernel's errors by its route: (f32, bf16) keys of its phase
ENTRY_ERRORS = {"simt": ("max_abs_err_f32_simt", "max_abs_err_bf16_simt"),
                "f32": ("max_abs_err_f32", None),
                "sm90": ("max_abs_err_bf16", "max_abs_err_bf16")}


def kernel_entry(name, source, replaces, launches, k, timing,
                 route="simt"):
    """A forward kernel's entry by its route (fwd_route): "simt" (its f32
    and bf16 errors those of the cases it ran), "f32" the FFMA one's,
    "sm90" the wgmma one's (bf16)."""
    f32, bf16 = ENTRY_ERRORS[route]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "dtype": "bf16" if route == "sm90" else "f32",
            "max_abs_err": k[bf16 if route == "sm90" else f32],
            "max_abs_err_bf16": k[bf16] if bf16 else None,
            "tolerance": {str(t)[6:]: {"atol": a, "rtol": r}
                          for t, (a, r) in K_TOL.items()},
            "match": True, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


def bwd_entry(name, source, replaces, launches, phase, timing,
              dtype="float32"):
    """A backward kernel's entry with its own worst errors over the cases
    it ran (its phase's `errors`): in `dtype`, and under "errors" in each
    type it ran (the SIMT kernels also ran bf16)."""
    errs = {key.split("/")[1]: e for key, e in phase["errors"].items()
            if key.split("/")[0] == name}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "dtype": dtype,
            "max_abs_err": errs[dtype]["max_abs_err"],
            "max_rel_err": errs[dtype]["max_rel_err"], "errors": errs,
            "tolerance": {str(t)[6:]: {"rel_to_max": v}
                          for t, v in TRAIN_BWD_TOL.items()},
            "match": True, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"]}


STOCK_FA = "jax/experimental/pallas/ops/tpu/flash_attention.py"
K2_BWD = "wedetect_tpu/ops/flash_gqa.py"
SIMT_BWD_SOURCE = "wedetect_tpu_torch/csrc/flash_attn_bwd.cu"
SM90_BWD_SOURCE = "wedetect_tpu_torch/csrc/flash_gqa_bwd_sm90.cu"
F32_BWD_SOURCE = "wedetect_tpu_torch/csrc/flash_gqa_bwd_f32.cu"
K3_SM90_BWD_SOURCE = "wedetect_tpu_torch/csrc/flash_attn_bwd_sm90.cu"
K3_F32_BWD_SOURCE = "wedetect_tpu_torch/csrc/flash_attn_bwd_f32.cu"
F32_FWD_SOURCE = "wedetect_tpu_torch/csrc/flash_gqa_f32.cu"
K3_F32_FWD_SOURCE = "wedetect_tpu_torch/csrc/flash_attn_f32.cu"
K3_FWD = "wedetect_tpu/ops/attention.py:126"


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
    ev = phase_eval(dev, text_embeds)
    detect_int8 = phase_detect_int8(dev, "base", N_CLASSES, BATCH,
                                    text_embeds)
    del text_embeds
    phase_parity(dev)
    phase_int8_parity(dev)
    phase_uni(dev)
    phase_ref_parity(dev)
    image, proposals = ref_inputs(dev)
    ref = phase_ref(dev, (image, proposals))
    ref_int8 = phase_ref_int8(dev, (image, proposals))
    launches = ref["float32"]["launches"]
    launches_bf16 = ref["bfloat16"]["launches"]
    k2_bwd = phase_k2_bwd(dev)
    k3_bwd = phase_k3_bwd(dev)
    phase_train_parity(dev)
    phase_train_grad(dev, image, proposals)
    train, train_counts = phase_train(dev, image, proposals)
    phase_det_train_parity(dev)
    phase_det_train(dev)
    phase_gen_parity(dev)
    phase_gen(dev, image)
    serve = phase_serve(dev, image)
    gate = phase_quant_gate(dev, image)
    ground = phase_grounding(dev)
    # K2's and K3's launches a fused REC step and a multi-image call
    # (prefix sharing), by type: f32 on the FFMA kernels, bf16 on wgmma,
    # the SIMT kernels none (their nonzero counts)
    rec_step = {t: ground[t]["rec_step_launches"]
                for t in ("float32", "bfloat16")}
    multi = {t: ground[t]["multi_launches"] for t in ("float32", "bfloat16")}

    def simt(counts, k):
        return {t: a.get(k, 0) - a.get(f"{k}_sm90", 0) - a.get(f"{k}_f32", 0)
                for t, a in counts.items()}

    # K2's and K3's launches an admission prefill by route: f32 on the
    # FFMA kernels, bf16 on the wgmma ones, the SIMT ones none
    admit = {t: serve[t]["launches_per_admit"]
             for t in ("float32", "bfloat16")}
    # K2's and K3's launches in the int8 score call, by type, and K3's in
    # the calibration of one prompt
    int8 = {t: ref_int8[t]["launches"] for t in ("float32", "bfloat16")}
    calib_k3 = gate["calib_launches"]["k3_f32"] // gate["calib_prompts"]
    k2_train, k3_train = (k2_bwd_launches(train_counts),
                          k3_bwd_launches(train_counts))
    k2_bf16 = k2_bwd_launches(k2_bwd["autograd_bf16"]["launches"])
    k3_bf16 = k3_bwd_launches(k3_bwd["autograd_bf16"]["launches"])
    emit({"kernels": [
        {"name": "row_topk", "route": "cuda",
         "source": "wedetect_tpu_torch/csrc/row_topk.cu",
         "replaces": "wedetect_tpu/ops/pallas_topk.py:46",
         "launches": detect["row_topk_launches"],
         "launches_int8": detect_int8["row_topk_launches"],
         # per LVIS evaluation of 50 images (7 detect calls), f32, and
         # with flip TTA (7 calls of 2B)
         "launches_eval": ev["lvis_f32"]["row_topk_launches"],
         "launches_eval_bf16": ev["lvis_bf16"]["row_topk_launches"],
         "launches_eval_tta": ev["lvis_tta_f32"]["row_topk_launches"],
         "max_abs_err": k1["max_abs_err"], "max_abs_err_bf16": None,
         "tolerance": 0.0, "match": True,
         # ms / library_ms on k1_inputs (dense rows); path_ms on the
         # detect call's own thresholded scores, sparse_ms on
         # k1_sparse_inputs; rows by branch (no candidate, at most t,
         # more than t, a NaN) as the kernel counted them
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"],
         "path_ms": detect["k1_path"]["ms"],
         "path_library_ms": detect["k1_path"]["library_ms"],
         "path_bound_ms": detect["k1_path"]["bound_ms"],
         "path_branches": detect["k1_path"]["branches"],
         "sparse_ms": k1["sparse_ms"],
         "sparse_library_ms": k1["sparse_library_ms"],
         "sparse_branches": k1["sparse_branches"],
         "dense_branches": k1["dense_branches"]},
        # K2 timed at the suffix shape, K3 at the ViT shape, each route
        # with its launches in the score call of its type: K2 f32 at
        # D = 128 and K3 f32 at D = 64 on the FFMA kernels (also their
        # launches a SFT step, and their times at the other shapes), bf16
        # on the wgmma kernels; the SIMT K2 and K3 forwards (0 launches on
        # the f32 path; timed through their library at the suffix and at
        # the ViT shape)
        {**kernel_entry("gqa_flash_fwd_f32", F32_FWD_SOURCE,
                        "wedetect_tpu/ops/flash_gqa.py:86",
                        launches["k2_f32"], k2, k2["suffix_float32"],
                        route="f32"),
         "launches_sft_step": train["launches_per_step"]["k2_f32"],
         "launches_admit": admit["float32"]["k2_f32"],
         "launches_int8_score": int8["float32"]["k2_f32"],
         "launches_rec_step": rec_step["float32"].get("k2_f32", 0),
         "launches_multi": multi["float32"].get("k2_f32", 0),
         **{f"{shape}_{key}": k2[f"{shape}_float32"][key]
            for shape in ("prefix", "train")
            for key in ("ms", "bound_ms", "library_ms")},
         "turns_ms": {shape: k2[f"{shape}_float32"]["turns_ms"]
                      for shape in ("prefix", "suffix", "train")},
         "train_tiles_walked": k2["train_float32"]["tiles_walked"],
         "train_tiles_scanned": k2["train_float32"]["rule_tiles_scanned"]},
        {**kernel_entry("gqa_flash_fwd",
                        "wedetect_tpu_torch/csrc/flash_attn.cu",
                        "wedetect_tpu/ops/flash_gqa.py:86",
                        launches["k2"] - launches["k2_sm90"]
                        - launches["k2_f32"], k2, k2["suffix_simt_float32"]),
         "launches_admit": {t: a["k2"] - a["k2_sm90"] - a["k2_f32"]
                            for t, a in admit.items()},
         "launches_rec_step": simt(rec_step, "k2"),
         "launches_multi": simt(multi, "k2"),
         **{f"{shape}_ms": k2[f"{shape}_simt_float32"]["ms"]
            for shape in ("prefix", "train")}},
        {**kernel_entry("gqa_flash_fwd_sm90",
                        "wedetect_tpu_torch/csrc/flash_gqa_sm90.cu",
                        "wedetect_tpu/ops/flash_gqa.py:86",
                        launches_bf16["k2_sm90"], k2, k2["suffix_bfloat16"],
                        route="sm90"),
         "launches_admit": admit["bfloat16"]["k2_sm90"],
         "launches_int8_score": int8["bfloat16"]["k2_sm90"],
         "launches_rec_step": rec_step["bfloat16"].get("k2_sm90", 0),
         "launches_multi": multi["bfloat16"].get("k2_sm90", 0)},
        {**kernel_entry("flash_attention_fwd_f32", K3_F32_FWD_SOURCE, K3_FWD,
                        launches["k3_f32"], k3, k3["vit_float32"],
                        route="f32"),
         "launches_sft_step": train["launches_per_step"]["k3_f32"],
         "launches_admit": admit["float32"]["k3_f32"],
         "launches_int8_score": int8["float32"]["k3_f32"],
         "launches_calib_prompt": calib_k3,
         "launches_rec_step": rec_step["float32"].get("k3_f32", 0),
         "launches_multi": multi["float32"].get("k3_f32", 0),
         **{f"train_{key}": k3["train_float32"][key]
            for key in ("ms", "bound_ms", "library_ms")},
         "turns_ms": {shape: k3[f"{shape}_float32"]["turns_ms"]
                      for shape in ("vit", "train")},
         **{f"{shape}_tiles_{n}": k3[f"{shape}_float32"][key]
            for shape in ("vit", "train")
            for n, key in (("walked", "tiles_walked"),
                           ("scanned", "rule_tiles_scanned"))}},
        {**kernel_entry("flash_attention_fwd",
                        "wedetect_tpu_torch/csrc/flash_attn.cu", K3_FWD,
                        launches["k3"] - launches["k3_sm90"]
                        - launches["k3_f32"], k3, k3["vit_simt_float32"]),
         "launches_admit": {t: a["k3"] - a["k3_sm90"] - a["k3_f32"]
                            for t, a in admit.items()},
         "launches_rec_step": simt(rec_step, "k3"),
         "launches_multi": simt(multi, "k3"),
         "train_ms": k3["train_simt_float32"]["ms"]},
        {**kernel_entry("flash_attention_fwd_sm90",
                        "wedetect_tpu_torch/csrc/flash_attn_sm90.cu", K3_FWD,
                        launches_bf16["k3_sm90"], k3, k3["vit_bfloat16"],
                        route="sm90"),
         "launches_admit": admit["bfloat16"]["k3_sm90"],
         "launches_int8_score": int8["bfloat16"]["k3_sm90"],
         "launches_rec_step": rec_step["bfloat16"].get("k3_sm90", 0),
         "launches_multi": multi["bfloat16"].get("k3_sm90", 0)},
        # the backward kernels' launches from the train phase, their
        # times at its shapes (decoder and ViT), f32; K2-bwd in f32 at
        # D = 128 is the FFMA pair, and the SIMT dq and dk/dv kernels
        # (timed at the training shape through their library) are not
        # launched there
        bwd_entry("gqa_flash_bwd_dq_f32", F32_BWD_SOURCE, f"{K2_BWD}:169",
                  k2_train["gqa_flash_bwd_dq_f32"], k2_bwd,
                  k2_bwd["dq_float32"]),
        bwd_entry("gqa_flash_bwd_dq", SIMT_BWD_SOURCE, f"{K2_BWD}:169",
                  k2_train["gqa_flash_bwd_dq"], k2_bwd,
                  k2_bwd["dq_simt_float32"]),
        bwd_entry("gqa_flash_bwd_dkdv_f32", F32_BWD_SOURCE, f"{K2_BWD}:212",
                  k2_train["gqa_flash_bwd_dkdv_f32"], k2_bwd,
                  k2_bwd["dkdv_float32"]),
        bwd_entry("gqa_flash_bwd_dkdv", SIMT_BWD_SOURCE, f"{K2_BWD}:212",
                  k2_train["gqa_flash_bwd_dkdv"], k2_bwd,
                  k2_bwd["dkdv_simt_float32"]),
        # K2-bwd in bf16 (wgmma + TMA): launches from the k2_bwd phase's
        # loss.backward() through gqa_flash_attention (no CLI trains in
        # bf16), times at the training shape
        bwd_entry("gqa_flash_bwd_dq_sm90", SM90_BWD_SOURCE, f"{K2_BWD}:169",
                  k2_bf16["gqa_flash_bwd_dq_sm90"], k2_bwd,
                  k2_bwd["dq_bfloat16"], dtype="bfloat16"),
        bwd_entry("gqa_flash_bwd_dkdv_sm90", SM90_BWD_SOURCE,
                  f"{K2_BWD}:212", k2_bf16["gqa_flash_bwd_dkdv_sm90"],
                  k2_bwd, k2_bwd["dkdv_bfloat16"], dtype="bfloat16"),
        # K3-bwd in f32 at D = 64 is the FFMA pair, and the SIMT dq and
        # dk/dv kernels (timed at the training shape through their
        # library) are not launched there
        {**bwd_entry("flash_attention_bwd_dq_f32", K3_F32_BWD_SOURCE,
                     f"{STOCK_FA}:1146",
                     k3_train["flash_attention_bwd_dq_f32"], k3_bwd,
                     k3_bwd["dq_float32"]),
         "turns_ms": k3_bwd["dq_turns_float32"],
         "train_tiles_walked": k3_bwd["dq_float32"]["tiles_walked"],
         "train_tiles_scanned": k3_bwd["dq_float32"]["rule_tiles_scanned"],
         "pair_ms": k3_bwd["pair_float32"]["ms"],
         "pair_over_library": k3_bwd["pair_float32"]["over_library"]},
        bwd_entry("flash_attention_bwd_dq", SIMT_BWD_SOURCE,
                  f"{STOCK_FA}:1146", k3_train["flash_attention_bwd_dq"],
                  k3_bwd, k3_bwd["dq_simt_float32"]),
        bwd_entry("flash_attention_bwd_dkv_f32", K3_F32_BWD_SOURCE,
                  f"{STOCK_FA}:796", k3_train["flash_attention_bwd_dkv_f32"],
                  k3_bwd, k3_bwd["dkv_float32"]),
        bwd_entry("flash_attention_bwd_dkv", SIMT_BWD_SOURCE,
                  f"{STOCK_FA}:796", k3_train["flash_attention_bwd_dkv"],
                  k3_bwd, k3_bwd["dkv_simt_float32"]),
        # K3-bwd in bf16 at D = 64 (wgmma + TMA): launches from the k3_bwd
        # phase's loss.backward() through flash_attention, times at the
        # training shape
        bwd_entry("flash_attention_bwd_dq_sm90", K3_SM90_BWD_SOURCE,
                  f"{STOCK_FA}:1146", k3_bf16["flash_attention_bwd_dq_sm90"],
                  k3_bwd, k3_bwd["dq_bfloat16"], dtype="bfloat16"),
        bwd_entry("flash_attention_bwd_dkv_sm90", K3_SM90_BWD_SOURCE,
                  f"{STOCK_FA}:796", k3_bf16["flash_attention_bwd_dkv_sm90"],
                  k3_bwd, k3_bwd["dkv_bfloat16"], dtype="bfloat16")]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
