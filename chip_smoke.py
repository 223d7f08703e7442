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
2a. native the port's JPEG decoder (cv2's libjpeg-turbo, the header,
            EXIF and letterbox C++ of native/image_pipeline.cc built by
            g++), held to cv2 + preprocess_image on
            the eval set's 50 seeded JPEGs, two at 2592 x 1458 and one
            with an EXIF orientation: scale factor, pad and ori shape
            exactly, pixels of decode_jpeg and decode_letterbox at the
            JAX package's limits (mean < 1, 99.9th percentile <= 2),
            fast (libjpeg's DCT-scaled decode) against exact (mean < 2,
            99th percentile <= 12); a
            corrupt file rejected (decode_fallbacks counts it); a
            letterbox one pixel off must miss. ms an image (native
            exact and fast, cv2), on one thread and on 8.
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
7a. detect_files  the same detector through Detector.__call__ on 8 JPEG
            paths (the native decode + letterbox), the head calibrated:
            one K1 launch, detections bitwise those of the same step on
            decode_letterbox's arrays (cuDNN deterministic), no cv2
            fallback; ms a call in f32 and bf16 on files, on decoded
            arrays and letterboxed, and the host decode's share.
7b. fold    ckpt/fuse on that detector, its BN statistics made random
            and the head calibrated again: the fold_conv_bn state in
            the same modules against the unfolded one in f32, logits
            within FOLD_TOL of their largest entry, the box (DFL)
            logits too, one K1 launch a call in each, and every
            detection kept by one model only a flipped decision (a
            score or an NMS IoU across its threshold, two scores
            swapped, or a cascade of such: nms_flips), none unexplained; bake_text_head's e @ W^T + c against each
            level's contrastive logits; controls that must miss: the
            neck's eps in the head's fold, the bake without the
            contrastive norms.
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
            the LVIS and COCO runs, and the LVIS f32 run again with
            the loader's fast_decode; every JPEG natively decoded.
8a. odinw   cli/eval_odinw.main --random-init on a seeded tree of two
            ODinW-13 subsets (Aquarium, K = 7; PascalVOC, K = 20; 8
            JPEGs each with planted boxes): both found and printed with
            mean_mAP, K1 never launched; items/s.
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
28. video_gen  WeDetect-Ref video chat at ref_2b's full width, random
            weights: 16 seeded 480x640 frames saved as an .npy stack,
            through RefScorer.generate_video_text (fetch_video,
            video_to_patches: grid 30 x 40, grid_t = 8, 9600 ViT tokens
            as one segment, 2400 video tokens, P = 2483 in 2560), 32
            greedy tokens, f32 then bf16: K2 = 28 and K3 = 24 a call and
            a prefill on the type's route (SIMT 0), the call's tokens
            equal to a direct ref_generate(grid_t) call; the prefill's
            last-position logits within REF_LOGIT_TOL (bf16: and the mean
            limit) of the same prefill through K2's and K3's plain
            versions, while the plain versions with one key tile masked,
            the clip with temporal groups 0 and 1 swapped and
            image-layout rope ids each miss it. Host prompt ms, prefill
            ms, decode ms a token, peak GB. Then K2 at the prompt's
            prefix (1, 2560, 16, 128 | 2560, 8) and K3 at its ViT (1,
            9600, 16, 64), both types: the route's one launch held to the
            plain version (K_TOL), device time beside the plain version,
            SDPA and the bound; K3's f32 walk read back and held to
            fwd_walk_map, the other tile timed.
29. video_sft  stage-2 video SFT at ref_2b, f32: a list of 4 seeded
            448x448 PNG frames through ChatSftDataset and
            build_step_inputs (grid_t = 2, 28 x 28, 1568 ViT tokens in
            1664, 392 video tokens, L = 1024); one LM loss and gradient
            through the kernels and through the plain forward and
            backward versions within TRAIN_GRAD_TOL (per parameter
            group, grad_norm, the loss), a control with one key tile
            dropped in every backward call that must miss; then 2
            ref_lm_steps through cli/train_ref.train_ref_loop: finite
            losses, the vision tower bitwise unchanged (stage 2), the
            decoder changed, 28 each of K2's FFMA forward, dq and dk/dv
            and 24 each of K3's a step (the ViT takes gradients); ms a
            step, peak GB.
30. video_cli  python -m wedetect_tpu_torch.cli.infer_wedetect_ref
            --random-init --video <the .npy> --generate "Describe the
            clip." on the card: exit 0 and text printed.
31. vis     the three CLIs' drawing on the card's detections of a
            seeded 480x640 image: infer_wedetect --output (WeDetect-Base,
            random init), generate_proposal --visualize (Uni-Base) and
            infer_wedetect_ref --visualize (Uni-Base proposals scored by
            the miniature random Ref, the checkpoint loader stubbed):
            each PNG written, at the input's size, different from it.

32. dist_det  multi-card detector training, two gloo ranks on the one
            card (spawned by spawn_ranks, a file:// rendezvous; nccl
            refuses two ranks on one GPU): WeDetect-Base at full width,
            640x640, K = 80, cli/train's build functions, each rank
            making only its rows of the global batch, drop path 0.2, lr
            1e-4, f32 with TF32 off and cuDNN deterministic: data = 2
            (B = 16, 8 a rank) and fsdp = 2 (data = 1, B = 8), two steps
            each, held to the one-process step on the same weights and
            global batch (run first, in this process). fsdp = 2
            bitwise: both steps' metrics, the gradients and moment
            slices after the first, the parameters after the second.
            data = 2: the first step's loss, its parts and grad_norm
            within DIST_TOL relative, the second's within
            DIST_DET_STEP2_TOL, num_pos equal; after the first step the
            summed gradients and each rank's Adam mu and nu by relative
            L2 per parameter group within DIST_DET_TOL, each BatchNorm
            weight's and bias's gradient within DIST_DET_BN_TOL, the BN
            running statistics; after the second each group's
            parameter move within DIST_DET_MOVE_TOL. The limits are
            constants; the one-process step with its BatchNorm through
            the data-parallel formula (the rounding floor) must stay
            within them, and a control with each rank's BatchNorm on
            its own rows must miss; K1 launched 0 times. Then 3 bf16
            steps (the CLI's dtype) of each: ms a step per rank,
            collective ms, calls and MB a step (each collective
            synchronised), peak GB per rank, beside det_train's
            one-process step.
33. dist_ref  WeDetect-Ref stage-3 SFT over fsdp = 2, two gloo ranks on
            the one card: ref_2b's widths cut to 8 of 28 decoder layers
            and 8 of 24 ViT blocks (two full-depth f32 ranks do not fit
            one card beside each other), the CLI's defaults, one step in
            f32 held to one process (loss and grad_norm within
            TRAIN_RANK_TOL, the parameters by TRAIN_PARAM_RULE, each
            rank's mu and nu slices within TRAIN_RANK_TOL of their
            tensor's largest entry, the initial weights' checksum equal;
            bitwise reported), K2, K3, K2-bwd and K3-bwd launches per
            rank (8 each on the FFMA kernels); a second step timed: ms
            and collective ms a step, peak GB per rank.
34. dist_nccl  the NCCL route at world 1: cli/train.py (WeDetect-Base,
            B = 4, 2 steps, a checkpoint read back) and cli/train_ref.py
            (ref_2b at full depth, random weights through a stubbed
            loader, stage 3, one f32 step: its peak GB) under torchrun's
            variables with WORLD_SIZE=1, through make_mesh at world 1;
            then an all_reduce, a gather and a broadcast of
            parallel/collectives on a one-rank nccl group.
35. tp_serve  tensor-parallel Ref serving, two gloo ranks on the one
            card (make_tp_mesh, tp = 2): ref_2b at full width cut to
            dist_ref's depth (gloo's ~1.8 ms a call made a full-depth
            GenServer run 46 s a mode on an NVIDIA H100 80GB HBM3 at
            700 W; full_depth=True runs it whole),
            each rank holding its slices of the serve phase's seeded
            weights (init_ref_variables(mesh=)), f32 with TF32 off,
            against one process on the same weights: RefScorer's score
            logits on the ref phase's inputs within TP_LOGIT_TOL (a
            control without the row-parallel all_reduce must miss it);
            64 greedy tokens of ref_generate and GenServer(mesh=) at the
            serve cell (8 slots, chunk 16, G = 64, 16 requests) greedy,
            warped (0.8, top-k 30, top-p 0.9), int8 KV and piggyback:
            every request's tokens equal one process's by the margin
            rule, the two ranks' tokens bitwise equal; K2 and K3
            launches per rank in a score call and an admission prefill;
            K2 (prefix, suffix) and K3 (ViT) at a rank's heads against
            their plain versions (K_TOL), f32 and bf16, with device ms;
            each rank's score ms, prefill ms, ms a token, GenServer
            tokens/s, collective calls, MB and ms a score call and a
            token, peak GB, in f32 and (where gloo carries a bf16
            all_reduce of a CUDA tensor) bf16.
36. legacy  the legacy modules at the JAX modules' default widths (no
            Pallas kernel lies inside them), each held to the same call
            on the CPU on the same weights and the first 2 inputs
            (LEGACY_TOL: max |card - CPU| over max |CPU|, 1e-4 in f32,
            5e-2 in bf16): the CLIP text tower (ViT-B/32's: 12 x 512, 8
            heads, 77 positions, 49,408 tokens) on 80 seeded prompts and
            the vision tower (12 x 768, 224 px, patch 32) at B = 8, f32
            and bf16; PseudoTextBackbone on the tower's embeddings;
            YOLOWorldPAFPN (channels 256/512/1024, embed 128/256/512,
            heads 4/8/16, 3 CSP blocks; dual off and on), YOLOv8PAFPN and
            YOLOv5PAFPN on a seeded 640 pyramid (80, 40, 20) at B = 8,
            the guide the text tower's (8, 80, 512) embeddings, BN
            statistics from the inputs; YOLOv5HeadModule at K = 80 on
            the YOLOv5 neck (obj bias shifted so that 15,000 (anchor,
            class) scores of image 0 pass score_thr), yolov5_decode
            (25,200 anchors an image) and batched_static_nms at the
            detect path's TestCfg, K1's launches counted around it, its
            slots bitwise the CPU's on the same decode; one yolov5_loss
            forward and backward at B = 8, 20 boxes an image (each term
            and the gradients of the predictions); RepVGGBlock at 256
            channels, 80 x 80, stride 1 and 2, and its repvgg_fuse
            deploy form against the train form. ms a call (device time)
            of each, with the nvidia-smi line.

Then the kernels line (each K2 and K3 entry with its launches a video
prefill and its times at the video shape, each backward entry with its
launches a video SFT step, every attention kernel with its launches in
each rank of a dist_ref step, K1 with its launches in dist_det's ranks
and in the legacy phase,
and the f32 and bf16 K2 and K3 entries with their launches in each
tp_serve rank and their times at a rank's shapes), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA card, or without the rest
of the repository beside it, the script fails before printing a result.
"""

from __future__ import annotations

import contextlib
import copy
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
            "loader_wait_ms_per_batch": t["loader_wait_ms"]
            / max(t["batches"], 1),
            "img_per_s": t["images"] * 1e3 / t["wall_ms"],
            **{k: t[k] for k in TIMING_KEYS},
            "host_eval_share": (t["add_image_ms"] + t["summarize_ms"])
            / t["wall_ms"]}


@contextlib.contextmanager
def fast_decode_loader():
    """Route eval/runner's EvalLoader through fast_decode=True (the
    native decoder's DCT-scaled decode)."""
    import functools

    from wedetect_tpu_torch.data.loader import EvalLoader
    from wedetect_tpu_torch.eval import runner

    runner.EvalLoader = functools.partial(EvalLoader, fast_decode=True)
    try:
        yield
    finally:
        runner.EvalLoader = EvalLoader


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
        AP50 above 0; the f32 run again with the loader's fast_decode;
        every JPEG through the native decoder (no cv2 fallback);
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

    from wedetect_tpu_torch import native

    fallbacks = native.decode_fallbacks
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
        with fast_decode_loader():
            m, launches, t = run(cfg, None)
        assert launches == n_calls, ("fast_decode", launches, n_calls)
        res["lvis_f32_fast_decode"] = {
            "row_topk_launches": launches,
            "metrics": check_metrics(m, LVIS_KEYS), **eval_split(t)}
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
    res["decode_fallbacks"] = native.decode_fallbacks - fallbacks
    assert res["decode_fallbacks"] == 0, res["decode_fallbacks"]
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


def ref_sft_dataset(cfg, image, proposals, grid_tokens: int, root=None):
    """The stage-3 dataset of the training phases: one seeded image (read
    from memory), two seeded ground-truth boxes, the Uni proposals (its
    json files under `root`, default build/chip_smoke)."""
    from wedetect_tpu_torch.data.sft_chat import ReferringSftDataset
    from wedetect_tpu_torch.data.vision_process import make_grid_buckets

    root = root or os.path.join(os.path.dirname(os.path.abspath(__file__)),
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


def teacher_logits(model, gh, gw, patches, ids, mask, pos, nxt, toks,
                   boxes, ori, vs):
    """The f32 logits (len(toks), vocab) from which each emitted token was
    drawn, under a teacher-forced forward of prompt + tokens (one row,
    padded to a multiple of 128)."""
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
        return model.lm_logits(h)[0, n_p - 1:n_p - 1 + len(toks)].float()


def teacher_margins(model, gh, gw, patches, ids, mask, pos, nxt, toks,
                    boxes, ori, vs):
    """Each emitted token's argmax agreement, top-2 margin and gap (the
    top logit less the emitted token's; 0 where it is the argmax) under
    a teacher-forced forward of prompt + tokens (teacher_logits): (argmax
    ok, margin, gap), each per step."""
    toks = [int(t) for t in toks]
    lg = teacher_logits(model, gh, gw, patches, ids, mask, pos, nxt, toks,
                        boxes, ori, vs)
    with torch.inference_mode():
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


# ------------------------------------------------------------------ video
VIDEO_FRAMES = 16          # seeded uint8 frames at 480x640, an .npy stack:
VIDEO_HW = (480, 640)      # video_frame_pixel_budget(16) keeps the size,
#                            grid 30 x 40 and grid_t = 8: 9600 ViT tokens
#                            (75 x 128, no pad), 2400 video tokens
VIDEO_PROMPT = "Describe the clip."
VIDEO_GEN_TOKENS = 32
VIDEO_SFT_FRAMES = 4       # PNG frames at 448x448: grid_t = 2, 28 x 28,
VIDEO_SFT_SIDE = 448       # 1568 ViT tokens (1664 padded), 392 video tokens
VIDEO_SFT_STEPS = 2


def video_root() -> str:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke", "video")
    os.makedirs(root, exist_ok=True)
    return root


def write_video_npy(n: int = VIDEO_FRAMES, hw=VIDEO_HW, seed: int = 5) -> str:
    """n seeded uint8 RGB frames of size hw saved as an .npy stack."""
    frames = np.random.default_rng(seed).integers(0, 256, (n, *hw, 3),
                                                  dtype=np.uint8)
    path = os.path.join(video_root(), "clip.npy")
    np.save(path, frames)
    return path


def video_prompt(scorer, npy: str) -> dict:
    """RefScorer's video-prompt layout (build_video_prompt) as arrays, and
    its host time (fetch_video, video_to_patches and the layout)."""
    t0 = time.perf_counter()
    patches, gt, gh, gw, ids, mask, pos, vs, w, h = \
        scorer.build_video_prompt(npy, VIDEO_PROMPT, GEN_PAD)
    host = (time.perf_counter() - t0) * 1e3
    return dict(patches=patches, gt=gt, gh=gh, gw=gw, ids=ids, mask=mask,
                pos=pos, vs=vs, nxt=int(pos.max()) + 1, host_ms=host,
                boxes=np.array([[0, 0, w, h]], np.float32),
                ori=np.array([w, h], np.float32))


def video_prefill(model, b, patches=None, pos=None):
    """The video prompt's prefill (ref_generate's): (hidden, kvs)."""
    from wedetect_tpu_torch.models import ref_generate as TG

    with torch.inference_mode():
        return TG._prefill_hidden_kvs(
            model, b["gh"], b["gw"],
            b["patches"] if patches is None else patches, b["ids"][None],
            b["mask"][None], (b["pos"] if pos is None else pos)[:, None],
            b["boxes"], b["ori"], b["vs"], np.full((1, 1), -1, np.int32),
            grid_t=b["gt"])


def video_logits(model, b, **kw) -> np.ndarray:
    """The prefill's LM logits (f32) at the prompt's last position."""
    hidden, kvs = video_prefill(model, b, **kw)
    del kvs
    with torch.inference_mode():
        out = model.lm_logits(hidden[0, int(b["mask"].sum()) - 1])
    return out.float().cpu().numpy()


def swap_groups(b) -> np.ndarray:
    """The clip's patches with temporal groups 0 and 1 swapped."""
    n = b["gh"] * b["gw"]
    p = b["patches"].copy()
    p[:n], p[n:2 * n] = b["patches"][n:2 * n], b["patches"][:n]
    return p


def image_rope(cfg, b) -> np.ndarray:
    """Image-layout rope ids in place of the video ones: the span read as
    one image of grid_t * gh rows."""
    from wedetect_tpu_torch.nn.qwen3vl import get_rope_index_single_image

    ids = np.where(b["ids"] == cfg.video_token_id, -1, b["ids"])
    return get_rope_index_single_image(ids, -1, b["gt"] * b["gh"], b["gw"],
                                       cfg.vision.merge).astype(np.int32)


def video_kernels(dev, p_real: int, p_pad: int, l: int) -> dict:
    """K2 at the video prompt's prefix (1, P, 16, 128 | P, 8; causal, the
    pad keys invalid) and K3 at its ViT (1, 9600, 16, 64; one segment),
    f32 and bf16: the route's launch, held to the plain version (K_TOL,
    lse 1e-3); device time (graph_ms) beside the plain version and SDPA,
    the bound; K3's f32 walk read back and held to fwd_walk_map."""
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        t = str(dtype)[6:]
        q, k, v, valid = k2_case(dev, 1, p_pad, p_pad, 16, 8, 128, True,
                                 ((p_real, p_pad),), dtype=dtype, seed=0)
        pairs = k2_visible_pairs(p_pad, p_pad, True, valid)
        r = attn_bound(16, 128, pairs, q.numel() + 2 * k.numel(), q.numel(),
                       p_pad * 16, dtype)
        launch_counts(reset=True)
        o, lse = fg.gqa_flash_attention(q, k, v, causal=True, kv_valid=valid,
                                        return_lse=True)
        torch.cuda.synchronize()
        r["launches"] = nonzero(launch_counts())
        po, plse = fg.gqa_flash_attention_plain(
            q, k, v, causal=True, kv_valid=valid, return_lse=True)
        r["route"] = fg.fwd_route(dtype, 128, 2)
        r["max_abs_err"] = float((o.float() - po.float()).abs().max())
        r["lse_err"] = float((lse - plse).abs().max())
        r["match"] = (kernel_close(o, po, dtype) and r["lse_err"] <= 1e-3
                      and r["launches"] == nonzero(route_counts(t, k2=1)))
        call = lambda: fg.gqa_flash_attention(  # noqa: E731
            q, k, v, causal=True, kv_valid=valid)
        mask = k2_mask(valid, p_pad, p_pad)
        r["ms"] = graph_ms(call)
        r["plain_ms"] = cuda_ms(lambda: fg.gqa_flash_attention_plain(
            q, k, v, causal=True, kv_valid=valid), iters=3, warmup=1)
        r["library_ms"] = graph_ms(lambda: sdpa_gqa(q, k, v, mask))
        res[f"k2_{t}"] = r
        del q, k, v, valid, o, lse, po, plse, mask
        q, k, v, seg = k3_case(dev, 1, l, 16, 64, l, False, dtype=dtype,
                               seed=1)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, sm_scale=0.125)
        r = attn_bound(16, 64, l * l, 3 * q.numel(), q.numel(), l * 16,
                       dtype)
        launch_counts(reset=True)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        r["launches"] = nonzero(launch_counts())
        po, plse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        r["route"] = fa.fwd_route(dtype, 64)
        r["max_abs_err"] = float((o.float() - po.float()).abs().max())
        r["lse_err"] = float((lse - plse).abs().max())
        r["match"] = (kernel_close(o, po, dtype) and r["lse_err"] <= 1e-3
                      and r["launches"] == nonzero(route_counts(t, k3=1)))
        del o, lse, po, plse
        call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        r["ms"] = graph_ms(call)
        r["plain_ms"] = cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, **kw), iters=3, warmup=1)
        r["library_ms"] = graph_ms(lambda: sdpa_gqa(q, k, v, None))
        if dtype == torch.float32:
            r.update(k3_walk(q, k, v, seg))
        res[f"k3_{t}"] = r
        del q, k, v, seg
        torch.cuda.empty_cache()
    return res


def phase_video_gen(dev, cfg=None, frames: int = VIDEO_FRAMES,
                    hw=VIDEO_HW, new_tokens: int = VIDEO_GEN_TOKENS,
                    timing: bool = True):
    """Video chat at ref_2b's full width (or `cfg`), random weights, on
    VIDEO_FRAMES seeded frames through RefScorer.generate_video_text, f32
    then bf16, greedy: K2 = layers and K3 = depth launches a call and a
    prefill on the type's route; the prefill's last-position logits
    within REF_LOGIT_TOL (bf16: and the mean limit) of the same prefill
    through K2's and K3's plain versions, while the plain versions with
    one key tile masked, the clip with two temporal groups swapped and
    image-layout rope ids each miss it; the call's tokens equal a direct
    ref_generate(grid_t) call. Host prompt ms, prefill ms, decode ms a
    token, peak GB; the kernels at the video shapes (video_kernels)."""
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.models.ref_generate import ref_generate
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = cfg or ref_2b()
    npy = write_video_npy(frames, hw)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=dev)
    res = {"frames": frames, "hw": list(hw), "npy": npy,
           "new_tokens": new_tokens}
    ok = True
    for name in ("float32", "bfloat16"):
        scorer = RefScorer(cfg=cfg, model=model, tokenizer=CharTok(),
                           dtype=name, device=dev)
        b = video_prompt(scorer, npy)
        want = route_counts(name, k2=cfg.text.layers, k3=cfg.vision.depth)

        def call():
            return scorer.generate_video_text(
                npy, VIDEO_PROMPT, max_new_tokens=new_tokens,
                eos_token_id=GEN_EOS, pad_token_id=GEN_PAD)

        launch_counts(reset=True)
        text = call()
        counts = launch_counts()
        direct = trim(ref_generate(
            cfg, b["gh"], b["gw"], model, b["patches"], b["ids"][None],
            b["mask"][None], b["pos"][:, None], b["vs"],
            np.array([b["nxt"]], np.int32), b["boxes"], b["ori"],
            new_tokens, GEN_EOS, pad_id=GEN_PAD,
            grid_t=b["gt"])[0].cpu().numpy())
        launch_counts(reset=True)
        logits = video_logits(model, b)
        prefill_counts = launch_counts()
        plain, dropped = plain_kernel_control(lambda: video_logits(model, b))
        err = logit_errors([logits], [plain])
        controls = {
            "dropped_tile": logit_errors([dropped], [plain]),
            "swap_groups": logit_errors(
                [video_logits(model, b, patches=swap_groups(b))], [plain]),
            "image_rope": logit_errors(
                [video_logits(model, b, pos=image_rope(cfg, b))], [plain])}
        r = res[name] = {
            "grid_t": b["gt"], "grid": [b["gh"], b["gw"]],
            "vit_tokens": b["gt"] * b["gh"] * b["gw"],
            "video_tokens": int((b["ids"] == cfg.video_token_id).sum()),
            "prompt_len": int(b["mask"].sum()), "bucket": len(b["ids"]),
            "next_pos": b["nxt"], "host_prompt_ms": b["host_ms"],
            "launches": counts, "prefill_launches": prefill_counts,
            "tokens": len(text), "text_equals_direct_call":
                list(text) == direct,
            "logit_err": err, "control_err": controls,
            "tolerance": {"max": REF_LOGIT_TOL[name],
                          "mean": REF_LOGIT_MEAN_TOL[name]}}
        ok = ok and (counts == want and prefill_counts == want
                     and r["text_equals_direct_call"] and len(text) > 0
                     and within_limit(err, name)
                     and not any(within_limit(c, name)
                                 for c in controls.values()))
        if timing:
            r["prefill_ms"] = host_ms(lambda: video_prefill(model, b), 2)
            r["call_ms"] = host_ms(call, 1)
            r["decode_ms_per_token"] = (r["call_ms"] - r["host_prompt_ms"]
                                        - r["prefill_ms"]) / new_tokens
        emit({"phase": "video_gen", "dtype": name, **r})
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del model, scorer
    torch.cuda.empty_cache()
    if timing:
        b = res["float32"]
        res["kernels"] = video_kernels(dev, b["prompt_len"], b["bucket"],
                                       b["vit_tokens"])
        ok = ok and all(r["match"] for r in res["kernels"].values())
    emit({"phase": "video_gen_model", "peak_mem_gb": res["peak_mem_gb"],
          "kernels": res.get("kernels")})
    if not ok:
        raise AssertionError("video_gen: video generation broke its checks")
    return res


def write_video_sft(root: str, n: int = VIDEO_SFT_FRAMES,
                    side: int = VIDEO_SFT_SIDE, seed: int = 6) -> str:
    """A chat json of one video sample: n seeded PNG frames (cv2) as a
    frame list, a <video> turn and an answer."""
    import cv2

    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        p = os.path.join(root, f"sft_frame{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
        paths.append(p)
    path = os.path.join(root, "video_chat.json")
    with open(path, "w") as f:
        json.dump([{"video": paths, "conversations": [
            {"from": "human", "value": "<video>\n" + VIDEO_PROMPT},
            {"from": "gpt", "value": "Coloured noise flickers across four "
                                     "frames."}]}], f)
    return path


def lm_loss_grads(model, b):
    """ref_lm_step's loss and gradients on a step's inputs, without the
    update."""
    from wedetect_tpu_torch.train.ref_lm import lm_cross_entropy

    gh, gw = b["grid"]
    model.zero_grad(set_to_none=True)
    hidden = model.hidden_states(
        b["patches"], b["input_ids"], b["attn_mask"], b["position_ids"],
        b["boxes"], b["ori_wh"], b["visual_start"], b["object_positions"],
        grid_h=gh, grid_w=gw, grid_t=b["grid_t"])
    loss = lm_cross_entropy(model.lm_logits(hidden), torch.as_tensor(
        b["labels"], device=model.device).long())
    loss.backward()
    # out_proj does not enter the LM loss: its gradient is zero
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_video_sft(dev, cfg=None, steps: int = VIDEO_SFT_STEPS):
    """Stage-2 video SFT at ref_2b's full width (or `cfg`), random
    weights, f32: a frame-list video sample through ChatSftDataset and
    build_step_inputs; one LM loss and gradient through the kernels and
    through the plain forward and backward versions (the loss, each
    parameter group's relative L2 gradient error and grad_norm's within
    TRAIN_GRAD_TOL; a control with one key tile dropped in every backward
    call must miss); then `steps` ref_lm_steps through
    cli/train_ref.train_ref_loop (stage_optimizer, stage 2): finite
    losses, the vision tower bitwise unchanged, the decoder changed, K2,
    K3 and their backward kernels launched on the f32 routes a step (the
    ViT takes gradients); ms a step, peak GB."""
    from wedetect_tpu_torch.cli.train_ref import (build_step_inputs,
                                                  train_ref_loop)
    from wedetect_tpu_torch.data.sft_chat import ChatSftDataset
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b
    from wedetect_tpu_torch.train.ref_lm import stage_optimizer
    from wedetect_tpu_torch.train.train_step import TrainState

    cfg = cfg or ref_2b()
    ds = ChatSftDataset(
        write_video_sft(video_root()), CharTok(),
        image_token_id=cfg.image_token_id,
        vision_start_token_id=cfg.vision_start_token_id,
        object_token_id=cfg.object_token_id,
        video_token_id=cfg.video_token_id, patch=cfg.vision.patch,
        merge=cfg.vision.merge)
    sample = ds.sample(0)
    buckets = (1024, 2048, 4096)
    b = build_step_inputs(cfg, sample, 2, buckets, 100, GEN_PAD)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=dev)
    launch_counts(reset=True)
    loss_k, gk = lm_loss_grads(model, b)
    counts = launch_counts()
    with plain_attention():
        loss_p, gp = lm_loss_grads(model, b)
    errs = group_errors(gk, gp)
    del gk
    with plain_attention(bwd_drop=BWD_CONTROL_DROP):
        loss_c, gc = lm_loss_grads(model, b)
    ctrl = group_errors(gc, gp)
    del gc, gp
    torch.cuda.empty_cache()
    per_step = expected_counts(
        k2=cfg.text.layers, k2_f32=cfg.text.layers, k3=cfg.vision.depth,
        k3_f32=cfg.vision.depth, k2_bwd=cfg.text.layers,
        k3_bwd=cfg.vision.depth, k2_bwd_dkdv_f32=cfg.text.layers,
        k2_bwd_dq_f32=cfg.text.layers, k3_bwd_dkv_f32=cfg.vision.depth,
        k3_bwd_dq_f32=cfg.vision.depth)
    gh, gw = b["grid"]
    res = {"grid_t": b["grid_t"], "grid": [gh, gw],
           "vit_tokens": b["grid_t"] * gh * gw,
           "video_tokens": int((sample["input_ids"]
                                == cfg.video_token_id).sum()),
           "seq_len": int(b["input_ids"].shape[1]),
           "real_tokens": int(b["attn_mask"].sum()),
           "loss_launches": counts, "loss": loss_k,
           "loss_abs_diff": abs(loss_k - loss_p),
           "control_loss_abs_diff": abs(loss_c - loss_p),
           "rel_l2_err": errs, "control_rel_l2_err": ctrl,
           "tolerance": TRAIN_GRAD_TOL}
    ok = (max(errs.values()) <= TRAIN_GRAD_TOL < max(ctrl.values())
          and res["loss_abs_diff"] <= TRAIN_GRAD_TOL * abs(loss_p)
          and counts == per_step)
    watch = {n: p.detach().clone() for n, p in model.named_parameters()
             if n.startswith("model.visual.blocks.0.") or n ==
             "model.language_model.layers.0.mlp.down_proj.weight"}
    state = TrainState.create(model, stage_optimizer(model, 2))
    logs = []
    launch_counts(reset=True)
    state = train_ref_loop(cfg, state, ds, 2, steps, seq_buckets=buckets,
                           max_proposals=100, pad_token_id=GEN_PAD,
                           log_every=1, seed=0,
                           log_fn=lambda s, m: logs.append(m))
    step_counts = launch_counts()
    torch.cuda.synchronize()
    params = dict(model.named_parameters())
    losses = [m["loss"] for m in logs]
    step_ms = [1e3 / m["steps_per_s"] for m in logs]
    res.update({
        "steps": steps, "losses": losses, "step_ms": step_ms,
        "ms_per_step": float(np.mean(step_ms[1:] or step_ms)),
        "launches_per_step": {n: c / steps for n, c in step_counts.items()},
        "vision_unchanged": all(torch.equal(params[n].detach(), w)
                                for n, w in watch.items()
                                if n.startswith("model.visual.")),
        "decoder_changed": not torch.equal(
            params["model.language_model.layers.0.mlp.down_proj.weight"]
            .detach(),
            watch["model.language_model.layers.0.mlp.down_proj.weight"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    ok = ok and (len(losses) == steps and all(np.isfinite(losses))
                 and res["vision_unchanged"] and res["decoder_changed"]
                 and step_counts == {n: c * steps
                                     for n, c in per_step.items()})
    emit({"phase": "video_sft", **res})
    del state, model, watch, params
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("video_sft: the video SFT step broke its checks")
    return res


def phase_video_cli(dev, npy: str):
    """python -m wedetect_tpu_torch.cli.infer_wedetect_ref --random-init
    --video <npy> --generate VIDEO_PROMPT on `dev` (the miniature random
    Ref, the same clip): exit 0 and text printed."""
    cmd = [sys.executable, "-m", "wedetect_tpu_torch.cli.infer_wedetect_ref",
           "--random-init", "--video", npy, "--generate", VIDEO_PROMPT,
           "--max_new_tokens", "16", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = proc.stdout.strip().splitlines()
    res = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
           "text": lines[-1] if lines else ""}
    emit({"phase": "video_cli", **res})
    if proc.returncode != 0 or not res["text"].strip():
        print(proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("video_cli: the CLI printed no text")
    return res


@contextlib.contextmanager
def random_ref_loader():
    """cli/_ref_load.load_ref returning the miniature random Ref: the Ref
    CLI's scoring refuses --random-init, and no checkpoint is here."""
    from wedetect_tpu_torch.cli import _ref_load

    saved = _ref_load.load_ref
    _ref_load.load_ref = lambda ckpt, device: \
        _ref_load.tiny_random_ref(device)
    try:
        yield
    finally:
        _ref_load.load_ref = saved


def phase_vis(dev):
    """The three CLIs' drawing on the card's detections of a seeded
    480x640 image: infer_wedetect --output (WeDetect-Base, random
    init), generate_proposal --visualize (Uni-Base) and
    infer_wedetect_ref --visualize (Uni-Base proposals scored by the
    miniature random Ref through random_ref_loader). Each PNG written,
    at the input's size, different from the input."""
    import cv2

    from wedetect_tpu_torch.cli import (generate_proposal, infer_wedetect,
                                        infer_wedetect_ref)

    root = os.path.join(video_root(), "vis")
    os.makedirs(root, exist_ok=True)
    img = np.random.default_rng(7).integers(0, 256, (480, 640, 3),
                                            dtype=np.uint8)
    path = os.path.join(root, "image.png")
    cv2.imwrite(path, img)
    outs = {n: os.path.join(root, f"{n}.png")
            for n in ("infer_wedetect", "generate_proposal",
                      "infer_wedetect_ref")}
    for out in outs.values():
        if os.path.exists(out):
            os.remove(out)
    boxes = {}
    on = ["--device", dev.type]
    r = infer_wedetect.main(["--image", path, "--text", "person,dog,car",
                             "--random-init", "--threshold", "0.0",
                             "--output", outs["infer_wedetect"], *on])
    boxes["infer_wedetect"] = len(r["bboxes"])
    r = generate_proposal.main(["--image", path, "--random-init",
                                "--score_thre", "0.0", "--visualize",
                                "--output", outs["generate_proposal"], *on])
    boxes["generate_proposal"] = len(r["bboxes"])
    with random_ref_loader():
        r = infer_wedetect_ref.main([
            "--image", path, "--query", "a dog", "--ref_checkpoint",
            "random", "--visualize", "--output", outs["infer_wedetect_ref"],
            *on])
    boxes["infer_wedetect_ref"] = len(r["boxes"])
    res, ok = {}, True
    for name, out in outs.items():
        drawn = cv2.imread(out) if os.path.exists(out) else None
        res[name] = {"boxes": boxes[name], "written": drawn is not None,
                     "size_ok": drawn is not None
                     and drawn.shape == img.shape,
                     "pixels_changed": 0 if drawn is None
                     or drawn.shape != img.shape
                     else int((drawn != img).any(-1).sum())}
        ok = ok and res[name]["size_ok"] and res[name]["pixels_changed"] > 0
    emit({"phase": "vis", **res})
    if not ok:
        raise AssertionError("vis: a CLI's drawing is missing or unchanged")
    return res


# ------------------------------------------------------------ deploy path
NATIVE_SIZE = (640, 640)
NATIVE_THREADS = 8
# the JAX package's limits (tests/test_native_loader.py): the native
# decode and letterbox against cv2's, the mean |diff| and its 99.9th
# percentile; fast decode against exact, its mean and 99th percentile
NATIVE_MEAN_TOL, NATIVE_P999_TOL = 1.0, 2.0
FAST_MEAN_TOL, FAST_P99_TOL = 2.0, 12.0


def exif_jpeg(data: bytes, orient: int) -> bytes:
    """JPEG bytes with an EXIF APP1 segment (one Orientation tag)
    spliced in after SOI."""
    tiff = (b"II*\x00\x08\x00\x00\x00\x01\x00\x12\x01\x03\x00\x01\x00"
            b"\x00\x00" + bytes([orient]) + b"\x00\x00\x00\x00\x00\x00\x00")
    body = b"Exif\x00\x00" + tiff
    return (data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(2, "big")
            + body + data[2:])


def pixel_diff(got: np.ndarray, want: np.ndarray) -> dict:
    """|got - want| over every channel: mean, 99th and 99.9th percentile,
    max."""
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return {"mean": float(d.mean()), "p99": float(np.percentile(d, 99)),
            "p999": float(np.quantile(d, 0.999)), "max": int(d.max())}


def within(stats: dict, mean_tol: float, q_key: str, q_tol: float) -> bool:
    return stats["mean"] < mean_tol and stats[q_key] <= q_tol


def worst(stats: list) -> dict:
    return {k: max(s[k] for s in stats) for k in stats[0]}


def per_image_ms(fn, items, threads: int) -> float:
    """Wall ms an item of fn over items, on one thread or a pool (after
    one warm-up pass, which builds each thread's decoder)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(fn, items))
        t0 = time.perf_counter()
        list(pool.map(fn, items))
        return (time.perf_counter() - t0) * 1e3 / len(items)


def synthetic_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """tests/test_native_loader.py's synthetic RGB image: x, y and x + y
    ramps with noise 0-31."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                    (xx + yy) % 256], -1).astype(np.uint8)
    noise = rng.integers(0, 32, img.shape, np.int32)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def dec_shape(data: bytes):
    """(h, w) of a JPEG as cv2 decodes it."""
    import cv2

    return cv2.imdecode(np.frombuffer(data, np.uint8),
                        cv2.IMREAD_COLOR).shape[:2]


def cv2_letterbox(data: bytes, size):
    """The reference path: cv2 decode + ops/letterbox.preprocess_image."""
    import cv2

    from wedetect_tpu_torch.ops.letterbox import preprocess_image

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return preprocess_image(cv2.cvtColor(img, cv2.COLOR_BGR2RGB), size)


def phase_native(n_images: int = EVAL_IMAGES, sides=(480, 1000),
                 size=NATIVE_SIZE, timing: bool = True):
    """The port's JPEG decoder (native/image_pipeline.cc) built here and
    held to cv2 + ops/letterbox.preprocess_image on the eval phase's
    seeded JPEGs (write_eval_dataset), two at 2592 x 1458 (fast decode
    engages: the JAX package's synthetic image, and smooth noise, whose
    fast-vs-exact error is reported, not held), one with an EXIF
    orientation (6) and one corrupt file: scale factor, pad and ori
    shape exactly, the
    pixels of decode_jpeg and decode_letterbox within the JAX package's
    limits (mean < 1, 99.9th percentile <= 2), fast decode against
    exact (mean < 2, 99th percentile <= 12); the corrupt file rejected
    (rc 1: decode_fallbacks counts it); a control, the letterbox one
    pixel to the right, must miss. ms an image, native exact, native
    fast and cv2, and the native decode alone (no resize), on one thread
    and on NATIVE_THREADS."""
    import tempfile
    from pathlib import Path

    import cv2

    from wedetect_tpu_torch import native

    t0 = time.perf_counter()
    native.load_image()
    res = {"decoder": f"cv2 {cv2.__version__}",
           "build_s": time.perf_counter() - t0,
           "images": n_images, "size": list(size)}
    tmp = tempfile.TemporaryDirectory(prefix="wedetect_native_")
    try:
        root = Path(tmp.name)
        write_eval_dataset(root, n_images, N_CLASSES, EVAL_COCO_CLASSES,
                           sides)
        paths = sorted(root.glob("*.jpg"))
        # two 2592 x 1458 images, >= 2x downscales where fast decode
        # engages: the JAX package's synthetic image of
        # its fast-decode limit (gradients + noise), held to that limit,
        # and the eval set's smooth noise, reported
        large = root / "large.jpg"
        cv2.imwrite(str(large), synthetic_image(1458, 2592)[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 92])
        noise = root / "large_noise.jpg"
        small = np.random.default_rng(8).integers(0, 256, (92, 163, 3),
                                                  dtype=np.uint8)
        cv2.imwrite(str(noise), cv2.resize(small, (2592, 1458)),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        exif = root / "exif6.jpg"
        exif.write_bytes(exif_jpeg(paths[0].read_bytes(), 6))
        paths += [large, noise, exif]
        datas = [p.read_bytes() for p in paths]
        dec, box, fast, control = [], [], [], []
        meta_exact = True
        for path, data in zip(paths, datas):
            want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
            dec.append(pixel_diff(native.decode_jpeg(data), want))
            got = native.decode_letterbox(data, size)
            ref = cv2_letterbox(data, size)
            meta_exact &= (np.array_equal(got[1], ref[1])
                           and np.array_equal(got[2], ref[2])
                           and got[3] == tuple(ref[3]))
            box.append(pixel_diff(got[0], ref[0]))
            control.append(pixel_diff(np.roll(got[0], 1, axis=1), ref[0]))
            quick = native.decode_letterbox(data, size, fast=True)
            meta_exact &= (np.array_equal(quick[1], got[1])
                           and np.array_equal(quick[2], got[2])
                           and quick[3] == got[3])
            fast.append(pixel_diff(quick[0], got[0]))
        fast_noise = fast.pop(-2)
        exif_shape = list(native.decode_jpeg(datas[-1]).shape)
        exif_ok = (exif_shape == list(cv2.imread(str(exif)).shape)
                   and exif_shape[:2] == list(dec_shape(datas[0]))[::-1])
        res.update(meta_exact=meta_exact, exif_shape=exif_shape,
                   exif_rotated=exif_ok,
                   decode=worst(dec), letterbox=worst(box),
                   fast_vs_exact=worst(fast),
                   fast_vs_exact_noise=fast_noise, control=worst(control))
        # the corrupt file: SOI, then bytes that are no JPEG segment
        corrupt = (b"\xff\xd8"
                   + np.random.default_rng(9).bytes(4096))
        before = native.decode_fallbacks
        rejected = (native.decode_letterbox(corrupt, size) is None
                    and native.decode_jpeg(corrupt) is None)
        res["corrupt_rejected"] = rejected
        res["corrupt_fallbacks"] = native.decode_fallbacks - before
        if timing:
            decode = native.decode_jpeg
            exact = lambda b: native.decode_letterbox(b, size)  # noqa: E731
            quick = lambda b: native.decode_letterbox(  # noqa: E731
                b, size, fast=True)
            ref = lambda b: cv2_letterbox(b, size)  # noqa: E731
            res["ms_per_image"] = {
                f"{name}_{threads}t": per_image_ms(fn, datas[:n_images],
                                                   threads)
                for threads in (1, NATIVE_THREADS)
                for name, fn in (("native_decode", decode),
                                 ("native", exact), ("native_fast", quick),
                                 ("cv2", ref))}
            res["cpu_count"] = os.cpu_count()
    finally:
        tmp.cleanup()
    res["ok"] = (meta_exact and rejected and res["corrupt_fallbacks"] == 2
                 and exif_ok
                 and all(within(s, NATIVE_MEAN_TOL, "p999", NATIVE_P999_TOL)
                         for s in dec + box)
                 and all(within(s, FAST_MEAN_TOL, "p99", FAST_P99_TOL)
                         for s in fast)
                 and not any(within(c, NATIVE_MEAN_TOL, "p999",
                                    NATIVE_P999_TOL) for c in control))
    emit({"phase": "native", **res})
    if not res["ok"]:
        raise AssertionError("native: the decoder missed a limit")
    return res


def det_lists_equal(a: list, b: list) -> bool:
    """Two Detector.__call__ results, key by key, bit for bit."""
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def call_on_letterboxed(det, boxed: list, thr: float) -> list:
    """Detector.__call__'s step and filter on already letterboxed images
    (decode_letterbox's (padded, sf, pad, ori) each)."""
    from wedetect_tpu_torch.models import wedetect as W

    d = W.detect_step(det.cfg, det.model, np.stack([b[0] for b in boxed]),
                      det._text_embeds, np.stack([b[1] for b in boxed]),
                      np.stack([b[2] for b in boxed]),
                      np.stack([np.array(b[3], np.float32) for b in boxed]))
    d = W.Detections(*(x.cpu().numpy() for x in d))
    out = []
    for i in range(len(boxed)):
        keep = d.valid[i] & (d.scores[i] > thr)
        out.append({"bboxes": d.boxes[i][keep], "scores": d.scores[i][keep],
                    "labels": d.labels[i][keep],
                    "embeddings": d.embeds[i][keep]})
    return out


def phase_detect_files(dev, text_embeds, size: str = "base",
                       k: int = N_CLASSES, batch: int = BATCH,
                       sides=(480, 1000), timing: bool = True, **cfg_kw):
    """Detector.__call__ on `batch` JPEG paths (the eval set's first
    images): each decoded by the native decoder, the head calibrated as
    the eval phase's (eval_calibrate: calibrate_head, then the bias
    lowered until bf16 is sparse too) so that K1 takes the sparse branch
    in both types, one K1 launch a call. Its detections equal, bit for bit
    (cuDNN deterministic), the same step on the arrays that
    native.decode_letterbox returns; no file falls back to cv2. ms a
    call in f32 and bf16: on the files, on the decoded arrays (cv2
    letterbox), the host decode alone and its share of the file call,
    and the detect step on letterboxed arrays. Returns the detector and
    its letterboxed inputs for the fold phase."""
    import tempfile
    from pathlib import Path

    from wedetect_tpu_torch import native
    from wedetect_tpu_torch.models.api import Detector
    from wedetect_tpu_torch.ops.row_topk import row_topk

    det = Detector.from_random(size, seed=0, device=dev, num_classes=k,
                               **cfg_kw)
    det.reparameterize([f"class_{i}" for i in range(k)], embeds=text_embeds)
    cfg, thr = det.cfg, det.cfg.test.score_thr
    tmp = tempfile.TemporaryDirectory(prefix="wedetect_files_")
    saved_det = torch.backends.cudnn.deterministic
    try:
        root = Path(tmp.name)
        write_eval_dataset(root, batch, N_CLASSES, EVAL_COCO_CLASSES, sides)
        paths = [str(p) for p in sorted(root.glob("*.jpg"))]
        datas = [Path(p).read_bytes() for p in paths]
        fallbacks = native.decode_fallbacks
        boxed = [native.decode_letterbox(b, cfg.img_size) for b in datas]
        images = np.stack([b[0] for b in boxed])
        res = {"calibration": eval_calibrate(det, [images],
                                             det._text_embeds, thr)}
        torch.backends.cudnn.deterministic = True
        row_topk.launches = 0
        got = det(paths, score_thr=thr)
        launches = row_topk.launches
        want = call_on_letterboxed(det, boxed, thr)
        torch.backends.cudnn.deterministic = saved_det
        match = det_lists_equal(got, want)
        res.update({
            "size": size, "k": k, "batch": batch, "img": list(cfg.img_size),
            "row_topk_launches": launches,
            "detections": sum(
                check_detections([r], max(b[3]), k, thr, cfg.embed_dims)
                for r, b in zip(got, boxed)),
            "matches_letterboxed_arrays": match,
            "decode_fallbacks": native.decode_fallbacks - fallbacks})
        assert launches == 1, f"the file call launched row_topk {launches}x"
        assert match, "detections on files != on decode_letterbox's arrays"
        assert res["decode_fallbacks"] == 0, res["decode_fallbacks"]
        if timing:
            import cv2

            arrays = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
                      for p in paths]
            for name, c in (("f32", cfg), ("bf16", dataclasses.replace(
                    cfg, compute_dtype="bfloat16"))):
                det.cfg = det.model.cfg = c
                row_topk.launches = 0
                r = res[name] = {
                    "files_call_ms": host_ms(
                        lambda: det(paths, score_thr=thr), 3)}
                r["row_topk_launches_per_call"] = row_topk.launches / 4
                r["arrays_call_ms"] = host_ms(
                    lambda: det(arrays, score_thr=thr), 3)
                r["letterboxed_step_ms"] = host_ms(
                    lambda: call_on_letterboxed(det, boxed, thr), 3)
                r["img_per_s_files"] = batch * 1e3 / r["files_call_ms"]
            det.cfg = det.model.cfg = cfg
            decode_ms = host_ms(lambda: [native.decode_letterbox(
                b, cfg.img_size) for b in datas], 3)
            res["host_decode_ms"] = decode_ms
            res["host_decode_share"] = {n: decode_ms / res[n]["files_call_ms"]
                                        for n in ("f32", "bf16")}
    finally:
        torch.backends.cudnn.deterministic = saved_det
        tmp.cleanup()
    emit({"phase": "detect_files", **res})
    return det, boxed, res


# the fold phase: the folded model's f32 class logits, its box (DFL)
# logits and the baked head's logits within this share of each tensor's
# largest entry. The boxes are read, not held: each side is a softmax
# expectation over reg_max bins times the level's stride (up to 32), so
# a logit error reaches the pixels amplified by up to 2 (reg_max - 1)
# stride
FOLD_TOL = 1e-4


@contextlib.contextmanager
def record_nms(calls: list):
    """Keep each batched_static_nms call of models/wedetect.postprocess:
    (scores (B, A, K), boxes (B, A, 4), NMSResult, its keywords)."""
    from wedetect_tpu_torch.models import wedetect as W

    inner = W.batched_static_nms

    def recorded(scores, boxes, **kw):
        out = inner(scores, boxes, **kw)
        calls.append((scores, boxes, out, kw))
        return out

    W.batched_static_nms = recorded
    try:
        yield calls
    finally:
        W.batched_static_nms = inner


def box_iou(a: torch.Tensor, b: torch.Tensor) -> float:
    """IoU of two xyxy boxes (4,), by ops/nms's own function on their
    device."""
    from wedetect_tpu_torch.ops.nms import _pairwise_iou_nn

    return float(_pairwise_iou_nn(a[None].float(), b[None].float())[0, 0])


def nms_flips(x_call, y_call) -> list:
    """The detections that one NMS call keeps and the other does not,
    keyed by (image, anchor, label), each with the decision that flipped
    it. For a candidate kept by one call (X) and dropped by the other
    (Y): "score_thr" when its score crossed the score threshold;
    otherwise the kept detection y of Y that suppressed it (same label,
    higher score, IoU above the threshold) and, in X: "order" when X
    ranks it above y, "iou" when its IoU with y in X is at or below the
    threshold (the IoU crossed it), "cascade" when X did not keep y (y
    flipped itself), "cap" when Y's slots were full, else
    "unexplained"."""
    flips = []
    for first, (cx, cy) in (("x", (x_call, y_call)), ("y", (y_call,
                                                            x_call))):
        sx, bx, rx, kw = cx
        sy, by, ry, _ = cy
        thr, score_thr = kw["iou_thr"], kw["score_thr"]
        for img in range(rx.valid.shape[0]):
            keep = [set(zip(r.anchors[img][r.valid[img]].tolist(),
                            r.labels[img][r.valid[img]].tolist()))
                    for r in (rx, ry)]
            for a, lab in sorted(keep[0] - keep[1]):
                f = {"kept_by": first, "image": img, "anchor": a,
                     "label": lab, "score": float(sx[img, a, lab]),
                     "score_other": float(sy[img, a, lab])}
                if f["score_other"] <= score_thr:
                    f["cause"] = "score_thr"
                    flips.append(f)
                    continue
                box_y = by[img, a]
                sup = [(float(sy[img, a2, lab]), a2)
                       for a2, l2 in keep[1] if l2 == lab
                       and box_iou(box_y, by[img, a2]) > thr
                       and float(sy[img, a2, lab]) >= f["score_other"]]
                if not sup:
                    f["cause"] = ("cap" if len(keep[1]) == kw["max_out"]
                                  else "unexplained")
                    flips.append(f)
                    continue
                s_sup, a2 = max(sup)
                f.update(by_anchor=a2, by_score_other=s_sup,
                         by_score=float(sx[img, a2, lab]),
                         iou_other=box_iou(box_y, by[img, a2]),
                         iou=box_iou(bx[img, a], bx[img, a2]))
                if (a2, lab) not in keep[0]:
                    f["cause"] = "cascade"
                elif f["by_score"] <= f["score"]:
                    f["cause"] = "order"
                elif f["iou"] <= thr:
                    f["cause"] = "iou"
                else:
                    f["cause"] = "unexplained"
                flips.append(f)
    return flips


def perturb_bn(model, seed: int = 11) -> None:
    """Random BN statistics and affines, in place (the random init
    leaves them at 0 / 1, where a fold changes nothing)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                draw = [0.1 * torch.randn(n, generator=g),
                        0.05 + 1.45 * torch.rand(n, generator=g),
                        0.1 * torch.randn(n, generator=g),
                        0.1 * torch.randn(n, generator=g)]
                mean, var, dw, db = (x.to(m.weight.device) for x in draw)
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
                m.weight.add_(dw)
                m.bias.add_(db)


def rel_max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over want's largest entry."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def phase_fold(dev, det, boxed, timing: bool = True):
    """ckpt/fuse on the detect_files detector, its BN statistics made
    random first (perturb_bn) and its head calibrated again: the
    fold_conv_bn model (the same modules, the folded state) against the
    unfolded one in f32 on decode_letterbox's arrays: logits within
    FOLD_TOL of their largest entry, and the box (DFL) logits too (the
    boxes' largest move read), one K1 launch a call in each; every
    detection that one model keeps and the other does not is a decision
    that the fold's rounding flipped (nms_flips: a score across the
    threshold, a score order or an NMS IoU crossed, or a cascade of
    such), none unexplained; a fold with the neck's eps in the head
    must miss. bake_text_head: e @ W^T + c on each level's raw
    embeddings within FOLD_TOL of the head's contrastive
    logits (both less the level's scalar bias), and a bake that leaves
    the norms out must miss. ms a call of both."""
    from wedetect_tpu_torch.ckpt import fuse
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.models.api import Detector, _build_detector
    from wedetect_tpu_torch.ops.row_topk import row_topk

    cfg, thr = det.cfg, det.cfg.test.score_thr
    images = np.stack([b[0] for b in boxed])
    w = det._text_embeds
    perturb_bn(det.model)
    calibrate_head(det, images, w, thr)

    def folded(state):
        model = _build_detector(cfg, dev)
        model.load_state_dict(state, strict=True)
        return Detector(cfg=cfg, model=model, _text_embeds=w)

    fdet = folded(fuse.fold_conv_bn(det.model))
    saved = fuse.HEAD_EPS
    fuse.HEAD_EPS = fuse.NECK_EPS
    try:
        control_state = fuse.fold_conv_bn(det.model.state_dict())
    finally:
        fuse.HEAD_EPS = saved
    # the bake's control: the contrastive norms left out (each made the
    # identity), as if raw embeddings were scored
    neutral = {"norm.weight": 1.0, "norm.bias": 0.0,
               "norm.running_mean": 0.0,
               "norm.running_var": 1.0 - fuse.HEAD_EPS}
    baked_control = fuse.bake_text_head(
        {k: torch.full_like(v, neutral[k.split(".", 3)[3]])
         if k.startswith("bbox_head.cls_contrasts.")
         and k.split(".", 3)[3] in neutral else v
         for k, v in det.model.state_dict().items()}, w.cpu())
    res = {"pairs": len(fuse.conv_bn_pairs(det.model.state_dict()))}
    with torch.inference_mode():
        a = W.forward_raw(cfg, det.model, images, w)
        b = W.forward_raw(cfg, fdet.model, images, w)
        res["logits_err"] = rel_max_err(b.logits, a.logits)
        res["dist_logits_err"] = rel_max_err(b.dist_logits, a.dist_logits)
        res["boxes_max_px"] = float((b.boxes - a.boxes).abs().max())
        del b
        c = W.forward_raw(cfg, folded(control_state).model, images, w)
        res["control_logits_err"] = rel_max_err(c.logits, a.logits)
        del a, c, control_state
    counts = []
    calls = []
    for d in (det, fdet):
        row_topk.launches = 0
        with record_nms(calls):
            call_on_letterboxed(d, boxed, thr)
        counts.append(row_topk.launches)
    res["row_topk_launches"] = counts
    res["detections"] = [int(c[2].valid.sum()) for c in calls]
    flips = nms_flips(*calls)
    del calls
    res["flips"] = len(flips)
    res["flip_causes"] = {c: sum(f["cause"] == c for f in flips)
                          for c in sorted({f["cause"] for f in flips})}
    res["flipped"] = flips
    res["flip_max_score"] = max((f["score"] for f in flips), default=0.0)

    # the baked head on each level's raw (pre-BN) region embeddings
    raw, logits = {}, {}
    hooks = []
    head = det.model.bbox_head
    for i, (pred, contrast) in enumerate(zip(head.cls_preds,
                                             head.cls_contrasts)):
        hooks.append(pred.register_forward_hook(
            lambda m, inp, out, i=i: raw.__setitem__(i, out)))
        hooks.append(contrast.register_forward_hook(
            lambda m, inp, out, i=i: logits.__setitem__(i, out[0])))
    try:
        with torch.inference_mode():
            W.forward_raw(cfg, det.model, images, w)
    finally:
        for h in hooks:
            h.remove()
    baked = fuse.bake_text_head(det.model, w.cpu())
    bake_err, bake_control = [], []
    with torch.inference_mode():
        for i in sorted(raw):
            # against the contrastive term: the level's scalar bias (the
            # calibrated shift, ~-30) is left out of both sides
            b = det.model.bbox_head.cls_contrasts[i].bias
            for table, errs in ((baked, bake_err),
                                (baked_control, bake_control)):
                p = table[f"cls_contrasts.{i}"]
                got = (torch.einsum("bchw,kc->bkhw", raw[i],
                                    p["weight"].to(dev))
                       + p["bias"].to(dev)[None, :, None, None])
                errs.append(rel_max_err(got - b, logits[i] - b))
    del raw, logits
    res.update(bake_err=bake_err, bake_control_err=bake_control)
    if timing:
        res["unfolded_call_ms"] = host_ms(
            lambda: call_on_letterboxed(det, boxed, thr), 3)
        res["folded_call_ms"] = host_ms(
            lambda: call_on_letterboxed(fdet, boxed, thr), 3)
    del fdet
    torch.cuda.empty_cache()
    res["ok"] = (res["logits_err"] <= FOLD_TOL
                 and res["dist_logits_err"] <= FOLD_TOL
                 and res["control_logits_err"] > FOLD_TOL
                 and counts == [1, 1]
                 and "unexplained" not in res["flip_causes"]
                 and max(bake_err) <= FOLD_TOL
                 and min(bake_control) > FOLD_TOL)
    emit({"phase": "fold", "tol": FOLD_TOL, **res})
    if not res["ok"]:
        raise AssertionError("fold: the folded model missed a limit")
    return res


# two ODinW-13 subsets (class lists as in GLIP's ODinW configs)
ODINW_SUBSETS = {
    "Aquarium": ["fish", "jellyfish", "penguin", "puffin", "shark",
                 "starfish", "stingray"],
    "PascalVOC": ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
                  "car", "cat", "chair", "cow", "diningtable", "dog",
                  "horse", "motorbike", "person", "pottedplant", "sheep",
                  "sofa", "train", "tvmonitor"]}
ODINW_IMAGES = 8


def write_odinw_tree(root, n: int = ODINW_IMAGES, sides=(480, 1000),
                     seed: int = 12) -> int:
    """Each subset as `<subset>/<subset>.coco/test/test_annotations.json`
    with n seeded JPEGs beside it (smooth noise, 1-10 planted boxes each,
    painted in, of its classes). Returns the number of images."""
    import cv2

    rng = np.random.default_rng(seed)
    for sub, classes in ODINW_SUBSETS.items():
        d = root / sub / f"{sub}.coco" / "test"
        d.mkdir(parents=True)
        images, anns = [], []
        for i in range(n):
            h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
            small = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3),
                                 dtype=np.uint8)
            img = cv2.resize(small, (w, h))
            for _ in range(int(rng.integers(1, 11))):
                bw, bh = rng.uniform(16, w / 2), rng.uniform(16, h / 2)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                img[int(y):int(y + bh), int(x):int(x + bw)] = rng.integers(
                    0, 256, 3)
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": int(rng.integers(len(classes)))
                             + 1, "bbox": [x, y, bw, bh], "area": bw * bh,
                             "iscrowd": 0})
            name = f"{i:06d}.jpg"
            cv2.imwrite(str(d / name), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
            images.append({"id": i + 1, "file_name": name, "width": w,
                           "height": h})
        (d / "test_annotations.json").write_text(json.dumps(
            {"images": images, "annotations": anns,
             "categories": [{"id": c + 1, "name": t}
                            for c, t in enumerate(classes)]}))
    return n * len(ODINW_SUBSETS)


def phase_odinw(dev, n_images: int = ODINW_IMAGES, sides=(480, 1000),
                size: str = "base"):
    """cli/eval_odinw.main --random-init on a seeded tree of two ODinW-13
    subsets (write_odinw_tree: Aquarium, K = 7; PascalVOC, K = 20):
    discover finds both, main returns (exit 0) and prints each subset's
    mAP line and the mean_mAP JSON; K1 never launches (K <= 20 takes the
    dense selection). items/s through the CLI and through its
    evaluate_coco calls, with their host split."""
    import io
    import tempfile
    from pathlib import Path

    from wedetect_tpu_torch import native
    from wedetect_tpu_torch.cli import eval_odinw
    from wedetect_tpu_torch.ops.row_topk import row_topk

    tmp = tempfile.TemporaryDirectory(prefix="wedetect_odinw_")
    try:
        root = Path(tmp.name)
        n = write_odinw_tree(root, n_images, sides)
        found = [s[0] for s in eval_odinw.discover(str(root))]
        assert found == sorted(ODINW_SUBSETS), found
        calls = []
        out = io.StringIO()
        fallbacks = native.decode_fallbacks
        row_topk.launches = 0
        t0 = time.perf_counter()
        with timed_runner(calls), contextlib.redirect_stdout(out):
            results = eval_odinw.main(["--root", str(root), "--random-init",
                                       "--size", size, "--device",
                                       dev.type])
        wall = time.perf_counter() - t0
    finally:
        tmp.cleanup()
    text = out.getvalue()
    lines = [line for line in text.splitlines() if ": mAP " in line]
    eval_ms = sum(c["wall_ms"] for c in calls)
    res = {"images": n, "subsets": found, "results": results,
           "printed": lines, "row_topk_launches": row_topk.launches,
           "decode_fallbacks": native.decode_fallbacks - fallbacks,
           "cli_s": wall, "items_per_s_cli": n / wall,
           "items_per_s_eval": n * 1e3 / eval_ms,
           "eval": [eval_split(c) for c in calls]}
    res["ok"] = (set(results) == {*ODINW_SUBSETS, "mean_mAP"}
                 and [line.split(":")[0] for line in lines]
                 == sorted(ODINW_SUBSETS)
                 and '"mean_mAP"' in text and row_topk.launches == 0
                 and res["decode_fallbacks"] == 0
                 and all(0 <= v <= 1 for v in results.values() if v == v))
    emit({"phase": "odinw", **res})
    if not res["ok"]:
        raise AssertionError("odinw: the CLI's output is not as expected")
    return res


# a forward kernel's errors by its route: (f32, bf16) keys of its phase
# ------------------------------------------------- multi-rank training
# Two ranks share the one card over gloo (nccl refuses two ranks on one
# GPU); each is a process of this script (`spawn_ranks`), joined through
# eval/dist.maybe_initialize with a file:// rendezvous. The one-process
# reference runs first, in this process, and leaves its tensors under
# dist_root() for the ranks, which compare on the card and write JSON.
DIST_LR = 1e-4            # tests/test_torch_dist_train.py's rate
# detector, one process vs 2 ranks, f32 with TF32 off, cuDNN
# deterministic. fsdp = 2 (data = 1): the parameters are sharded
# (ZeRO-3, parallel/fsdp.py: each rank stores its slices and gathers a
# unit at a time for the forward and again for the backward); each rank
# computes the one-process step on the whole batch from the gathered
# weights and updates its slices, so it is held bitwise: both steps'
# metrics, the summed gradients (gathered) and moment slices after the
# first step, the parameters (gathered) after the second. data =
# 2: the first step's loss, its parts and grad_norm within DIST_TOL
# relative, the second's within DIST_DET_STEP2_TOL, num_pos equal; after
# the first step the relative L2 error of the summed gradients, mu and
# nu for each parameter group (backbone, neck, head) and the whole
# within DIST_DET_TOL, and of each BatchNorm weight's and bias's
# gradient within DIST_DET_BN_TOL; each BN running statistic within
# DET_STATS_TOL of max(1, its tensor's largest entry); after the second
# step the relative L2 error of each group's parameter move (p - p0)
# within DIST_DET_MOVE_TOL (a rank that skipped its update reads 1).
# The limits are constants. The rounding floor, one process with its
# BatchNorm through the data-parallel formula (gathered statistics,
# Chan's rule: the same function, other rounding), must pass them too
# (`bn_formula_floor`); the per-rank BatchNorm control must miss. Read
# at random-init Base (NVIDIA H100 80GB HBM3, 700 W): data = 2 gradients
# 1.6e-3 and nu 1.9e-3 in the backbone and neck, the worst BatchNorm
# tensor 2.4e-3, the second step's loss 1.3e-4 (Adam turns the sign
# noise of near-zero gradients into +-lr), the move 0.114 in the
# backbone; the control 0.37, 0.43, 6.7e-4 and 0.47-0.76.
DIST_TOL = 1e-4
DIST_DET_STEP2_TOL = 1e-3
DIST_DET_TOL = 5e-3
DIST_DET_BN_TOL = 2e-2
DIST_DET_MOVE_TOL = 0.3
DIST_DET_BATCH = {"dp": 16, "fsdp": 8}    # global batches
DIST_DET_DROP_PATH = 0.2
# dist_ref: ref_2b's widths at 8 of 28 decoder layers and 8 of 24 ViT
# blocks, its deepstack taps scaled from (5, 11, 17) of 24: the tensor
# checks. phase_dist_ref(full_depth=True) runs ref_2b whole (with its
# parameters sharded, two full-depth f32 ranks fit the card: 33.12 GB a
# rank on an NVIDIA H100 80GB HBM3 at 700 W), held by exact checksums;
# it is left out of main(), whose gloo phases vary by up to 2x: with it
# the whole script took 936 s on that card, without it 802 s
DIST_REF_DEPTH = {"layers": 8, "vit": 8, "deepstack": (1, 3, 5)}
DIST_DEV = "cuda"         # the ranks' device (a CPU rehearsal sets "cpu")


def dist_root() -> str:
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "dist")
    os.makedirs(root, exist_ok=True)
    return root


def spawn_ranks(entry: str, root: str, world: int = 2,
                timeout: int = 600) -> list:
    """Run `chip_smoke.<entry>(root)` as `world` ranks on card 0 (gloo,
    a file:// rendezvous under root); their results (root/<entry>
    .rank<r>.json). Raises with a rank's stderr if one fails; kills
    every rank on a timeout."""
    rdv = os.path.join(root, f"{entry}.rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for rank in range(world):
        env = dict(os.environ, WEDETECT_DIST="1", RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK="0",
                   WEDETECT_DIST_INIT=f"file://{rdv}", GLOO_SOCKET_IFNAME="lo",
                   PYTHONPATH=here)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as C; C.DIST_DEV = {DIST_DEV!r}; "
             f"C.{entry}({root!r})"],
            env=env, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            print(err[-6000:], file=sys.stderr)
            raise AssertionError(f"{entry}: rank {rank} exited "
                                 f"{p.returncode}")
    out = []
    for rank in range(world):
        with open(os.path.join(root, f"{entry}.rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def dist_join():
    """A rank's start: TF32 off, the gloo group joined (the join point's
    CPU route; gloo carries all_reduce and broadcast of CUDA tensors),
    then card 0 set for every rank."""
    from wedetect_tpu_torch.eval import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.maybe_initialize("cpu")
    if DIST_DEV == "cuda":
        torch.cuda.set_device(0)
    return dist.process_index()


def dist_det_args(batch: int, dtype: str):
    """cli/train's arguments at WeDetect-Base, 640x640, K = 80, global
    batch `batch`, lr DIST_LR, drop path DIST_DET_DROP_PATH; the config
    in `dtype` (the CLI's is bf16)."""
    import dataclasses as dc

    from wedetect_tpu_torch.cli import train as CLI

    args = CLI.parse_args(["--size", "base", "--batch-size", str(batch),
                           "--lr", str(DIST_LR), "--drop-path",
                           str(DIST_DET_DROP_PATH), "--device", DIST_DEV])
    return args, dc.replace(CLI.build_config(args), compute_dtype=dtype)


def sharded(mesh) -> bool:
    return mesh is not None and mesh.shape["fsdp"] > 1


def dist_det_state(args, cfg, sd, mesh):
    """The CLI's train state on the saved weights over `mesh` (None: one
    process), and its batches: each rank builds only its rows. With an
    fsdp axis the model is built on the host, as cli/train.py builds it,
    and only this rank's slices reach the card."""
    from wedetect_tpu_torch.cli import train as CLI
    from wedetect_tpu_torch.models.wedetect import WeDetectModule
    from wedetect_tpu_torch.train.loop import (TrainLoopCfg,
                                               make_batch_iterator)
    from wedetect_tpu_torch.train.train_step import TrainState, det_optimizer

    model = WeDetectModule(cfg).to("cpu" if sharded(mesh) else DIST_DEV)
    model.load_state_dict(sd)
    tx = det_optimizer(model, base_lr=args.lr,
                       weight_decay=args.weight_decay,
                       total_batch_size=args.batch_size)
    state = TrainState.create(model, tx, mesh,
                              device=DIST_DEV if sharded(mesh) else None)
    sample_fn = CLI.make_sample_fn(
        args, cfg, lambda rng: det_raw_sample(rng, cfg.img_size[0],
                                              args.num_classes),
        [[f"class {i}"] for i in range(args.num_classes)])
    batches = make_batch_iterator(
        cfg, TrainLoopCfg(batch_size=args.batch_size), sample_fn,
        CLI.random_text_bank(cfg.embed_dims), seed=1, mesh=mesh)
    return state, batches


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms (no atomic weight gradients)."""
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved


@contextlib.contextmanager
def data_parallel_bn_formula():
    """Every train-mode BatchNorm through the data-parallel formula
    (`BatchNorm2d._global_forward`: gathered count, mean and variance
    combined by Chan's rule) on a group of one rank, in place of cuDNN's
    kernel: the same statistics, other rounding."""
    from wedetect_tpu_torch.nn.layers import BatchNorm2d
    from wedetect_tpu_torch.parallel.collectives import (CollectiveStats,
                                                         Group)

    one = Group(None, [0], 0, CollectiveStats())
    stock = BatchNorm2d.forward

    def forward(self, x):
        if not self.training:
            return stock(self, x)
        self.group = one
        try:
            return self._global_forward(x)
        finally:
            self.group = None

    BatchNorm2d.forward = forward
    try:
        yield
    finally:
        BatchNorm2d.forward = stock


def dist_det_steps(sd, kind: str, mesh, steps: int = 2,
                   local_bn: bool = False) -> dict:
    """f32 steps of the dist_det cell `kind` (global batch
    DIST_DET_BATCH[kind]) over `mesh`, cuDNN deterministic: metrics, and
    after the first step the summed gradients, BN statistics and this
    rank's moments; after the last the parameters (card tensors; the
    sharded gradients and parameters gathered to their full shapes)."""
    from wedetect_tpu_torch.nn.layers import BatchNorm2d
    from wedetect_tpu_torch.parallel.fsdp import full_state_dict, gather_full
    from wedetect_tpu_torch.train.train_step import train_step

    args, cfg = dist_det_args(DIST_DET_BATCH[kind], "float32")
    state, batches = dist_det_state(args, cfg, sd, mesh)
    storage = (zero3_storage(state.model, sd, mesh) if sharded(mesh)
               else None)
    if local_bn:
        for m in state.model.modules():
            if isinstance(m, BatchNorm2d):
                m.group = None
    out = {"metrics": []}
    det_launches(reset=True)
    for step in range(steps):
        with cudnn_deterministic():
            state, m = train_step(cfg, state, next(batches))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if step == 0:
            named = list(state.model.named_parameters())
            grads = [p.grad.detach() for _, p in named]
            if sharded(mesh):
                grads = [g.to(DIST_DEV) for g in gather_full(
                    mesh, grads, state.tx.specs, state.tx.shapes)]
            out["grads"] = {n: g.clone() for (n, _), g in zip(named, grads)}
            out["stats"] = {n: t.clone() for n, t in
                            state.model.state_dict().items()
                            if n.endswith(("running_mean", "running_var"))}
            out["mu"] = [t.clone() for t in state.tx.mu]
            out["nu"] = [t.clone() for t in state.tx.nu]
    out["launches"] = det_launches()
    full = full_state_dict(state.model)
    out["params"] = {n: full[n].to(DIST_DEV, copy=True)
                     for n, _ in state.model.named_parameters()}
    out["specs"] = list(state.tx.specs)
    out["names"] = [n for n, _ in state.model.named_parameters()]
    out["bn"] = [f"{mn}.{pn}" for mn, m in state.model.named_modules()
                 if isinstance(m, BatchNorm2d) for pn in ("weight", "bias")]
    out["storage"] = storage
    return out


def det_group(name: str) -> str:
    return name.split(".")[0]          # backbone, neck, bbox_head


def rel_l2_by_group(got: dict, want: dict) -> dict:
    """Relative L2 error of each parameter group (det_group) and of the
    whole: ||got - want|| / ||want|| over the group's tensors."""
    num, den = {}, {}
    for n, w in want.items():
        for grp in (det_group(n), "all"):
            num[grp] = num.get(grp, 0.0) + float(
                (got[n].double() - w.double()).square().sum())
            den[grp] = den.get(grp, 0.0) + float(w.double().square().sum())
    return {g: math.sqrt(num[g] / max(den[g], 1e-300)) for g in num}


def rel_l2(got, want) -> float:
    return math.sqrt(float((got.double() - want.double()).square().sum())
                     / max(float(want.double().square().sum()), 1e-300))


def dist_det_check(got: dict, want: dict, init: dict, fidx: int,
                   fsdp: int) -> dict:
    """The rank's run `got` against the one-process run `want` (card
    tensors; `init`: the weights both started from) by the rules above
    DIST_TOL."""
    from wedetect_tpu_torch.parallel.collectives import fsdp_slice

    keys = ("loss", "loss_cls", "loss_bbox", "loss_dfl", "grad_norm")
    rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in keys}
           for g, w in zip(got["metrics"], want["metrics"])]
    names = want["names"]
    mom, bitwise = {}, got["metrics"] == want["metrics"]
    for kind in ("mu", "nu"):
        ws = {n: fsdp_slice(want[kind][i], got["specs"][i], fidx, fsdp)
              for i, n in enumerate(names)}
        gs = {n: got[kind][i] for i, n in enumerate(names)}
        mom[kind] = rel_l2_by_group(gs, ws)
        bitwise &= all(torch.equal(gs[n], ws[n]) for n in names)
    stats = max(float((got["stats"][n] - w).abs().max())
                / (DET_STATS_TOL * max(1.0, float(w.abs().max())))
                for n, w in want["stats"].items())
    loose = total = 0
    for n in names:
        bitwise &= bool(torch.equal(got["params"][n], want["params"][n])
                        and torch.equal(got["grads"][n], want["grads"][n]))
        err = (got["params"][n] - want["params"][n]).abs()
        loose += int((err > 1e-6 + 1e-5 * want["params"][n].abs()).sum())
        total += err.numel()
    tensor_rel = {n: rel_l2(got["grads"][n], want["grads"][n])
                  for n in names}
    worst = max(names, key=tensor_rel.get)
    return {"metric_rel_err": rel,
            "num_pos": [[g["num_pos"], w["num_pos"]] for g, w in
                        zip(got["metrics"], want["metrics"])],
            "grad_rel_l2": rel_l2_by_group(got["grads"], want["grads"]),
            "mu_rel_l2": mom["mu"], "nu_rel_l2": mom["nu"],
            "bn_grad_rel_l2": max(tensor_rel[n] for n in want["bn"]),
            "worst_grad_tensor": [worst, tensor_rel[worst]],
            "stats_over_limit": stats,
            "move_rel_l2": rel_l2_by_group(
                {n: got["params"][n] - init[n] for n in names},
                {n: want["params"][n] - init[n] for n in names}),
            "loose_share": loose / total, "bitwise": bitwise}


def dist_det_ok(e: dict, kind: str) -> bool:
    """The rules above DIST_TOL: fsdp = 2 bitwise; data = 2 within the
    constant limits."""
    if kind == "fsdp":
        return e["bitwise"]
    return (all(max(r.values()) <= tol for r, tol in
                zip(e["metric_rel_err"], (DIST_TOL, DIST_DET_STEP2_TOL)))
            and all(g == w for g, w in e["num_pos"])
            and all(e[k][g] <= DIST_DET_TOL for g in e["grad_rel_l2"]
                    for k in ("grad_rel_l2", "mu_rel_l2", "nu_rel_l2"))
            and e["bn_grad_rel_l2"] <= DIST_DET_BN_TOL
            and e["stats_over_limit"] <= 1
            and max(e["move_rel_l2"].values()) <= DIST_DET_MOVE_TOL)


def zero3_storage(model, sd, mesh) -> dict:
    """This rank's stored parameters against the one-process weights
    `sd`: each exactly its fsdp_spec slice (`exact_slices`), none of the
    sharded ones whole, and the bytes stored (`param_bytes`) against the
    slices' sum (`want_bytes`) and the whole model's (`model_bytes`)."""
    from wedetect_tpu_torch.parallel.collectives import fsdp_slice
    from wedetect_tpu_torch.parallel.fsdp import param_bytes
    from wedetect_tpu_torch.parallel.mesh import fsdp_spec

    size, index = mesh.shape["fsdp"], mesh.fsdp_index
    exact, want, total, whole = True, 0, 0, 0
    for n, p in model.named_parameters():
        w = sd[n]
        d = fsdp_spec(tuple(w.shape), size)
        sl = fsdp_slice(w, d, index, size)
        exact &= bool(torch.equal(p.detach(), sl.to(p.device)))
        whole += int(d is not None and tuple(p.shape) == tuple(w.shape))
        want += sl.numel() * sl.element_size()
        total += w.numel() * w.element_size()
    return {"exact_slices": exact, "sharded_stored_whole": whole,
            "param_bytes": param_bytes(model), "want_bytes": want,
            "model_bytes": total}


def zero3_ok(st: dict) -> bool:
    return (st["exact_slices"] and st["sharded_stored_whole"] == 0
            and st["param_bytes"]["stored"] == st["want_bytes"])


def zero3_cost(model) -> dict:
    """The parameter bytes this rank stores, and its unit gathers since
    the last reset (count, MB, ms: device time when the mesh's stats are
    timed), from parallel/fsdp.Zero3.stats."""
    from wedetect_tpu_torch.parallel.fsdp import param_bytes

    z = getattr(model, "zero3", None)
    out = {"param_bytes": param_bytes(model)}
    if z is not None:
        out.update(units=len(z.units), gathers=z.stats.calls,
                   gather_mb=z.stats.bytes / 1e6,
                   gather_ms=1e3 * z.stats.seconds)
    return out


def dist_det_time(sd, kind: str, mesh, steps: int = 3) -> dict:
    """`steps` bf16 steps (the CLI's dtype) of the cell `kind` over
    `mesh`, its collectives timed (each synchronised): ms a step and
    collective ms a step (steps 2-3), the unit gathers a step and the
    parameter bytes stored (zero3_cost), the peak GB of this process in
    set-up and in the steps."""
    from wedetect_tpu_torch.train.train_step import train_step

    args, cfg = dist_det_args(DIST_DET_BATCH[kind], "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, batches = dist_det_state(args, cfg, sd, mesh)
    setup_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    stats = mesh.stats if mesh is not None else None
    if stats is not None:
        stats.timed = True
    z = getattr(state.model, "zero3", None)
    step_ms, coll_ms, gathers = [], [], []
    for _ in range(steps):
        batch = next(batches)
        if stats is not None:
            stats.reset()
        if z is not None:
            z.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train_step(cfg, state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        coll_ms.append(1e3 * stats.seconds if stats is not None else 0.0)
        gathers.append(zero3_cost(state.model))
    res = {"step_ms": step_ms, "ms_per_step": float(np.mean(step_ms[1:])),
           "collective_ms": coll_ms,
           "collective_ms_per_step": float(np.mean(coll_ms[1:])),
           "collective_calls_per_step": stats.calls if stats else 0,
           "collective_mb_per_step": stats.bytes / 1e6 if stats else 0.0,
           "zero3_per_step": gathers[-1],
           "setup_peak_gb": setup_gb,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if stats is not None:
        stats.timed = False
    del state, batches
    torch.cuda.empty_cache()
    return res


def dist_det_worker(root: str) -> None:
    """A dist_det rank: data parallel (data = 2, B = 16) and its per-rank
    BatchNorm control, fsdp = 2 (B = 8), each held to the one-process
    run in root; then the bf16 timing of both."""
    rank = dist_join()
    from wedetect_tpu_torch.parallel.mesh import make_mesh

    dp, fsdp = make_mesh(data=2), make_mesh(data=1, fsdp=2)
    sd = torch.load(os.path.join(root, "det_init.pt"), map_location=DIST_DEV)
    res = {"rank": rank}
    for kind, mesh in (("dp", dp), ("fsdp", fsdp)):
        want = torch.load(os.path.join(root, f"det_{kind}_want.pt"),
                          map_location=DIST_DEV)
        got = dist_det_steps(sd, kind, mesh)
        res[kind] = {"errors": dist_det_check(got, want, sd,
                                              mesh.fsdp_index,
                                              mesh.shape["fsdp"]),
                     "metrics": got["metrics"],
                     "launches": got["launches"],
                     "sharded_tensors": sum(d is not None
                                            for d in got["specs"]),
                     "storage": got["storage"]}
        del got
        if kind == "dp":
            ctrl = dist_det_steps(sd, kind, mesh, local_bn=True)
            res["dp_local_bn"] = {"errors": dist_det_check(
                ctrl, want, sd, 0, 1)}
            del ctrl
        del want
        torch.cuda.empty_cache()
    for kind, mesh in (("dp", dp), ("fsdp", fsdp)):
        res[f"time_{kind}"] = dist_det_time(sd, kind, mesh)
    with open(os.path.join(root, f"dist_det_worker.rank{rank}.json"),
              "w") as f:
        json.dump(res, f)


def phase_dist_det(dev, one_process: dict = None):
    """Detector training over two ranks on the one card: WeDetect-Base,
    640x640, K = 80, f32, data = 2 (B = 16) and fsdp = 2 (B = 8) against
    the one-process step on the same weights and global batch; the
    per-rank BatchNorm control; bf16 timing (`one_process`: det_train's
    one-process result of this run, B = 16)."""
    from wedetect_tpu_torch.models.wedetect import init_variables

    root = dist_root()
    t0 = time.perf_counter()
    _, cfg = dist_det_args(16, "float32")
    sd = {k: v for k, v in init_variables(cfg, seed=0, device=dev)
          .state_dict().items()}
    torch.save(sd, os.path.join(root, "det_init.pt"))
    for kind in ("dp", "fsdp"):
        want = dist_det_steps(sd, kind, None)
        torch.save(want, os.path.join(root, f"det_{kind}_want.pt"))
        if kind == "dp":
            # the rounding floor: one process, BatchNorm through the
            # data-parallel formula
            with data_parallel_bn_formula():
                formula = dist_det_steps(sd, kind, None)
            floor = dist_det_check(formula, want, sd, 0, 1)
            del formula
        del want
        torch.cuda.empty_cache()
    del sd
    torch.cuda.empty_cache()
    ranks = spawn_ranks("dist_det_worker", root)
    res = {"ranks": ranks, "seconds": time.perf_counter() - t0,
           "bn_formula_floor": floor,
           "tolerance": {"metrics": DIST_TOL,
                         "step2_metrics": DIST_DET_STEP2_TOL,
                         "groups": DIST_DET_TOL,
                         "bn_tensor": DIST_DET_BN_TOL,
                         "move": DIST_DET_MOVE_TOL, "stats": DET_STATS_TOL,
                         "fsdp": "bitwise"},
           "one_process_bf16_ms_per_step": (one_process or {}).get(
               "ms_per_step"),
           "one_process_bf16_peak_gb": (one_process or {}).get(
               "peak_mem_gb")}
    ok = dist_det_ok(floor, "dp") and all(dist_det_ok(r[k]["errors"], k)
                    for r in ranks for k in ("dp", "fsdp"))
    ok = ok and all(r["dp_local_bn"]["errors"]["stats_over_limit"] > 1
                    and not dist_det_ok(r["dp_local_bn"]["errors"], "dp")
                    for r in ranks)
    ok = ok and all(not any(r[k]["launches"].values()) for r in ranks
                    for k in ("dp", "fsdp"))
    ok = ok and all(r["fsdp"]["sharded_tensors"] > 0
                    and zero3_ok(r["fsdp"]["storage"])
                    and r["time_fsdp"]["zero3_per_step"]["gathers"]
                    == 2 * r["time_fsdp"]["zero3_per_step"]["units"]
                    for r in ranks)
    for r in ranks:
        t = r["time_fsdp"]
        z = t["zero3_per_step"]
        print(f"dist_det rank {r['rank']} fsdp = 2: "
              f"{z['param_bytes']['stored'] / 1e9:.3f} GB of parameters "
              f"stored ({r['fsdp']['storage']['model_bytes'] / 1e9:.3f} "
              f"whole), {z['gathers']} unit gathers a step "
              f"({z['gather_mb']:.1f} MB, {z['gather_ms']:.1f} ms), "
              f"peak {t['setup_peak_gb']:.2f} GB set-up, "
              f"{t['peak_mem_gb']:.2f} GB step", flush=True)
    emit({"phase": "dist_det", **res})
    if not ok:
        raise AssertionError("dist_det: a rank's step missed the "
                             "one-process step, the BatchNorm-formula floor "
                             "passed the limits, the control did not miss, "
                             "or a fsdp rank stored more than its slices")
    return res


def dist_ref_cfg(full_depth: bool = False):
    """ref_2b's widths at DIST_REF_DEPTH, or ref_2b whole."""
    import dataclasses as dc

    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    cfg = ref_2b()
    if full_depth:
        return cfg
    return dc.replace(
        cfg, text=dc.replace(cfg.text, layers=DIST_REF_DEPTH["layers"]),
        vision=dc.replace(cfg.vision, depth=DIST_REF_DEPTH["vit"],
                          deepstack_idx=DIST_REF_DEPTH["deepstack"]))


def bit_checksum(tensors, specs=None, mesh=None) -> int:
    """An exact checksum of f32 tensors: the sum of their bit patterns
    as integers. With `specs` and `mesh` the tensors are this rank's
    fsdp slices (a None spec: whole): the slices' sums are added over
    the fsdp group and the whole tensors counted once, so a sharded model
    gives the one-process model's checksum."""
    part = [0, 0]                       # sharded, whole
    for i, t in enumerate(tensors):
        v = int(t.detach().float().contiguous().view(torch.int32)
                .to(torch.int64).sum())
        part[specs is None or specs[i] is None] += v
    if mesh is not None and specs is not None:
        buf = torch.tensor([part[0]], dtype=torch.int64)
        mesh.fsdp_group.all_reduce(buf)
        part[0] = int(buf[0])
    return part[0] + part[1]


def dist_ref_step(root: str, mesh, tag: str, full_depth: bool = False,
                  keep: bool = True) -> dict:
    """One stage-3 ref_sft_step of ref_2b (cut to DIST_REF_DEPTH unless
    `full_depth`; f32, the CLI's defaults, lr TRAIN_LR) over `mesh` on
    the seeded sample, then a second step for its time: the first step's
    loss, grad_norm, launches and ms, the exact checksums (bit_checksum)
    of the parameters before it and of the parameters and moments after
    it, the peak GB in set-up and in the steps, the parameter bytes
    stored and the unit gathers of the timed step (zero3_cost); and, with
    `keep`, host copies of the tensors after the first step (parameters,
    this rank's moments: slices where sharded). Over a mesh with an fsdp
    axis the model is initialised sharded (`init_ref_variables(mesh=)`:
    each tensor drawn whole on the card, in the one-process order, then
    sliced)."""
    from wedetect_tpu_torch.cli.train_ref import build_step_inputs
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.train.ref_sft import ref_optimizer, ref_sft_step
    from wedetect_tpu_torch.train.train_step import TrainState

    cfg = dist_ref_cfg(full_depth)
    inp = np.load(os.path.join(root, "ref_inputs.npz"))
    sub = os.path.join(root, tag)
    os.makedirs(sub, exist_ok=True)
    ds = ref_sft_dataset(cfg, inp["image"], inp["proposals"], 1024,
                         root=sub)
    b = build_step_inputs(cfg, ds.sample(0), 3, (1024, 2048, 4096), 100,
                          151643)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=DIST_DEV,
                               mesh=mesh if sharded(mesh) else None)
    tx = ref_optimizer(model, base_lr=TRAIN_LR)
    state = TrainState.create(model, tx, mesh)
    specs = tx.specs if sharded(mesh) else None
    on = mesh if sharded(mesh) else None
    checksum = bit_checksum(tx.params, specs, on)
    out = {"setup_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    gh, gw = b["grid"]
    args = (b["patches"], b["input_ids"], b["attn_mask"], b["position_ids"],
            b["visual_start"], b["boxes"], b["ori_wh"], b["object_positions"],
            b["soft_labels"], b["valid"])
    launch_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = ref_sft_step(cfg, gh, gw, state, *args)
    out.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
    torch.cuda.synchronize()
    out["first_step_ms"] = 1e3 * (time.perf_counter() - t0)
    out["launches"] = launch_counts()
    out["init_checksum"] = checksum
    out["sharded_tensors"] = sum(d is not None for d in tx.specs)
    out["checksums"] = {k: bit_checksum(v, specs, on) for k, v in (
        ("params", tx.params), ("mu", tx.mu), ("nu", tx.nu))}
    tensors = None
    if keep:
        tensors = {"mults": list(tx.mults), "specs": list(tx.specs),
                   "params": {n: p.detach().cpu()
                              for n, p in model.named_parameters()},
                   "mu": [t.cpu() for t in tx.mu],
                   "nu": [t.cpu() for t in tx.nu]}
    stats = mesh.stats if mesh is not None else None
    if stats is not None:
        stats.reset()
        stats.timed = True
    z = getattr(model, "zero3", None)
    if z is not None:
        z.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = ref_sft_step(cfg, gh, gw, state, *args)
    float(m["loss"])
    torch.cuda.synchronize()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0)
    out["collective_ms_per_step"] = (1e3 * stats.seconds if stats else 0.0)
    out["collective_calls_per_step"] = stats.calls if stats else 0
    out["zero3_per_step"] = zero3_cost(model)
    if z is not None:
        out["unit_gathers"] = z.gathers()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seq_len"] = int(b["input_ids"].shape[1])
    out["vit_tokens"] = int(gh * gw)
    out["depth"] = {"layers": cfg.text.layers, "vit": cfg.vision.depth}
    del state, model, tx
    return out, tensors


def dist_ref_worker(root: str) -> None:
    """A dist_ref rank (fsdp = 2, the parameters sharded): its step held
    to the one-process step in root (at the cut, tensor by tensor on
    this rank's slices; at full depth by the exact checksums)."""
    rank = dist_join()
    from wedetect_tpu_torch.parallel.collectives import fsdp_slice
    from wedetect_tpu_torch.parallel.mesh import make_mesh

    with open(os.path.join(root, "dist_ref_job.json")) as f:
        full_depth = json.load(f)["full_depth"]
    mesh = make_mesh(data=1, fsdp=2)
    out, got = dist_ref_step(root, mesh, f"rank{rank}", full_depth,
                             keep=not full_depth)
    torch.cuda.empty_cache()
    if got is not None:
        want = torch.load(os.path.join(root, "ref_want.pt"),
                          map_location="cpu", mmap=True)
        param_ok, mom, bitwise = True, 0.0, True
        for i, (n, p) in enumerate(got["params"].items()):
            d = got["specs"][i]
            w = fsdp_slice(want["params"][n], d, mesh.fsdp_index, 2)
            param_ok &= param_close(p, w, got["mults"][i])
            bitwise &= bool(torch.equal(p, w))
            for kind in ("mu", "nu"):
                ws = fsdp_slice(want[kind][i], d, mesh.fsdp_index, 2)
                x = got[kind][i]
                err = float((x - ws).abs().max())
                mom = max(mom, err / (TRAIN_RANK_TOL * float(ws.abs().max())
                                      + 1e-30))
                bitwise &= bool(torch.equal(x, ws))
        out.update(params_ok=bool(param_ok), moments_over_limit=mom,
                   bitwise=bitwise)
    out["rank"] = rank
    with open(os.path.join(root, f"dist_ref_worker.rank{rank}.json"),
              "w") as f:
        json.dump(out, f)


# dist_ref: a rank's loss and grad_norm against the one-process step
# (relative), and its moments' slices (of each tensor's largest entry):
# every rank computes the whole gradient on the same sample with the
# same kernels, so only a nondeterministic reduction could part them
TRAIN_RANK_TOL = 1e-5


def phase_dist_ref(dev, image, proposals, full_depth: bool = False):
    """One stage-3 step of ref_2b's widths cut to DIST_REF_DEPTH (or
    whole, `full_depth`) over fsdp = 2 with the parameters sharded (two
    gloo ranks on the one card), against one process: loss, grad_norm,
    the parameters after the step (TRAIN_PARAM_RULE on each rank's
    slices, and exact checksums of the parameters and moments), each
    rank's mu and nu slices (at the cut); K2, K3, K2-bwd and K3-bwd
    launches per rank; ms a step, the parameter bytes each rank stores,
    its unit gathers (count, MB, ms) a step and its set-up and step peak
    GB. At full depth the one-process tensors are not written out: the
    checksums hold the ranks to it."""
    root = dist_root()
    t0 = time.perf_counter()
    np.savez(os.path.join(root, "ref_inputs.npz"), image=image,
             proposals=np.asarray(proposals))
    with open(os.path.join(root, "dist_ref_job.json"), "w") as f:
        json.dump({"full_depth": full_depth}, f)
    one, tensors = dist_ref_step(root, None, "one", full_depth,
                                 keep=not full_depth)
    if tensors is not None:
        torch.save({"params": tensors["params"], "mu": tensors["mu"],
                    "nu": tensors["nu"]}, os.path.join(root, "ref_want.pt"))
    del tensors
    torch.cuda.empty_cache()
    ranks = spawn_ranks("dist_ref_worker", root,
                        timeout=1200 if full_depth else 600)
    cfg = dist_ref_cfg(full_depth)
    per_step = expected_counts(
        k2=cfg.text.layers, k3=cfg.vision.depth, k2_f32=cfg.text.layers,
        k3_f32=cfg.vision.depth, k2_bwd=cfg.text.layers,
        k3_bwd=cfg.vision.depth, k2_bwd_dkdv_f32=cfg.text.layers,
        k2_bwd_dq_f32=cfg.text.layers, k3_bwd_dkv_f32=cfg.vision.depth,
        k3_bwd_dq_f32=cfg.vision.depth)
    res = {"one_process": one, "ranks": ranks, "full_depth": full_depth,
           "seconds": time.perf_counter() - t0,
           "depth": {"layers": cfg.text.layers, "vit": cfg.vision.depth},
           "tolerance": {"loss_grad_norm_rel": TRAIN_RANK_TOL,
                         "moments": TRAIN_RANK_TOL,
                         "params": "TRAIN_PARAM_RULE",
                         "checksums": "exact"}}
    ok = all(abs(r[k] - one[k]) <= TRAIN_RANK_TOL * abs(one[k])
             for r in ranks for k in ("loss", "grad_norm"))
    ok = ok and all(r["init_checksum"] == one["init_checksum"]
                    and r["checksums"] == one["checksums"]
                    and r["launches"] == per_step
                    and r["sharded_tensors"] > 0 for r in ranks)
    if not full_depth:
        ok = ok and all(r["params_ok"] and r["moments_over_limit"] <= 1
                        for r in ranks)
    ok = ok and one["launches"] == per_step
    for r in ranks:
        z = r["zero3_per_step"]
        print(f"dist_ref{' full depth' if full_depth else ''} rank "
              f"{r['rank']}: {z['param_bytes']['stored'] / 1e9:.3f} GB of "
              f"parameters stored ({z['param_bytes']['sharded'] / 1e9:.3f} "
              f"GB slices), {z['gathers']} unit gathers a step "
              f"({z['gather_mb']:.1f} MB, {z['gather_ms']:.1f} ms), "
              f"{r['ms_per_step']:.1f} ms a step, peak "
              f"{r['setup_peak_gb']:.2f} GB set-up, {r['peak_mem_gb']:.2f} "
              f"GB step (one process {one['peak_mem_gb']:.2f})", flush=True)
    emit({"phase": "dist_ref_full" if full_depth else "dist_ref", **res})
    if not ok:
        raise AssertionError("dist_ref: a rank's step missed the "
                             "one-process step")
    return res


NCCL_CHECK = r"""
import json, sys, torch
import torch.distributed as dist
from wedetect_tpu_torch.parallel.collectives import (CollectiveStats, Group,
                                                     fsdp_slice)
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=sys.argv[1], rank=0,
                        world_size=1)
g = Group(dist.group.WORLD, [0], 0, CollectiveStats())
x = torch.arange(12.0, device="cuda").view(3, 4)
y = g.all_reduce(x.clone())
full = torch.empty(3, 4, device="cuda")
g.gather_flat([full], [lambda v: fsdp_slice(v, 1, 0, 1).copy_(x)])
b = g.broadcast(x.clone(), 0)
dist.destroy_process_group()
print(json.dumps({"backend": "nccl",
                  "all_reduce_equal": bool(torch.equal(y, x)),
                  "gather_equal": bool(torch.equal(full, x)),
                  "broadcast_equal": bool(torch.equal(b, x)),
                  "calls": g.stats.calls}))
"""

REF_CLI_FULL = r"""
import json, sys, torch
from wedetect_tpu_torch.cli import _ref_load
from wedetect_tpu_torch.cli import train_ref as TCLI
_ref_load.load_ref = lambda ckpt, device: _ref_load.random_ref("2b", device)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.cuda.reset_peak_memory_stats()
TCLI.main(["--stage", "3", "--data", sys.argv[1], "--proposals", sys.argv[2],
           "--steps", "1", "--log-every", "1", "--device", "cuda"])
print(json.dumps({"peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
"""


def torchrun_env(port: int) -> dict:
    """torchrun's variables for a world of one on card 0."""
    here = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), PYTHONPATH=here)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_json(cmd, env, timeout: int = 600) -> tuple:
    """(the last stdout line's JSON or None, the process) of `cmd`."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(cmd, env=env, cwd=here, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr)
    return last, proc


def phase_dist_nccl(dev, image, proposals):
    """The NCCL route at world 1: cli/train.py (WeDetect-Base, B = 4, 2
    steps, a checkpoint) and cli/train_ref.py (ref_2b at full depth,
    random weights, stage 3, one f32 step: its peak GB) under torchrun's
    variables with WORLD_SIZE=1, through the mesh code; one all_reduce,
    one gather and one broadcast of the collectives module on a one-rank
    NCCL group."""
    import cv2

    root = os.path.join(dist_root(), "nccl")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    from pathlib import Path

    _, coco = write_eval_dataset(Path(root), 6, 20, 80)
    ckpt = os.path.join(root, "det_ckpt")
    det_cmd = [sys.executable, "-m", "wedetect_tpu_torch.cli.train",
               "--ann", coco, "--img-root", root, "--size", "base",
               "--steps", "2", "--batch-size", "4", "--ckpt-dir", ckpt,
               "--ckpt-every", "2", "--device", "cuda"]
    _, det = run_json(det_cmd, torchrun_env(free_port()))
    det_state = None
    if det.returncode == 0:
        tree = torch.load(os.path.join(ckpt, "step_2", "train_state.pt"),
                          map_location="cpu", weights_only=True)
        det_state = {"step": tree["step"],
                     "count": tree["opt_state"]["count"],
                     "finite": all(bool(torch.isfinite(v).all())
                                   for v in tree["model"].values()
                                   if v.is_floating_point())}
        del tree
    img = os.path.join(root, "ref_image.png")
    cv2.imwrite(img, cv2.cvtColor(np.asarray(image), cv2.COLOR_RGB2BGR))
    data, props = (os.path.join(root, n) for n in ("stage3.json",
                                                   "props.json"))
    with open(data, "w") as f:
        json.dump([{"image": img, "class_name": REF_QUERIES[0],
                    "bounding_boxes": TRAIN_GT}], f)
    with open(props, "w") as f:
        json.dump({img: np.asarray(proposals).tolist()}, f)
    ref_out, ref = run_json([sys.executable, "-c", REF_CLI_FULL, data,
                             props], torchrun_env(free_port()))
    rdv = os.path.join(root, "nccl.rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    nccl_out, nccl = run_json([sys.executable, "-c", NCCL_CHECK,
                               f"file://{rdv}"], torchrun_env(free_port()))
    res = {"det_cli": {"rc": det.returncode, "checkpoint": det_state},
           "ref_cli": {"rc": ref.returncode, **(ref_out or {})},
           "nccl": {"rc": nccl.returncode, **(nccl_out or {})},
           "seconds": time.perf_counter() - t0}
    ok = (det.returncode == 0 and det_state["step"] == 2
          and det_state["count"] == 2 and det_state["finite"]
          and ref.returncode == 0 and ref_out is not None
          and nccl.returncode == 0 and nccl_out is not None
          and nccl_out["all_reduce_equal"] and nccl_out["gather_equal"]
          and nccl_out["broadcast_equal"] and nccl_out["calls"] == 3)
    emit({"phase": "dist_nccl", **res})
    if not ok:
        raise AssertionError("dist_nccl: a CLI or the NCCL collectives "
                             "failed at world 1")
    return res


# ------------------------------------------------ tensor-parallel serving
# tp_serve: ref_2b at full width held by TP_RANKS gloo ranks on card 0
# (parallel/mesh.make_tp_mesh; nccl refuses two ranks on one GPU), each
# rank holding its slices of the serve phase's seeded weights
# (init_ref_variables(mesh=)), against one process on the same weights,
# f32 with TF32 off. A rank's gloo collectives carry CUDA tensors through
# the host, ~1.8 ms a call on an NVIDIA H100 80GB HBM3 at 700 W (58
# calls a decode token at full depth), so its times are a floor on what
# the collectives cost, not a multi-card speed; and the phase runs at
# dist_ref's depth (DIST_REF_DEPTH: 8 of 28 decoder layers, 8 of 24 ViT
# blocks), where a full-depth GenServer run took 46 s a mode on that
# card. phase_tp_serve(full_depth=True) runs ref_2b whole.
TP_RANKS = 2
# a rank's f32 score logits against the one-process call: the limit the
# Ref path's kernels are held to (REF_LOGIT_TOL["float32"]); summing a
# row-parallel product over two ranks only reorders f32 additions
TP_LOGIT_TOL = 1e-4
TP_GEN_TOKENS = 64
TP_TIMED_TOKENS = 16      # decode tokens counted with every collective
#                           synchronised (CollectiveStats.timed)
TP_SERVE_CELL = dict(slots=8, chunk=16, p=384, g=64, n_req=16)
# "bits": the rank's int8 / int4 decode tree (quantize_decode_params of
# the rank's model) against the one-process model's
TP_SERVE_MODES = {"greedy": {},
                  "warped": dict(temperature=0.8, top_k=30, top_p=0.9),
                  "kv8": dict(kv_bits=8), "piggyback": dict(piggyback=True),
                  "int8": dict(bits=8), "int4": dict(bits=4),
                  "int8_kv8": dict(bits=8, kv_bits=8)}
# ref_generate_spec (TP_GEN_TOKENS greedy tokens, prompt lookup) per rank
TP_SPEC_MODES = {"plain": {}, "int8": dict(bits=8)}


# the int8 prefill under TP: every int8 product is the one-process one
# bitwise (tp_int8_ops, at the path's row-parallel shapes), but the
# mergers' float fc2 sums its row-parallel halves in f32 (parallel/
# mesh.py) and the f32 kernels pick their tile by head count, either of
# which can move an int8 code downstream, and random ref_2b weights
# amplify a moved code (on an H100 as far from one process as int8 is
# from float). So the served call is held as an approximation of the float
# call: its distance to one process's float logits within
# TP_INT8_FLOAT_RATIO x the one-process int8 call's; and the call with
# that fc2 computed whole and the f32 kernels' tiles pinned to one
# process's (int8_whole_merger_logits) is held bitwise
TP_INT8_FLOAT_RATIO = 2.0
# (rows, K, N) of the row-parallel int8 products of a score call: the
# ViT's proj and fc2 (1280 tokens), the decoder's o_proj and down_proj
# (the prefix's 384 rows)
TP_INT8_OPS = {"vit_proj": (1280, 1024, 1024), "vit_fc2": (1280, 4096, 1024),
               "o_proj": (384, 2048, 2048), "down_proj": (384, 6144, 2048)}


def tp_int8_ops(mesh, dev) -> dict:
    """ops/int8.quant_linear(group=) on this rank's K slice against the
    one-process call on the whole operands, at TP_INT8_OPS in f32 and
    bf16: bitwise (the same seeded operands on every rank)."""
    from wedetect_tpu_torch.ops.int8 import quant_linear
    from wedetect_tpu_torch.parallel.collectives import fsdp_slice

    t, n = mesh.tp_index, mesh.shape["tp"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, (m, k, nn_)) in enumerate(TP_INT8_OPS.items()):
            g = torch.Generator(device=dev).manual_seed(100 + i)
            x = torch.randn(m, k, generator=g, device=dev).to(dtype)
            w = (torch.randn(nn_, k, generator=g, device=dev)
                 * k ** -0.5).to(dtype)
            bias = torch.randn(nn_, generator=g, device=dev).to(dtype)
            with torch.inference_mode():
                got = quant_linear(fsdp_slice(x, 1, t, n),
                                   fsdp_slice(w, 1, t, n), bias, mesh.tp)
                want = quant_linear(x, w, bias)
            out[f"{name}_{str(dtype)[6:]}"] = bool(torch.equal(got, want))
    return out


def whole_float_rows(lin, x, group):
    """parallel/mesh.row_linear with every float row-parallel layer (the
    mergers' fc2 under the int8 prefill) computed whole: its input and
    weight gathered exactly (gather_vocab), one product on each rank."""
    import torch.nn.functional as F

    from wedetect_tpu_torch.parallel import mesh as pm

    if group is None or getattr(lin, "quant", False):
        return pm.row_linear(lin, x, group)
    return F.linear(pm.gather_vocab(x.contiguous(), group),
                    pm.gather_vocab(lin.weight.contiguous(), group),
                    lin.bias)


def int8_whole_merger_logits(scorer, image, proposals, tp: int):
    """The scorer's logits with the model's float row-parallel layers
    computed whole (whole_float_rows) and the f32 kernels' tiles those of
    one process's head counts (a tp-way rank's heads times tp)."""
    from wedetect_tpu_torch.nn import qwen3vl
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    saved = qwen3vl.row_linear, fa.fwd_f32_tile, fg.fwd_f32_tile
    k3_tile, k2_tile = saved[1:]
    qwen3vl.row_linear = whole_float_rows
    fa.fwd_f32_tile = lambda b, l, h, sms: k3_tile(b, l, h * tp, sms)
    fg.fwd_f32_tile = lambda b, s, g, kvh, sms: k2_tile(b, s, g, kvh * tp,
                                                         sms)
    try:
        return scorer.logits(image, proposals, REF_QUERIES)
    finally:
        qwen3vl.row_linear, fa.fwd_f32_tile, fg.fwd_f32_tile = saved


def tp_mode_kw(kw: dict, trees: dict) -> dict:
    """A TP_SERVE_MODES / TP_SPEC_MODES entry as keyword arguments: its
    "bits" as the decode tree of that width from `trees`."""
    kw = dict(kw)
    bits = kw.pop("bits", None)
    if bits:
        kw["decode_params"] = trees[bits]
    return kw


def tree_code_bytes(tree: dict) -> int:
    """Bytes of a decode tree's quantized leaves (codes and scales of the
    layers' matmuls and the LM head; not the token table or the norms)."""
    from wedetect_tpu_torch.models.quant import quantized_bytes

    leaves = [v for layer in tree["text"].values() if isinstance(layer, dict)
              for v in layer.values() if isinstance(v, dict)]
    return quantized_bytes({str(i): v for i, v in
                            enumerate(leaves + [tree["lm_head"]])})


def spec_call(cfg, model, b, new_tokens, **kw):
    """ref_generate_spec of one prompt: (tokens, verify steps)."""
    from wedetect_tpu_torch.models.ref_speculative import ref_generate_spec

    toks, steps = ref_generate_spec(
        cfg, b["gh"], b["gw"], model, b["patches"], b["ids"][None],
        b["mask"][None], b["pos"][:, None], b["vs"],
        np.array([b["nxt"]], np.int32), b["boxes"], b["ori"], new_tokens,
        GEN_EOS, GEN_PAD, **kw)
    return trim(toks[0].cpu().numpy()), int(steps)


def tp_shapes(tp: int) -> dict:
    """K2's prefix and suffix and K3's ViT case at one rank's heads."""
    def k2(case):
        b, s, lk, h, kvh, d, causal, holes = case
        return (b, s, lk, h // tp, kvh // tp, d, causal, holes)

    b, l, h, d, n_real, causal = K3_VIT
    return {"k2_prefix": k2(K2_PREFIX), "k2_suffix": k2(K2_SUFFIX),
            "k3_vit": (b, l, h // tp, d, n_real, causal)}


def tp_rank_kernels(dev, tp: int = TP_RANKS) -> dict:
    """K2 and K3 at a rank's shapes (tp_shapes), f32 and bf16: each
    route's kernel launched once and held to its plain version (K_TOL, lse
    within 1e-3); device ms beside the plain version's, the bound and
    SDPA's."""
    from wedetect_tpu_torch.ops import flash_attention as fa
    from wedetect_tpu_torch.ops import flash_gqa as fg

    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for i, (name, case) in enumerate(tp_shapes(tp).items()):
            if name.startswith("k2"):
                b, s, lk, h, kvh, d, causal, holes = case
                q, k, v, valid = k2_case(dev, *case, dtype=dtype, seed=i)
                kw = dict(causal=True, kv_valid=valid)
                run = lambda **x: fg.gqa_flash_attention(  # noqa: E731
                    q, k, v, **kw, **x)
                plain = lambda **x: fg.gqa_flash_attention_plain(  # noqa
                    q, k, v, **kw, **x)
                route = fg.gqa_flash_fwd_sm90 if bf16 else \
                    fg.gqa_flash_fwd_f32
                pairs = k2_visible_pairs(s, lk, True, valid)
                mask = k2_mask(valid, s, lk)
                bound = attn_bound(h, d, pairs, q.numel() + 2 * k.numel(),
                                   q.numel(), b * s * h, dtype)
            else:
                b, l, h, d, n_real, causal = case
                q, k, v, seg = k3_case(dev, *case, dtype=dtype, seed=i)
                kw = dict(q_segment_ids=seg, kv_segment_ids=seg,
                          sm_scale=d ** -0.5)
                run = lambda **x: fa.flash_attention(  # noqa: E731
                    q, k, v, **kw, **x)
                plain = lambda **x: fa.flash_attention_plain(  # noqa
                    q, k, v, **kw, **x)
                route = fa.flash_attention_fwd_sm90 if bf16 else \
                    fa.flash_attention_fwd_f32
                pairs = b * (n_real * n_real + (l - n_real) ** 2)
                mask = (seg[:, :, None] == seg[:, None, :])[:, None]
                bound = attn_bound(h, d, pairs, 3 * q.numel(), q.numel(),
                                   b * l * h, dtype)
            route.launches = 0
            o, lse = run(return_lse=True)
            torch.cuda.synchronize()
            launched = route.launches
            po, plse = plain(return_lse=True)
            r = {"shape": list(case[:6]), "launches": launched,
                 "max_abs_err": float((o.float() - po.float()).abs().max()),
                 "lse_err": float((lse - plse).abs().max()), **bound,
                 "ms": graph_ms(run),
                 "plain_ms": cuda_ms(plain, iters=3, warmup=1),
                 "library_ms": graph_ms(lambda: sdpa_gqa(q, k, v, mask))}
            r["match"] = (launched == 1 and kernel_close(o, po, dtype)
                          and r["lse_err"] <= 1e-3)
            res[f"{name}_{str(dtype)[6:]}"] = r
            del q, k, v, o, lse, po, plse, mask
    return res


def gen_margins(model, b, toks, sampling=None, seed=0):
    """The margin of each of a request's tokens under the one-process
    model (teacher_logits), in logit units: greedy, the top-2 logit gap;
    sampled (the GenServer's (temperature, top_k, top_p) and the
    request's seed), the top-2 gap of the warped, Gumbel-perturbed
    logits, and where a token outside the top-k or top-p cut would beat
    the draw if let in (or the draw sits at the cut), the logit gap at
    that cut."""
    from wedetect_tpu_torch.ops import prng

    lg = teacher_logits(model, b["gh"], b["gw"], b["patches"], b["ids"],
                        b["mask"], b["pos"], b["nxt"], toks, b["boxes"],
                        b["ori"], b["vs"])
    with torch.inference_mode():
        if sampling is None:
            top = torch.topk(lg, 2).values
            return (top[:, 0] - top[:, 1]).cpu().numpy()
        t, top_k, top_p = sampling
        n = len(toks)
        keys = prng.fold_in(prng.PRNGKey(torch.full(
            (n,), seed, dtype=torch.int32, device=lg.device)),
            torch.arange(n, dtype=torch.int32, device=lg.device))
        raw = lg / t
        pert = raw + prng.gumbel(keys, raw.shape[-1:])
        cut = torch.topk(raw, top_k + 1).values
        lw = torch.where(raw < cut[:, top_k - 1:top_k], -torch.inf, raw)
        srt = torch.sort(lw, dim=-1, descending=True).values
        p = torch.softmax(srt, dim=-1)
        n_keep = ((torch.cumsum(p, -1) - p) < top_p).sum(-1, keepdim=True)
        last, first_out = srt.gather(1, n_keep - 1), srt.gather(1, n_keep)
        kept = raw >= last
        top = torch.topk(torch.where(kept, pert, -torch.inf), 2)
        win = top.indices[:, :1]
        at_win = pert.gather(1, win)
        threat = ((pert > at_win) & ~kept).any(-1)
        win_raw = raw.gather(1, win)[:, 0]
        inf = torch.full_like(win_raw, torch.inf)
        gap_k = torch.where(threat | (win_raw == cut[:, top_k - 1]),
                            t * (cut[:, top_k - 1] - cut[:, top_k]), inf)
        gap_p = torch.where(threat | (win_raw == last[:, 0]),
                            t * (last - first_out)[:, 0], inf)
        gaps = torch.stack([t * (top.values[:, 0] - top.values[:, 1]),
                            gap_k, gap_p.nan_to_num(torch.inf)])
        return gaps.amin(0).cpu().numpy()


def tree_margins(model, dp, b, toks):
    """The top-2 margin of each token of a greedy stream decoded from the
    tree `dp` (a quantized one): the first from the prefill's last state
    through dp's head, the rest teacher-forced through dp's layers and
    head from the prefill KV (block_logits; a full-precision cache where
    the stream ran kv_bits=8)."""
    from wedetect_tpu_torch.models import ref_generate as TG

    dev = model.device
    with torch.inference_mode():
        hidden, kvs = TG._prefill_hidden_kvs(
            model, b["gh"], b["gw"], b["patches"], b["ids"][None],
            b["mask"][None], b["pos"][:, None], b["boxes"], b["ori"],
            b["vs"], np.full((1, 1), -1, np.int32))
        lg = TG._lm_logits(dp, hidden[0, int(b["mask"].sum()) - 1][None])
    if len(toks) > 1:
        lg = torch.cat([lg, block_logits(
            model.cfg, dp, hidden, kvs, b["mask"],
            torch.tensor(b["nxt"], device=dev), toks[:-1])])
    top = torch.topk(lg, 2).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def tp_stream_check(model, b, got, want, sampling=None, seed=0,
                    dp=None) -> dict:
    """One stream of a rank against the one-process stream under the
    margin rule (the margins computed only where they part; `dp`: the
    one-process decode tree of a quantized stream)."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return {"ok": True, "agree": len(want), "margin": None}
    margins = (gen_margins(model, b, want, sampling, seed) if dp is None
               else tree_margins(model, dp, b, want))
    d = divergence(got, want, margins)
    return {"ok": d[0], "agree": d[1], "margin": d[2]}


def collective_cost(stats, fn) -> dict:
    """Calls, MB and ms of the collectives of fn(), each synchronised
    (device time)."""
    stats.reset()
    stats.timed = True
    try:
        fn()
    finally:
        stats.timed = False
    return {"calls": stats.calls, "mb": stats.bytes / 1e6,
            "ms": stats.seconds * 1e3}


def tp_cfg(full_depth: bool):
    from wedetect_tpu_torch.nn.qwen3vl import ref_2b

    return ref_2b() if full_depth else dist_ref_cfg()


def tp_timings(cfg, model, scorer, mesh, image, proposals, b, reqs,
               served=None, trees=None) -> dict:
    """A rank's times: a score call, the generation prefill and ms a
    token, GenServer tokens/s at the serve cell (greedy; `served`: the
    (tokens, wall ms) of a run already made), and the collectives'
    calls, MB and ms a score call and a decode token; with `trees`
    ({bits: decode tree}), ms a token decoding from each (over
    TP_TIMED_TOKENS tokens)."""
    from wedetect_tpu_torch.models import ref_generate as TG

    c = TP_SERVE_CELL
    call = lambda: scorer.score(image, proposals, REF_QUERIES)  # noqa

    def prefill():
        with torch.inference_mode():
            return TG._prefill_hidden_kvs(
                model, b["gh"], b["gw"], b["patches"], b["ids"][None],
                b["mask"][None], b["pos"][:, None], b["boxes"], b["ori"],
                b["vs"], np.full((1, 1), -1, np.int32))

    r = {"score_ms": host_ms(call, 2), "prefill_ms": host_ms(prefill, 2)}
    call_ms = host_ms(lambda: gen_call(cfg, model, b, TP_GEN_TOKENS), 1,
                      warmup=0)
    r["decode_ms_per_token"] = (call_ms - r["prefill_ms"]) / TP_GEN_TOKENS
    for bits, tree in (trees or {}).items():
        q_ms = host_ms(lambda: gen_call(cfg, model, b, TP_TIMED_TOKENS,
                                        decode_params=tree), 1, warmup=0)
        r[f"int{bits}_decode_ms_per_token"] = \
            (q_ms - r["prefill_ms"]) / TP_TIMED_TOKENS
    if served is None:
        toks, _, ms, _, _, _ = serve_run(cfg, model, reqs, c["slots"],
                                         c["p"], c["g"], c["chunk"],
                                         mesh=mesh)
    else:
        toks, ms = served
    r["serve"] = {"wall_ms": ms, "tokens": sum(map(len, toks)),
                  "tokens_per_s": sum(map(len, toks)) / ms * 1e3}
    r["collectives_score_call"] = collective_cost(mesh.stats, call)
    one = collective_cost(mesh.stats, lambda: gen_call(cfg, model, b, 1))
    many = collective_cost(mesh.stats, lambda: gen_call(
        cfg, model, b, 1 + TP_TIMED_TOKENS))
    r["collectives_per_token"] = {k: (many[k] - one[k]) / TP_TIMED_TOKENS
                                  for k in one}
    r["collectives_prefill"] = one
    return r


def tp_serve_worker(root: str) -> None:
    """A tp_serve rank: its slices of ref_2b, then the score call (and
    its control without the row-parallel sum), the int8-prefill score
    call, 64 greedy tokens, its int8 and int4 decode trees
    (quantize_decode_params of its model: bytes and collectives), the
    GenServer(mesh=) runs of every TP_SERVE_MODES mode, ref_generate_spec
    in every TP_SPEC_MODES mode, and its times in f32 and, where gloo
    carries a bf16 all_reduce, in bf16 (there the int8-prefill score
    call's logits and launches too)."""
    rank = dist_join()
    from wedetect_tpu_torch.models.quant import quantize_decode_params
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer
    from wedetect_tpu_torch.parallel import mesh as pm

    dev, c = torch.device(DIST_DEV), TP_SERVE_CELL
    inp = np.load(os.path.join(root, "tp_inputs.npz"))
    image, proposals = inp["image"], inp["proposals"]
    cfg = tp_cfg(bool(inp["full_depth"]))
    mesh = pm.make_tp_mesh(data=1, tp=TP_RANKS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_ref_variables(cfg, seed=0, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    out = {"rank": rank, "tp_index": mesh.tp_index,
           "init_s": time.perf_counter() - t0,
           "params": sum(p.numel() for p in model.parameters()),
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.reset_peak_memory_stats()
    tok = CharTok()
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok, device=dev)
    launch_counts(reset=True)
    logits = scorer.logits(image, proposals, REF_QUERIES)
    out["score_launches"] = launch_counts()
    row_sum = pm.row_sum
    pm.row_sum = lambda tp, y: y
    try:
        control = scorer.logits(image, proposals, REF_QUERIES)
    finally:
        pm.row_sum = row_sum
    # the int8 prefill: MAX scales and int32 sums over the group
    scorer8 = RefScorer(cfg=cfg, model=model, tokenizer=tok, device=dev,
                        quant_prefill=True)
    launch_counts(reset=True)
    mesh.stats.reset()
    logits8 = scorer8.logits(image, proposals, REF_QUERIES)
    out["score_int8"] = {"launches": launch_counts(),
                         "collective_kinds": dict(mesh.stats.kinds),
                         "collectives": collective_cost(
                             mesh.stats, lambda: scorer8.logits(
                                 image, proposals, REF_QUERIES))}
    np.savez(os.path.join(root, f"tp_logits.rank{rank}.npz"),
             logits=logits, control=control, int8=logits8,
             int8_whole=int8_whole_merger_logits(scorer8, image, proposals,
                                                 TP_RANKS))
    out["int8_ops_bitwise"] = tp_int8_ops(mesh, dev)
    b = gen_prompt(scorer, image, GEN_PROMPT)
    out["gen"] = trim(gen_call(cfg, model, b, TP_GEN_TOKENS)[0].cpu()
                      .numpy())
    trees, out["trees"] = {}, {}
    for bits in (8, 4):
        mesh.stats.reset()
        t0 = time.perf_counter()
        trees[bits] = quantize_decode_params(model, bits)
        torch.cuda.synchronize()
        out["trees"][bits] = {"code_bytes": tree_code_bytes(trees[bits]),
                              "seconds": time.perf_counter() - t0,
                              "collective_calls": mesh.stats.calls,
                              "collective_kinds": dict(mesh.stats.kinds)}
    reqs = serve_requests(scorer, image, c["n_req"], c["p"], c["g"])
    out["serve"] = {}
    for name, kw in TP_SERVE_MODES.items():
        mesh.stats.reset()
        toks, st, ms, pool, counts, _ = serve_run(
            cfg, model, reqs, c["slots"], c["p"], c["g"], c["chunk"],
            mesh=mesh, **tp_mode_kw(kw, trees))
        out["serve"][name] = {
            "tokens": toks, "stats": st, "pool_gb": pool / 1e9,
            "wall_ms": ms, "launches_per_admit": {
                k: v / st["admits"] for k, v in counts.items()
                if "bwd" not in k},
            # host clock, not synchronised: gloo's wait included
            "collectives": {"calls": mesh.stats.calls,
                            "mb": mesh.stats.bytes / 1e6,
                            "host_ms": mesh.stats.seconds * 1e3}}
    out["spec"] = {}
    for name, kw in TP_SPEC_MODES.items():
        launch_counts(reset=True)
        t0 = time.perf_counter()
        toks, steps = spec_call(cfg, model, b, TP_GEN_TOKENS,
                                **tp_mode_kw(kw, trees))
        torch.cuda.synchronize()
        out["spec"][name] = {"tokens": toks, "steps": steps,
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "launches": launch_counts()}
    greedy = out["serve"]["greedy"]
    out["float32"] = tp_timings(cfg, model, scorer, mesh, image, proposals,
                                b, reqs, (greedy["tokens"],
                                          greedy["wall_ms"]), trees)
    del trees
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # bf16 timing, where gloo carries a bf16 all_reduce of a CUDA tensor
    probe = torch.ones(4, dtype=torch.bfloat16, device=dev)
    try:
        mesh.tp.all_reduce(probe)
        out["bf16_all_reduce"] = bool((probe == TP_RANKS).all())
    except (RuntimeError, ValueError) as e:
        out["bf16_all_reduce"], out["bf16_refused"] = False, str(e)
    if out["bf16_all_reduce"]:
        scorer = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                           dtype="bfloat16", device=dev)
        launch_counts(reset=True)
        scorer.score(image, proposals, REF_QUERIES)
        out["score_launches_bf16"] = launch_counts()
        scorer8 = RefScorer(cfg=cfg, model=model, tokenizer=tok,
                            dtype="bfloat16", device=dev, quant_prefill=True)
        launch_counts(reset=True)
        logits8 = scorer8.logits(image, proposals, REF_QUERIES)
        out["score_int8_bf16"] = {"launches": launch_counts()}
        np.savez(os.path.join(root, f"tp_logits_int8_bf16.rank{rank}.npz"),
                 int8=logits8,
                 int8_whole=int8_whole_merger_logits(scorer8, image,
                                                     proposals, TP_RANKS))
        trees = {bits: quantize_decode_params(model, bits) for bits in (8, 4)}
        out["bfloat16"] = tp_timings(cfg, model, scorer, mesh, image,
                                     proposals, b, reqs, trees=trees)
        del trees
    with open(os.path.join(root, f"tp_serve_worker.rank{rank}.json"),
              "w") as f:
        json.dump(out, f)


def phase_tp_serve(dev, image, proposals, full_depth: bool = False):
    """ref_2b (at DIST_REF_DEPTH, or whole with `full_depth`) served by
    TP_RANKS tensor-parallel ranks on the one card against one process on
    the same weights (f32): RefScorer's score logits within
    TP_LOGIT_TOL, a control without the row-parallel sum missing it; the
    int8-prefill score logits bitwise one process's (f32; bf16 within
    REF_LOGIT_TOL); 64 greedy tokens of ref_generate, the GenServer(mesh=)
    tokens of each TP_SERVE_MODES mode (int8 / int4 decode trees among
    them) and ref_generate_spec's in each TP_SPEC_MODES mode equal to one
    process's by the margin rule (spec: the verify steps too where the
    tokens agree), and bitwise equal between the ranks; K2 and K3
    launches per rank in a score call, an int8-prefill score call, an
    admission prefill of each mode and a speculative call; K2 and K3 at a
    rank's shapes against their plain versions; each rank's quantized
    bytes, times and collective costs, and peak GB beside one
    process's."""
    from wedetect_tpu_torch.models.quant import quantize_decode_params
    from wedetect_tpu_torch.models.ref import init_ref_variables
    from wedetect_tpu_torch.models.ref_api import RefScorer

    cfg, c = tp_cfg(full_depth), TP_SERVE_CELL
    root = os.path.join(dist_root(), "tp")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    np.savez(os.path.join(root, "tp_inputs.npz"), image=image,
             proposals=np.asarray(proposals), full_depth=full_depth)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_ref_variables(cfg, seed=0, device=dev)
    scorer = RefScorer(cfg=cfg, model=model, tokenizer=CharTok(), device=dev)
    want = scorer.logits(image, proposals, REF_QUERIES)
    want8 = RefScorer(cfg=cfg, model=model, tokenizer=CharTok(), device=dev,
                      quant_prefill=True).logits(image, proposals,
                                                 REF_QUERIES)
    b = gen_prompt(scorer, image, GEN_PROMPT)
    want_gen = trim(gen_call(cfg, model, b, TP_GEN_TOKENS)[0].cpu().numpy())
    trees = {bits: quantize_decode_params(model, bits) for bits in (8, 4)}
    tree_bytes = {bits: tree_code_bytes(t) for bits, t in trees.items()}
    reqs = serve_requests(scorer, image, c["n_req"], c["p"], c["g"])
    want_serve = {name: serve_run(cfg, model, reqs, c["slots"], c["p"],
                                  c["g"], c["chunk"],
                                  **tp_mode_kw(kw, trees))[0]
                  for name, kw in TP_SERVE_MODES.items()}
    want_spec = {name: spec_call(cfg, model, b, TP_GEN_TOKENS,
                                 **tp_mode_kw(kw, trees))
                 for name, kw in TP_SPEC_MODES.items()}
    kernels = tp_rank_kernels(dev)
    ranks = spawn_ranks("tp_serve_worker", root, world=TP_RANKS)
    logits = [np.load(os.path.join(root, f"tp_logits.rank{r}.npz"))
              for r in range(TP_RANKS)]
    res = {"ranks": TP_RANKS, "config": c, "tolerance": TP_LOGIT_TOL,
           "depth": {"layers": cfg.text.layers, "vit": cfg.vision.depth},
           "margin_limit": GEN_LOGIT_TOL, "kernels": kernels}
    res["score"] = {
        "max_abs_err": [float(np.abs(x["logits"] - want).max())
                        for x in logits],
        "control_max_abs_err": [float(np.abs(x["control"] - want).max())
                                for x in logits],
        "ranks_bitwise": all(np.array_equal(x["logits"], logits[0]["logits"])
                             for x in logits)}
    one_gap = float(np.abs(want8 - want).max())
    res["score_int8"] = {
        "ops_bitwise_per_rank": [r["int8_ops_bitwise"] for r in ranks],
        "whole_merger_bitwise": [bool(np.array_equal(x["int8_whole"], want8))
                                 for x in logits],
        "whole_merger_max_abs_err": [
            float(np.abs(x["int8_whole"] - want8).max()) for x in logits],
        "bitwise": [bool(np.array_equal(x["int8"], want8)) for x in logits],
        "max_abs_err": [float(np.abs(x["int8"] - want8).max())
                        for x in logits],
        "vs_float_max_abs_err": [float(np.abs(x["int8"] - want).max())
                                 for x in logits],
        "one_process_vs_float_max_abs_err": one_gap,
        "ratio_limit": TP_INT8_FLOAT_RATIO,
        "ranks_bitwise": all(np.array_equal(x["int8"], logits[0]["int8"])
                             for x in logits),
        "collective_kinds": ranks[0]["score_int8"]["collective_kinds"],
        "collectives": [r["score_int8"]["collectives"] for r in ranks]}
    ok = (all(e <= TP_LOGIT_TOL for e in res["score"]["max_abs_err"])
          and all(e > TP_LOGIT_TOL
                  for e in res["score"]["control_max_abs_err"])
          and res["score"]["ranks_bitwise"]
          and all(all(r.values())
                  for r in res["score_int8"]["ops_bitwise_per_rank"])
          and all(res["score_int8"]["whole_merger_bitwise"])
          and all(e <= TP_INT8_FLOAT_RATIO * one_gap
                  for e in res["score_int8"]["vs_float_max_abs_err"])
          and res["score_int8"]["ranks_bitwise"])
    res["gen"] = tp_stream_check(model, b, ranks[0]["gen"], want_gen)
    res["gen"]["ranks_equal"] = all(r["gen"] == ranks[0]["gen"]
                                    for r in ranks)
    ok = ok and res["gen"]["ok"] and res["gen"]["ranks_equal"]
    res["serve"] = {}
    for name, kw in TP_SERVE_MODES.items():
        got = ranks[0]["serve"][name]["tokens"]
        sampling = (kw["temperature"], kw["top_k"], kw["top_p"]) \
            if "temperature" in kw else None
        dp = tp_mode_kw(kw, trees).get("decode_params")
        checks = [tp_stream_check(model, q, g, w, sampling, 1000 + k, dp)
                  for k, (q, g, w) in enumerate(zip(reqs, got,
                                                    want_serve[name]))]
        r = res["serve"][name] = {
            "ok": all(x["ok"] for x in checks),
            "equal": sum(x["margin"] is None and x["ok"] for x in checks),
            "partings": [x for x in checks if x["margin"] is not None],
            "ranks_equal": all(x["serve"][name]["tokens"] == got
                               for x in ranks),
            "complete": complete(got, reqs),
            "stats": ranks[0]["serve"][name]["stats"],
            "pool_gb_per_rank": ranks[0]["serve"][name]["pool_gb"],
            "tokens_per_s_per_rank": [
                sum(map(len, x["serve"][name]["tokens"]))
                / x["serve"][name]["wall_ms"] * 1e3 for x in ranks],
            "collectives_per_rank": [x["serve"][name]["collectives"]
                                     for x in ranks]}
        ok = ok and r["ok"] and r["ranks_equal"] and r["complete"]
    res["spec"] = {}
    for name, kw in TP_SPEC_MODES.items():
        got, steps = ranks[0]["spec"][name]["tokens"], \
            ranks[0]["spec"][name]["steps"]
        want_toks, want_steps = want_spec[name]
        dp = tp_mode_kw(kw, trees).get("decode_params")
        chk = tp_stream_check(model, b, got, want_toks, dp=dp)
        r = res["spec"][name] = {
            **chk, "steps": steps, "one_process_steps": want_steps,
            "ranks_equal": all(x["spec"][name]["tokens"] == got
                               and x["spec"][name]["steps"] == steps
                               for x in ranks),
            "ms_per_rank": [x["spec"][name]["ms"] for x in ranks]}
        # the steps must agree where the tokens do
        ok = ok and chk["ok"] and r["ranks_equal"] and (
            steps == want_steps or chk["margin"] is not None)
    res["tree_code_bytes"] = {
        f"int{bits}": {"one_process": tree_bytes[bits],
                       "per_rank": [r["trees"][str(bits)]["code_bytes"]
                                    for r in ranks],
                       "build_s_per_rank": [r["trees"][str(bits)]["seconds"]
                                            for r in ranks],
                       "collective_kinds":
                           ranks[0]["trees"][str(bits)]["collective_kinds"]}
        for bits in (8, 4)}
    k2, k3 = cfg.text.layers, cfg.vision.depth
    per_score = expected_counts(k2=2 * k2, k2_f32=2 * k2, k3=k3, k3_f32=k3)
    per_admit = {n: float(v) for n, v in expected_counts(
        k2=k2, k2_f32=k2, k3=k3, k3_f32=k3).items() if "bwd" not in n}
    per_spec = expected_counts(k2=k2, k2_f32=k2, k3=k3, k3_f32=k3)
    res["launches"] = {
        "score_per_rank": [r["score_launches"] for r in ranks],
        "admit_per_rank": [r["serve"]["greedy"]["launches_per_admit"]
                           for r in ranks],
        "score_bf16_per_rank": [r.get("score_launches_bf16")
                                for r in ranks],
        "score_int8_per_rank": [r["score_int8"]["launches"] for r in ranks],
        "score_int8_bf16_per_rank": [
            r.get("score_int8_bf16", {}).get("launches") for r in ranks],
        "admit_per_rank_by_mode": {
            name: [r["serve"][name]["launches_per_admit"] for r in ranks]
            for name in TP_SERVE_MODES},
        "spec_per_rank": {name: [r["spec"][name]["launches"]
                                 for r in ranks]
                          for name in TP_SPEC_MODES}}
    # every admission prefill but piggyback's, whose decoder rows ride
    # the decode chunk
    ok = ok and all(r["score_launches"] == per_score
                    and r["score_int8"]["launches"] == per_score
                    and all(r["serve"][n]["launches_per_admit"] == per_admit
                            for n, kw in TP_SERVE_MODES.items()
                            if not kw.get("piggyback"))
                    and all(r["spec"][n]["launches"] == per_spec
                            for n in TP_SPEC_MODES) for r in ranks)
    ok = ok and all(x["match"] for x in kernels.values())
    res["timings_per_rank"] = {
        t: [r[t] for r in ranks] for t in ("float32", "bfloat16")
        if t in ranks[0]}
    res["bf16_all_reduce"] = ranks[0]["bf16_all_reduce"]
    if "bf16_refused" in ranks[0]:
        res["bf16_refused"] = ranks[0]["bf16_refused"]
    res["peak_mem_gb_per_rank"] = [r["peak_mem_gb"] for r in ranks]
    res["init_peak_gb_per_rank"] = [r["init_peak_gb"] for r in ranks]
    res["params_per_rank"] = [r["params"] for r in ranks]
    res["one_process_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if res["bf16_all_reduce"]:
        # the int8 prefill in bf16: one process's calls on the cast model
        want_bf16 = RefScorer(cfg=cfg, model=model, tokenizer=CharTok(),
                              dtype="bfloat16", device=dev).logits(
            image, proposals, REF_QUERIES)
        want8_bf16 = RefScorer(cfg=cfg, model=model, tokenizer=CharTok(),
                               dtype="bfloat16", device=dev,
                               quant_prefill=True).logits(
            image, proposals, REF_QUERIES)
        gap_bf16 = float(np.abs(want8_bf16 - want_bf16).max())
        got = [np.load(os.path.join(root,
                                    f"tp_logits_int8_bf16.rank{r}.npz"))
               for r in range(TP_RANKS)]
        per_bf16 = expected_counts(k2=2 * k2, k2_sm90=2 * k2, k3=k3,
                                   k3_sm90=k3)
        res["score_int8_bf16"] = {
            "whole_merger_bitwise": [
                bool(np.array_equal(g["int8_whole"], want8_bf16))
                for g in got],
            "bitwise": [bool(np.array_equal(g["int8"], want8_bf16))
                        for g in got],
            "max_abs_err": [float(np.abs(g["int8"] - want8_bf16).max())
                            for g in got],
            "vs_float_max_abs_err": [
                float(np.abs(g["int8"] - want_bf16).max()) for g in got],
            "one_process_vs_float_max_abs_err": gap_bf16,
            "ratio_limit": TP_INT8_FLOAT_RATIO}
        ok = ok and all(res["score_int8_bf16"]["whole_merger_bitwise"]) \
            and all(e <= TP_INT8_FLOAT_RATIO * gap_bf16
                    for e in res["score_int8_bf16"]["vs_float_max_abs_err"]) \
            and all(r["score_int8_bf16"]["launches"] == per_bf16
                    for r in ranks)
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "tp_serve", **res})
    del model, scorer, trees
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("tp_serve: a tensor-parallel rank missed the "
                             "one-process run")
    return res


# ------------------------------------------------------------- legacy
# card against the same call on the CPU (same weights, the first
# LEGACY_CPU_BATCH inputs): max |card - CPU| over max |CPU|, by type
LEGACY_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LEGACY_CPU_BATCH = 2
LEGACY_PROMPTS = 80
LEGACY_BOXES = 20          # ground truths an image in the yolov5_loss step
LEGACY_CANDIDATES = 15000  # (anchor, class) scores above score_thr, image 0


def rel_max(got, want) -> float:
    """rel_max_err over a tensor or a sequence of them, on the CPU."""
    if not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    return max(rel_max_err(g.detach().cpu(), w.detach().cpu())
               for g, w in zip(got, want))


def legacy_module(make, seed: int, *inputs):
    """make() on the CPU under torch.manual_seed(seed) (torch's default
    init), its BN running statistics those of `inputs` (one train-mode
    pass at momentum 1, so activations stay O(1) through depth), BN
    scales and shifts then drawn around 1 and 0; eval mode."""
    torch.manual_seed(seed)
    module = make()
    bns = [m for m in module.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    keep = [m.momentum for m in bns]
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in bns:
            m.momentum = 1.0
        module.train()(*inputs)
        for m, mom in zip(bns, keep):
            m.momentum = mom
            m.weight.normal_(1.0, 0.2, generator=g)
            m.bias.normal_(0.0, 0.2, generator=g)
    return module.eval()


def clip_prompts(cfg, n: int, seed: int = 3):
    """n seeded CLIP prompts at max_positions: BOS, random tokens, EOS at a
    random length, 0 after; the attention mask up to the EOS."""
    g = torch.Generator().manual_seed(seed)
    length = cfg.max_positions
    ids = torch.randint(1, cfg.eos_token_id - 1, (n, length), generator=g)
    eos = torch.randint(2, length, (n,), generator=g)
    pos = torch.arange(length)[None]
    ids[:, 0] = cfg.eos_token_id - 1
    ids = torch.where(pos == eos[:, None], cfg.eos_token_id, ids)
    ids = torch.where(pos > eos[:, None], 0, ids)
    return ids, (pos <= eos[:, None]).long()


def v5_obj_shift(raw, thr: float, target: int) -> float:
    """The obj-logit shift s at which about `target` (anchor, class)
    scores sigmoid(obj + s) * sigmoid(cls) of image 0 exceed thr
    (bisection; raw: per-level (B, A, 5+K, H, W) on the CPU)."""
    obj = torch.cat([p[0, :, 4].reshape(-1) for p in raw]).double()
    cls = torch.cat([p[0, :, 5:].transpose(0, 1).reshape(p.shape[2] - 5, -1)
                     for p in raw], 1).double().sigmoid()
    lo, hi = -30.0, 30.0
    for _ in range(40):
        mid = (lo + hi) / 2
        n = int((torch.sigmoid(obj + mid)[None] * cls > thr).sum())
        lo, hi = (mid, hi) if n < target else (lo, mid)
    return (lo + hi) / 2


def card_copy(module, dev):
    """A copy of a CPU module on the card (the CPU one stays)."""
    return copy.deepcopy(module).to(dev)


def phase_legacy(dev, timing: bool = True, text_cfg=None, vision_cfg=None,
                 widths=(256, 512, 1024), img: int = 640,
                 batch: int = BATCH, n_prompts: int = LEGACY_PROMPTS,
                 rep=(256, 80)):
    """The legacy modules (no Pallas kernel lies inside them) at the JAX
    modules' default widths, each held to the same call on the CPU."""
    from wedetect_tpu_torch.configs import TestCfg
    from wedetect_tpu_torch.nn import clip
    from wedetect_tpu_torch.nn import yolo_world_pafpn as ywp
    from wedetect_tpu_torch.nn.layers import RepVGGBlock, repvgg_fuse
    from wedetect_tpu_torch.nn.pseudo_text import PseudoTextBackbone
    from wedetect_tpu_torch.nn.yolov5_head import YOLOv5HeadModule
    from wedetect_tpu_torch.ops import nms
    from wedetect_tpu_torch.ops.row_topk import row_topk
    from wedetect_tpu_torch.ops.yolov5 import yolov5_decode
    from wedetect_tpu_torch.train.yolov5_loss import yolov5_loss

    nb = LEGACY_CPU_BATCH
    errors, ms, device_ms = {}, {}, {}
    f32, bf16 = torch.float32, torch.bfloat16

    def check(name, got, want, dtype="float32"):
        errors[name] = e = rel_max(got, want)
        assert e <= LEGACY_TOL[dtype], (name, e, LEGACY_TOL[dtype])

    def timed(name, fn, graph=True):
        """ms a call with the host (cuda_ms) and, where the call can be
        captured (no host sync or pageable copy), its device time alone
        (graph_ms)."""
        ms[name] = cuda_ms(fn, 5) if timing else None
        if timing and graph:
            device_ms[name] = graph_ms(fn, iters=10, replays=3)

    # CLIP: the text tower (ViT-B/32's, 12 x 512) on 80 prompts, the
    # vision tower (12 x 768, 224 px, patch 32) at B = batch, f32 and bf16
    tc = text_cfg or clip.ClipTextCfg()
    vc = vision_cfg or clip.ClipVisionCfg()
    ids, mask = clip_prompts(tc, n_prompts)
    ids_d, mask_d = ids.to(dev), mask.to(dev)
    images = torch.randn(batch, 3, vc.image_size, vc.image_size,
                         generator=torch.Generator().manual_seed(4))
    images_d = images.to(dev)
    torch.manual_seed(5)
    text_sd = clip.ClipTextTower(tc).state_dict()
    torch.manual_seed(6)
    vision_sd = clip.ClipVisionTower(vc).state_dict()
    for dt, name in ((f32, "float32"), (bf16, "bfloat16")):
        text, vision = clip.ClipTextTower(tc, dt), clip.ClipVisionTower(vc, dt)
        text.load_state_dict(text_sd)
        vision.load_state_dict(vision_sd)
        text_d = clip.ClipTextTower(tc, dt).to(dev).eval()
        text_d.load_state_dict(text_sd)
        vision_d = clip.ClipVisionTower(vc, dt).to(dev).eval()
        vision_d.load_state_dict(vision_sd)
        with torch.inference_mode():
            emb = text_d(ids_d, mask_d)
            cls_tok = vision_d(images_d)
            assert emb.shape == (n_prompts, tc.projection_dim)
            assert cls_tok.shape == (batch, vc.hidden)
            assert torch.isfinite(emb).all() and torch.isfinite(cls_tok).all()
            check(f"clip_text_{name}", emb[:nb],
                  text.eval()(ids[:nb], mask[:nb]), name)
            check(f"clip_vision_{name}", cls_tok[:nb],
                  vision.eval()(images[:nb]), name)
            timed(f"clip_text_{name}", lambda: text_d(ids_d, mask_d))
            timed(f"clip_vision_{name}", lambda: vision_d(images_d))
        if dt == f32:
            text_embeds = emb
        del text, vision, text_d, vision_d
    # the pseudo-text backbone on the tower's embeddings
    table = {f"class_{i}": e for i, e in enumerate(text_embeds.cpu().numpy())}
    pseudo = PseudoTextBackbone(table=table, device=dev)(list(table))
    assert pseudo.device.type == dev.type
    check("pseudo_text", pseudo, text_embeds.cpu())

    # the necks on a 640 pyramid (80, 40, 20) at B = batch, the guide the
    # text tower's (batch, 80, 512) embeddings
    g = torch.Generator().manual_seed(7)
    sides = (img // 8, img // 16, img // 32)
    feats = [torch.randn(batch, c, s, s, generator=g)
             for c, s in zip(widths, sides)]
    feats_d = [f.to(dev) for f in feats]
    guide_d = text_embeds[None].expand(batch, -1, -1).contiguous()
    guide = guide_d[:nb].cpu()
    cpu_in = [f[:nb] for f in feats]
    world_kw = dict(out_channels=widths, guide_channels=tc.projection_dim,
                    embed_channels=tuple(w // 2 for w in widths),
                    num_heads=tuple(w // 64 for w in widths))
    necks = {
        "yolo_world": (lambda: ywp.YOLOWorldPAFPN(**world_kw), True),
        "yolo_world_dual": (lambda: ywp.YOLOWorldPAFPN(dual=True,
                                                       **world_kw), True),
        "yolov8_pafpn": (lambda: ywp.YOLOv8PAFPN(out_channels=widths), False),
        "yolov5_pafpn": (lambda: ywp.YOLOv5PAFPN(widths), False)}
    for i, (name, (make, guided)) in enumerate(necks.items()):
        args = (cpu_in, guide) if guided else (cpu_in,)
        cpu = legacy_module(make, 10 + i, *args)
        card = card_copy(cpu, dev)
        args_d = (feats_d, guide_d) if guided else (feats_d,)
        with torch.inference_mode():
            outs = card(*args_d)
            assert [tuple(o.shape) for o in outs] == [
                (batch, c, s, s) for c, s in zip(widths, sides)]
            check(name, [o[:nb] for o in outs], cpu(*args))
            timed(name, lambda: card(*args_d))
        if name == "yolov5_pafpn":
            v5_out_d, v5_out = outs, cpu(*args)
        del cpu, card

    # the YOLOv5 head at K = 80 on the YOLOv5 neck, its decode (25,200
    # anchors an image at 640) and the detect path's NMS, K1 counted
    k = 80
    test = TestCfg()
    torch.manual_seed(20)
    head = YOLOv5HeadModule(k, widths).eval()
    with torch.no_grad():
        shift = v5_obj_shift(head(v5_out), test.score_thr,
                             LEGACY_CANDIDATES)
        for conv in head.convs_pred:
            conv.bias.view(3, 5 + k)[:, 4] += shift
    head_d = card_copy(head, dev)
    with torch.inference_mode():
        raw_d = head_d(v5_out_d)
        check("yolov5_head", [r[:nb] for r in raw_d], head(v5_out))
        boxes_d, scores_d = yolov5_decode(raw_d)
        n_anchors = boxes_d.shape[1]
        assert n_anchors == 3 * sum(s * s for s in sides), n_anchors
        check("yolov5_decode", [boxes_d[:nb], scores_d[:nb]],
              yolov5_decode([r[:nb].cpu() for r in raw_d]))
        nms_kw = dict(score_thr=test.score_thr, nms_pre=test.nms_pre,
                      iou_thr=test.nms_iou_thr, max_out=test.max_per_img,
                      multi_label=test.multi_label)
        row_topk.launches = 0
        dets = nms.batched_static_nms(scores_d, boxes_d, **nms_kw)
        torch.cuda.synchronize()
        k1 = row_topk.launches
        dets_cpu = nms.batched_static_nms(scores_d[:nb].cpu(),
                                          boxes_d[:nb].cpu(), **nms_kw)
        nms_match = all(bitwise_equal(a[:nb].cpu(), b)
                        for a, b in zip(dets, dets_cpu))
        assert nms_match, "yolov5 NMS: card != CPU on the same decode"
        n_cand = int((scores_d > test.score_thr).sum(dim=(1, 2))[0])
        n_det = int(dets.valid.sum())
        assert n_det > 0 and torch.isfinite(dets.boxes).all()
        timed("yolov5_head", lambda: head_d(v5_out_d))
        timed("yolov5_decode", lambda: yolov5_decode(raw_d), graph=False)
        timed("yolov5_nms", lambda: nms.batched_static_nms(
            scores_d, boxes_d, **nms_kw), graph=False)

    # one yolov5_loss forward and backward at B = batch, 20 boxes an
    # image, card against the CPU on the same predictions
    g = torch.Generator().manual_seed(21)
    ctr = torch.rand(batch, LEGACY_BOXES, 2, generator=g) * img
    wh = 8 + torch.rand(batch, LEGACY_BOXES, 2, generator=g) * (img / 2 - 8)
    gt = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).clamp(0, img)
    labels = torch.randint(0, k, (batch, LEGACY_BOXES), generator=g)
    gmask = torch.ones(batch, LEGACY_BOXES, dtype=torch.bool)

    def loss_step(preds, d):
        ps = [p.detach().clone().requires_grad_() for p in preds]
        out = yolov5_loss(ps, gt.to(d), labels.to(d), gmask.to(d),
                          (img, img), loss_scale=float(batch))
        out.total.backward()
        return out, [p.grad for p in ps]

    loss_d, grads_d = loss_step(raw_d, dev)
    loss_c, grads_c = loss_step([r.cpu() for r in raw_d], "cpu")
    for name in ("total", "cls", "obj", "bbox", "num_pos"):
        check(f"yolov5_loss_{name}", getattr(loss_d, name),
              getattr(loss_c, name))
    check("yolov5_loss_grad", grads_d, grads_c)
    assert float(loss_d.num_pos) > 0 and torch.isfinite(loss_d.total)
    timed("yolov5_loss_fwd_bwd", lambda: loss_step(raw_d, dev), graph=False)
    del raw_d, boxes_d, scores_d, dets, grads_d, v5_out_d

    # RepVGGBlock at 256 channels, 80 x 80, stride 1 and 2: train form
    # card vs CPU, and the fused deploy form against the train form
    ch, side = rep
    x = torch.randn(batch, ch, side, side,
                    generator=torch.Generator().manual_seed(22))
    x_d = x.to(dev)
    for stride in (1, 2):
        blk = legacy_module(lambda: RepVGGBlock(ch, ch, stride), 30 + stride,
                            x[:nb])
        blk_d = card_copy(blk, dev)
        fused_d = RepVGGBlock(ch, ch, stride, deploy=True).to(dev)
        fused_d.load_state_dict(repvgg_fuse(blk_d))
        with torch.inference_mode():
            y = blk_d(x_d)
            assert y.shape == (batch, ch, side // stride, side // stride)
            check(f"repvgg_s{stride}", y[:nb], blk(x[:nb]))
            check(f"repvgg_s{stride}_fused", fused_d(x_d), y)
            timed(f"repvgg_s{stride}", lambda: blk_d(x_d))
            timed(f"repvgg_s{stride}_fused", lambda: fused_d(x_d))
    res = {"row_topk_launches": k1, "ms": ms, "device_ms": device_ms,
           "errors": errors,
           "tolerance": LEGACY_TOL, "cpu_batch": nb, "batch": batch,
           "anchors_per_image": n_anchors, "obj_shift": shift,
           "candidates_image0": n_cand, "detections": n_det,
           "nms_card_equals_cpu": nms_match,
           "loss": {n: float(getattr(loss_d, n).detach())
                    for n in loss_d._fields}}
    emit({"phase": "legacy", "nvidia_smi": nvidia_smi(), **res})
    return res


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
    phase_native()
    k1 = phase_k1(dev, BATCH * 8400, N_CLASSES)
    k2 = phase_k2(dev)
    k3 = phase_k3(dev)
    text_embeds = phase_text(dev, TEXT_BASE, N_CLASSES)
    detect = phase_detect(dev, "base", N_CLASSES, BATCH, text_embeds)
    det, boxed, files = phase_detect_files(dev, text_embeds)
    fold = phase_fold(dev, det, boxed)
    del det, boxed
    torch.cuda.empty_cache()
    ev = phase_eval(dev, text_embeds)
    odinw = phase_odinw(dev)
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
    det_train = phase_det_train(dev)
    phase_gen_parity(dev)
    phase_gen(dev, image)
    serve = phase_serve(dev, image)
    gate = phase_quant_gate(dev, image)
    ground = phase_grounding(dev)
    video = phase_video_gen(dev)
    video_sft = phase_video_sft(dev)
    phase_video_cli(dev, video["npy"])
    phase_vis(dev)
    dist_det = phase_dist_det(dev, det_train)
    dist_ref = phase_dist_ref(dev, image, proposals)
    phase_dist_nccl(dev, image, proposals)
    tp = phase_tp_serve(dev, image, proposals)
    legacy = phase_legacy(dev)
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
    # K2's and K3's launches a video prefill by type (the SIMT kernels'
    # none), and the backward kernels' a video SFT step (f32)
    vprefill = {t: video[t]["prefill_launches"]
                for t in ("float32", "bfloat16")}
    vk = video["kernels"]
    vsft = {n: int(c) for n, c in video_sft["launches_per_step"].items()}
    vsft_bwd = {**k2_bwd_launches(vsft), **k3_bwd_launches(vsft)}

    def video_times(key):
        """A kernel's times at the video shape (video_kernels): K2 at the
        video prompt's prefix, K3 at its ViT (L = 9600)."""
        r = vk[key]
        return {f"video_{k}": r[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "max_abs_err")}
    kernels = [
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
         # a Detector.__call__ on 8 JPEG paths; the unfolded and the
         # folded detector's call (fold); the ODinW CLI (K <= 20: none)
         "launches_detect_files": files["row_topk_launches"],
         "launches_fold": fold["row_topk_launches"],
         "launches_odinw": odinw["row_topk_launches"],
         # the YOLOv5 head's decode through batched_static_nms at K = 80,
         # B = 8 (legacy): A*K = 2,016,000 < 2^21, so the sort path
         "launches_legacy": legacy["row_topk_launches"],
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
         "launches_video_prefill": vprefill["float32"]["k2_f32"],
         "launches_video_sft_step": vsft["k2_f32"],
         **video_times("k2_float32"),
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
         "launches_video_prefill": simt(vprefill, "k2"),
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
         "launches_multi": multi["bfloat16"].get("k2_sm90", 0),
         "launches_video_prefill": vprefill["bfloat16"]["k2_sm90"],
         **video_times("k2_bfloat16")},
        {**kernel_entry("flash_attention_fwd_f32", K3_F32_FWD_SOURCE, K3_FWD,
                        launches["k3_f32"], k3, k3["vit_float32"],
                        route="f32"),
         "launches_sft_step": train["launches_per_step"]["k3_f32"],
         "launches_admit": admit["float32"]["k3_f32"],
         "launches_int8_score": int8["float32"]["k3_f32"],
         "launches_calib_prompt": calib_k3,
         "launches_rec_step": rec_step["float32"].get("k3_f32", 0),
         "launches_multi": multi["float32"].get("k3_f32", 0),
         "launches_video_prefill": vprefill["float32"]["k3_f32"],
         "launches_video_sft_step": vsft["k3_f32"],
         **video_times("k3_float32"),
         "video_tiles_walked": vk["k3_float32"]["tiles_walked"],
         "video_tiles_scanned": vk["k3_float32"]["rule_tiles_scanned"],
         "video_tile_rows": vk["k3_float32"]["tile_rows"],
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
         "launches_video_prefill": simt(vprefill, "k3"),
         "train_ms": k3["train_simt_float32"]["ms"]},
        {**kernel_entry("flash_attention_fwd_sm90",
                        "wedetect_tpu_torch/csrc/flash_attn_sm90.cu", K3_FWD,
                        launches_bf16["k3_sm90"], k3, k3["vit_bfloat16"],
                        route="sm90"),
         "launches_admit": admit["bfloat16"]["k3_sm90"],
         "launches_int8_score": int8["bfloat16"]["k3_sm90"],
         "launches_rec_step": rec_step["bfloat16"].get("k3_sm90", 0),
         "launches_multi": multi["bfloat16"].get("k3_sm90", 0),
         "launches_video_prefill": vprefill["bfloat16"]["k3_sm90"],
         **video_times("k3_bfloat16")},
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
                  k3_bwd, k3_bwd["dkv_bfloat16"], dtype="bfloat16")]
    # every attention kernel's launches in each rank of a 2-rank (fsdp =
    # 2, the parameters sharded) SFT step of the cut ref_2b (dist_ref),
    # and K1's in each rank's detector steps (dist_det: none)
    def by_kernel(c):
        return {**k2_bwd_launches(c), **k3_bwd_launches(c),
                "gqa_flash_fwd_f32": c["k2_f32"],
                "gqa_flash_fwd_sm90": c["k2_sm90"],
                "gqa_flash_fwd": c["k2"] - c["k2_sm90"] - c["k2_f32"],
                "flash_attention_fwd_f32": c["k3_f32"],
                "flash_attention_fwd_sm90": c["k3_sm90"],
                "flash_attention_fwd": c["k3"] - c["k3_sm90"] - c["k3_f32"]}

    per_rank = [by_kernel(r["launches"]) for r in dist_ref["ranks"]]
    for entry in kernels:
        if entry["name"] in vsft_bwd:
            entry["launches_video_sft_step"] = vsft_bwd[entry["name"]]
        if entry["name"] in per_rank[0]:
            entry["launches_dist_sft_step_per_rank"] = [
                c[entry["name"]] for c in per_rank]
    # K2's and K3's launches in each tp_serve rank: a score call, an
    # int8-prefill score call, an admission prefill of each serving mode
    # and a speculative call in f32 (the FFMA kernels), a score call and
    # an int8-prefill one in bf16 (the wgmma ones, where gloo carried
    # bf16), and their times at a rank's shapes (tp_rank_kernels)
    tp_counter = {"gqa_flash_fwd_f32": "k2_f32",
                  "flash_attention_fwd_f32": "k3_f32",
                  "gqa_flash_fwd_sm90": "k2_sm90",
                  "flash_attention_fwd_sm90": "k3_sm90"}
    for entry in kernels:
        name = entry["name"]
        if name not in tp_counter:
            continue
        n = tp_counter[name]
        bf16 = name.endswith("sm90")
        tl = tp["launches"]
        entry["launches_tp_score_per_rank"] = [
            (c or {}).get(n, 0) for c in
            tl["score_bf16_per_rank" if bf16 else "score_per_rank"]]
        entry["launches_tp_int8_score_per_rank"] = [
            (c or {}).get(n, 0) for c in tl[
                "score_int8_bf16_per_rank" if bf16
                else "score_int8_per_rank"]]
        if not bf16:
            entry["launches_tp_admit_per_rank"] = [
                c[n] for c in tl["admit_per_rank"]]
            entry["launches_tp_admit_per_rank_by_mode"] = {
                mode: [c[n] for c in per]
                for mode, per in tl["admit_per_rank_by_mode"].items()}
            entry["launches_tp_spec_per_rank"] = {
                mode: [c[n] for c in per]
                for mode, per in tl["spec_per_rank"].items()}
        for shape in (("k2_prefix", "k2_suffix") if n.startswith("k2")
                      else ("k3_vit",)):
            r = tp["kernels"][f"{shape}_{'bfloat16' if bf16 else 'float32'}"]
            entry[f"tp_{shape[3:]}"] = {
                k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms", "max_abs_err")}
    kernels[0]["launches_dist_det_step"] = [
        r[k]["launches"]["row_topk"] for r in dist_det["ranks"]
        for k in ("dp", "fsdp")]
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
