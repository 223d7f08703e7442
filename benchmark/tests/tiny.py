"""Miniature sizes of the benchmark's cells for the CPU tests: every
width cut, the same code paths (the port's plain versions of its
kernels run on the CPU)."""

import os
import time

UNI = {"size": "base", "depths": [1, 1, 1, 1], "dims": [32, 64, 128, 256],
       "neck_scale": 0.25, "neck_repeats": 2, "head_in_channels": [32, 64, 128],
       "embed_dims": 64, "reg_max": 16, "strides": [8, 16, 32],
       "cls_hidden": 32, "reg_hidden": 16, "img_size": [128, 128],
       "compute_dtype": "bfloat16"}
SHAPES = [[96, 128], [128, 96], [85, 128]]


def det(dtype="bfloat16"):
    return {"model": dict(UNI, compute_dtype=dtype),
            "traffic": {"batch": 4, "calls": 3, "shapes": SHAPES,
                        "shares": [1, 1, 1], "vocabulary": 70}}


def rec(dtype="bfloat16"):
    return {
        "uni": {"model": dict(UNI, compute_dtype=dtype), "num_prompts": 70},
        "ref": {"vision": {"depth": 2, "hidden": 64, "heads": 4,
                           "intermediate": 128, "patch": 16,
                           "temporal_patch": 2, "in_ch": 3, "merge": 2,
                           "out_hidden": 128, "num_pos_emb": 64,
                           "deepstack_idx": [0, 1]},
                "text": {"vocab_size": 151936, "hidden": 128, "layers": 2,
                         "heads": 4, "kv_heads": 2, "head_dim": 32,
                         "intermediate": 256, "rms_eps": 1e-6,
                         "rope_theta": 5e6, "mrope_section": [6, 5, 5]}},
        "scorer": {"grid_tokens": 16, "query_batch": 4, "dtype": dtype},
        "traffic": {"batch": 4, "calls": 4, "shapes": SHAPES[:2],
                    "shares": [1, 1]}}


def run(cell, overrides, seed=2 ** 31 + 5, seconds=4.0, **kw):
    """One run of the cell on the CPU at these sizes: (the result line's
    object, every number the check read)."""
    from benchmark.harness import run_cell

    os.environ.setdefault("OMP_NUM_THREADS", "2")
    rec = {}
    r = run_cell(cell, seed, seconds, 0, "cpu", time.perf_counter(),
                 overrides=overrides, record=rec, **kw)
    return r, rec["check"]
