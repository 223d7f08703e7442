"""The metric arithmetic on hand-made inputs: the busy-interval union
and idle gaps, rates and tails over every call, the roofline bounds and
the FLOP counts."""

import math

import pytest
import torch

from benchmark import peaks, trace
from benchmark.harness import Cell, Run, percentile, span_ms_per_call
from benchmark.harness import reader
from benchmark.metrics import (det_call_ms_p95, det_idle_pct,
                               det_img_per_s, k1_roofline_pct,
                               k2_roofline_pct)
from benchmark.reference import flops


def test_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40), (40, 45), (50, 51)]
    assert trace.union_seconds(spans) == 10 + 10 + 15 + 1 - 0
    assert trace.gaps(spans, 0, 60) == [(20, 30), (45, 50), (51, 60)]
    assert trace.union_seconds([]) == 0.0


def test_reduce_names_gaps_by_host_op():
    kernels = [(0.0, 4e6, "k_a"), (6e6, 7e6, "k_b"), (7e6, 8e6, "k_a")]
    cpu = [(0.0, 10e6, "bench.window"), (3e6, 7e6, "bench.det_post"),
           (3.5e6, 6.5e6, "aten::item")]
    out = trace.reduce(kernels, cpu, 0.0, 10e6)
    assert out["busy_s"] == pytest.approx(6.0)
    assert out["window_s"] == pytest.approx(10.0)
    assert out["kernels"] == {"k_a": 5.0, "k_b": 1.0}
    assert out["breakdown"]["device_ops"] == [["k_a", 5.0], ["k_b", 1.0]]
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps == {"det_post/aten::item": 2.0, "window/idle": 2.0}


def test_tails_and_rates_over_every_call():
    lat = [float(i) for i in range(1, 101)]
    assert percentile(lat, 95) == pytest.approx(95.05)
    assert percentile(lat, 90) == pytest.approx(90.1)
    run = Run(cell=None, seconds=2.0, calls=100, items=1600,
              latencies_ms=lat)
    assert det_img_per_s.read(run) == 800.0
    assert det_call_ms_p95.read(run) == pytest.approx(95.05)
    assert reader("rec_call_ms_p90.host")(run) == pytest.approx(90.1)


def test_spans_and_idle():
    run = Run(cell=None, spans={"det_post": [1.0, 2.0, 3.0]},
              counters={"calls": 2},
              trace={"busy_s": 0.75, "window_s": 1.0, "kernels": {}})
    assert span_ms_per_call(run, "det_post") == 3.0
    assert span_ms_per_call(run, "det_prep") is None
    assert det_idle_pct.read(run) == pytest.approx(25.0)


def test_k1_bound_and_roofline():
    rows, k, t = 134400, 1203, 64
    nbytes = rows * k * 4 + rows * t * 8
    assert peaks.k1_bound_s(rows, k, t, [rows, 0, 0]) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S)
    c = {"k1_launches": 1, "k1_rows": rows, "k1_k": k, "k1_t": t,
         "k1_empty": rows, "k1_sparse": 0, "k1_dense": 0}
    run = Run(cell=None, counters=c, trace={"kernels": {
        "row_topk_regs(float const*, ...)": 2 * nbytes / 3.35e12}})
    assert k1_roofline_pct.read(run) == pytest.approx(50.0)
    assert k1_roofline_pct.read(Run(cell=None, counters=c)) is None


def test_attention_bound():
    # operations bound: 4 * H * D a pair at the bf16 peak
    b = peaks.attn_bound_s(16, 128, 1e9, 1e3, 1e3, 10, 2,
                           peaks.BF16_OPS_PER_S)
    assert b == pytest.approx(4 * 16 * 128 * 1e9 / 989e12)
    # bytes bound: q, k, v and o at 2 bytes, lse at 4
    b = peaks.attn_bound_s(1, 1, 1, 1e9, 1e9, 1e6, 2, peaks.BF16_OPS_PER_S)
    assert b == pytest.approx((4e9 + 4e6) / 3.35e12)
    run = Run(cell=None, counters={"k2_launches": 56, "k2_bound_s": 1e-3},
              trace={"kernels": {"void gqa_fwd_sm90_kernel<>": 4e-3}})
    assert k2_roofline_pct.read(run) == pytest.approx(25.0)


def test_detector_flops_by_hand():
    model = {"depths": [1, 1, 1, 1], "dims": [8, 8, 8, 8],
             "neck_scale": 0.0625, "neck_repeats": 1, "embed_dims": 16,
             "reg_max": 4, "strides": [8, 16, 32], "cls_hidden": 8,
             "reg_hidden": 8, "img_size": [32, 32]}
    got = flops.detector_flops(model, 5)
    # the stem alone: 4x4 stride-4 conv, 3 -> 8 channels on 8x8 outputs
    stem = 2 * 8 * 8 * 8 * 3 * 16
    assert got > stem and got == flops.detector_flops(dict(model), 5)


def test_ref_flops_match_the_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import qwen3vl as Q

    vision = dict(depth=2, hidden=32, heads=2, intermediate=64, patch=4,
                  temporal_patch=2, in_ch=3, merge=2, out_hidden=32,
                  num_pos_emb=16, deepstack_idx=(0, 1))
    text = dict(vocab_size=64, hidden=32, layers=2, heads=4, kv_heads=2,
                head_dim=8, intermediate=48, rms_eps=1e-6, rope_theta=1e4,
                mrope_section=(2, 1, 1))
    c = Q.RefCfg(vision=Q.VisionCfg(**vision), text=Q.TextCfg(**text),
                 image_token_id=60, vision_start_token_id=61,
                 object_token_id=62)
    torch.manual_seed(0)
    m = Q.RefReference(c).eval()
    gh, gw, n_obj = 4, 6, 3
    ids = torch.tensor([1, 61] + [60] * (gh * gw // 4) + [2, 3]
                       + [62] * n_obj + [4])
    pos = torch.as_tensor(Q.rope_index(ids.numpy(), 60, gh // 2, gw // 2))
    pixels = torch.randint(0, 256, (gh * 4, gw * 4, 3), dtype=torch.uint8)
    boxes = torch.tensor([[0.0, 0, 8, 8], [2, 2, 20, 12], [1, 5, 3, 9]])
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        m(pixels, ids, pos, boxes, (gw * 4, gh * 4))
    counted = fc.get_total_flops()
    want = flops.ref_flops(vision, text, gh, gw, len(ids), n_obj)
    # the counter also sees RoIAlign's contractions and the attention's
    # masked (causal) half, which the model count leaves out
    assert want <= counted
    assert want > 0.5 * counted
    assert math.isfinite(want)


def test_cell_dataclass_fields():
    assert {"name", "chips", "config", "traffic", "spec", "end_to_end",
            "per_layer"} <= set(Cell.__dataclass_fields__)
