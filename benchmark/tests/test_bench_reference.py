"""The check that decides `correct`, driven at a miniature size on the
CPU (the harness's look for a card skipped): the reference agrees with
the port where both compute in float32; the sound bf16 program passes
the cell's limits; the control (the plain reference in fp8 in the
program's place) and planted faults fail them."""

import pytest
import torch

from benchmark.faults import FAULTS as PATCHES
from benchmark.tests import tiny

CELLS = {"det_base_lvis_b16": tiny.det, "rec_ref2b_b16": tiny.rec}


def test_detector_reference_agrees_with_the_port_in_f32():
    r, c = tiny.run("det_base_lvis_b16", tiny.det("float32"))
    assert c["det_score_gap"] < 1e-5
    assert c["det_box_gap_px"] < 1e-3
    assert c["det_embed_gap"] < 1e-5
    assert r["correct"] and r["failed"] == 0


def test_ref_reference_agrees_with_the_port_in_f32():
    r, c = tiny.run("rec_ref2b_b16", tiny.rec("float32"))
    assert c["rec_logit_gap"] < 1e-4
    assert c["uni_score_gap"] < 1e-5 and c["uni_embed_gap"] < 1e-5
    assert c["uni_box_gap_px"] < 1e-3
    assert r["correct"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_bf16_program_is_correct(cell):
    r, _ = tiny.run(cell, CELLS[cell]())
    assert r["correct"], r["check"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(cell):
    """The control: the plain reference computed in fp8, the precision
    below the configuration's bf16, answering in the program's place."""
    r, _ = tiny.run(cell, CELLS[cell](), control=True)
    assert not r["correct"], r["check"]


def half_batch(call, i):
    items, out = call(i)
    if isinstance(out, tuple):          # REC: (proposals, logits)
        props, logits = out
        return items, (props, logits[:len(logits) // 2])
    return items, out[:len(out) // 2]


def det_altered(det):
    """Every region embedding of the first level moved where it is
    produced (its BatchNorm's shift)."""
    with torch.no_grad():
        det.model.bbox_head.cls_contrasts[0].norm.bias += 0.1


def rec_altered(uni):
    """Every region embedding of Uni's first level moved where it is
    produced (its BatchNorm's shift)."""
    det_altered(uni)


def ref_altered(model):
    """Every Ref logit moved where it is produced (out_proj's bias)."""
    with torch.no_grad():
        model.out_proj.bias += 0.1


FAULTS = [("det_base_lvis_b16", {"call": half_batch}),
          ("det_base_lvis_b16", {"program": det_altered}),
          ("rec_ref2b_b16", {"call": half_batch}),
          ("rec_ref2b_b16", {"program": rec_altered}),
          ("rec_ref2b_b16", {"ref": ref_altered})]


@pytest.mark.parametrize("cell,faults", FAULTS,
                         ids=["det-half", "det-altered", "rec-half",
                              "rec-altered", "rec-ref-altered"])
def test_planted_fault_fails(cell, faults):
    r, _ = tiny.run(cell, CELLS[cell](), faults=faults)
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", sorted(PATCHES))
def test_selection_and_nms_faults_fail(cell, fault):
    """A selection that hands NMS the wrong candidates, and an NMS that
    suppresses nothing (benchmark/faults.py), each come out not
    correct."""
    with PATCHES[fault]():
        r, c = tiny.run(cell, CELLS[cell]())
    assert not r["correct"], r["check"]
    prefix = "uni_" if cell.startswith("rec") else ""
    key = "missed" if fault == "selection" else "det_pair_iou"
    if prefix:
        key = key.replace("det_", "")
    c = r["check"][prefix + key]
    assert c["value"] > c["limit"], r["check"]
