"""The port's WeRefDataset (`wedetect_tpu_torch/data/weref.py`) against
the JAX package's on tests/test_weref.py's JSONL tree: the same samples
(texts, boxes, labels and the base fields), the same fallback and
success ids and the same generator state after every call, over 32
calls (indices 0-3 in turn) at mixed_ratio 0, 0.5 and 1, with and
without the negative queue and the sam boxes. Everything is compared
exactly."""

import numpy as np
import pytest

from test_weref import FakeBase, ref_root  # noqa: F401
from wedetect_tpu.data.weref import WeRefDataset as JWeRef
from wedetect_tpu_torch.data.weref import WeRefDataset as TWeRef


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mixed_ratio", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kw", [dict(), dict(use_negative_queue=False,
                                             use_sam_box=False, seed=3)])
def test_samples_equal_jax(ref_root, mixed_ratio, kw):  # noqa: F811
    t = TWeRef(FakeBase(), ref_root, mixed_ratio=mixed_ratio, **kw)
    j = JWeRef(FakeBase(), ref_root, mixed_ratio=mixed_ratio, **kw)
    assert t.ref_infos == j.ref_infos
    assert len(t) == len(j) == 3
    for i in range(32):
        # img0 succeeds, img1 has no tags, img2 and img3 have no entry
        idx = i % 4
        _same(t.sample(idx), j.sample(idx))
        assert t.error_ids == j.error_ids
        assert t.success_ids == j.success_ids
        assert t.rng.bit_generator.state == j.rng.bit_generator.state
        if t.neg_queue is not None:
            assert t.neg_queue.queue == j.neg_queue.queue
    if mixed_ratio > 0:
        assert t.error_ids and t.success_ids


def test_error_tag_and_boxes(ref_root):  # noqa: F811
    """The ERROR -> ["object"] rewrite and xywh -> xyxy of sam2_bbox and
    bbox."""
    for sam, box in ((True, [2, 2, 6, 6]), (False, [1, 1, 5, 5])):
        ds = TWeRef(FakeBase(), ref_root, mixed_ratio=1.0, use_sam_box=sam,
                    use_negative_queue=False)
        s = ds.sample(0)
        np.testing.assert_array_equal(s["gt_bboxes"][0], box)
        assert s["texts"] == ["红色的狗", "object"]
        assert s["gt_labels"].tolist() == [0, 1]
