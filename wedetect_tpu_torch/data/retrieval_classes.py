"""Canonical retrieval class-name tables (COCO 80 / LVIS 1203, zh+en).

Data artifact reproducing the reference's embedded tables —
eval_retrieval/extract_embedding.py:1324-1587 ``ds_collections``
``name_chinese``/``name_english`` — shipped as JSON data
(retrieval_classes.json) instead of hardcoded source. The retrieval
protocol scores proposals against the CHINESE names through the XLM-R
text tower (extract_embedding.py:1706-1713 encodes ``name_chinese`` in
80-name batches and L2-normalizes), so drop-in protocol parity needs
these exact strings; the English table is the paired reporting
vocabulary. Tables must match the reference by definition (a data
mapping, like the checkpoint key-map schema in ckpt/convert.py). A copy of
`wedetect_tpu.data.retrieval_classes`, with its own copy of the JSON.
"""

from __future__ import annotations

import functools
import json
import os

CLASS_SETS = ("coco", "lvis")


@functools.lru_cache(maxsize=None)
def _tables():
    path = os.path.join(os.path.dirname(__file__),
                        "retrieval_classes.json")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_retrieval_classes(class_set: str, lang: str = "zh"):
    """The canonical class-name list for ``class_set`` ("coco" or
    "lvis") in ``lang`` ("zh" — the scoring protocol's language — or
    "en"). Returns a list of strings in category order."""
    tables = _tables()
    if class_set not in tables:
        raise KeyError(f"unknown class set {class_set!r}; "
                       f"have {sorted(tables)}")
    if lang not in tables[class_set]:
        raise KeyError(f"unknown language {lang!r}; "
                       f"have {sorted(tables[class_set])}")
    return list(tables[class_set][lang])
