"""Object-retrieval evaluation over stored proposal embeddings.

Behavioral spec: reference eval_retrieval/retrieval_metric.py:14-47,
362-395 — per image: sigmoid(region_embed @ text_embed^T * e^scale
+ bias), max over proposals, threshold -> predicted image set per
class; per-class P/R/F1 vs gt image sets + macro average.

The scoring is one batched matmul over all stored embeddings, in
numpy: offline retrieval is host-side. A copy of
`wedetect_tpu.eval.retrieval`.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Set

import numpy as np


def score_image(embeddings: np.ndarray, text_embeds: np.ndarray,
                scale: np.ndarray, bias: np.ndarray) -> np.ndarray:
    """(P, C) proposal embeds x (K, C) text -> (K,) max-over-proposal
    sigmoid scores. scale/bias: per-proposal (P,) logit_scale (log
    space) and bias from the BN heads."""
    logits = embeddings @ text_embeds.T
    logits = logits * np.exp(scale)[:, None] + bias[:, None]
    probs = 1.0 / (1.0 + np.exp(-logits))
    return probs.max(axis=0) if len(probs) else np.zeros(
        text_embeds.shape[0])


def retrieval_metrics(image_results: Sequence[Dict],
                      text_embeds: np.ndarray,
                      class_names: Sequence[str],
                      gt_by_class: Mapping[str, Set[int]],
                      thr: float = 0.2) -> Dict[str, Dict[str, float]]:
    """image_results: [{image_id, embeddings (P,C), scale (P,),
    bias (P,)}]. Returns per-class P/R/F1 + 'macro' averages."""
    predictions: Dict[str, List[int]] = {n: [] for n in class_names}
    for r in image_results:
        probs = score_image(np.asarray(r["embeddings"]), text_embeds,
                            np.asarray(r["scale"]),
                            np.asarray(r["bias"]))
        for ci in np.nonzero(probs > thr)[0]:
            predictions[class_names[ci]].append(int(r["image_id"]))

    results: Dict[str, Dict[str, float]] = {}
    for name, gt_set in gt_by_class.items():
        if not gt_set:
            continue
        pred = set(predictions.get(name, []))
        tp = len(pred & gt_set)
        fp = len(pred - gt_set)
        fn = len(gt_set - pred)
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * p * r / (p + r) if p + r else 0.0
        results[name] = {"precision": round(p, 4), "recall": round(r, 4),
                         "f1": round(f1, 4), "support": len(gt_set),
                         "n_pred": len(pred)}
    if results:
        results["macro"] = {
            k: float(np.mean([r[k] for n, r in results.items()
                              if n != "macro"]))
            for k in ("precision", "recall", "f1")}
    return results
