// COCO greedy matcher — the hot inner loops of bbox evaluation.
//
// Native (C++) implementation of the per-(image, class) detection->gt
// matching used by wedetect_tpu_torch.eval.coco_map.CocoEvaluator
// (COCOeval-compatible semantics: detections in score order, each
// takes the unmatched gt with highest IoU above the threshold; crowd
// gts can absorb multiple detections; once a non-ignored match is
// found, ignored gts are not considered). A copy of
// wedetect_tpu/native/coco_match.cc.
//
// The evaluator calls this through ctypes (see
// wedetect_tpu_torch/native/__init__.py); its plain Python version,
// eval/coco_map.coco_match_python, runs only when asked for
// (CocoEvaluator(..., matcher="python")).

#include <cstdint>

extern "C" {

// iou:    nd x ng row-major
// gt_ig:  ng    (1 = ignored for this area range)
// crowd:  ng    (1 = crowd gt, may match many detections)
// thrs:   nt IoU thresholds
// dtm:    nt x nd output, gt index matched per detection or -1
// gtm:    nt x ng output, det index matched per gt or -1
void coco_match(const double* iou, int nd, int ng,
                const uint8_t* gt_ig, const uint8_t* crowd,
                const double* thrs, int nt,
                int64_t* dtm, int64_t* gtm) {
  for (int t = 0; t < nt; ++t) {
    int64_t* dtm_t = dtm + (int64_t)t * nd;
    int64_t* gtm_t = gtm + (int64_t)t * ng;
    for (int d = 0; d < nd; ++d) dtm_t[d] = -1;
    for (int g = 0; g < ng; ++g) gtm_t[g] = -1;
    const double thr = thrs[t];
    for (int d = 0; d < nd; ++d) {
      double best = thr < (1.0 - 1e-10) ? thr : (1.0 - 1e-10);
      int bi = -1;
      const double* row = iou + (int64_t)d * ng;
      for (int g = 0; g < ng; ++g) {
        if (gtm_t[g] >= 0 && !crowd[g]) continue;
        if (bi > -1 && !gt_ig[bi] && gt_ig[g]) break;
        if (row[g] < best) continue;
        best = row[g];
        bi = g;
      }
      if (bi == -1) continue;
      dtm_t[d] = bi;
      gtm_t[bi] = d;
    }
  }
}

}  // extern "C"
