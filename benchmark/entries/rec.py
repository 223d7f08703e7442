"""Entry: referring-expression comprehension (REC), WeDetect-Uni
proposals scored by WeDetect-Ref.

A call takes a batch of images of one size, one query each (the RefCOCO
protocol), as `infer_wedetect_ref` does for one: WeDetect-Uni
(`Detector.__call__`, the prompt bank, the yolov5 letterbox) gives
each image's detections, whose top `proposals` feed
`RefScorer.rec_logits` with the grid buckets and query batch of the
configuration (`eval_grounding --grid-tokens 256 --batch-queries 16
--bf16`), so one call is one fused REC step. Its items are queries.

Set-up: the Uni detector as in `entries/detect.py` (seeded weights,
the head calibrated by the plain reference); the Ref's seeded weights
at the port's init scales, drawn in bf16 on the device and loaded into
the port's RefModules; a stub tokenizer (one id a character).

The check: the Uni reference judges every Uni answer of the sampled
calls (benchmark/reference/compare_det.py, the numbers prefixed
`uni_`), and the Ref reference (benchmark/reference/qwen3vl.py) scores
each item's chat -- worked out again from the image, the query and the
program's proposals -- for `rec_logit_gap`, the largest distance of a
program logit from the reference's.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
from torch import nn

from benchmark import weights as Wt
from benchmark.entries import detect as D
from benchmark.reference import detector as R
from benchmark.reference import no_tf32
from benchmark.reference import qwen3vl as Q
from benchmark.reference.compare_det import compare_images, \
    reference_answers
from benchmark.reference.lowp import fp8_operands

QUERY_TEMPLATE = 'Please detect the "%s" in the image'
CHECK_BLOCK = 4


class CharTok:
    """Stub tokenizer: one id a character, clear of Qwen's special ids
    (151643 and up)."""

    def encode(self, text, add_special_tokens=False):
        return [1000 + ord(ch) % 5000 for ch in text]


def ref_cfg(conf: dict) -> Q.RefCfg:
    v, t = conf["vision"], conf["text"]
    return Q.RefCfg(
        vision=Q.VisionCfg(**{k: tuple(x) if isinstance(x, list) else x
                              for k, x in v.items()}),
        text=Q.TextCfg(**{k: tuple(x) if isinstance(x, list) else x
                          for k, x in t.items()}),
        **conf["token_ids"])


def ref_init_rule(mname, m, pname, t):
    """The port's Ref init (wedetect_tpu_torch/models/ref.py
    `_init_draws`), at its scales: LeCun-normal Linear and Conv3d
    weights, the transposed convolutions at a fan-in of 2 * in * out,
    token embeddings N(0, 1 / hidden), the ViT position table N(0,
    0.02), unit norm scales, zero biases, and out_proj's prior bias
    -log(0.99 / 0.01)."""
    if pname == "bias":
        return ("const", -math.log(0.99 / 0.01) if mname == "out_proj"
                else 0.0)
    if isinstance(m, nn.ConvTranspose2d):
        return ("normal", Wt.lecun_std(2 * m.in_channels * m.out_channels))
    if isinstance(m, (nn.Linear, nn.Conv3d)):
        return ("normal", Wt.lecun_std(t[0].numel()))
    if isinstance(m, nn.Embedding):
        return ("normal", 0.02 if mname.endswith("pos_embed")
                else m.embedding_dim ** -0.5)
    return ("const", 1.0)


def make_ref_weights(rc: Q.RefCfg, seed: int, dev) -> dict:
    with torch.device("meta"):
        tree = Q.RefReference(rc)
    return Wt.materialize(Wt.plan(tree, ref_init_rule), seed, dev,
                          dtype=torch.bfloat16)


def ref_seeds(seed: int) -> dict:
    s = D.seeds(seed)
    s["ref"] = 4 * seed + 3
    return s


def prefix_ids(tok, rc: Q.RefCfg, n_img: int):
    return (tok.encode("<|im_start|>user\n") + [rc.vision_start_token_id]
            + [rc.image_token_id] * n_img + tok.encode("<|vision_end|>"))


def suffix_ids(tok, rc: Q.RefCfg, query: str, n_obj: int):
    return (tok.encode(QUERY_TEMPLATE % query)
            + tok.encode("<|im_end|>\n<|im_start|>assistant\n")
            + [rc.object_token_id] * n_obj + tok.encode("<|im_end|>\n"))


def prep_boxes(boxes, w, h, n_pad):
    """Proposals clipped to the image, padded to n_pad by repeating the
    last (the scorer's layout; the pad slots' logits are not read)."""
    b = np.array(boxes, np.float32).reshape(-1, 4)[:n_pad]
    b[:, 0::2] = np.clip(b[:, 0::2], 0, w)
    b[:, 1::2] = np.clip(b[:, 1::2], 0, h)
    n = len(b)
    last = b[-1:] if n else np.array([[0, 0, 1, 1]], np.float32)
    return np.concatenate([b, np.tile(last, (n_pad - n, 1))]), n


def resize_bicubic(img: np.ndarray, hb: int, wb: int) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize(
        (wb, hb), Image.Resampling.BICUBIC))


class RecSession:
    trace_calls = 4

    def __init__(self, cell, uni, scorer, traffic, dev, info):
        self.cell, self.uni, self.scorer = cell, uni, scorer
        self.traffic, self.dev, self.info = traffic, dev, info
        self.n_prop = info["proposals"]

    def call(self, i):
        j = i % len(self.traffic.images)
        images, queries = self.traffic.images[j], self.traffic.queries[j]
        props = self.uni(images)
        samples = [(im, p["bboxes"][:self.n_prop], q)
                   for im, p, q in zip(images, props, queries)]
        return len(images), (props, self.scorer.rec_logits(samples))

    def warmup(self):
        # one call of each image size of the mix (each a grid bucket)
        seen = set()
        for j, shapes in enumerate(self.traffic.shapes):
            if shapes[0] not in seen:
                seen.add(shapes[0])
                self.call(j)

    def check_sample(self, rng):
        n = len(self.traffic.images)
        c = min(self.cell.spec["check_calls"], n)
        pool = rng.choice(n, c, replace=False)
        return set(int(p + n * rng.integers(0, 2)) for p in pool)

    def inputs_of(self, i):
        j = i % len(self.traffic.images)
        return self.traffic.images[j], self.traffic.queries[j]

    def _stages(self, stack, wrap):
        from wedetect_tpu_torch.models.ref import RefModules

        for name in ("prefix_stage_batch", "suffix_stage"):
            span = "rec_prefix" if name.startswith("prefix") else "rec_suffix"
            stack.enter_context(D.patched(RefModules, name,
                                          lambda f, s=span: wrap(s, f)))
        stack.enter_context(D.patched(self, "uni",
                                      lambda f: wrap("rec_uni", f)))

    @contextlib.contextmanager
    def spans(self):
        from wedetect_tpu_torch.ops import flash_attention as fa
        from wedetect_tpu_torch.ops import flash_gqa as fg

        rec = D.SpanRecorder()
        dev = self.dev
        with contextlib.ExitStack() as stack:
            self._stages(stack, lambda s, f: D.timed(rec, s, dev, f))
            stack.enter_context(D.patched(fg, "gqa_flash_fwd_sm90",
                                          lambda f: k2_counter(rec, f)))
            stack.enter_context(D.patched(fa, "flash_attention_fwd_sm90",
                                          lambda f: k3_counter(rec, f)))
            stack.enter_context(D.patched(
                self, "call", lambda f: self._counted(rec, f)))
            yield rec

    def _counted(self, rec, fn):
        def run(i):
            rec.count("calls", 1)
            items, out = fn(i)
            rec.count("items", items)
            return items, out
        return run

    def ranges(self):
        stack = contextlib.ExitStack()
        self._stages(stack, D.ranged)
        return stack

    def close(self):
        self.uni = self.scorer = None


def k2_counter(rec, fn):
    """K2's least time at each launch's own shapes, summed
    (benchmark/peaks.attn_bound_s): the visible pairs are the
    (query, key) pairs of valid query rows (end-aligned causal) whose
    key is valid."""
    from benchmark.peaks import BF16_OPS_PER_S, attn_bound_s

    def run(q, k, v, kv_valid, causal, sm_scale):
        b, s, h, d = q.shape
        lk, kvh = k.shape[1], k.shape[2]
        valid = kv_valid.to(torch.int64)
        off = lk - s
        if causal:
            reach = valid.cumsum(1)[:, off:]
        else:
            reach = valid.sum(1, keepdim=True).expand(b, s)
        rows = valid[:, off:]
        pairs = int((rows * reach).sum())
        nq = int(rows.sum())
        nk = int(valid.sum())
        rec.count("k2_launches", 1)
        rec.count("k2_bound_s", attn_bound_s(
            h, d, pairs, nq * h * d + 2 * nk * kvh * d, nq * h * d, nq * h,
            q.element_size(), BF16_OPS_PER_S))
        return fn(q, k, v, kv_valid, causal, sm_scale)
    return run


def k3_counter(rec, fn):
    """K3's least time at each launch's own shapes, summed: the ViT's
    pairs of real tokens (segment ids 0 mark pad tokens)."""
    from benchmark.peaks import BF16_OPS_PER_S, attn_bound_s

    def run(q, k, v, q_seg=None, kv_seg=None, causal=False, sm_scale=1.0):
        b, l, h, d = q.shape
        real = (torch.full((b,), l, device=q.device) if q_seg is None
                else (q_seg != 0).sum(1))
        pairs = int((real.to(torch.int64) ** 2).sum())
        n = int(real.sum())
        rec.count("k3_launches", 1)
        rec.count("k3_bound_s", attn_bound_s(
            h, d, pairs, 3 * n * h * d, n * h * d, n * h,
            q.element_size(), BF16_OPS_PER_S))
        return fn(q, k, v, q_seg, kv_seg, causal, sm_scale)
    return run


def setup(cell, seed, device, phases, faults, traffic, **_):
    conf = cell.config
    uni_m, test = conf["uni"]["model"], conf["uni"]["test"]
    prompts = conf["uni"]["num_prompts"]
    dev = device
    s = ref_seeds(seed)
    with phases("traffic"):
        tr = traffic.make(cell.traffic, s["images"], dev)
    rcu = D.ref_cfg(uni_m, test, prompts)
    rc = ref_cfg(conf["ref"])
    with phases("weights"):
        usd = D.make_weights(rcu, s["weights"], dev)
        rsd = make_ref_weights(rc, s["ref"], dev)
    with phases("reference"):
        cands = conf["uni"]["calibration"]["candidates_per_image"]
        calib = D.calibrate(rcu, usd, [im for c in tr.images for im in c],
                            "yolov5", dev, None, cands)
    with phases("build"):
        from wedetect_tpu_torch.data.vision_process import make_grid_buckets
        from wedetect_tpu_torch.models.api import Detector
        from wedetect_tpu_torch.models.ref import RefModules
        from wedetect_tpu_torch.models.ref_api import RefScorer
        from wedetect_tpu_torch.nn.qwen3vl import RefCfg, RefTextCfg, \
            RefVisionCfg

        ucfg = D.port_cfg(uni_m, test, prompts, prompts)
        uni = Detector(cfg=ucfg, model=D.build_port(ucfg, usd, dev),
                       preproc="yolov5")
        del usd
        pcfg = RefCfg(vision=RefVisionCfg(**_tuples(conf["ref"]["vision"])),
                      text=RefTextCfg(**_tuples(conf["ref"]["text"])),
                      **conf["ref"]["token_ids"])
        with torch.device("meta"):
            model = RefModules(pcfg)
        model = model.to_empty(device=dev)
        model.load_state_dict(rsd, strict=True)
        del rsd
        sc = conf["scorer"]
        buckets = tuple(make_grid_buckets(
            sc["grid_tokens"], pcfg.vision.patch * pcfg.vision.merge))
        scorer = RefScorer(cfg=pcfg, model=model.eval(), tokenizer=CharTok(),
                           grid_buckets=buckets,
                           query_batch=sc["query_batch"],
                           max_proposals=sc["proposals"], dtype=sc["dtype"],
                           device=dev)
        if dev.type == "cuda":
            from wedetect_tpu_torch.ops import _build

            for lib in ("row_topk", "flash_gqa_sm90", "flash_attn_sm90"):
                _build.load(lib)
    faults.get("program", lambda d: d)(uni)
    faults.get("ref", lambda m: m)(model)
    info = {"uni": uni_m, "test": test, "prompts": prompts,
            "ref": conf["ref"], "scorer": sc, "calibration": calib,
            "batch": cell.traffic["batch"], "proposals": sc["proposals"],
            "call_items": call_items(rc, sc, tr)}
    return D.with_faults(RecSession(cell, uni, scorer, tr, dev, info), faults)


def chat_shape(rc: Q.RefCfg, sc: dict, h: int, w: int, query: str):
    """(bucket height, width, its merged grid rows, columns, the chat's
    length) of an h x w image and its query."""
    factor = rc.vision.patch * rc.vision.merge
    hb, wb = Q.snap(h, w, Q.grid_buckets(sc["grid_tokens"], factor))
    mh, mw = hb // factor, wb // factor
    tok = CharTok()
    seq = (len(prefix_ids(tok, rc, mh * mw))
           + len(suffix_ids(tok, rc, query, sc["proposals"])))
    return hb, wb, mh, mw, seq


def call_items(rc: Q.RefCfg, sc: dict, tr):
    """Every pool call's items as (ViT grid rows, columns, chat length),
    for the FLOP count."""
    out = []
    for shapes, queries in zip(tr.shapes, tr.queries):
        items = []
        for (h, w), q in zip(shapes, queries):
            hb, wb, _, _, seq = chat_shape(rc, sc, h, w, q)
            items.append((hb // rc.vision.patch, wb // rc.vision.patch, seq))
        out.append(items)
    return out


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def uni_reference(ctx):
    """(config, the Uni reference model), its weights made again from
    the seed with the calibration worked out at set-up."""
    info = ctx["info"]
    rcu = D.ref_cfg(info["uni"], info["test"], info["prompts"])
    usd = D.make_weights(rcu, ref_seeds(ctx["seed"])["weights"],
                         ctx["device"])
    D.apply_calibration(usd, len(rcu.strides), *info["calibration"][:2])
    return rcu, D.reference_model(rcu, usd, ctx["device"])


def ref_reference(ctx):
    """(config, the Ref reference model in float32), its weights made
    again from the seed."""
    rc = ref_cfg(ctx["info"]["ref"])
    rsd = make_ref_weights(rc, ref_seeds(ctx["seed"])["ref"], ctx["device"])
    with torch.device("meta"):
        ref = Q.RefReference(rc)
    ref = ref.to_empty(device=ctx["device"])
    ref.load_state_dict({k: v.float() for k, v in rsd.items()}, strict=True)
    return rc, ref.eval()


def check(ctx, inputs, outputs):
    dev, info = ctx["device"], ctx["info"]
    images, queries, props, logits = [], [], [], []
    for i in sorted(outputs):
        ims, qs = inputs[i]
        p, lg = outputs[i]
        images += list(ims)
        queries += list(qs)
        props += list(p)[:len(ims)] + [None] * (len(ims) - len(p))
        lg = list(lg)[:len(ims)]
        logits += lg + [None] * (len(ims) - len(lg))
    rcu, uref = uni_reference(ctx)
    out = {f"uni_{k[4:] if k.startswith('det_') else k}": v
           for k, v in compare_images(uref, rcu, images, props, None,
                                      "yolov5", dev, CHECK_BLOCK).items()}
    del uref
    rc, ref = ref_reference(ctx)
    out.update(rec_gaps(ref, rc, info, images, queries, props, logits,
                        dev))
    return out


def control(ctx, inputs):
    """The control's answers to the sampled calls: the Uni and Ref
    references in fp8 (benchmark/reference/lowp.py) in the program's
    place, the Ref scoring the fp8 Uni's proposals."""
    dev, info = ctx["device"], ctx["info"]
    rcu, uref = uni_reference(ctx)
    with fp8_operands(uref, (R.ContrastiveScore,)):
        props = {i: reference_answers(uref, rcu, list(inputs[i][0]), None,
                                      "yolov5", dev, CHECK_BLOCK)
                 for i in sorted(inputs)}
    del uref
    rc, ref = ref_reference(ctx)
    out = {}
    with fp8_operands(ref, attention_owner=Q):
        for i in sorted(inputs):
            ims, qs = inputs[i]
            out[i] = (props[i], [
                ref_logits(ref, rc, info, im, q, p).cpu().numpy()
                for im, q, p in zip(ims, qs, props[i])])
    return out


def ref_logits(ref, rc: Q.RefCfg, info, im, q, p) -> torch.Tensor:
    """The reference's logits of one item's chat, laid out again from
    the image, the query and the proposals p (an answer dict): one a
    proposal, at most `proposals`."""
    sc = info["scorer"]
    n_pad = sc["proposals"]
    dev = next(ref.parameters()).device
    h, w = im.shape[:2]
    hb, wb, mh, mw, _ = chat_shape(rc, sc, h, w, q)
    boxes, n = prep_boxes(p["bboxes"][:n_pad], w, h, n_pad)
    tok = CharTok()
    ids = np.array(prefix_ids(tok, rc, mh * mw)
                   + suffix_ids(tok, rc, q, n_pad), np.int64)
    pos = Q.rope_index(ids, rc.image_token_id, mh, mw)
    pixels = torch.as_tensor(np.array(resize_bicubic(im, hb, wb)),
                             device=dev)
    with torch.inference_mode(), no_tf32():
        return ref(pixels, torch.as_tensor(ids, device=dev),
                   torch.as_tensor(pos, device=dev),
                   torch.as_tensor(boxes, device=dev), (w, h))[:n]


def rec_gaps(ref, rc: Q.RefCfg, info, images, queries, props, logits, dev):
    """The reference's logits of every item's chat, each program logit
    held to its proposal's: the largest and the mean distance (the
    cell's limits hold these two), the mean over queries of a query's
    mean offset and the offset over them all (recorded), and the
    queries with no readable answer."""
    gap, total, shifts, signed = 0.0, 0.0, 0.0, 0.0
    items = count = missing = 0
    for im, q, p, lg in zip(images, queries, props, logits):
        if p is None or lg is None:
            missing += 1
            continue
        want = ref_logits(ref, rc, info, im, q, p)
        got = torch.as_tensor(np.asarray(lg, np.float32), device=dev)
        if got.shape != want.shape or not torch.isfinite(got).all():
            missing += 1
            continue
        diff = got - want
        gap = max(gap, float(diff.abs().max()))
        total += float(diff.abs().sum())
        shifts += float(diff.mean().abs())
        signed += float(diff.sum())
        count += len(diff)
        items += 1
    return {"rec_items": items, "rec_missing": missing,
            "rec_logit_gap": gap,
            "rec_logit_gap_mean": total / max(count, 1),
            "rec_logit_shift_mean": shifts / max(items, 1),
            "rec_logit_bias": abs(signed) / max(count, 1)}
