"""Entry: open-vocabulary detection through `Detector.__call__`.

Set-up: the configuration's detector is built on the meta device
(the port's module tree), seeded weights at the port's init scales are
made on the device (`benchmark/weights.py`), the plain reference
calibrates the head on a few of the traffic's images (a trained
checkpoint's sparse score profile, so the selection takes the path it
takes in deployment), and the weights load into the port through its
checkpoint loader (`ckpt/convert.load_into`). The vocabulary's class
embeddings are seeded unit vectors, loaded as a deployment loads the
text tower's output: `Detector.reparameterize(names, embeds=...)`.

A call is one `Detector.__call__` on a batch of the traffic's images;
its items are images. The check runs the plain reference
(`benchmark/reference/detector.py`) on the sampled calls' images and
holds the port's answers to it (`benchmark/reference/compare_det.py`).
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch
from torch import nn

from benchmark import weights as Wt
from benchmark.reference import detector as R
from benchmark.reference import no_tf32
from benchmark.reference.compare_det import compare_images, \
    reference_answers
from benchmark.reference.letterbox import letterbox
from benchmark.reference.lowp import fp8_operands

# the per-anchor row top-k width of the port's selection (ops/nms)
ROW_T = 64
# a logit margin below the threshold for the 64th best class of the
# calibration images' highest anchor (the program's bf16 logits move by
# a tenth of it) keeps the selection on its sparse path
CALIB_MARGIN = 0.5
CALIB_IMAGES = 16
CHECK_BLOCK = 4


def ref_cfg(model: dict, test: dict, num_prompts: int = 0) -> R.DetCfg:
    return R.DetCfg(
        depths=tuple(model["depths"]), dims=tuple(model["dims"]),
        neck_scale=model["neck_scale"], neck_repeats=model["neck_repeats"],
        embed_dims=model["embed_dims"], reg_max=model["reg_max"],
        strides=tuple(model["strides"]), cls_hidden=model["cls_hidden"],
        reg_hidden=model["reg_hidden"], img_size=tuple(model["img_size"]),
        num_prompts=num_prompts, score_thr=test["score_thr"],
        nms_pre=test["nms_pre"], nms_iou_thr=test["nms_iou_thr"],
        max_per_img=test["max_per_img"])


def init_rule(mname, m, pname, t):
    """The port's init (wedetect_tpu_torch/nn/init.py), by module kind:
    LeCun-normal conv and linear weights, zero biases, unit norms, BN
    statistics 0 / 1, layer scale 1e-6, BottleRep alpha 1, contrastive
    bias 0 and logit_scale -1, the Uni prompt bank normal (then
    L2-normalised)."""
    if isinstance(m, R.ConvNeXtBlock) and pname == "gamma":
        return ("const", 1e-6)
    if isinstance(m, R.BottleRep) and pname == "alpha":
        return ("const", 1.0)
    if isinstance(m, R.ContrastiveScore):
        return ("const", -1.0 if pname == "logit_scale" else 0.0)
    if isinstance(m, R.Detector) and pname == "embeddings":
        return ("normal", 1.0)
    if pname == "weight" and isinstance(m, nn.ConvTranspose2d):
        return ("normal", Wt.lecun_std(t.shape[0]))
    if pname == "weight" and isinstance(m, (nn.Conv2d, nn.Linear)):
        return ("normal", Wt.lecun_std(t[0].numel()))
    if pname in ("weight", "running_var"):
        return ("const", 1.0)
    return ("const", 0.0)


def make_weights(rc: R.DetCfg, seed: int, dev) -> dict:
    with torch.device("meta"):
        tree = R.Detector(rc)
    sd = Wt.materialize(Wt.plan(tree, init_rule), seed, dev)
    if "embeddings" in sd:
        e = sd["embeddings"]
        e /= torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    return sd


def reference_model(rc: R.DetCfg, sd: dict, dev) -> R.Detector:
    with torch.device("meta"):
        ref = R.Detector(rc)
    ref = ref.to_empty(device=dev)
    ref.load_state_dict(sd, strict=True)
    return ref.eval()


def apply_calibration(sd: dict, levels: int, scale: float, shift: float):
    for i in range(levels):
        sd[f"bbox_head.cls_contrasts.{i}.logit_scale"] += scale
        sd[f"bbox_head.cls_contrasts.{i}.bias"] += shift


def class_embeds(k: int, dims: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    e = torch.randn((k, dims), generator=g, device=dev)
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


def seeds(seed: int) -> dict:
    """Independent generator seeds for each thing a run draws."""
    return {"weights": 4 * seed, "embeds": 4 * seed + 1,
            "images": 4 * seed + 2}


def port_cfg(model: dict, test: dict, k: int, num_prompts: int = 0):
    """The port's ModelCfg of the configuration's preset with every size
    of its file."""
    from wedetect_tpu_torch.configs import TestCfg, get_config

    name = f"uni_{model['size']}" if num_prompts else model["size"]
    kw = {key: tuple(v) if isinstance(v, list) else v
          for key, v in model.items() if key != "size"}
    kw.update(test=TestCfg(**test))
    if num_prompts:
        return get_config(name, num_prompts=num_prompts, **kw)
    return get_config(name, num_classes=k, **kw)


def build_port(cfg, sd: dict, dev):
    from wedetect_tpu_torch.ckpt.convert import load_into
    from wedetect_tpu_torch.models.wedetect import WeDetectModule

    with torch.device("meta"):
        model = WeDetectModule(cfg)
    return load_into(model.to_empty(device=dev), sd).eval()


def calibrate(rc, sd, images, flavor, dev, embeds, candidates):
    """The calibration of the reference's head on the traffic's first
    CALIB_IMAGES images (the pixels are noise, alike in every image):
    the logit scale that spreads the classes as a trained head does,
    then the bias that leaves `candidates` (anchor, class) pairs an image
    (the configuration's `calibration`, an assumption it explains)
    above the score threshold -- or fewer, where that would give an
    anchor ROW_T of them (with CALIB_MARGIN to spare). Every seed so
    sends NMS the same amount of work, on the selection's sparse path.
    Returns (scale, shift, candidates an image) and applies the first
    two to sd."""
    ref = reference_model(rc, sd, dev)
    images = images[:CALIB_IMAGES]
    scale, kth, tops = None, float("-inf"), []
    for st in range(0, len(images), CHECK_BLOCK):
        boxed = np.stack([letterbox(im, rc.img_size, flavor)[0]
                          for im in images[st:st + CHECK_BLOCK]])
        with torch.inference_mode(), no_tf32():
            logits, _, _ = ref(torch.as_tensor(boxed, device=dev), embeds)
        if scale is None:
            scale = R.logit_scale_step(logits)
        kth = max(kth, R.max_kth_logit(logits, scale, ROW_T))
        tops.append(torch.topk(logits.flatten() * math.exp(scale),
                               candidates * len(boxed)).values)
    del ref, logits
    nth = float(torch.cat(tops).topk(candidates * len(images)).values[-1])
    shift = min(R.bias_step(kth, rc.score_thr, CALIB_MARGIN),
                R.bias_step(nth, rc.score_thr, 0.0))
    thr = math.log(rc.score_thr / (1 - rc.score_thr)) - shift
    kept = float((torch.cat(tops) > thr).sum()) / len(images)
    apply_calibration(sd, len(rc.strides), scale, shift)
    return scale, shift, kept


class SpanRecorder:
    def __init__(self):
        self.spans = {}
        self.counters = {}

    def add(self, name, ms):
        self.spans.setdefault(name, []).append(ms)

    def count(self, name, v):
        self.counters[name] = self.counters.get(name, 0) + v


@contextlib.contextmanager
def patched(obj, name, wrapper):
    """obj.name replaced by wrapper(obj.name) for the block. A launch
    counter the original keeps on itself (`fn.launches`, which the
    program increments through the module's name) moves to the wrapper
    and back, so the program's counts stay whole."""
    saved = getattr(obj, name)
    new = wrapper(saved)
    if hasattr(saved, "launches"):
        new.launches = saved.launches
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, saved)
        if hasattr(saved, "launches"):
            saved.launches = new.launches


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(rec, span, dev, fn):
    """fn with the device synchronised before and after, its wall ms
    added to span."""
    def run(*a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(dev)
        rec.add(span, (time.perf_counter() - t0) * 1e3)
        return out
    return run


def host_timed(rec, span, fn):
    def run(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        rec.add(span, (time.perf_counter() - t0) * 1e3)
        return out
    return run


def ranged(name, fn):
    def run(*a, **kw):
        with torch.profiler.record_function(f"bench.{name}"):
            return fn(*a, **kw)
    return run


def det_stage_patches(stack, wrap, rec_k1=None):
    """Wrap the stages of Detector.__call__: the letterbox (host), the
    network (WeDetectModule.forward), decode + selection + NMS
    (decode_outputs, postprocess), by `wrap(stage, fn)`."""
    from wedetect_tpu_torch.models import api
    from wedetect_tpu_torch.models import wedetect as W
    from wedetect_tpu_torch.ops import nms

    for fname in ("preprocess_image", "yolov5_letterbox"):
        stack.enter_context(patched(api, fname,
                                    lambda f: wrap("det_prep", f)))
    stack.enter_context(patched(W.WeDetectModule, "forward",
                                lambda f: wrap("det_network", f)))
    for fname in ("decode_outputs", "postprocess"):
        stack.enter_context(patched(W, fname, lambda f: wrap("det_post", f)))
    if rec_k1 is not None:
        stack.enter_context(patched(nms, "row_topk", rec_k1))


def k1_counter(rec):
    """Count K1's launches and its input's rows by branch (no
    candidate, 1..t, more than t), the call's own scores."""
    def wrap(fn):
        def run(x, t, *a, **kw):
            n = (x > float("-inf")).sum(dim=1)
            rec.count("k1_launches", 1)
            rec.count("k1_rows", x.shape[0])
            rec.counters["k1_k"] = x.shape[1]
            rec.counters["k1_t"] = t
            rec.count("k1_empty", int((n == 0).sum()))
            rec.count("k1_sparse", int(((n > 0) & (n <= t)).sum()))
            rec.count("k1_dense", int((n > t).sum()))
            return fn(x, t, *a, **kw)
        return run
    return wrap


class DetectSession:
    trace_calls = 6

    def __init__(self, cell, det, traffic, dev, info):
        self.cell, self.det, self.traffic, self.dev = cell, det, traffic, dev
        self.info = info

    def call(self, i):
        images = self.traffic.images[i % len(self.traffic.images)]
        return len(images), self.det(images)

    def warmup(self):
        for i in range(min(2, len(self.traffic.images))):
            self.call(i)

    def check_sample(self, rng):
        n = len(self.traffic.images)
        c = min(self.cell.spec["check_calls"], n)
        pool = rng.choice(n, c, replace=False)
        return set(int(p + n * rng.integers(0, 2)) for p in pool)

    def inputs_of(self, i):
        return self.traffic.images[i % len(self.traffic.images)]

    @contextlib.contextmanager
    def spans(self):
        rec = SpanRecorder()
        dev = self.dev
        with contextlib.ExitStack() as stack:
            det_stage_patches(
                stack, lambda s, f: (host_timed(rec, s, f) if s == "det_prep"
                                     else timed(rec, s, dev, f)),
                k1_counter(rec))
            stack.enter_context(patched(
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
        det_stage_patches(stack, ranged)
        return stack

    def close(self):
        self.det = None


def setup(cell, seed, device, phases, faults, traffic, **_):
    model, test = cell.config["model"], cell.config["test"]
    dev = device
    s = seeds(seed)
    with phases("traffic"):
        tr = traffic.make(cell.traffic, s["images"], dev)
    k = tr.vocabulary
    rc = ref_cfg(model, test)
    with phases("weights"):
        sd = make_weights(rc, s["weights"], dev)
        embeds = class_embeds(k, rc.embed_dims, s["embeds"], dev)
    with phases("reference"):
        cands = cell.config["calibration"]["candidates_per_image"]
        calib = calibrate(rc, sd, [im for c in tr.images for im in c],
                          "pipeline", dev, embeds, cands)
    with phases("build"):
        from wedetect_tpu_torch.models.api import Detector

        cfg = port_cfg(model, test, k)
        det = Detector(cfg=cfg, model=build_port(cfg, sd, dev),
                       preproc="pipeline")
        det.reparameterize([f"class_{i}" for i in range(k)], embeds=embeds)
        del sd
        if dev.type == "cuda" and k * cfg.num_anchors >= 1 << 21:
            from wedetect_tpu_torch.ops import _build

            _build.load("row_topk")
    faults.get("program", lambda d: d)(det)
    info = {"model": model, "test": test, "vocabulary": k,
            "calibration": calib, "batch": cell.traffic["batch"],
            "img_size": rc.img_size}
    return with_faults(DetectSession(cell, det, tr, dev, info), faults)


def with_faults(session, faults):
    """The session with a test's planted fault: faults["call"](call, i)
    in place of each call (faults["program"], and in REC faults["ref"],
    already ran on the program)."""
    if "call" in faults:
        call = session.call
        session.call = lambda i: faults["call"](call, i)
    return session


def reference_of(ctx):
    """(config, the reference model, its class embeddings), the weights
    made again from the seed with the calibration that the reference
    worked out at set-up."""
    seed, dev, info = ctx["seed"], ctx["device"], ctx["info"]
    rc = ref_cfg(info["model"], info["test"])
    s = seeds(seed)
    sd = make_weights(rc, s["weights"], dev)
    embeds = class_embeds(info["vocabulary"], rc.embed_dims, s["embeds"],
                          dev)
    apply_calibration(sd, len(rc.strides), *info["calibration"][:2])
    return rc, reference_model(rc, sd, dev), embeds


def check(ctx, inputs, outputs):
    """The reference over the sampled calls' images: the worst gaps of
    the port's answers (benchmark/reference/compare_det.py)."""
    rc, ref, embeds = reference_of(ctx)
    images, answers = flatten(inputs, outputs)
    return compare_images(ref, rc, images, answers, embeds, "pipeline",
                          ctx["device"], CHECK_BLOCK)


def control(ctx, inputs):
    """The control's answers to the sampled calls: the reference in fp8
    (benchmark/reference/lowp.py) in the program's place."""
    rc, ref, embeds = reference_of(ctx)
    with fp8_operands(ref, (R.ContrastiveScore,)):
        return {i: reference_answers(ref, rc, list(inputs[i]), embeds,
                                     "pipeline", ctx["device"], CHECK_BLOCK)
                for i in sorted(inputs)}


def flatten(inputs, outputs):
    """The sampled calls' images and answers, in call order; a call that
    answered fewer images than it was sent gets None for the rest."""
    images, answers = [], []
    for i in sorted(outputs):
        images += list(inputs[i])
        got = list(outputs[i])[:len(inputs[i])]
        answers += got + [None] * (len(inputs[i]) - len(got))
    return images, answers
