"""High-level detector API: checkpoint in, detections out.

    det = Detector.from_torch_checkpoint("wedetect_base.pth", "base")
    det.reparameterize(["person", "dog"])        # text tower, once
    results = det(["img1.jpg", image_array])     # detect step

`Detector.from_jax_variables` takes the JAX package's variables (as
numpy) for side-by-side checks. Every constructor defaults to
`device="cuda"` and raises if no card is present.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from wedetect_tpu_torch import resolve_device
from wedetect_tpu_torch.configs import ModelCfg, TextCfg, get_config
from wedetect_tpu_torch.models import wedetect as W
from wedetect_tpu_torch.nn.init import init_module
from wedetect_tpu_torch.nn.xlmr import TextTower
from wedetect_tpu_torch.ops.letterbox import (preprocess_image,
                                              yolov5_letterbox)


def build_text_tower(cfg: TextCfg, device="cuda",
                     seed: Optional[int] = None) -> TextTower:
    """A TextTower on `device`: random from torch.Generator(seed), or
    uninitialized (to be loaded) when seed is None."""
    dev = resolve_device(device)
    with torch.device("meta"):
        tower = TextTower(cfg)
    if seed is None:
        return tower.to_empty(device=dev).eval()
    return init_module(tower, seed, dev)


def _build_detector(cfg: ModelCfg, device) -> W.WeDetectModule:
    with torch.device("meta"):
        model = W.WeDetectModule(cfg)
    return model.to_empty(device=resolve_device(device)).eval()


@dataclasses.dataclass
class Detector:
    cfg: ModelCfg
    model: W.WeDetectModule
    text_tower: Optional[TextTower] = None
    tokenizer_path: str = "xlm-roberta-base"
    _text_embeds: Optional[torch.Tensor] = None
    class_names: Optional[List[str]] = None
    # "pipeline" = mmdet two-stage cv2 flavor (infer_wedetect/test.py);
    # "yolov5" = the standalone scripts' letterbox (Uni's default)
    preproc: str = "pipeline"

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @classmethod
    def from_torch_checkpoint(cls, path: str, size: str = "base",
                              uni: bool = False, num_prompts: int = 256,
                              tokenizer_path: str = "xlm-roberta-base",
                              device="cuda", **cfg_kw) -> "Detector":
        from wedetect_tpu_torch.ckpt.convert import (canonicalize_torch_keys,
                                                     load_into,
                                                     load_torch_checkpoint)

        name = f"uni_{size}" if uni else size
        cfg = (get_config(name, num_prompts=num_prompts, **cfg_kw) if uni
               else get_config(name, **cfg_kw))
        canon = canonicalize_torch_keys(load_torch_checkpoint(path))
        model = load_into(_build_detector(cfg, device), canon)
        tower = None
        tm = "backbone.text_model."
        if cfg.text is not None and any(
                k.startswith(tm + "model.") for k in canon):
            # embedded text tower (extract_embedding.py:1293-1304)
            tsd = {k[len(tm + "model."):]: v for k, v in canon.items()
                   if k.startswith(tm + "model.")}
            for hk in ("head.weight", "head.bias"):
                if tm + hk in canon:
                    tsd[hk] = canon[tm + hk]
            tower = load_into(build_text_tower(cfg.text, device), tsd)
        return cls(cfg=cfg, model=model, text_tower=tower,
                   tokenizer_path=tokenizer_path,
                   preproc="yolov5" if uni else "pipeline")

    @classmethod
    def from_random(cls, size: str = "base", seed: int = 0,
                    device="cuda", **cfg_kw) -> "Detector":
        cfg = get_config(size, **cfg_kw)
        return cls(cfg=cfg, model=W.init_variables(cfg, seed, device),
                   preproc="yolov5" if size.startswith("uni")
                   else "pipeline")

    @classmethod
    def from_jax_variables(cls, variables: Mapping, cfg: ModelCfg,
                           text_params: Optional[Mapping] = None,
                           device="cuda",
                           preproc: str = "pipeline") -> "Detector":
        """From the JAX package's detector `variables` (and TextTower
        params), as numpy arrays."""
        from wedetect_tpu_torch.ckpt.convert import (from_jax_text_params,
                                                     from_jax_variables)

        model = _build_detector(cfg, device)
        model.load_state_dict(from_jax_variables(variables, cfg),
                              strict=True)
        tower = None
        if text_params is not None:
            tower = build_text_tower(cfg.text, device)
            tower.load_state_dict(from_jax_text_params(text_params,
                                                       cfg.text),
                                  strict=True)
        return cls(cfg=cfg, model=model, text_tower=tower, preproc=preproc)

    # ----------------------------------------------------------------- text
    @torch.inference_mode()
    def encode_texts(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Text tower over tokenized prompts (N, L) -> (N, 768) unit
        vectors on the detector's device. attention_mask defaults to
        input_ids != pad_token_id."""
        if self.text_tower is None:
            raise ValueError("no text tower weights")
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev)
        if attention_mask is None:
            mask = ids != self.cfg.text.pad_token_id
        else:
            mask = torch.as_tensor(attention_mask, device=dev)
        return self.text_tower(ids, mask.to(torch.int32))

    def reparameterize(self, texts: Sequence[str], embeds=None,
                       token_ids=None) -> None:
        """Cache the (K, C) class embeddings: `embeds` as given, else the
        text tower over `token_ids` ((ids, mask) or ids), else over the
        tokenized `texts` (needs the tokenizer files)."""
        self.class_names = list(texts)
        if embeds is None:
            if token_ids is None:
                from wedetect_tpu_torch.data.tokenizer import TextTokenizer

                token_ids = TextTokenizer(self.tokenizer_path)(texts)
            if isinstance(token_ids, tuple):
                embeds = self.encode_texts(*token_ids)
            else:
                embeds = self.encode_texts(token_ids)
        self._text_embeds = torch.as_tensor(embeds, dtype=torch.float32,
                                            device=self.device)

    # ------------------------------------------------------------ detection
    def __call__(self, images: Sequence[Union[str, np.ndarray]],
                 score_thr: float = 0.0, max_dets: Optional[int] = None
                 ) -> List[Dict[str, np.ndarray]]:
        """Detect on a list of image paths / HWC uint8 RGB arrays. A JPEG
        path goes through the native decode + letterbox (cv2 for a file
        it rejects), except under the Uni presets' yolov5 letterbox."""
        from wedetect_tpu_torch.data.loader import (letterbox_file,
                                                    load_image_rgb)

        cfg = self.cfg
        if cfg.num_prompts:
            w = None
        elif self._text_embeds is None:
            raise ValueError("call reparameterize(texts) first")
        else:
            w = self._text_embeds
        arrs, sfs, pads, oris = [], [], [], []
        for im in images:
            if self.preproc == "yolov5":
                arr = load_image_rgb(im) if isinstance(im, str) else im
                padded, sf, pad, ori = yolov5_letterbox(arr, cfg.img_size)
            elif isinstance(im, str):
                padded, sf, pad, ori = letterbox_file(im, cfg.img_size)
            else:
                padded, sf, pad, ori = preprocess_image(im, cfg.img_size)
            arrs.append(padded)
            sfs.append(sf)
            pads.append(pad)
            oris.append(np.array(ori, np.float32))
        det = W.detect_step(cfg, self.model, np.stack(arrs), w,
                            np.stack(sfs), np.stack(pads), np.stack(oris))
        det = W.Detections(*(x.cpu().numpy() for x in det))
        out = []
        for i in range(len(images)):
            keep = det.valid[i] & (det.scores[i] > score_thr)
            if max_dets:
                keep &= np.cumsum(keep) <= max_dets
            out.append({"bboxes": det.boxes[i][keep],
                        "scores": det.scores[i][keep],
                        "labels": det.labels[i][keep],
                        "embeddings": det.embeds[i][keep]})
        return out
