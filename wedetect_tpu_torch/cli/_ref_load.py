"""WeDetect-Ref checkpoint loading for the CLI entry points.

Loads an HF-format directory (config.json + tokenizer + *.safetensors,
the reference's checkpoint layout) into (RefCfg, RefModules on
`device`, tokenizer). transformers and safetensors are imported on use.
"""

from __future__ import annotations

import dataclasses

import torch


def load_ref(checkpoint: str, device="cuda"):
    import transformers

    from wedetect_tpu_torch import resolve_device
    from wedetect_tpu_torch.ckpt.convert_ref import load_hf_state_dict
    from wedetect_tpu_torch.models.ref import RefModules
    from wedetect_tpu_torch.nn.qwen3vl import RefCfg

    if not checkpoint:
        raise SystemExit(
            "random-init Ref requires the full Qwen3-VL config; supply "
            "--ref_checkpoint (HF dir with config.json + weights)")
    cfg = RefCfg.from_hf_config(
        transformers.AutoConfig.from_pretrained(checkpoint))
    tok = transformers.AutoTokenizer.from_pretrained(checkpoint)
    obj_id = tok.convert_tokens_to_ids("<object>")
    if obj_id is not None and obj_id >= 0:
        cfg = dataclasses.replace(cfg, object_token_id=obj_id)
    with torch.device("meta"):
        model = RefModules(cfg)
    model = model.to_empty(device=resolve_device(device))
    sd = load_hf_state_dict(checkpoint)
    # the stage-1/2 twin's lm_head and other extra entries are not read
    model.load_state_dict({k: sd[k] for k in model.state_dict()
                           if k in sd}, strict=True)
    return cfg, model.eval(), tok
