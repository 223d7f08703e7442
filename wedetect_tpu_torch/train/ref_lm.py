"""WeDetect-Ref stages 1-2 SFT: language-model loss.

Port of `wedetect_tpu/train/ref_lm.py` (reference wedetect_ref/sft.py:
100-291: chat data, labels = input ids with visual/user tokens masked to
-100, next-token cross-entropy through the LM head; and
models/qwen3vl_grounding.py, the stage-2 twin of the grounding model).

Stage schedule (reference scripts/run_stage{1,2}.sh): stage 1 trains the
projectors only (lr 1e-3, vision and LLM frozen); stage 2 unfreezes the
LLM. The hidden states are `RefModules.hidden_states` (the JAX
package's `_hidden_states`); the LM head is `RefModules.lm_logits`: the
untied `lm_head` of a stage-1/2 checkpoint when the model carries one,
else the tied input embedding. The stage optimizers train `lm_head`
from stage 1 on: its path, "lm_head/kernel", matches none of the
frozen keys, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wedetect_tpu_torch.models.ref import RefModules
from wedetect_tpu_torch.parallel.fsdp import forward_scope
from wedetect_tpu_torch.train.optimizer import (Optimizer, Schedule,
                                                make_optimizer)
from wedetect_tpu_torch.train.ref_sft import check_ref_mesh, ref_named_params
from wedetect_tpu_torch.train.train_step import TrainState

IGNORE_INDEX = -100


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                     ) -> torch.Tensor:
    """Shifted next-token CE with -100 masking. logits (B, L, V); labels
    (B, L) with IGNORE_INDEX at masked positions."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    mask = targets != IGNORE_INDEX
    safe = targets.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def mask_labels(input_ids: np.ndarray, image_token_id: int,
                assistant_spans) -> np.ndarray:
    """Labels: only assistant-turn tokens supervise; image/user tokens
    -> IGNORE (reference sft.py label construction)."""
    labels = np.full_like(input_ids, IGNORE_INDEX)
    for b, spans in enumerate(assistant_spans):
        for (st, en) in spans:
            labels[b, st:en] = input_ids[b, st:en]
    labels[input_ids == image_token_id] = IGNORE_INDEX
    return labels


def stage_optimizer(model: RefModules, stage: int,
                    base_lr: Optional[float] = None,
                    lr_schedule: Optional[Schedule] = None) -> Optimizer:
    """Stage 1: projectors only (lr 1e-3); stage 2: everything except
    the vision tower (lr 1e-5); stage 3 is ref_sft.ref_optimizer."""
    if stage == 1:
        lr = base_lr if base_lr is not None else 1e-3
        mults = {"vision": 0.0, "text": 0.0, "embed": 0.0}
    else:
        lr = base_lr if base_lr is not None else 1e-5
        mults = {"vision": 0.0}
    return make_optimizer(ref_named_params(model), base_lr=lr,
                          weight_decay=0.0, lr_schedule=lr_schedule,
                          custom_lr_mults=mults)


def ref_lm_step(cfg, grid_h: int, grid_w: int, state: TrainState, patches,
                input_ids, attn_mask, position_ids, visual_start: int, boxes,
                ori_wh, object_positions, labels, grid_t: int = 1
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One LM-loss step through the grounding trunk, updating `state` in
    place. labels: (B, L) token ids with IGNORE_INDEX masking. grid_t > 1
    feeds a video sample (one contiguous span; RefModules.hidden_states)."""
    check_ref_mesh(state)
    model = state.model
    model.zero_grad(set_to_none=True)
    with forward_scope(model):
        hidden = model.hidden_states(patches, input_ids, attn_mask,
                                     position_ids, boxes, ori_wh,
                                     visual_start, object_positions,
                                     grid_h=grid_h, grid_w=grid_w,
                                     grid_t=grid_t)
        logits = model.lm_logits(hidden)
    loss = lm_cross_entropy(
        logits, torch.as_tensor(labels, device=model.device).long())
    loss.backward()
    grad_norm = state.tx.grad_norm()
    state.tx.step()
    state.step += 1
    return state, {"loss": loss.detach(), "grad_norm": grad_norm}
