"""Checkpoints: torch and JAX converters, Conv+BN folding and the
text-head bake, io."""

from wedetect_tpu_torch.ckpt.fuse import bake_text_head, fold_conv_bn

__all__ = ["bake_text_head", "fold_conv_bn"]
