"""WeDetect in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `wedetect_tpu`, module for module: the same
configs, the same detect graph and the same fixed-slot outputs, as NCHW
`nn.Module`s under the reference checkpoint's torch key names, its
training (`train/`, `cli/train.py`), and the WeDetect-Ref proposal
scorer (Qwen3-VL) under the HF key names, its SFT training, and its
text generation and continuous-batching serving (`models/ref_generate`,
`models/serve`, `models/serve_http`), and its grounding evaluation
(`cli/eval_grounding`: cross-image and multi-image scoring). The TPU kernels on these paths
are CUDA C++ kernels under `csrc/`, built with nvcc at first use: the
per-anchor row top-k (detection), the two flash attention forwards
(the Qwen3-VL decoder's grouped-KV one and the ViT's) and their
backward kernels.

Entry points default to `device="cuda"` and raise when no card is
present; pass `device="cpu"` to run the plain PyTorch versions.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card
    is present (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
