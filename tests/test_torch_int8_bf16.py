"""The int8 modes in bf16 against the JAX package on the CPU, call by
call (test_torch_int8.check_calls): the detector under bf16 autocast and
the Ref prefill of a bf16-cast model call their int8 modules in JAX's
order, each weight JAX's kernel rounded to bf16, and the port's op on
JAX's recorded input equals JAX's op on it, bit for bit. JAX's forward
runs jitted and its op eagerly on the recorded operands: XLA rewrites
the jitted quantize (the scale's division by 127 becomes a product with
its reciprocal), so the jitted outputs are not the op as written.
"""

import jax
import jax.numpy as jnp
import torch

from test_torch_int8 import (IMGS, W, _det, _PortCalls, _record_jax_calls,
                             check_calls)
from test_torch_int8_ref import ref_calls_check, tiny  # noqa: F401
from torch_ref_util import one_torch_thread  # noqa: F401 (autouse)
from wedetect_tpu.models import wedetect as JW
from wedetect_tpu_torch.models import wedetect as TW
from wedetect_tpu_torch.ops import int8 as TI


def test_detector_int8_calls_match_jax_bf16(monkeypatch):
    """The detector's int8 calls under bf16 autocast: the weights are
    quantized from their bf16 values, the activations from the bf16
    inputs; the same modules stay float as in f32."""
    _, jq, jvars, _, _, tq, mq = _det("bfloat16")
    calls = _record_jax_calls(monkeypatch)
    JW.forward_raw(jq, jvars, jnp.asarray(IMGS), jnp.asarray(W))
    jax.effects_barrier()
    with _PortCalls(mq) as order:
        out = TW.forward_raw(tq, mq, IMGS, W)
    assert out.logits.dtype == torch.float32
    assert sum(isinstance(m, (TI.QuantLinear, TI.QuantConv2d))
               for m in mq.modules()) == len(order)
    check_calls(calls, order, torch.bfloat16, autocast=True)


def test_ref_int8_calls_match_jax_bf16(tiny, monkeypatch):  # noqa: F811
    """The Ref prefill's int8 calls with the model cast to bf16."""
    ref_calls_check(tiny, monkeypatch, "bfloat16")
