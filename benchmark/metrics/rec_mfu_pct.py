"""The whole REC step's share of the H100's bf16 peak (%): the model
FLOPs of the window's calls (Uni on every image, by the reference's
FlopCounterMode count, and WeDetect-Ref on every query at its own grid
and chat length, benchmark/reference/flops.ref_flops) over the window's
seconds, over 989 TFLOP/s."""

from benchmark.peaks import BF16_OPS_PER_S
from benchmark.reference.flops import detector_flops, ref_flops


def read(run):
    info = run.info
    if run.seconds <= 0 or not run.calls:
        return None
    uni = detector_flops(info["uni"], info["prompts"], info["prompts"])
    per_call = [info["batch"] * uni + sum(
        ref_flops(info["ref"]["vision"], info["ref"]["text"], gh, gw, seq,
                  info["proposals"]) for gh, gw, seq in items)
        for items in info["call_items"]]
    total = sum(per_call[i % len(per_call)] for i in range(run.calls))
    return 100.0 * total / run.seconds / BF16_OPS_PER_S
