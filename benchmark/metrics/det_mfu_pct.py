"""The whole detect step's share of the H100's bf16 peak (%): the
reference's model FLOPs an image at the cell's shapes (counted by
torch's FlopCounterMode on the meta device) times the window's images a
second, over 989 TFLOP/s."""

from benchmark.peaks import BF16_OPS_PER_S
from benchmark.reference.flops import detector_flops


def read(run):
    if run.seconds <= 0 or not run.items:
        return None
    f = detector_flops(run.info["model"], run.info["vocabulary"])
    return 100.0 * f * run.items / run.seconds / BF16_OPS_PER_S
