"""K1's share of its roofline (%): the least time of the selection's
work on the profiled calls' own scores (benchmark/peaks.k1_bound_s:
their rows, classes, t and rows by branch, counted by the span phase's
wrapper on the same calls), over the device time of K1's kernels in the
profiled phase. The kernels are found by these names, which the port's
csrc/row_topk.cu gives them."""

from benchmark.harness import kernel_seconds
from benchmark.peaks import k1_bound_s

K1_KERNELS = ("row_topk_regs", "row_topk_smem")


def read(run):
    c = run.counters
    seconds = kernel_seconds(run, K1_KERNELS)
    if not c.get("k1_launches") or seconds <= 0:
        return None
    bound = k1_bound_s(c["k1_rows"], c["k1_k"], c["k1_t"],
                       [c["k1_empty"], c["k1_sparse"], c["k1_dense"]])
    return 100.0 * bound / seconds
