"""K2's share of its roofline (%): the least time of the decoder's
attention at each launch's own shapes (benchmark/peaks.attn_bound_s:
the visible pairs of valid query rows and valid keys, q, k, v read once,
the output and log-sum-exp written once, bf16 at 989 TFLOP/s), summed
by the span phase's wrapper, over the device time of K2's kernels in
the profiled phase, which runs the same calls. The kernel is found by
this name, which the port's csrc/flash_gqa_sm90.cu gives it."""

from benchmark.harness import kernel_seconds

K2_KERNELS = ("gqa_fwd_sm90_kernel",)


def read(run):
    seconds = kernel_seconds(run, K2_KERNELS)
    if not run.counters.get("k2_launches") or seconds <= 0:
        return None
    return 100.0 * run.counters["k2_bound_s"] / seconds
