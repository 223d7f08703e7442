"""Milliseconds a call in the rec_prefix span (the benchmark's wrapper; see the
entry's spans())."""

from benchmark.harness import span_ms_per_call


def read(run):
    return span_ms_per_call(run, "rec_prefix")
