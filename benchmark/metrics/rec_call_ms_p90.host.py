"""90th percentile of every REC call (Uni proposals and Ref scoring) of
the window (host clock, ms). The card idles for most of a REC call
(66% in the first traced runs), so the host paces this tail: it stands
beside `rec_queries_per_s` as a layer's reading, not as an end-to-end
bound."""

from benchmark.harness import percentile


def read(run):
    return percentile(run.latencies_ms, 90) if run.latencies_ms else None
