"""The 95th percentile of the window's request latencies, each from its due
time until its answer, in ms (the open-loop mix's own timing)."""


def read(ctx):
    return ctx.get("latency_p95_ms")
