"""Host milliseconds per pass: the benchmark's ``dispatch`` spans around
the batch cells' ``query_batch`` calls, less the device's busy time, over the passes.
All device work of the window runs inside those spans."""


def read(ctx):
    if ctx.get("frontend") is not None or not ctx["dispatch_n"]:
        return None
    return (ctx["dispatch_s"] - ctx["busy_s"]) * 1e3 / ctx["dispatch_n"]
