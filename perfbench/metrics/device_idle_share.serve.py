"""Share of the traced window in which no operation ran on the device:
1 - (union of the device's operation intervals / window)."""


def read(ctx):
    if ctx.get("frontend") is None or not ctx["window_s"]:
        return None
    return 1.0 - ctx["busy_s"] / ctx["window_s"]
