"""Share of the device's busy time that the yardstick's bound of the
window's passes accounts for, in % (``roofline.py``; all device work counts,
whatever its name)."""


def read(ctx):
    if ctx.get("frontend") is not None or not ctx["busy_s"] or not ctx["passes"]:
        return None
    return 100.0 * ctx["bound_s"] / ctx["busy_s"]
