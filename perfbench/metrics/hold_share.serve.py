"""Share of the traced window in which the frontend's scheduler held queued
requests for its target or deadline: the program's ``frontend.hold`` spans
over the window.  The spans come from the recorder of the program this
process has loaded (``repro_torch.utils.tracing``, looked up, not imported:
the yardstick imports no program).  None where it recorded no pass."""
import sys


def read(ctx):
    tracing = sys.modules.get("repro_torch.utils.tracing")
    if ctx.get("frontend") is None or tracing is None or not ctx["window_s"]:
        return None
    records = tracing.records()
    if not any(r.name == "frontend.pass" for r in records):
        return None
    held = sum(r.end_ns - r.start_ns for r in records if r.name == "frontend.hold")
    return held * 1e-9 / ctx["window_s"]
