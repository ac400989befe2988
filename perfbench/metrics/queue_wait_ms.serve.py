"""Mean queue wait in ms of the window's requests: the program's
``frontend.queue`` spans, each from a request's submit to the pass that
took it.  The spans come from the recorder of the program this process has
loaded (``repro_torch.utils.tracing``, looked up, not imported: the
yardstick imports no program).  None where there is none."""
import sys


def read(ctx):
    tracing = sys.modules.get("repro_torch.utils.tracing")
    if ctx.get("frontend") is None or tracing is None:
        return None
    waits = [r.end_ns - r.start_ns for r in tracing.records() if r.name == "frontend.queue"]
    if not waits:
        return None
    return sum(waits) / len(waits) * 1e-6
