"""Host milliseconds per pass, timed inside the program: each
``frontend.pass`` span (stacking, the service's dispatch, answering the
futures) less the ``index.wait`` of its pass (the host blocked on the
device), over the passes.  The spans come from the recorder of the program
this process has loaded (``repro_torch.utils.tracing``, looked up, not
imported: the yardstick imports no program).  None where there is none."""
import sys


def read(ctx):
    tracing = sys.modules.get("repro_torch.utils.tracing")
    if ctx.get("frontend") is None or tracing is None:
        return None
    records = tracing.records()
    passes = {r.pass_id: r.end_ns - r.start_ns for r in records
              if r.name == "frontend.pass" and r.parent_id is None}
    if not passes:
        return None
    wait = sum(r.end_ns - r.start_ns for r in records
               if r.name == "index.wait" and r.pass_id in passes)
    return (sum(passes.values()) - wait) * 1e-6 / len(passes)
