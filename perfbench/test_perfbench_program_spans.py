"""The readers of the metrics timed inside the program, on hand-built spans.

Each reader takes the spans from the recorder of the program the process
has loaded (``repro_torch.utils.tracing``) and the window from ``ctx``;
given the records below it returns the value worked out by hand, None on
the other cell, and None where the program recorded no spans or has no
recorder loaded (a program without the tracing module).
"""
import sys

import pytest

from perfbench import harness
from repro_torch.utils import tracing

MS = 1_000_000


def rec(name, start_ms, end_ms, span_id, parent_id=None, pass_id=None, request_id=None,
        attrs=None):
    return tracing.Record(name, int(start_ms * MS), int(end_ms * MS), span_id, parent_id,
                          pass_id, request_id, 1, attrs)


RECORDS = [
    # the batch cell: two outermost query_batch passes, 3 ms (1.5 waited) and 2 ms (1)
    rec("index.query_batch", 0, 3, 1, pass_id=10),
    rec("index.wait", 1, 2.5, 2, parent_id=1, pass_id=10),
    rec("index.query_batch", 4, 6, 3, pass_id=11),
    rec("index.wait", 4.5, 5.5, 4, parent_id=3, pass_id=11),
    # the serve cell: three queued requests, two passes, two holds, an idle
    rec("frontend.queue", 10, 11, 5, pass_id=20, request_id=100),
    rec("frontend.queue", 8, 11, 6, pass_id=20, request_id=101),
    rec("frontend.queue", 14, 16, 7, pass_id=21, request_id=102),
    rec("frontend.pass", 11, 16, 8, pass_id=20, attrs={"q": 2, "reason": "target"}),
    rec("index.query_batch", 11.5, 15.5, 9, parent_id=8, pass_id=20),
    rec("index.wait", 12, 15, 10, parent_id=9, pass_id=20),
    rec("frontend.pass", 16, 18, 11, pass_id=21, attrs={"q": 1, "reason": "deadline"}),
    rec("index.wait", 16.5, 17.5, 12, parent_id=11, pass_id=21),
    rec("frontend.hold", 8, 508, 13),
    rec("frontend.hold", 1000, 1250, 14),
    rec("frontend.idle", 2000, 2500, 15),
]
BATCH = {"frontend": None, "window_s": 3.0}
SERVE = {"frontend": {"passes": 2, "queries": 3}, "window_s": 3.0}

CASES = [("program_host_ms_per_pass.batch", BATCH, SERVE, (1.5 + 1.0) / 2),
         ("program_host_ms_per_pass.serve", SERVE, BATCH, (2.0 + 1.0) / 2),
         ("queue_wait_ms.serve", SERVE, BATCH, (1 + 3 + 2) / 3),
         ("hold_share.serve", SERVE, BATCH, 0.75 / 3.0)]


@pytest.mark.parametrize("metric,cell,other,want", CASES)
def test_reader_returns_the_hand_computed_value(monkeypatch, metric, cell, other, want):
    monkeypatch.setattr(tracing, "records", lambda: list(RECORDS))
    read = harness.load_reader(metric)
    assert read(dict(cell)) == pytest.approx(want, rel=1e-12)
    assert read(dict(other)) is None


@pytest.mark.parametrize("metric,cell,other,want", CASES)
def test_reader_is_silent_without_spans_or_recorder(monkeypatch, metric, cell, other, want):
    read = harness.load_reader(metric)
    monkeypatch.setattr(tracing, "records", lambda: [])
    assert read(dict(cell)) is None
    monkeypatch.delitem(sys.modules, "repro_torch.utils.tracing")
    assert read(dict(cell)) is None
