"""The reference's tests of the op tracing plane: spans, historic and
slow rings, trace ids across daemons, slow-op health and the flight
recorder (tests/test_optracker.py), run against ceph_tpu_torch; then
the port's span helper: name totals, thread seconds, profiler ranges
and the EC item's phase tiling."""

import sys
import threading
import time

import pytest
import torch
from _port_reference import run_reference

from ceph_tpu_torch.utils import optracker as toptracker

run_reference(globals(), "test_optracker")


# ---------------------------------------------------------------------------
# the port's span helper: totals, thread seconds, profiler ranges
# ---------------------------------------------------------------------------

def _in_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(30)
    return out[0]


def test_span_counts_its_name_and_its_threads_work_and_wait():
    """A span adds its seconds to its name's process-wide total and,
    in a thread that bound a ThreadTotals, to the thread's work or wait
    seconds; a nested span's seconds leave the outer span's share."""
    before = toptracker.span_totals()

    def body():
        tt = toptracker.ThreadTotals()
        toptracker.bind_thread_totals(tt)
        with toptracker.span("test.outer_work") as outer:
            time.sleep(0.02)
            with toptracker.span("ec.result_wait") as inner:
                time.sleep(0.03)
        tt.sample()
        return tt, outer, inner

    tt, outer, inner = _in_thread(body)
    wait = inner.t1 - inner.t0
    assert outer.t0 <= inner.t0 < inner.t1 <= outer.t1
    assert tt.wait_s == pytest.approx(wait, abs=1e-9)
    assert tt.work_s == pytest.approx(outer.t1 - outer.t0 - wait,
                                      abs=1e-9)
    assert tt.cpu_s > 0
    after = toptracker.span_totals()
    n0 = before.get("test.outer_work", {"avgcount": 0, "sum": 0.0})
    assert after["test.outer_work"]["avgcount"] == n0["avgcount"] + 1
    assert after["test.outer_work"]["sum"] - n0["sum"] == pytest.approx(
        outer.t1 - outer.t0, abs=1e-9)
    assert set(toptracker.WORK_SPANS).isdisjoint(toptracker.WAIT_SPANS)


def test_span_totals_lose_no_update_across_threads():
    """Sixteen threads close spans of one name under a 1 us switch
    interval: the process-wide count loses none of them."""
    before = toptracker.span_totals().get("test.stress",
                                          {"avgcount": 0})["avgcount"]

    def body():
        for _ in range(2000):
            with toptracker.span("test.stress"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert toptracker.span_totals()["test.stress"]["avgcount"] == \
        before + 16 * 2000


def test_a_thread_without_totals_counts_only_the_name():
    before = toptracker.span_totals().get("test.unbound",
                                          {"avgcount": 0})["avgcount"]
    with toptracker.span("test.unbound"):
        pass
    assert toptracker.span_totals()["test.unbound"]["avgcount"] == \
        before + 1


def test_no_profiler_means_no_profiler_range(monkeypatch):
    """With no torch profiler recording a span enters no profiler
    range: one flag check is its whole cost."""
    def boom(*a, **k):
        raise AssertionError("profiler range entered")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    with toptracker.span("test.quiet"):
        pass


def test_spans_are_profiler_ranges_on_their_own_thread():
    from torch._C._profiler import _ExperimentalConfig
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        with toptracker.span("test.main_range"):
            pass
        _in_thread(lambda: toptracker.span("test.worker_range")
                   .__enter__().__exit__(None, None, None))
    finally:
        prof.stop()
    ev = {e.name: e for e in prof.events()
          if e.name in ("test.main_range", "test.worker_range")}
    assert set(ev) == {"test.main_range", "test.worker_range"}
    assert ev["test.main_range"].thread != ev["test.worker_range"].thread
    # plain CPU ops: a user annotation would be mirrored onto the device
    # timeline, over the work launched inside it
    assert not any(e.is_user_annotation for e in ev.values())


def test_phase_spans_tile_from_submit_to_return():
    """The two new stamps bring the two new phases: the lane queue
    (picked -> stage0 of an item that entered one) and the tail (done,
    or host1 on the host, -> returned)."""
    b = 100.0
    lane = {"submit": b, "picked": b + 1, "queued": b + 1.5,
            "stage0": b + 2, "stage1": b + 3, "issue": b + 3,
            "collect0": b + 5, "done": b + 6, "returned": b + 7}
    got = toptracker.phase_spans(lane)
    assert [n for n, _, _ in got] == [
        "ec.coalesce", "ec.lane_queue", "ec.stage_h2d",
        "ec.device_compute", "ec.d2h", "ec.tail"]
    assert all(a[2] == c[1] for a, c in zip(got, got[1:]))
    assert got[0][1] == b and got[-1][2] == b + 7
    host = {"submit": b, "picked": b + 1, "host0": b + 1,
            "host1": b + 4, "returned": b + 5}
    assert toptracker.phase_spans(host) == [
        ("ec.coalesce", b, b + 1), ("ec.host_encode", b + 1, b + 4),
        ("ec.tail", b + 4, b + 5)]
