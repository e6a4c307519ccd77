"""The readers of the port's spans and counters, the idle-gap labeller
that names the port's work ranges, and a run that reports them
(`python3 -m ecbench.spans`).  The card test runs with `-m card`."""

import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from ecbench import run, spans, tracing

SEED = (1 << 31) + 777
CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


def _reader(name):
    path = os.path.join(ROOT, "ecbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"r_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _rec(**delta):
    return {"entry": "write", "window_s": 10.0, "ops": 100,
            "latencies_s": [0.04] * 100, "trace": None,
            "delta": {"pipe": {}, "copies": {}, **delta}}


SPANS = {"ec.arena/avgcount": 100, "ec.arena/sum": 0.1,
         "ec.stage_copy/avgcount": 100, "ec.stage_copy/sum": 0.5,
         "ec.cache_commit/avgcount": 100, "ec.cache_commit/sum": 0.02}
PHASES = {"enc/items": 100,
          "enc/ec.coalesce/avgcount": 100, "enc/ec.coalesce/sum": 1.0,
          "enc/ec.lane_queue/avgcount": 100, "enc/ec.lane_queue/sum": 0.3,
          "enc/ec.stage_h2d/avgcount": 100, "enc/ec.stage_h2d/sum": 0.4,
          "enc/ec.device_compute/avgcount": 100,
          "enc/ec.device_compute/sum": 0.8,
          "enc/ec.d2h/avgcount": 100, "enc/ec.d2h/sum": 0.2,
          "enc/ec.tail/avgcount": 100, "enc/ec.tail/sum": 0.7}
THREADS = {"ec-pipeline-dispatch/work_s": 1.0,
           "ec-pipeline-stage-0/work_s": 4.0,
           "ec-pipeline-stage-0/wait_s": 2.0,
           "ec-pipeline-collect-0/work_s": 3.0}


def test_each_reader_on_a_synthetic_record():
    rec = _rec(spans=SPANS, phases=PHASES, threads=THREADS)
    assert _reader("op_stage_ms")(rec) == pytest.approx(6.0)
    assert _reader("op_queue_ms")(rec) == pytest.approx(13.0)
    assert _reader("op_dispatch_ms")(rec) == pytest.approx(14.0)
    assert _reader("op_tail_ms")(rec) == pytest.approx(7.2)
    assert _reader("pipeline_thread_busy_share")(rec) == pytest.approx(40.0)
    rec["trace"] = {"idle_gap_s": 2.0, "idle_unattributed_s": 0.5}
    assert _reader("idle_unattributed_share")(rec) == pytest.approx(25.0)


@pytest.mark.parametrize("name", [n for n, _u in spans.SPAN_METRICS])
def test_a_record_without_the_ports_counters_reads_nothing(name):
    """The parent's run, or `run.py`'s own: no groups, no value."""
    assert _reader(name)(_rec()) is None
    rec = _rec(spans=SPANS, phases=PHASES, threads=THREADS)
    rec["entry"] = "degraded_read"
    assert _reader(name)(rec) is None


def _ev(name, t0, t1, dev=CPU):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=t0, end=t1))


# a 100 us stretch: kernels at [0,10), [40,50), [90,100); a stager's
# upload range over most of the first gap, the op thread in result()
# over both, and a second gap half covered by a collector's readback
EVENTS = [_ev("gf_fused_kernel", 0, 10, CUDA),
          _ev("Memcpy HtoD", 40, 50, CUDA),
          _ev("gf_fused_kernel", 90, 100, CUDA),
          _ev("ec.stage_h2d", 12, 38), _ev("ec.d2h", 50, 70),
          _ev("EncodeHandle.result", 0, 100), _ev("aten::copy_", 5, 95)]
MARKS = ("ecutil.encode_object_async", "EncodeHandle.result")


def test_the_labeller_names_the_ports_range():
    out = spans.summarize(EVENTS, MARKS, 1e-4, work=("ec.stage_h2d",
                                                     "ec.d2h"))
    assert out["idle_gaps"] == pytest.approx({"ec.stage_h2d": 30e-6,
                                              "ec.d2h": 40e-6})
    assert out["mark_gaps"] == pytest.approx({"EncodeHandle.result": 70e-6})
    assert out["idle_gap_s"] == pytest.approx(70e-6)
    # [10,12) + [38,40) + [70,90) have no work range open
    assert out["idle_unattributed_s"] == pytest.approx(24e-6)
    # with no work range a gap falls back to the marks, then to none
    fall = spans.summarize([e for e in EVENTS if e.name != "ec.d2h"],
                           ("EncodeHandle.result",), 1e-4,
                           work=("ec.stage_h2d",))
    assert fall["idle_gaps"] == pytest.approx(
        {"ec.stage_h2d": 30e-6, "EncodeHandle.result": 40e-6})
    bare = spans.summarize(EVENTS[:3], (), 1e-4, work=())
    assert bare["idle_gaps"] == pytest.approx({tracing.UNLABELLED: 70e-6})


def test_the_device_metrics_read_what_they_read_before():
    """busy_s, device_ops and window_s, and so device_idle_share and
    ec_kernel_roofline, come out bit for bit as `tracing.summarize`'s."""
    before = tracing.summarize(EVENTS, MARKS, 1e-4)
    after = spans.summarize(EVENTS, MARKS, 1e-4, work=("ec.stage_h2d",))
    for key in ("busy_s", "device_ops", "window_s"):
        assert after[key] == before[key]
    for name in ("device_idle_share", "ec_kernel_roofline"):
        rec = {"entry": "write", "k": 8, "m": 3, "L": 1 << 20, "lost": 0}
        got = [_reader(name)(dict(rec, trace=dict(
            tr, delta={"pipe": {"stripes": 64}}))) for tr in (before, after)]
        assert got[0] is not None and got[0] == got[1]


def test_a_traced_cpu_run_reports_the_program_side_metrics(tiny_root,
                                                           cpu_port):
    seen = {}
    with spans.reading_spans(seen):
        out = run.run_cell(tiny_root, "tiny.write", SEED, 3.0, True,
                           card=False)
    assert out["correct"], out["checks"]
    for name in ("op_stage_ms", "op_queue_ms", "op_dispatch_ms",
                 "op_tail_ms", "pipeline_thread_busy_share"):
        assert out["metrics"][f"{name}.write"]["value"] > 0, name
    d = spans.diag(seen["rec"], seen["values"])
    assert d["busiest_thread"].startswith("ec-pipeline-")
    assert 0 < d["op_parts_sum_ms"] <= 1.2 * d["op_mean_ms"]
    # the harness's own functions are back
    assert run.counters is not spans.counters


@pytest.mark.card
def test_all_six_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a run measures the card only")
    r = subprocess.run([sys.executable, "-m", "ecbench.spans",
                        "--workload", "tpu_k8m3_1m.write", "--seed",
                        str(SEED), "--seconds", "12", "--trace", "1"],
                       capture_output=True, text=True, timeout=900,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"]
    for name, _unit in spans.SPAN_METRICS:
        assert f"{name}.write" in out["metrics"], name
    assert "ecbench spans:" in r.stderr
