"""The port's telemetry layer (`runtime/telemetry.py`) against the JAX
package's, on the CPU, with both modules' clocks patched to the same
scripted values: the span tracer's nesting and Chrome-trace export, the
goodput buckets over a scripted sequence of step windows, and the
scalars of whole step windows (goodput, MFU, effective tokens) must be
equal (the MFU through each package's own peak: the port's is the
H100's). Then the port alone: the `torch.profiler` capture window, its
Chrome trace beside the spans', its release when the telemetry object
is collected mid-window, one anomaly capture per episode, the memory
watermark scalars, the spans inside a `torch.profiler` trace, and
`utils.timer.profiler_trace` sharing the capture windows' flag.
"""

import gc
import json
import os
import types

import pytest
import torch

from deeperspeed_tpu.runtime import telemetry as jtm
from deeperspeed_tpu_torch.profiling.hardware import (PEAK_FLOPS_DEFAULT,
                                                      peak_flops_per_chip)
from deeperspeed_tpu_torch.runtime import telemetry as tm

torch.set_num_threads(2)


class FakeClock:
    """A perf_counter / time that moves only when told to."""

    def __init__(self, t=100.0):
        self.t = t

    def perf_counter(self):
        return self.t

    def time(self):
        return self.t

    def tick(self, dt):
        self.t += dt


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock for each module, started at the same value."""
    pair = (FakeClock(), FakeClock())
    for mod, clock in zip((jtm, tm), pair):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=clock.perf_counter, time=clock.time))
    return pair


class RecordingMonitor:
    def __init__(self):
        self.records = []

    def record(self, sample, scalars):
        self.records.append((sample, dict(scalars)))


class FakeEngine:
    def __init__(self):
        self.global_samples = 0
        self.global_steps = 0
        self.checkpoint_manager = types.SimpleNamespace(total_stall_s=0.0)


def _span_script(tracer, clock):
    """A nested span sequence: step{data_fetch, train_dispatch{inner}}."""
    with tracer.span("step"):
        clock.tick(0.5)
        with tracer.span("data_fetch"):
            clock.tick(0.25)
        with tracer.span("train_dispatch"):
            clock.tick(1.0)
            with tracer.span("inner"):
                clock.tick(0.125)
        clock.tick(0.0625)


def test_span_nesting_and_chrome_export_match_jax(clocks, tmp_path):
    traces = []
    for mod, clock in zip((jtm, tm), clocks):
        tracer = mod.SpanTracer(mirror_annotations=False)
        tracer.start_capture()
        _span_script(tracer, clock)
        events = tracer.stop_capture()
        path = mod.SpanTracer.export_chrome_trace(
            events, str(tmp_path / f"{mod.__name__}.json"))
        with open(path) as f:
            traces.append(json.load(f))
        assert tracer.drain_phases() == {
            "step": 1.9375, "data_fetch": 0.25, "train_dispatch": 1.125,
            "inner": 0.125}
    assert traces[0] == traces[1]
    depths = {e["name"]: e["tid"] for e in traces[1]["traceEvents"]}
    assert depths == {"step": 0, "data_fetch": 1, "train_dispatch": 1,
                      "inner": 2}


def test_span_outside_window_buffers_nothing(clocks):
    for mod, clock in zip((jtm, tm), clocks):
        tracer = mod.SpanTracer(mirror_annotations=False)
        _span_script(tracer, clock)
        assert tracer.stop_capture() == []
        tracer.record_event("request/0", 1.0, 2.0)
        assert tracer.stop_capture() == []


SCRIPT = [  # (dt, verdict, data_wait, param_wait, ckpt_stall)
    (1.0, "ok", 0.25, 0.0, 0.0),
    (2.0, "quarantined", 0.5, 0.0, 0.125),
    (0.5, "overflow", 0.0, 0.0, 0.0),
    (4.0, "rollback", 0.0, 0.0, 1.0),
    (1.0, "warned", 2.0, 0.0, 0.0),        # data wait clamps to dt
    (3.0, "ok", 0.5, 0.25, 5.0),           # stall clamps to the rest
]


def test_goodput_buckets_match_jax():
    meters = (jtm.GoodputMeter(), tm.GoodputMeter())
    for dt, verdict, dw, pw, cs in SCRIPT:
        for meter in meters:
            meter.account(dt, verdict, data_wait=dw, param_wait=pw,
                          ckpt_stall=cs)
        assert meters[0].scalars() == meters[1].scalars()
    assert tm.GOODPUT_BUCKETS == jtm.GOODPUT_BUCKETS
    assert meters[1].total == pytest.approx(sum(s[0] for s in SCRIPT))


def _windows(mod, clock, tel, engine):
    """Scripted step windows through on_step_start / on_step_end: a data
    fetch span, a checkpoint stall, a quarantined step, packed tokens."""
    for i, (dt, verdict, dw, _, cs) in enumerate(SCRIPT):
        tel.on_step_start(engine.global_steps)
        with tel.span("data_fetch"):
            clock.tick(min(dw, dt))
        clock.tick(dt - min(dw, dt))
        engine.checkpoint_manager.total_stall_s += min(cs, dt)
        engine.global_steps += 1
        engine.global_samples += 8
        tel.on_step_end(engine, verdict=verdict, flops=3e12,
                        tokens=(6, 8) if i % 2 else None)


def test_step_windows_match_jax(clocks):
    recs = []
    for mod, clock in zip((jtm, tm), clocks):
        monitor = RecordingMonitor()
        tel = mod.Telemetry(monitor=monitor, devices=[], spans=False)
        _windows(mod, clock, tel, FakeEngine())
        tel.close()
        recs.append(monitor.records)
    assert [s for s, _ in recs[0]] == [s for s, _ in recs[1]]
    jax_peak = jtm.Telemetry(devices=[])._peak()
    for (_, theirs), (_, ours) in zip(*recs):
        assert set(ours) == set(theirs)
        for tag, value in theirs.items():
            if tag.endswith("mfu"):
                # each package divides by its own peak: the H100's here
                assert ours[tag] == pytest.approx(
                    value * jax_peak / PEAK_FLOPS_DEFAULT, rel=1e-12)
            else:
                assert ours[tag] == pytest.approx(value, rel=1e-12), tag
        assert ours["Train/Samples/mfu"] == pytest.approx(
            ours["Train/Samples/achieved_tflops"] * 1e12 /
            PEAK_FLOPS_DEFAULT)


def test_peak_table_is_the_h100_row():
    assert PEAK_FLOPS_DEFAULT == 989e12
    assert peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops_per_chip(torch.device("cpu")) == 989e12
    assert peak_flops_per_chip(None) == 989e12


def test_null_telemetry_is_inert():
    null = tm.NULL_TELEMETRY
    assert not null.enabled and not null.wants_flops
    assert null.span("x") is null.step_annotation(3)
    with null.span("x"):
        pass
    assert tm.build_telemetry(None) is null
    assert tm.build_telemetry({"enabled": False}) is null


def _capture_tel(tmp_path, **kw):
    return tm.Telemetry(devices=[torch.device("cpu")],
                        trace_dir=str(tmp_path), **kw)


def test_capture_window_exports_spans_and_profiler_trace(tmp_path):
    tel = _capture_tel(tmp_path, capture={"start_step": 1, "num_steps": 2})
    eng = FakeEngine()
    for step in range(4):
        tel.on_step_start(step)
        with tel.span("train_dispatch"), tel.step_annotation(step):
            torch.ones(64, 64) @ torch.ones(64, 64)
        tel.on_step_end(eng)
    assert tel.windows_opened == 1 and not tm._TRACE_ACTIVE
    spans = json.load(open(tmp_path / "spans_step1.json"))
    assert [e["name"] for e in spans["traceEvents"]] == \
        ["train_dispatch"] * 2
    assert set(spans["otherData"]["dispatch"]) == {
        "flash", "decode_attention", "quant_matmul"}
    trace = json.load(open(tmp_path / "torch_trace_step1.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"train_dispatch", "train_step1", "train_step2"} <= names
    assert tel.profiler_traces == [str(tmp_path / "torch_trace_step1.json")]
    tel.close()


def test_collected_mid_window_releases_trace(tmp_path):
    tel = _capture_tel(tmp_path, capture={"start_step": 0, "num_steps": 5})
    tel.on_step_start(0)
    assert tm._TRACE_ACTIVE
    del tel
    gc.collect()
    assert not tm._TRACE_ACTIVE
    # a later window in the process still traces
    tel = _capture_tel(tmp_path / "b", capture={"start_step": 0,
                                                "num_steps": 1})
    tel.on_step_start(0)
    assert tm._TRACE_ACTIVE
    tel.on_step_end(FakeEngine())
    assert not tm._TRACE_ACTIVE
    assert os.path.isfile(tmp_path / "b" / "torch_trace_step0.json")


def test_close_flushes_open_window(tmp_path):
    tel = _capture_tel(tmp_path, capture={"start_step": 0, "num_steps": 9})
    tel.on_step_start(0)
    with tel.span("sentinel"):
        pass
    tel.close()
    tel.close()
    assert not tm._TRACE_ACTIVE
    assert os.path.isfile(tmp_path / "spans_step0.json")


def test_anomaly_capture_once_per_episode(tmp_path):
    tel = _capture_tel(tmp_path, capture_on_anomaly=True,
                       anomaly_capture_steps=1)
    eng = FakeEngine()
    tel.on_step_start(0)
    tel.on_step_end(eng, verdict="warned")
    tel.on_anomaly(eng, "nan_loss", step=0)
    tel.on_anomaly(eng, "nan_loss", step=0)       # same episode
    assert tel.anomaly_captures == 1 and len(tel.memory_snapshots) == 1
    snap = json.load(open(tel.memory_snapshots[0]))
    assert snap["tag"] == "anomaly_nan_loss_step0"
    assert snap["devices"] == {"cpu": {}}
    tel.on_step_start(1)                          # the armed window
    assert tel.windows_opened == 1
    tel.on_step_end(eng, verdict="warned")        # still anomalous
    tel.on_anomaly(eng, "nan_loss", step=1)
    assert tel.anomaly_captures == 1
    tel.on_step_start(2)
    tel.on_step_end(eng, verdict="ok")            # the episode ends
    tel.on_anomaly(eng, "loss_spike", step=3)
    assert tel.anomaly_captures == 2
    tel.close()


def test_memory_watermark_scalars_on_the_cpu(monkeypatch):
    monitor = RecordingMonitor()
    tel = tm.Telemetry(monitor=monitor, devices=[torch.device("cpu")],
                       memory_watermark_interval_steps=1)
    tel.on_step_start(0)
    tel.on_step_end(FakeEngine())
    # the CPU has no allocator stats: no watermark tags, as JAX's CPU
    assert not any(t.startswith("Train/Memory")
                   for t in monitor.records[0][1])
    stats = {"allocated_bytes.all.current": 5,
             "allocated_bytes.all.peak": 9}
    monkeypatch.setattr(tm.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tm.torch.cuda, "memory_stats", lambda dev: stats)
    tel.devices = [torch.device("cuda", 0)]
    assert tel._memory_scalars() == {"Train/Memory/hbm_bytes_in_use": 5,
                                     "Train/Memory/hbm_peak_bytes": 9}
    tel.close()


def test_spans_enter_record_function():
    tel = tm.Telemetry(devices=[])
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tel.span("data_fetch"):
            torch.ones(8) + 1
        with tel.step_annotation(7):
            torch.ones(8) + 1
    names = {e.key for e in prof.key_averages()}
    assert {"data_fetch", "train_step7"} <= names
    tel.close()


def test_profiler_trace_shares_the_capture_flag(tmp_path):
    """`profiler_trace` and the capture windows take the process's one
    torch.profiler profile through one flag: inside an open window the
    block raises, a window opened inside the block keeps its host spans
    and no trace, and the flag is free after each."""
    from deeperspeed_tpu_torch.utils.timer import profiler_trace
    with profiler_trace(str(tmp_path / "user")):
        assert tm._TRACE_ACTIVE
        tel = _capture_tel(tmp_path / "win", capture={"start_step": 0,
                                                      "num_steps": 1})
        tel.on_step_start(0)
        with tel.span("train_dispatch"):
            torch.ones(8, 8) @ torch.ones(8, 8)
        tel.on_step_end(FakeEngine())
        assert tel.profiler_traces == [] and tel.windows_opened == 1
        assert os.path.isfile(tmp_path / "win" / "spans_step0.json")
    assert not tm._TRACE_ACTIVE
    assert os.path.isfile(tmp_path / "user" / "trace.json")
    tel = _capture_tel(tmp_path / "win2", capture={"start_step": 0,
                                                   "num_steps": 1})
    tel.on_step_start(0)
    with pytest.raises(RuntimeError, match="already runs"):
        with profiler_trace(str(tmp_path / "user2")):
            pass
    tel.on_step_end(FakeEngine())
    assert not tm._TRACE_ACTIVE
    assert tel.profiler_traces == [str(tmp_path / "win2" /
                                       "torch_trace_step0.json")]
