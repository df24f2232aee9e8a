"""The port's monitor (`runtime/monitor.py`) and export backends
(`runtime/exporters.py`) against the JAX package's, on the CPU, for the
same inputs: the TSV fallback's rows and its size rotation, the
tensorboardX event rows, the Prometheus text (gauges, histograms,
labels) and a scrape of the port's endpoint on 127.0.0.1, and the JSONL
rows (both modules' epoch clock patched to one value) must be equal.
Then the port alone: device tensors in the queue are read at the flush
(one stacked copy), nothing is written before it, and a record after
close warns once and is dropped.
"""

import os
import types
import urllib.request

import numpy as np
import pytest
import torch

from deeperspeed_tpu.runtime import exporters as jex
from deeperspeed_tpu.runtime import monitor as jmon
from deeperspeed_tpu_torch.runtime import exporters as ex
from deeperspeed_tpu_torch.runtime import monitor as mon

torch.set_num_threads(2)

# (sample, {tag: value}) records, as an engine queues them
RECORDS = [(8 * (i + 1), {"Train/Samples/train_loss": 2.0 / (i + 1),
                          "Train/Samples/lr": 1e-3 * (i + 1),
                          "Train/Samples/grad_norm": np.float32(0.5 + i)})
           for i in range(5)] + [
    (48, {"Train/Checkpoint/stall_ms": 12.5, "Serve/queue_depth": 3.0})]


def _feed(monitor, records, tensors=False):
    for sample, scalars in records:
        if tensors:
            scalars = {k: torch.tensor(float(v), dtype=torch.float64)
                       for k, v in scalars.items()}
        monitor.record(sample, scalars)


def _read_tsv(log_dir):
    with open(os.path.join(log_dir, "events.tsv")) as f:
        return f.read()


def _both(tmp_path, tb, export=None, flush_interval=10):
    """(JAX monitor, port monitor), each under its own root, with
    tensorboardX or the TSV fallback."""
    out = []
    for mod, root in ((jmon, "jax"), (mon, "port")):
        mod_tb = mod._HAVE_TB
        mod._HAVE_TB = tb
        try:
            out.append(mod.TensorBoardMonitor(
                output_path=str(tmp_path / root), job_name="unit",
                flush_interval=flush_interval, rank=0, export=export))
        finally:
            mod._HAVE_TB = mod_tb
    return out


def test_tsv_rows_equal_jax(tmp_path):
    jm, pm = _both(tmp_path, tb=False)
    _feed(jm, RECORDS)
    _feed(pm, RECORDS, tensors=True)
    jm.flush()
    pm.flush()
    got = _read_tsv(tmp_path / "port" / "unit")
    assert got == _read_tsv(tmp_path / "jax" / "unit")
    assert got.splitlines()[0] == "tag\tsample\tvalue"
    assert len(got.splitlines()) == 1 + sum(len(s) for _, s in RECORDS)
    jm.close()
    pm.close()


def test_tsv_rotation_equal_jax(tmp_path):
    export = {"rotate_max_mb": 300 / 2 ** 20, "rotate_keep": 2}
    jm, pm = _both(tmp_path, tb=False, export=export, flush_interval=1)
    for _ in range(4):
        _feed(jm, RECORDS)
        _feed(pm, RECORDS)
    jm.close()
    pm.close()
    jdir, pdir = tmp_path / "jax" / "unit", tmp_path / "port" / "unit"
    names = sorted(os.listdir(pdir))
    assert names == sorted(os.listdir(jdir))
    assert names == ["events.tsv", "events.tsv.1", "events.tsv.2"]
    for name in names:
        assert (pdir / name).read_text() == (jdir / name).read_text()


def _tb_rows(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return {tag: [(ev.step, ev.value) for ev in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.mark.skipif(not (mon._HAVE_TB and jmon._HAVE_TB),
                    reason="tensorboardX does not import on this host")
def test_tensorboard_rows_equal_jax(tmp_path):
    jm, pm = _both(tmp_path, tb=True)
    _feed(jm, RECORDS)
    _feed(pm, RECORDS, tensors=True)
    jm.close()
    pm.close()
    rows = _tb_rows(tmp_path / "port" / "unit")
    assert rows == _tb_rows(tmp_path / "jax" / "unit")
    assert [s for s, _ in rows["Train/Samples/train_loss"]] == \
        [8, 16, 24, 32, 40]


def _observe(backend):
    for sample, scalars in RECORDS:
        for tag, value in scalars.items():
            backend.observe_scalar(tag, float(value), sample)
    for v in (0.4, 3.0, 7.5, 30.0, 700.0, 20000.0):
        backend.observe_histogram("Serve/ttft_ms", v)
        backend.observe_histogram("Serve/inter_token_ms", v / 10)
    backend.observe_scalar("Serve/nan_gauge", float("nan"))
    backend.observe_scalar("Serve/inf_gauge", float("inf"))


def test_prometheus_text_equal_jax():
    jb, pb = jex.PrometheusBackend(), ex.PrometheusBackend()
    for backend in (jb, pb):
        _observe(backend)
    assert pb.render() == jb.render()
    for backend in (jb, pb):
        backend.set_labels({"role": "decode", "host": 'a"b'})
    text = pb.render()
    assert text == jb.render()
    assert 'ds_serve_ttft_ms_bucket{le="+Inf",host="a\\"b",role="decode"} 6' \
        in text
    assert ex.prometheus_name("Train/Fleet/step_skew_ms") == \
        jex.prometheus_name("Train/Fleet/step_skew_ms") == \
        "ds_train_fleet_step_skew_ms"
    assert ex.LATENCY_BUCKETS_MS == jex.LATENCY_BUCKETS_MS


def test_prometheus_scrape_on_loopback(tmp_path):
    (pm,) = _both(tmp_path, tb=False,
                  export={"prometheus_port": 0})[1:]
    backend = pm.prometheus
    assert backend is not None and backend.port
    _feed(pm, RECORDS[:2])
    pm.observe_histogram("Serve/ttft_ms", 12.0)
    pm.flush()
    url = f"http://127.0.0.1:{backend.port}/metrics"
    # no proxy: the scrape stays on this host whatever http_proxy says
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=10) as resp:
        body = resp.read().decode()
    assert body == backend.render()
    assert "ds_train_samples_lr 0.002" in body
    assert 'ds_serve_ttft_ms_bucket{le="25.0"} 1' in body
    pm.close()
    assert backend._server is None


def test_jsonl_rows_equal_jax(tmp_path, monkeypatch):
    fixed = types.SimpleNamespace(time=lambda: 1234.5)
    monkeypatch.setattr(jex, "time", fixed)
    monkeypatch.setattr(ex, "time", fixed)
    jm, pm = _both(tmp_path, tb=False, export={"jsonl": True})
    _feed(jm, RECORDS)
    _feed(pm, RECORDS, tensors=True)
    for m in (jm, pm):
        m.observe_histogram("Serve/ttft_ms", 3.5)
        m.close()
    got = (tmp_path / "port" / "unit" / "events.jsonl").read_text()
    assert got == (tmp_path / "jax" / "unit" / "events.jsonl").read_text()
    assert got.count("\n") == len({s for s, _ in RECORDS}) + 1


def test_histogram_and_rotating_file_match_jax(tmp_path):
    for edges in (ex.LATENCY_BUCKETS_MS, (1.0, 2.0)):
        h, jh = ex.Histogram(edges), jex.Histogram(edges)
        for v in (0.5, 1.0, 1.5, 3.0, 1e6):
            h.observe(v)
            jh.observe(v)
        assert h.cumulative() == jh.cumulative()
        for q in (0.5, 0.99):
            assert h.percentile(q) == jh.percentile(q)
    with pytest.raises(ValueError, match="sorted"):
        ex.Histogram((2.0, 1.0))


def test_device_values_read_at_flush(tmp_path):
    (pm,) = _both(tmp_path, tb=False, flush_interval=3)[1:]
    pm.record(8, {"a": torch.tensor(1.5), "b": 2})
    pm.record(16, {"a": torch.tensor(2.5, dtype=torch.bfloat16)})
    assert len(pm._pending) == 2 and pm.flushes == 0
    assert "\t8\t" not in _read_tsv(tmp_path / "port" / "unit")
    pm.record(24, {"a": np.float64(3.25)})      # the third: a flush
    pm.wait()                                   # on the writer thread
    assert pm.flushes == 1 and pm._pending == []
    pm.flush()
    rows = _read_tsv(tmp_path / "port" / "unit").splitlines()[1:]
    assert rows == ["a\t8\t1.5", "b\t8\t2.0", "a\t16\t2.5", "a\t24\t3.25"]
    # host numbers, numpy scalars and tensors of any dtype read as floats
    assert mon.host_values([0.5, np.float32(1.5), torch.tensor(2),
                            torch.tensor(3.5, dtype=torch.bfloat16)]) == \
        [0.5, 1.5, 2.0, 3.5]
    pm.close()


def test_record_after_close_warns_once(tmp_path, monkeypatch):
    (pm,) = _both(tmp_path, tb=False)[1:]
    warnings = []
    monkeypatch.setattr(mon.logger, "warning", warnings.append)
    pm.close()
    pm.record(8, {"a": 1.0})
    pm.record(16, {"a": 2.0})
    assert len(warnings) == 1 and "after close" in warnings[0]
    assert pm._pending == []


def test_checkpoint_and_health_records_match_jax(tmp_path):
    jm, pm = _both(tmp_path, tb=False)
    stats = {"stall_s": 0.25, "write_s": 1.5, "bytes": 4096}
    health = {"anomalies": 1, "quarantined": 1, "rollbacks": 0}
    for m in (jm, pm):
        m.record_checkpoint(32, stats)
        m.record_health(32, health)
        m.close()
    assert _read_tsv(tmp_path / "port" / "unit") == \
        _read_tsv(tmp_path / "jax" / "unit")


def test_periodic_flush_runs_on_the_writer_thread(tmp_path, monkeypatch):
    import threading
    (pm,) = _both(tmp_path, tb=False, flush_interval=2)[1:]
    seen = []
    real = mon.host_values
    monkeypatch.setattr(mon, "host_values", lambda values: (
        seen.append(threading.current_thread().name), real(values))[1])
    pm.record(8, {"a": torch.tensor(1.0)})
    pm.record(16, {"a": torch.tensor(2.0)})     # periodic: the thread
    pm.wait()
    pm.record(24, {"a": 3.0})
    pm.flush()                                  # explicit: inline
    assert seen == ["ds-monitor-writer", threading.current_thread().name]
    rows = _read_tsv(tmp_path / "port" / "unit").splitlines()[1:]
    assert rows == ["a\t8\t1.0", "a\t16\t2.0", "a\t24\t3.0"]
    pm.close()
