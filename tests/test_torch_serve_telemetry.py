"""The serving engine with telemetry and a monitor, against the JAX
serving engine, on the CPU: the same shared-prefix stream (fp32, greedy,
tiny GPT-NeoX from one JAX seed, both engines on fake clocks) through
both engines, each with a "telemetry" block and a recording monitor,
must give the same span names (schedule / prefill / decode), the same
per-step Serve/* scalars at the same token counts, the same histogram
tags and observation counts, and the same Serve/* tags at `drain` but
for the disaggregation handoff counters, which the port does not carry
(scale-out, A.7). `drain` closes a monitor the engine owns and flushes
one it borrows. A real monitor with a Prometheus port serves the TTFT
and inter-token histograms on 127.0.0.1, and the tokens are those of an
engine without telemetry.
"""

import urllib.request

import pytest
import torch

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu_torch import InferenceEngine
from deeperspeed_tpu_torch.runtime.monitor import TensorBoardMonitor

from tests.torch_serving import (build_models, config, fake_clocks, serve,
                                 stream)

torch.set_num_threads(2)

TELEMETRY = {"enabled": True}
# the JAX engine's counters of disaggregated serving (handoff offers and
# their verdicts), pushed by its serve_stats: no port counterpart until
# the disaggregated roles are ported (A.7)
JAX_ONLY = {f"Serve/handoff_{k}" for k in (
    "sent", "acked", "rejected", "expired", "installed", "refused")}


class RecordingMonitor:
    def __init__(self):
        self.records, self.histograms = [], []
        self.flushes = self.closes = 0

    def record(self, sample, scalars):
        self.records.append((sample, dict(scalars)))

    def observe_histogram(self, tag, value, edges=None):
        self.histograms.append(tag)

    def flush(self):
        self.flushes += 1

    def close(self):
        self.closes += 1


@pytest.fixture(scope="module")
def models():
    return build_models(("gpt_neox",))["gpt_neox"]["target"]


def _pair(models, monitors, owns=True, telemetry=TELEMETRY):
    jmodel, jparams, model = models
    conf = dict(config(), telemetry=telemetry)
    return (JaxEngine(jmodel, config=conf, params=jparams,
                      monitor=monitors[0], owns_monitor=owns),
            InferenceEngine(model, config=conf, device="cpu",
                            monitor=monitors[1], owns_monitor=owns))


def test_spans_and_serve_scalars_match_jax(models, monkeypatch):
    fake_clocks(monkeypatch)
    monitors = RecordingMonitor(), RecordingMonitor()
    jeng, eng = _pair(models, monitors)
    prompts = stream(0, n=6)
    news = [4 + i % 3 for i in range(6)]
    out = [serve(e, prompts, news) for e in (jeng, eng)]
    assert out[0] == out[1]
    phases = [set(e.telemetry.tracer.drain_phases()) for e in (jeng, eng)]
    assert phases[0] == phases[1] == {"schedule", "prefill", "decode"}
    steps = [m.records for m in monitors]
    assert len(steps[0]) == len(steps[1]) == eng.stats["steps"]
    assert steps[1] == steps[0]
    assert monitors[1].histograms == monitors[0].histograms
    assert set(monitors[1].histograms) == {
        "Serve/admission_wait_ms", "Serve/ttft_ms", "Serve/inter_token_ms"}
    for eng_, mon in zip((jeng, eng), monitors):
        eng_.drain()
        assert mon.closes == 1
    final = [set(m.records[-1][1]) for m in monitors]
    assert final[0] - final[1] == JAX_ONLY
    assert final[1] <= final[0]
    assert monitors[1].records[-1][0] == monitors[0].records[-1][0]


def test_drain_flushes_a_borrowed_monitor(models):
    monitors = RecordingMonitor(), RecordingMonitor()
    jeng, eng = _pair(models, monitors, owns=False)
    for eng_, mon in zip((jeng, eng), monitors):
        serve(eng_, stream(1, n=2), [3, 3])
        eng_.drain()
        assert mon.closes == 0 and mon.flushes == 1


def test_prometheus_scrape_and_tokens_unchanged(models, tmp_path):
    jmodel, jparams, model = models
    prompts, news = stream(2, n=4), [5] * 4
    bare = InferenceEngine(model, config=config(), device="cpu")
    want = serve(bare, prompts, news)
    monitor = TensorBoardMonitor(output_path=str(tmp_path), job_name="serve",
                                 export={"prometheus_port": 0})
    eng = InferenceEngine(model, config=dict(config(), telemetry=TELEMETRY),
                          device="cpu", monitor=monitor)
    assert serve(eng, prompts, news) == want
    port = monitor.prometheus.port
    # no proxy: the scrape stays on this host whatever http_proxy says
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    body = opener.open(f"http://127.0.0.1:{port}/metrics",
                       timeout=10).read().decode()
    for family in ("ds_serve_ttft_ms_bucket", "ds_serve_inter_token_ms_count",
                   "ds_serve_admission_wait_ms_sum"):
        assert family in body
    assert 'ds_serve_ttft_ms_count 4' in body
    eng.drain()
    assert monitor.writer is None     # owned: closed by the drain
    assert monitor.prometheus is None
