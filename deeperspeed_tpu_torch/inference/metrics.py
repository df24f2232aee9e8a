"""Request-level serving observability.

The serving engine's ``Serve/*`` counters are aggregates — total
prefill tokens, cumulative phase seconds. Operating a fleet needs
*distributions*: a p99 TTFT regression is invisible in a mean. This
module keeps fixed-bucket histograms (the same bucket ladder the
Prometheus exporter renders, so in-process percentiles and the scrape
agree) for the three per-request latencies:

- **admission wait**: enqueue → admitted (scheduler queueing delay;
  re-counted from the requeue after an eviction, matching the
  scheduler's `enqueued_at` reset);
- **TTFT** (time to first token): submit → first sampled token, once
  per request (an evicted request's re-prefill does not re-count it);
- **inter-token**: gap between consecutive sampled tokens of one
  request (the decode cadence users actually feel).

Every observation is also forwarded to the monitor's export backends
(`TensorBoardMonitor.observe_histogram`) so the Prometheus endpoint
serves ``Serve/*`` histogram families with bucket counts, sum, and
count. Host floats only — the serving loop already measured these on
the host, nothing here touches a device value.
"""

from ..runtime.exporters import LATENCY_BUCKETS_MS, Histogram
from .admission import REQUEST_STATUSES

# monitor/Prometheus family names
ADMISSION_WAIT = "Serve/admission_wait_ms"
TTFT = "Serve/ttft_ms"
INTER_TOKEN = "Serve/inter_token_ms"
# disaggregated handoff: offer-publish → ack-receipt round
# trip, observed on the prefill pool (inference/handoff.py)
HANDOFF = "Serve/handoff_ms"

# front-end router gauge families (inference/router.py): cumulative
# routed/shed counts, the cross-pool handoff p50, per-pool load scores,
# and the advisory autoscaling bit — recorded as monitor scalars by
# `ServeRouter.serve_stats` (latest-value gauges on the scrape)
ROUTER_ROUTED = "Serve/router/routed"
ROUTER_SHED = "Serve/router/shed"
ROUTER_HANDOFF_MS = "Serve/router/handoff_ms"
ROUTER_POOL_LOAD = "Serve/router/load"
ROUTER_ADVISE_SCALE_UP = "Serve/router/advise_scale_up"

# prefix-cache / speculative-decode gauge families: recorded as
# monitor scalars every step, like REQUEST_STATUS_FAMILIES below —
# latest-value gauges on the Prometheus scrape
PREFIX_HIT_RATE = "Serve/prefix_cache/hit_rate"
PREFIX_PAGES_SHARED = "Serve/prefix_cache/pages_shared"
PREFIX_SAVED_PREFILL_TOKENS = "Serve/prefix_cache/saved_prefill_tokens"
SPEC_ACCEPTANCE_RATE = "Serve/speculative/acceptance_rate"

# per-terminal-status request counters (admission.REQUEST_STATUSES):
# the engine records these every step as monitor scalars, so they ride
# the single buffered drain into EVERY export backend — latest-value
# gauges on the Prometheus scrape, per-drain events on the JSONL stream
REQUEST_STATUS_FAMILIES = {
    status: f"Serve/requests_{status}" for status in REQUEST_STATUSES}


class ServeRequestMetrics:
    """Fixed-bucket latency histograms + monitor fan-out."""

    def __init__(self, monitor=None, buckets=LATENCY_BUCKETS_MS):
        self.monitor = monitor
        self.admission_wait = Histogram(buckets)
        self.ttft = Histogram(buckets)
        self.inter_token = Histogram(buckets)
        self.handoff = Histogram(buckets)

    def _observe(self, hist, tag, ms):
        ms = max(float(ms), 0.0)
        hist.observe(ms)
        if self.monitor is not None:
            hook = getattr(self.monitor, "observe_histogram", None)
            if hook is not None:
                hook(tag, ms)

    def observe_admission_wait(self, seconds):
        self._observe(self.admission_wait, ADMISSION_WAIT, seconds * 1e3)

    def observe_ttft(self, seconds):
        self._observe(self.ttft, TTFT, seconds * 1e3)

    def observe_inter_token(self, seconds):
        self._observe(self.inter_token, INTER_TOKEN, seconds * 1e3)

    def observe_handoff(self, seconds):
        self._observe(self.handoff, HANDOFF, seconds * 1e3)

    def summary(self):
        """p50/p99 scalars (ms) for `serve_stats` — None-valued entries
        are omitted (no observations yet)."""
        out = {}
        for name, hist in (("admission_wait", self.admission_wait),
                           ("ttft", self.ttft),
                           ("inter_token", self.inter_token),
                           ("handoff", self.handoff)):
            for q, label in ((0.5, "p50"), (0.99, "p99")):
                value = hist.percentile(q)
                if value is not None:
                    out[f"{name}_{label}_ms"] = value
        return out
