"""Fixed-bucket latency histograms for the serving metrics.

The part of `deeperspeed_tpu/runtime/exporters.py` the serving engine
needs (`Histogram`, `LATENCY_BUCKETS_MS`); the Prometheus and JSONL
export backends wait for the observability slice.
"""

# fixed latency buckets (milliseconds) — shared with the serving
# histograms so the scrape and the in-process percentiles agree
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: each
    bucket counts observations ≤ its upper edge; +Inf is implicit)."""

    __slots__ = ("edges", "counts", "inf_count", "total", "count")

    def __init__(self, edges=LATENCY_BUCKETS_MS):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(self.edges):
            raise ValueError(f"histogram bucket edges must be sorted, "
                             f"got {edges}")
        self.counts = [0] * len(self.edges)
        self.inf_count = 0
        self.total = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        self.total += value
        self.count += 1
        for i, edge in enumerate(self.edges):
            if value <= edge:
                self.counts[i] += 1
                return
        self.inf_count += 1

    def cumulative(self):
        """[(upper_edge, cumulative_count)] plus the +Inf bucket."""
        out, running = [], 0
        for edge, n in zip(self.edges, self.counts):
            running += n
            out.append((edge, running))
        out.append((float("inf"), running + self.inf_count))
        return out

    def percentile(self, q):
        """Approximate q-quantile (upper edge of the covering bucket;
        None with no observations)."""
        if self.count == 0:
            return None
        target = q * self.count
        for edge, cum in self.cumulative():
            if cum >= target:
                return edge if edge != float("inf") else self.edges[-1]
        return self.edges[-1]  # pragma: no cover - cumulative covers all
