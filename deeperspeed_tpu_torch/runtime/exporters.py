"""Scrapeable metrics export backends for the monitor, and the
fixed-bucket latency histograms of the serving metrics.

The port of `deeperspeed_tpu/runtime/exporters.py` (pure Python, copied
so the port imports nothing of the JAX package). The monitor's event
stream (tensorboardX / TSV) is a FILE; nothing in a serving fleet can
scrape it. These backends ride the monitor's ONE buffered drain
(`TensorBoardMonitor.flush` hands each already-converted float to every
backend; no second copy of the scalar queue exists):

- `PrometheusBackend`: keeps the LATEST value per tag (gauges) plus
  fixed-bucket histograms (admission wait / TTFT / inter-token from the
  serving engine) and serves them in Prometheus text format 0.0.4 from
  a stdlib ``http.server`` daemon thread on a config-gated port
  (``monitor.export.prometheus_port``; 0 binds an ephemeral port:
  tests read ``backend.port``), on 127.0.0.1 unless
  ``prometheus_host`` says otherwise.
- `JSONLBackend`: append-only structured events (one JSON object per
  drain batch) for log shippers, with the same size-based rotation as
  the TSV writer.

`RotatingFile` is the shared rotation primitive (also used by the
monitor's TSV fallback): when the live file crosses ``max_bytes`` it is
rotated to ``<name>.1`` (older generations shift up) and only the last
``keep`` files survive.
"""

import json
import os
import threading
import time

from ..utils.logging import logger

# Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*
_NAME_PREFIX = "ds_"

# fixed latency buckets (milliseconds) — shared with the serving
# histograms so the scrape and the in-process percentiles agree
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0)


def prometheus_name(tag):
    """``Train/Fleet/step_skew_ms`` → ``ds_train_fleet_step_skew_ms``."""
    out = []
    for ch in str(tag):
        out.append(ch.lower() if ch.isalnum() else "_")
    name = "".join(out).strip("_")
    while "__" in name:
        name = name.replace("__", "_")
    return _NAME_PREFIX + name


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


class PrometheusBackend:
    """Latest-value gauges + histograms served over HTTP (module
    docstring). Thread-safe: the serving loop observes while the scrape
    handler renders."""

    def __init__(self, port=None, host="127.0.0.1", labels=None):
        self._lock = threading.Lock()
        self._gauges = {}        # tag -> float
        self._hists = {}         # tag -> Histogram
        self._labels = {}        # constant labels on every family
        self._server = None
        self._thread = None
        self.port = None
        if labels:
            self.set_labels(labels)
        if port is not None:
            self.start_http(port, host=host)

    def set_labels(self, labels):
        """Constant labels rendered on EVERY sample (`role`/`host` for
        a disaggregated serving pool — a fleet scrape can then tell a
        prefill host's ``ds_serve_queue_depth`` from a decode host's).
        Values are escaped per the text format; an empty dict restores
        label-less rendering."""
        clean = {}
        for key, value in dict(labels).items():
            value = (str(value).replace("\\", "\\\\")
                     .replace('"', '\\"').replace("\n", "\\n"))
            clean[str(key)] = value
        with self._lock:
            self._labels = clean

    @staticmethod
    def _label_str(labels, extra=""):
        body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        if extra:
            body = f"{extra},{body}" if body else extra
        return "{" + body + "}" if body else ""

    # -- sink API (fed from the monitor's drain) -------------------------

    def observe_scalar(self, tag, value, sample_count=None):  # noqa: ARG002
        with self._lock:
            self._gauges[tag] = float(value)

    def observe_histogram(self, tag, value, edges=LATENCY_BUCKETS_MS):
        with self._lock:
            hist = self._hists.get(tag)
            if hist is None:
                hist = self._hists[tag] = Histogram(edges)
            hist.observe(value)

    def histogram(self, tag):
        with self._lock:
            return self._hists.get(tag)

    def flush(self):
        pass                     # values are live; nothing buffered here

    # -- text-format rendering -------------------------------------------

    @staticmethod
    def _fmt(value):
        if value != value:       # NaN
            return "NaN"
        if value in (float("inf"), float("-inf")):
            return "+Inf" if value > 0 else "-Inf"
        return repr(float(value))

    def render(self):
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            gauges = dict(self._gauges)
            hists = {tag: (h.cumulative(), h.total, h.count)
                     for tag, h in self._hists.items()}
            labels = dict(self._labels)
        lbl = self._label_str(labels)
        lines = []
        for tag in sorted(gauges):
            name = prometheus_name(tag)
            lines.append(f"# HELP {name} DeeperSpeed-TPU scalar {tag}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{lbl} {self._fmt(gauges[tag])}")
        for tag in sorted(hists):
            name = prometheus_name(tag)
            cumulative, total, count = hists[tag]
            lines.append(f"# HELP {name} DeeperSpeed-TPU histogram {tag}")
            lines.append(f"# TYPE {name} histogram")
            for edge, cum in cumulative:
                le = "+Inf" if edge == float("inf") else self._fmt(edge)
                bucket_lbl = self._label_str(labels, extra=f'le="{le}"')
                lines.append(f"{name}_bucket{bucket_lbl} {cum}")
            lines.append(f"{name}_sum{lbl} {self._fmt(total)}")
            lines.append(f"{name}_count{lbl} {count}")
        return "\n".join(lines) + "\n"

    # -- HTTP endpoint ----------------------------------------------------

    def start_http(self, port, host="127.0.0.1"):
        """Serve ``/metrics`` on ``host:port`` from a daemon thread
        (port 0 = ephemeral; the bound port lands in ``self.port``).
        The default bind is loopback — set
        ``monitor.export.prometheus_host: "0.0.0.0"`` for an off-box
        scrape."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        backend = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 - stdlib API
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = backend.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # noqa: ARG002 - scrape noise
                pass

        self._server = ThreadingHTTPServer((host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="ds-prometheus-exporter", daemon=True)
        self._thread.start()
        logger.info(f"monitor: Prometheus exporter serving /metrics on "
                    f"{host}:{self.port}")
        return self

    def close(self):
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class RotatingFile:
    """Size-rotated append file: ``path`` rolls to ``path.1`` …
    ``path.<keep>`` at ``max_bytes`` (0 disables rotation)."""

    def __init__(self, path, max_bytes=0, keep=5, header=None):
        self.path = path
        self.max_bytes = int(max_bytes)
        self.keep = max(int(keep), 1)
        self.header = header
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._open()

    def _open(self):
        self._f = open(self.path, "a")
        if self.header and self._f.tell() == 0:
            self._f.write(self.header)

    def write(self, text):
        self._f.write(text)
        if self.max_bytes and self._f.tell() >= self.max_bytes:
            self.rotate()

    def rotate(self):
        self._f.close()
        # path.<keep-1> overwrites path.<keep>; older generations are gone
        for i in range(self.keep - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._open()

    def tell(self):
        return self._f.tell()

    def flush(self, fsync=False):
        self._f.flush()
        if fsync:
            try:
                os.fsync(self._f.fileno())
            except OSError:  # pragma: no cover - exotic filesystems
                pass

    def close(self):
        self.flush(fsync=True)
        self._f.close()


class JSONLBackend:
    """Structured-JSONL event stream: one JSON object per drained
    record batch (``{"ts", "sample", "scalars": {...}}``) plus
    histogram snapshots on close — machine-parseable without
    tensorboard tooling, rotated like the TSV fallback."""

    def __init__(self, log_dir, max_bytes=0, keep=5):
        self._file = RotatingFile(os.path.join(log_dir, "events.jsonl"),
                                  max_bytes=max_bytes, keep=keep)
        self._batch = {}         # sample -> scalars accumulated pre-flush
        self._observations = []  # (ts, tag, value) accumulated pre-flush

    @property
    def path(self):
        return self._file.path

    def observe_scalar(self, tag, value, sample_count=0):
        self._batch.setdefault(int(sample_count), {})[tag] = float(value)

    def observe_histogram(self, tag, value, edges=None):  # noqa: ARG002
        # buffered like the scalars: histogram observations arrive from
        # the serving DECODE loop (one per generated token) — a
        # synchronous file write per token would put disk latency on
        # the hot path
        # true epoch timestamp: JSONL "ts" fields are parsed by external
        # tooling that correlates records across hosts/restarts
        self._observations.append(
            (time.time(), tag, float(value)))

    def flush(self):
        batches, self._batch = self._batch, {}
        obs, self._observations = self._observations, []
        now = time.time()  # the JSONL epoch "ts"
        for sample in sorted(batches):
            self._file.write(json.dumps(
                {"ts": now, "sample": sample,
                 "scalars": batches[sample]}) + "\n")
        for ts, tag, value in obs:
            self._file.write(json.dumps(
                {"ts": ts, "kind": "observation", "tag": tag,
                 "value": value}) + "\n")
        self._file.flush()

    def close(self):
        self.flush()
        self._file.close()


def build_export_backends(export, log_dir):
    """Backends from the validated ``monitor.export`` config dict
    (empty list when nothing is enabled)."""
    backends = []
    if not export:
        return backends
    max_bytes = int(float(export.get("rotate_max_mb", 0)) * 1024 * 1024)
    keep = int(export.get("rotate_keep", 5))
    port = export.get("prometheus_port")
    if port is not None:
        backends.append(PrometheusBackend(
            port=port, host=export.get("prometheus_host", "127.0.0.1")))
    if export.get("jsonl"):
        backends.append(JSONLBackend(log_dir, max_bytes=max_bytes,
                                     keep=keep))
    return backends
