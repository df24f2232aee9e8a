"""Training-metrics event writer (reference: `deepspeed/runtime/engine.py:
163-164,1222-1275`: tensorboardX SummaryWriter logging train loss, lr,
loss scale and step times, keyed by global SAMPLE count).

The port of `deeperspeed_tpu/runtime/monitor.py`. The engine hands the
monitor 0-d device tensors (the step's grad norm, the MoE routing
statistics) beside host floats; reading each on the spot would stall
the launch queue once a value. The monitor therefore *buffers* them and
drains every `flush_interval` records: the device values of the whole
window are stacked and read with ONE device-to-host copy, then every
value goes to every sink as a host float. The periodic drain
(``drain=False``) hands its batch to one writer thread through a queue,
so neither its device read nor its file writes sit in the training
loop; an explicit `flush()` and `close()` write inline once the queue
is empty. The training thread never synchronizes the device for the
monitor.

Backends: tensorboardX when it imports (real event files, as the
reference), else a TSV file with the same tag/sample/value rows; the
data is never silently dropped and nothing is installed. The TSV file is
size-rotated (``monitor.export.rotate_max_mb`` / ``rotate_keep``).

Export backends (`runtime/exporters.py`, the ``monitor.export`` config
block): a Prometheus text-format HTTP endpoint and a structured-JSONL
stream, fed inside the same drain. One process trains on one card here,
so ``rank`` defaults to 0.
"""

import atexit
import os
import queue
import threading
import time
import weakref

import torch

from ..utils.logging import log_dist, logger
from .exporters import PrometheusBackend, RotatingFile, build_export_backends
from .utils import register_weak_atexit

try:
    from tensorboardX import SummaryWriter as _TBWriter
    _HAVE_TB = True
except Exception:  # pragma: no cover - the TSV fallback
    _TBWriter = None
    _HAVE_TB = False


class _TSVWriter:
    """Fallback event writer: size-rotated `events.tsv` of
    (tag, sample, value) rows."""

    def __init__(self, log_dir, max_bytes=0, keep=5):
        self._file = RotatingFile(os.path.join(log_dir, "events.tsv"),
                                  max_bytes=max_bytes, keep=keep,
                                  header="tag\tsample\tvalue\n")

    def add_scalar(self, tag, value, global_step):
        self._file.write(f"{tag}\t{global_step}\t{value}\n")

    def flush(self, fsync=False):
        # flush on the TB path's cadence; the fsync barrier is kept for
        # draining flushes and close (a per-interval fsync on a networked
        # filesystem would stall the training loop)
        self._file.flush(fsync=fsync)

    def close(self):
        self._file.close()


def host_values(values):
    """The host floats of a list of values (host numbers or tensors):
    every tensor on a device is stacked by device and read with one copy
    a device, not one `.item()` each."""
    out = [None] * len(values)
    by_device = {}
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cpu":
                out[i] = float(v)
            else:
                by_device.setdefault(v.device, []).append(i)
        else:
            out[i] = float(v)
    for device, idx in by_device.items():
        # float64: every fp32 / bf16 / integer value reads exactly
        stacked = torch.stack([values[i].detach().reshape(()).double()
                               for i in idx])
        for i, v in zip(idx, stacked.cpu().tolist()):
            out[i] = v
    return out


def _writer_loop(monitor_ref, batches):
    """The writer thread: write each queued batch through the monitor
    (held weakly, so a dropped monitor stays collectible) until a None
    arrives or the monitor is gone."""
    while True:
        batch = batches.get()
        try:
            monitor = monitor_ref()
            if batch is None or monitor is None:
                return
            try:
                monitor._write_batch(batch, drain=False)
            except Exception as e:  # noqa: BLE001 - surfaced by wait()
                monitor._write_error = e
            del monitor
        finally:
            batches.task_done()


class TensorBoardMonitor:
    """Reference-layout event stream: `Train/Samples/<metric>` scalars
    keyed by global sample count (reference `engine.py:1222-1275`)."""

    def __init__(self, output_path="", job_name="DeepSpeedJobName",
                 flush_interval=10, rank=0, export=None):
        self.enabled = rank == 0
        self._pending = []          # (sample_count, {tag: tensor-or-float})
        self.flush_interval = max(1, int(flush_interval))
        self.writer = None
        self._warned_closed = False
        self._export_backends = []
        self.flushes = 0            # drains that wrote pending records
        self._queue = None          # periodic drains for the writer thread
        self._thread = None
        self._write_error = None
        if not self.enabled:
            return
        export = export or {}
        log_dir = os.path.join(output_path or os.getcwd(), job_name)
        self.log_dir = log_dir
        rotate_bytes = int(float(export.get("rotate_max_mb", 0))
                           * 1024 * 1024)
        if _HAVE_TB:
            self.writer = _TBWriter(log_dir=log_dir)
        else:  # pragma: no cover - exercised by monkeypatching _HAVE_TB
            self.writer = _TSVWriter(log_dir, max_bytes=rotate_bytes,
                                     keep=export.get("rotate_keep", 5))
            logger.warning("tensorboardX unavailable; writing TSV events "
                           f"to {log_dir}/events.tsv")
        self._export_backends = build_export_backends(export, log_dir)
        # drain buffered scalars on interpreter shutdown (weakly held:
        # discarded monitors stay collectible)
        self._atexit = register_weak_atexit(self, "close")
        log_dist(f"Monitor: writing events to {log_dir}", ranks=[0])

    @property
    def prometheus(self):
        """The PrometheusBackend when ``monitor.export.prometheus_port``
        armed one (tests and the serving engine read its port), else
        None."""
        for backend in self._export_backends:
            if isinstance(backend, PrometheusBackend):
                return backend
        return None

    def record(self, sample_count, scalars):
        """Queue `{tag: value}` at `sample_count`; values may be 0-d
        device tensors (read at the flush, all in one copy)."""
        if not self.enabled:
            return
        if self.writer is None:
            # closed: warn once, drop loudly (a record after close is a
            # lifecycle bug of the caller)
            if not self._warned_closed:
                self._warned_closed = True
                logger.warning(
                    "monitor: record() after close(); events are being "
                    "dropped (fix the caller's monitor lifecycle)")
            return
        self._pending.append((int(sample_count), dict(scalars)))
        if len(self._pending) >= self.flush_interval:
            # periodic flush: hand events to the writer thread but do NOT
            # drain it (draining blocks the training loop on telemetry)
            self.flush(drain=False)

    def set_export_labels(self, labels):
        """Stamp constant labels (``role``/``host``) onto every export
        backend that renders them (the Prometheus scrape)."""
        if not self.enabled:
            return
        for backend in self._export_backends:
            hook = getattr(backend, "set_labels", None)
            if hook is not None:
                hook(labels)

    def observe_histogram(self, tag, value, edges=None):
        """Feed one histogram observation (the serving latencies) to every
        export backend that keeps distributions. Host floats, no
        buffering."""
        if not self.enabled or self.writer is None:
            return
        for backend in self._export_backends:
            hook = getattr(backend, "observe_histogram", None)
            if hook is not None:
                if edges is not None:
                    hook(tag, float(value), edges=edges)
                else:
                    hook(tag, float(value))

    def flush(self, drain=True):
        """Write pending scalars. `drain=True` (explicit/user flush)
        writes inline once the writer thread is done, and waits for
        tensorboardX's own queue, so events are durable for readers; the
        periodic auto-flush passes drain=False and hands the batch to the
        writer thread (after the one before it is written)."""
        if not self.enabled or self.writer is None:
            return
        batch, self._pending = self._pending, []
        if drain:
            self.wait()
            self._write_batch(batch, drain=True)
            return
        if self._queue is None:
            self._queue = queue.Queue()
            self._thread = threading.Thread(
                target=_writer_loop, args=(weakref.ref(self), self._queue),
                name="ds-monitor-writer", daemon=True)
            self._thread.start()
        self._queue.put(batch)

    def wait(self):
        """Block until every periodic drain handed to the writer thread
        is written; a failure there is logged here."""
        if self._queue is not None:
            self._queue.join()
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            logger.warning(f"monitor: a periodic flush failed: {err!r}")

    def _write_batch(self, batch, drain):
        if batch:
            rows = [(sample, tag, value)
                    for sample, scalars in batch
                    for tag, value in scalars.items()]
            # ONE host conversion per scalar (and one copy a device),
            # shared by every sink
            floats = host_values([value for _, _, value in rows])
            for (sample, tag, _), v in zip(rows, floats):
                self.writer.add_scalar(tag, v, sample)
                for backend in self._export_backends:
                    backend.observe_scalar(tag, v, sample)
            self.flushes += 1
            if drain:
                self._drain_writer_queue()
            if isinstance(self.writer, _TSVWriter):
                self.writer.flush(fsync=drain)
            else:
                self.writer.flush()
        # backends flush even with no pending scalars: the JSONL sink
        # buffers histogram observations apart from the queue
        for backend in self._export_backends:
            backend.flush()

    def _drain_writer_queue(self):
        """tensorboardX queues events to a worker thread and its flush()
        does NOT drain the queue: without this, events recorded just
        before flush can be invisible to readers until close()."""
        fw = getattr(self.writer, "file_writer", None)
        ew = getattr(fw, "event_writer", None) if fw is not None else None
        q = getattr(ew, "_event_queue", None) if ew is not None else None
        if q is None:
            return
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                if q.empty():
                    break
            except (OSError, ValueError):  # pragma: no cover - closed queue
                break
            time.sleep(0.005)
        # the worker may still be mid-write on the last event it popped
        time.sleep(0.02)

    def record_checkpoint(self, sample_count, stats):
        """Goodput counters of one completed checkpoint save: `stall_s`
        is the snapshot time the training loop was blocked, `write_s`
        the background write and commit, `bytes` the checkpoint size."""
        if not self.enabled:
            return
        self.record(sample_count, {
            "Train/Checkpoint/stall_ms": stats["stall_s"] * 1e3,
            "Train/Checkpoint/write_ms": stats["write_s"] * 1e3,
            "Train/Checkpoint/bytes_written": stats["bytes"],
        })

    def record_health(self, sample_count, counters):
        """Training-health sentinel counters (runtime/sentinel.py),
        recorded only when something changed."""
        if not self.enabled:
            return
        self.record(sample_count, {
            f"Train/Sentinel/{tag}": value
            for tag, value in counters.items()})

    def close(self):
        if self.writer is not None:
            self.flush()
            if self._queue is not None:
                self._queue.put(None)       # the writer thread exits
                self._thread.join()
                self._queue = self._thread = None
            self.writer.close()
            self.writer = None
            for backend in self._export_backends:
                try:
                    backend.close()
                except Exception as e:  # noqa: BLE001 - best-effort
                    logger.warning(f"monitor: export backend close "
                                   f"failed: {e}")
            self._export_backends = []
            try:
                atexit.unregister(self._atexit)
            except Exception:  # pragma: no cover
                pass
