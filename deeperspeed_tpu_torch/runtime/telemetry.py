"""Unified telemetry: step/phase tracing, goodput + MFU accounting, and
trigger-driven profiler capture.

The port of `deeperspeed_tpu/runtime/telemetry.py`: one config-driven
layer (the ``"telemetry"`` JSON block) the engine consults every step:

- **Span tracer** (`telemetry.span("data_fetch")`): host-side phase
  timing around the boundaries the engine owns: data fetch, train-step
  dispatch, checkpoint snapshot stall, sentinel escalation, rollback
  restore; in serving schedule, prefill and decode. Each span also
  enters `torch.profiler.record_function(name)` (where JAX enters a
  `jax.profiler.TraceAnnotation`), so a `torch.profiler` trace of the
  same steps carries the phase names beside the kernels; the host spans
  export as Chrome-trace/Perfetto JSON per capture window.
- **Goodput accounting**: the wall time inside step windows is split
  into productive / data_wait / param_wait / ckpt_stall / quarantined /
  rollback buckets, emitted as `Train/Goodput/*` scalars plus a running
  `Train/Goodput/fraction` (productive over everything).
- **In-engine MFU**: the engine counts a step variant's flops once
  (`register_compiled(key, flops)`, key = the accumulation steps, as the
  JAX engine keys ``compiled_flops``; the count is the flops profiler's
  `count_train_flops`, over fake tensors, its seconds left out of the
  step window by `outside_window`) and every step emits
  `Train/Samples/mfu` and the achieved TFLOP/s against the card's peak
  (`profiling.hardware`). The
  JAX layer's `_AOTStep` and `aot_compile_with_flops` have no
  counterpart: nothing is compiled ahead of time here.
- **Trigger-driven capture**: ``capture: {start_step, num_steps}`` arms
  a `torch.profiler` window whose Chrome trace is exported beside
  ``spans_<tag>.json``; ``memory_watermark_interval_steps`` emits the
  caching allocator's watermark scalars (`torch.cuda.memory_stats`, a
  host query); the on-anomaly hook (the sentinel's flagged steps and its
  hang watchdog) writes a memory snapshot at once and arms a trace of
  the following step(s), at most once per anomaly episode.

Zero-overhead path: when the block is absent the engine holds
`NULL_TELEMETRY`, whose hooks are empty methods and whose `span()`
returns a shared no-op context manager. Nothing here reads a device
value: the step's scalars are host floats or 0-d device tensors that
the monitor reads at its flush. The ``fleet`` sub-block is not ported
(the config refuses it).
"""

import contextlib
import json
import os
import threading
import time
import weakref

import torch

from ..utils.logging import log_dist, logger

# one process-wide flag: torch.profiler allows a single active profile a
# process; overlapping windows (scheduled + anomaly) must coalesce, not
# crash
_TRACE_LOCK = threading.Lock()
_TRACE_ACTIVE = False


def _release_orphaned_trace(wstate):
    """weakref.finalize target: a Telemetry collected mid-capture-window
    must stop the profile it started and release the process-wide flag,
    or every later window in the process silently skips tracing. Shares
    only the mutable `wstate` dict with the owner (no reference
    cycle)."""
    global _TRACE_ACTIVE
    prof = wstate.get("profile")
    if prof is None:
        return
    with _TRACE_LOCK:
        try:
            prof.stop()
        except Exception:  # noqa: BLE001 - interpreter may be tearing down
            pass
        _TRACE_ACTIVE = False
        wstate["profile"] = None


def start_trace():
    """Start a `torch.profiler` profile of the CPU and the card, unless
    one started here is active (torch.profiler allows one a process; the
    capture windows and `utils.timer.profiler_trace` share the flag):
    the profile, or None when the process already traces."""
    global _TRACE_ACTIVE
    with _TRACE_LOCK:
        if _TRACE_ACTIVE:
            return None
        from torch.profiler import profile
        prof = profile(activities=_profiler_activities())
        prof.start()
        _TRACE_ACTIVE = True
        return prof


def stop_trace(prof, path=None):
    """Stop a profile of `start_trace`, export its Chrome trace to
    ``path`` where given, and release the process-wide flag (also when
    the stop or the export fails)."""
    global _TRACE_ACTIVE
    with _TRACE_LOCK:
        try:
            prof.stop()
            if path is not None:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                prof.export_chrome_trace(path)
        finally:
            _TRACE_ACTIVE = False


def _profiler_activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class _NullSpan:
    """Shared no-op context manager (the zero-overhead span)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: phase accumulation + optional capture-buffer entry
    + a mirrored `torch.profiler.record_function`, so device timelines
    show the same names."""
    __slots__ = ("tel", "name", "t0", "ann")

    def __init__(self, tel, name):
        self.tel = tel
        self.name = name
        self.ann = None

    def __enter__(self):
        tel = self.tel
        self.t0 = time.perf_counter()
        tel._depth += 1
        if tel.mirror_annotations:
            self.ann = torch.profiler.record_function(self.name)
            self.ann.__enter__()
        return self

    def __exit__(self, *exc):
        tel = self.tel
        t1 = time.perf_counter()
        tel._depth -= 1
        if self.ann is not None:
            self.ann.__exit__(*exc)
        tel._on_span(self.name, self.t0, t1 - self.t0, tel._depth)
        return False


class SpanTracer:
    """Host-side span recorder. Always accumulates per-step phase
    durations (goodput inputs); buffers full (name, ts, dur, depth)
    events only while a capture window is open, and exports them as a
    Chrome-trace JSON (`{"traceEvents": [...]}`, "X" complete events,
    microsecond timestamps) loadable in Perfetto/chrome://tracing."""

    def __init__(self, mirror_annotations=True):
        self.mirror_annotations = mirror_annotations
        self._depth = 0
        self._phase_acc = {}        # name -> seconds, this step window
        self._buffer = []           # capture-window events
        self.capturing = False

    def span(self, name):
        return _Span(self, name)

    def _on_span(self, name, t0, dur, depth):
        self._phase_acc[name] = self._phase_acc.get(name, 0.0) + dur
        if self.capturing:
            self._buffer.append((name, t0, dur, depth))

    def record_event(self, name, t0, dur, depth=0):
        """Append one pre-timed event to an open capture window (the
        serving engine's per-request lifecycle records). No-op outside a
        window."""
        if self.capturing:
            self._buffer.append((str(name), float(t0), float(dur),
                                 int(depth)))

    def drain_phases(self):
        phases, self._phase_acc = self._phase_acc, {}
        return phases

    def start_capture(self):
        self._buffer = []
        self.capturing = True

    def stop_capture(self):
        self.capturing = False
        events, self._buffer = self._buffer, []
        return events

    @staticmethod
    def chrome_trace(events, pid=0, metadata=None):
        """Chrome-trace dict for a list of (name, t0, dur, depth);
        `metadata` (the kernel dispatch report) lands in the trace's
        ``otherData``."""
        trace_events = [
            {"name": name, "ph": "X", "pid": pid, "tid": depth,
             "ts": t0 * 1e6, "dur": dur * 1e6,
             "cat": "deeperspeed_tpu"}
            for name, t0, dur, depth in events]
        trace = {"traceEvents": trace_events,
                 "displayTimeUnit": "ms"}
        if metadata:
            trace["otherData"] = metadata
        return trace

    @classmethod
    def export_chrome_trace(cls, events, path, pid=0, metadata=None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(cls.chrome_trace(events, pid=pid,
                                       metadata=metadata), f)
        return path


# goodput bucket names, in emission order
GOODPUT_BUCKETS = ("productive", "data_wait", "param_wait", "ckpt_stall",
                   "quarantined", "rollback")


class GoodputMeter:
    """Cumulative wall-time classifier over step windows.

    Every `account()` call covers one step window of `dt` seconds and
    splits it: data-fetch span time is charged to `data_wait`;
    parameter-fetch stalls (`param_gather` spans; no port path has one
    yet) to `param_wait`; the checkpoint snapshot stall (the delta of the
    async manager's cumulative stall inside this window) to
    `ckpt_stall`; the rest goes to `productive` for taken steps,
    `quarantined` for skipped updates (sentinel quarantine or fp16
    overflow: the step burned time without advancing), and `rollback`
    for windows that ended in a checkpoint restore."""

    def __init__(self):
        self.buckets = {name: 0.0 for name in GOODPUT_BUCKETS}

    def account(self, dt, verdict, data_wait=0.0, param_wait=0.0,
                ckpt_stall=0.0):
        data_wait = min(max(data_wait, 0.0), dt)
        param_wait = min(max(param_wait, 0.0), dt - data_wait)
        ckpt_stall = min(max(ckpt_stall, 0.0),
                         dt - data_wait - param_wait)
        rest = dt - data_wait - param_wait - ckpt_stall
        self.buckets["data_wait"] += data_wait
        self.buckets["param_wait"] += param_wait
        self.buckets["ckpt_stall"] += ckpt_stall
        if verdict == "rollback":
            self.buckets["rollback"] += rest
        elif verdict in ("quarantined", "overflow"):
            self.buckets["quarantined"] += rest
        else:
            self.buckets["productive"] += rest

    @property
    def total(self):
        return sum(self.buckets.values())

    @property
    def fraction(self):
        total = self.total
        return self.buckets["productive"] / total if total > 0 else 1.0

    def scalars(self):
        out = {f"Train/Goodput/{name}_s": secs
               for name, secs in self.buckets.items()}
        out["Train/Goodput/fraction"] = self.fraction
        return out


class _NullTelemetry:
    """The absent-config telemetry object: every hook is a no-op and
    `span()` hands back one shared do-nothing context manager."""

    enabled = False
    wants_flops = False
    spans_enabled = False

    def span(self, name):  # noqa: ARG002
        return _NULL_SPAN

    def step_annotation(self, step):  # noqa: ARG002
        return _NULL_SPAN

    def on_step_start(self, step):  # noqa: ARG002
        pass

    def outside_window(self):
        return _NULL_SPAN

    def on_step_end(self, engine, verdict="ok", flops=None, steps=1,
                    tokens=None):
        pass

    def on_anomaly(self, engine, kind, step=None):
        pass

    def register_compiled(self, key, flops):
        pass

    def close(self):
        pass


NULL_TELEMETRY = _NullTelemetry()


class Telemetry:
    """Config-driven engine telemetry (the ``"telemetry"`` JSON block).

    Constructed by the engine AFTER the monitor; emits scalars through
    `monitor.record` keyed by the engine's global sample count, so the
    goodput/MFU/memory series line up with the loss series."""

    enabled = True

    def __init__(self, monitor=None, devices=None, goodput=True, mfu=True,
                 spans=True, trace_dir=None, capture=None,
                 memory_watermark_interval_steps=0,
                 capture_on_anomaly=False, anomaly_capture_steps=1,
                 fleet=None):
        if fleet:
            from .config_utils import DeepSpeedConfigError
            raise DeepSpeedConfigError(
                "telemetry.fleet is not ported (fleet, A.8.3): the "
                "cross-host aggregation needs more than one rank")
        self.monitor = monitor
        self.devices = [torch.device(d) for d in (devices or [])]
        self.goodput_enabled = bool(goodput)
        self.mfu_enabled = bool(mfu)
        self.spans_enabled = bool(spans)
        self.trace_dir = trace_dir
        self.capture_start_step = None
        self.capture_num_steps = 0
        if capture:
            self.capture_start_step = int(capture["start_step"])
            self.capture_num_steps = int(capture["num_steps"])
        self.memory_watermark_interval = int(memory_watermark_interval_steps)
        self.capture_on_anomaly = bool(capture_on_anomaly)
        self.anomaly_capture_steps = int(anomaly_capture_steps)

        self.tracer = SpanTracer(mirror_annotations=self.spans_enabled)
        self.goodput = GoodputMeter()
        self.compiled_flops = {}    # step-variant key -> flops a step

        self._step_t0 = None
        self._steps_seen = 0
        self._last_ckpt_stall = None
        self._peak_flops = None
        # packed-batch effective-token accounting (runtime/packing.py)
        self._tokens_effective = 0
        self._tokens_total = 0

        # capture-window state. The live profile lives in a dict shared
        # with a weakref.finalize: a Telemetry collected mid-window must
        # still stop it and release the process-wide flag
        self._window_open = False
        self._window_tag = None
        self._window_steps_left = 0
        self._wstate = {"profile": None}
        self._finalizer = weakref.finalize(self, _release_orphaned_trace,
                                           self._wstate)
        self._scheduled_done = False
        self._armed = []            # pending (tag, num_steps) requests
        self.windows_opened = 0     # capture windows, scheduled + anomaly

        # anomaly episode state
        self._anomaly_episode = False
        self.anomaly_captures = 0
        self.memory_snapshots = []  # memory snapshot JSON paths written
        self.exported_traces = []   # span Chrome-trace JSON paths written
        self.profiler_traces = []   # torch.profiler Chrome traces written

        # flush an open capture window at interpreter exit (weakly held,
        # like the monitor's and the checkpoint manager's hooks)
        from .utils import register_weak_atexit
        self._atexit = register_weak_atexit(self, "close")

    # ------------------------------------------------------------------
    # spans
    # ------------------------------------------------------------------

    def span(self, name):
        # goodput keeps phase timing alive even with spans off: the
        # data_wait / ckpt-stall buckets are fed by these spans. What
        # spans: false turns off: the record_function mirroring and span
        # capture/export
        if not (self.spans_enabled or self.goodput_enabled):
            return _NULL_SPAN
        return self.tracer.span(name)

    def step_annotation(self, step):
        """A `record_function` named for the train step around its
        dispatch (JAX: `jax.profiler.StepTraceAnnotation`), so a trace
        groups kernels by step."""
        if not self.spans_enabled:
            return _NULL_SPAN
        return torch.profiler.record_function(f"train_step{int(step)}")

    # ------------------------------------------------------------------
    # MFU
    # ------------------------------------------------------------------

    @property
    def wants_flops(self):
        return self.mfu_enabled

    def register_compiled(self, key, flops):
        """Record a step variant's flops a step (counted once, at its
        first step)."""
        if flops:
            self.compiled_flops[key] = float(flops)
            log_dist(f"telemetry: step variant {key} costs "
                     f"{flops / 1e9:.2f} GFLOPs/device per call",
                     ranks=[0])

    def _peak(self):
        if self._peak_flops is None:
            from ..profiling.hardware import peak_flops_per_chip
            dev = self.devices[0] if self.devices else None
            self._peak_flops = peak_flops_per_chip(dev)
        return self._peak_flops

    # ------------------------------------------------------------------
    # step hooks
    # ------------------------------------------------------------------

    def on_step_start(self, step):
        self._step_t0 = time.perf_counter()
        # scheduled window: arm once when the step counter reaches it
        if (self.capture_start_step is not None
                and not self._scheduled_done
                and step >= self.capture_start_step):
            self._scheduled_done = True
            self._armed.append((f"step{step}", self.capture_num_steps))
        if self._armed and not self._window_open:
            tag, n_steps = self._armed.pop(0)
            self._open_window(tag, n_steps)

    @contextlib.contextmanager
    def outside_window(self):
        """Host work inside a step's call that is not the step (the
        flops count, the flops profiler's pass): its seconds move the
        open step window's start later, so goodput and MFU leave them
        out."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._step_t0 is not None:
                self._step_t0 += time.perf_counter() - t0

    def on_step_end(self, engine, verdict="ok", flops=None, steps=1,
                    tokens=None):
        """Close one step window: goodput accounting, MFU/memory
        scalars, capture-window bookkeeping. `steps` > 1 for a window
        covering several optimizer steps.

        `tokens` = (effective, total) target counts for packed batches
        (`runtime.packing.packed_batch_token_stats`): emitted as
        effective-tokens/s and effective-MFU beside the raw scalars. The
        JAX layer's ``offload`` counters come with the offload tiers
        (A.7)."""
        t1 = time.perf_counter()
        dt = (t1 - self._step_t0) if self._step_t0 is not None else 0.0
        self._step_t0 = None
        self._steps_seen += steps
        phases = self.tracer.drain_phases()

        scalars = {}
        if self.goodput_enabled:
            manager = getattr(engine, "checkpoint_manager", None)
            stall = getattr(manager, "total_stall_s", 0.0)
            if self._last_ckpt_stall is None:
                self._last_ckpt_stall = stall
            ckpt_delta = max(stall - self._last_ckpt_stall, 0.0)
            self._last_ckpt_stall = stall
            self.goodput.account(dt, verdict,
                                 data_wait=phases.get("data_fetch", 0.0),
                                 param_wait=phases.get("param_gather", 0.0),
                                 ckpt_stall=ckpt_delta)
            scalars.update(self.goodput.scalars())

        if self.mfu_enabled and flops and dt > 0:
            achieved = flops / dt          # flop/s on this card
            scalars["Train/Samples/achieved_tflops"] = achieved / 1e12
            scalars["Train/Samples/mfu"] = achieved / self._peak()

        if tokens is not None and dt > 0:
            eff, total = tokens
            self._tokens_effective += int(eff)
            self._tokens_total += int(total)
            scalars["Train/Samples/tokens_per_sec"] = total / dt
            scalars["Train/Samples/effective_tokens_per_sec"] = eff / dt
            if self._tokens_total:
                scalars["Train/Goodput/effective_token_fraction"] = (
                    self._tokens_effective / self._tokens_total)
            if self.mfu_enabled and flops and total:
                scalars["Train/Samples/effective_mfu"] = (
                    flops / dt / self._peak()) * (eff / total)

        if (self.memory_watermark_interval > 0
                and self._steps_seen % self.memory_watermark_interval < steps):
            scalars.update(self._memory_scalars())

        if scalars and self.monitor is not None:
            self.monitor.record(getattr(engine, "global_samples", 0),
                                scalars)

        if verdict == "ok":
            self._anomaly_episode = False

        if self._window_open:
            self._window_steps_left -= steps
            if self._window_steps_left <= 0:
                self._close_window()

    # ------------------------------------------------------------------
    # anomaly hook (sentinel escalation path + hang watchdog)
    # ------------------------------------------------------------------

    def on_anomaly(self, engine, kind, step=None):
        """Called by the sentinel when a step is flagged (and by its hang
        watchdog on expiry): snapshot device memory NOW and arm a trace
        window over the next step(s). Fires at most once per anomaly
        episode: a run of consecutive anomalous steps gives one capture,
        and the episode re-arms after the next healthy step."""
        if not self.capture_on_anomaly or self._anomaly_episode:
            return
        self._anomaly_episode = True
        self.anomaly_captures += 1
        step = step if step is not None else \
            getattr(engine, "global_steps", 0)
        tag = f"anomaly_{kind}_step{step}"
        self.write_memory_snapshot(tag)
        # trace the FOLLOWING step(s): the flagged step already ran
        self._armed.append((tag, self.anomaly_capture_steps))
        log_dist(f"telemetry: anomaly ({kind}) at step {step}: memory "
                 f"snapshot written, trace armed for the next "
                 f"{self.anomaly_capture_steps} step(s)", ranks=[0])

    # ------------------------------------------------------------------
    # capture windows
    # ------------------------------------------------------------------

    def _open_window(self, tag, n_steps):
        self._window_open = True
        self._window_tag = tag
        self._window_steps_left = max(int(n_steps), 1)
        self.windows_opened += 1
        if self.spans_enabled:
            # spans: false turns span capture/export off; the window
            # still drives the torch.profiler trace below
            self.tracer.start_capture()
        if self.trace_dir:
            try:
                prof = start_trace()
            except Exception as e:  # noqa: BLE001
                prof = None
                logger.warning(f"telemetry: torch.profiler failed to start "
                               f"({e}); host spans still captured")
            else:
                if prof is None:
                    logger.warning(
                        f"telemetry: capture window '{tag}': this process "
                        f"already runs a torch.profiler trace; host spans "
                        f"still captured")
            self._wstate["profile"] = prof

    def _close_window(self):
        events = self.tracer.stop_capture()
        tag = self._window_tag
        self._window_open = False
        self._window_tag = None
        prof = self._wstate["profile"]
        if prof is not None:
            self._wstate["profile"] = None
            path = os.path.join(self.trace_dir, f"torch_trace_{tag}.json")
            try:
                stop_trace(prof, path)
                self.profiler_traces.append(path)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"telemetry: torch.profiler stop or "
                               f"export failed ({e})")
        if self.trace_dir and events:
            path = os.path.join(self.trace_dir, f"spans_{tag}.json")
            # the capture artifact carries the kernel dispatch report:
            # WHICH kernel design produced these timings matters as much
            # as the timings
            from ..ops import dispatch_report
            self.exported_traces.append(
                SpanTracer.export_chrome_trace(
                    events, path, pid=0,
                    metadata={"host": 0, "dispatch": dispatch_report()}))
            log_dist(f"telemetry: capture window '{tag}' closed: "
                     f"{len(events)} host spans -> {path}", ranks=[0])

    # ------------------------------------------------------------------
    # memory
    # ------------------------------------------------------------------

    def _memory_scalars(self):
        """Device-memory watermark scalars of the first device (the JAX
        layer's tags: bytes in use and the peak)."""
        stats = self._device_memory_stats()
        first = next(iter(stats.values()), None) or {}
        out = {}
        if "bytes_in_use" in first:
            out["Train/Memory/hbm_bytes_in_use"] = first["bytes_in_use"]
        if "peak_bytes_in_use" in first:
            out["Train/Memory/hbm_peak_bytes"] = \
                first["peak_bytes_in_use"]
        return out

    def _device_memory_stats(self):
        """{device: stats} from the caching allocator of each CUDA device
        (`torch.cuda.memory_stats`, under the JAX layer's key names
        ``bytes_in_use`` and ``peak_bytes_in_use`` beside the allocator's
        own); a device without stats (the CPU) gives {}."""
        out = {}
        for dev in self.devices:
            stats = {}
            if dev.type == "cuda" and torch.cuda.is_available():
                try:
                    raw = torch.cuda.memory_stats(dev)
                    stats = {
                        "bytes_in_use": raw.get(
                            "allocated_bytes.all.current", 0),
                        "peak_bytes_in_use": raw.get(
                            "allocated_bytes.all.peak", 0),
                        "bytes_reserved": raw.get(
                            "reserved_bytes.all.current", 0),
                        "num_alloc_retries": raw.get("num_alloc_retries", 0),
                        "num_ooms": raw.get("num_ooms", 0)}
                except Exception:  # noqa: BLE001 - allocator without stats
                    stats = {}
            out[str(dev)] = stats
        return out

    def write_memory_snapshot(self, tag):
        """Per-device memory stats JSON under the trace dir (the anomaly
        hook's artifact). Thread-safe: the hang watchdog calls this from
        its own thread."""
        if not self.trace_dir:
            return None
        path = os.path.join(self.trace_dir, f"memory_{tag}.json")
        os.makedirs(self.trace_dir, exist_ok=True)
        # true epoch timestamp: snapshot files are correlated with logs
        payload = {"tag": tag, "time": time.time(),
                   "devices": self._device_memory_stats()}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        self.memory_snapshots.append(path)
        return path

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def close(self):
        """Flush an open capture window (export what was collected) and
        detach the atexit hook. Idempotent."""
        if self._window_open:
            self._close_window()
        try:
            import atexit
            atexit.unregister(self._atexit)
        except Exception:  # pragma: no cover
            pass


def build_telemetry(config_dict, monitor=None, devices=None):
    """Telemetry (or NULL_TELEMETRY) from a parsed telemetry config
    dict (`DeepSpeedConfig.telemetry_config`)."""
    if not config_dict or not config_dict.get("enabled"):
        return NULL_TELEMETRY
    kwargs = {k: v for k, v in config_dict.items() if k != "enabled"}
    return Telemetry(monitor=monitor, devices=devices, **kwargs)
