"""Asynchronous checkpointing: the port of
`deeperspeed_tpu/checkpoint/async_manager.py`.

`AsyncCheckpointManager.save_async` snapshots the engine to host at a
step boundary (the only stall: one device-to-host copy of each flat
buffer, complete before it returns), then serializes and commits in a
background writer thread while training runs on. The engine builds one
from the "checkpoint" config block, which also drives auto-saves every
``save_interval_steps``, retention GC and the emergency save on SIGTERM
/ SIGINT.

Guarantees, as in the JAX package:

- at most ONE save is in flight; a new save first waits out the
  previous commit (back-pressure), so checkpoints are totally ordered;
- the writer thread never touches the engine or a device tensor: it
  owns a host snapshot that no later step writes (the engine's host
  buffers are reused only by the next snapshot, after the wait);
- commits are crash-consistent (`manifest.py`), and `latest` only ever
  names a committed checkpoint;
- retention GC (`keep_last_n` / `keep_every_n_steps`) runs after each
  commit, deletes committed checkpoints only, and never the one
  `latest` points to;
- a writer failure is re-raised on the caller's thread at the next
  `wait()` / save (and logged at the next step boundary).

Across data-parallel ranks the commit runs inline on the training
thread, as the JAX package's multihost branch does: it gathers every
rank's file entries and passes barriers, collectives that must not
interleave with the step's own. Rank 0 alone runs the retention GC.
"""

import atexit
import signal
import threading
import time
import weakref

from ..runtime.utils import register_weak_atexit
from ..utils.logging import log_dist, logger
from . import manifest as mf


class AsyncCheckpointManager:
    """Engine-attached manager for async saves, auto-save, retention and
    preemption handling."""

    def __init__(self, engine, save_dir=None, async_save=True,
                 save_interval_steps=0, keep_last_n=0,
                 keep_every_n_steps=0, save_on_preemption=False):
        # weakly held: the engine holds the manager, and a cycle would
        # keep a deleted engine's device buffers until the next gc pass
        self._engine_ref = weakref.ref(engine)
        self.save_dir = save_dir
        self.async_save = bool(async_save)
        self.save_interval_steps = int(save_interval_steps or 0)
        self.keep_last_n = int(keep_last_n or 0)
        self.keep_every_n_steps = int(keep_every_n_steps or 0)
        self.save_on_preemption = bool(save_on_preemption)

        self._thread = None
        self._error = None
        self._error_logged = False
        self._lock = threading.Lock()
        self._finished = []         # per-save stats awaiting the drain
        self._last_autosave_step = 0   # first auto-save after one interval
        self._prev_handlers = {}
        self.preemption_requested = False
        self._preempt_signum = None
        # test seam: runs inside the writer thread before the commit
        self._pre_commit_hook = None

        # cumulative, host-side
        self.saves_completed = 0
        self.total_stall_s = 0.0    # training blocked in the snapshot
        self.total_write_s = 0.0    # background serialization + commit
        self.total_bytes = 0

        if self.save_on_preemption:
            self._install_signal_handlers()
        # flush an in-flight commit at interpreter exit
        self._atexit = register_weak_atexit(self, "_drain_at_exit")

    # ------------------------------------------------------------------
    # save API
    # ------------------------------------------------------------------

    @property
    def engine(self):
        return self._engine_ref()

    @property
    def in_flight(self):
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        """Block until the in-flight commit (if any) finishes; re-raise a
        writer failure on the caller's thread."""
        thread = self._thread
        if thread is not None:
            thread.join()
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
            self._error_logged = False
        if err is not None:
            raise RuntimeError(
                f"async checkpoint save failed: {err}") from err

    def save_async(self, save_dir=None, tag=None, client_state=None,
                   save_latest=True):
        """Snapshot now, commit in the background. Returns the tag once
        the snapshot is on the host (training may resume); the checkpoint
        is on disk only after the commit: `wait()` for durability."""
        from .checkpointing import (snapshot_checkpoint,
                                    validate_checkpoint_tag,
                                    write_and_commit)

        engine = self.engine
        save_dir = save_dir if save_dir is not None else self.save_dir
        if save_dir is None:
            raise ValueError("save_async needs a save_dir (argument or "
                             "the checkpoint.save_dir config key)")
        if tag is None:
            tag = f"global_step{engine.global_steps}"
        tag = str(tag)

        # back-pressure: one save in flight, totally ordered commits
        self.wait()
        validate_checkpoint_tag(engine, tag)

        from ..runtime.telemetry import NULL_TELEMETRY
        telemetry = getattr(engine, "telemetry", NULL_TELEMETRY)
        t0 = time.perf_counter()
        # the snapshot is the only training-loop stall of an async save;
        # spanning it puts the stall on the trace timeline, and the
        # goodput meter reads total_stall_s deltas a step window
        with telemetry.span("ckpt_snapshot"):
            payloads = snapshot_checkpoint(engine, client_state)
        stall_s = time.perf_counter() - t0
        step = engine.global_steps
        gc_here = engine.dp_rank == 0
        self.total_stall_s += stall_s

        def writer():
            try:
                if self._pre_commit_hook is not None:
                    self._pre_commit_hook()
                t1 = time.perf_counter()
                nbytes = write_and_commit(payloads, save_dir, tag,
                                          step=step,
                                          save_latest=save_latest)
                deleted = mf.gc_checkpoints(
                    save_dir, keep_last_n=self.keep_last_n,
                    keep_every_n_steps=self.keep_every_n_steps,
                    protect=(tag,)) if gc_here else []
                write_s = time.perf_counter() - t1
                with self._lock:
                    self.saves_completed += 1
                    self.total_write_s += write_s
                    self.total_bytes += nbytes
                    self._finished.append({
                        "tag": tag, "step": step, "bytes": nbytes,
                        "stall_s": stall_s, "write_s": write_s,
                        "deleted": deleted})
            except BaseException as e:  # surfaced at the next wait()
                with self._lock:
                    self._error = e

        if engine.dp_world_size > 1:
            writer()   # inline: the commit's collectives
            return tag
        thread = threading.Thread(target=writer, daemon=True,
                                  name=f"ds-ckpt-writer-{tag}")
        self._thread = thread
        thread.start()
        return tag

    def save_sync(self, save_dir=None, tag=None, client_state=None,
                  save_latest=True):
        """The same snapshot-then-commit protocol, waited to completion
        before returning (emergency saves, final saves)."""
        tag = self.save_async(save_dir, tag=tag, client_state=client_state,
                              save_latest=save_latest)
        self.wait()
        return tag

    # ------------------------------------------------------------------
    # engine hooks (called at every step boundary)
    # ------------------------------------------------------------------

    def on_step_boundary(self, engine):
        """Drain completed-save stats, honor a pending preemption
        request, and fire the auto-save interval."""
        self._drain_finished()
        if self.preemption_requested:
            self._emergency_save(engine)   # raises to stop the loop
            return
        if (self.save_interval_steps and self.save_dir
                and engine.global_steps - self._last_autosave_step
                >= self.save_interval_steps):
            # interval-CROSSING test, not an exact modulo: fp16 overflows
            # shift the phase, and an overflow re-entry at an unchanged
            # global step must not save twice
            self._last_autosave_step = engine.global_steps
            if self.async_save:
                self.save_async(self.save_dir)
            else:
                self.save_sync(self.save_dir)

    def on_checkpoint_loaded(self, engine):
        """Re-sync the auto-save clock after a resume, so the first
        post-resume step does not fire a near-duplicate save."""
        self._last_autosave_step = engine.global_steps

    def _drain_finished(self):
        with self._lock:
            finished, self._finished = self._finished, []
            err = self._error
        for stats in finished:
            log_dist(
                f"Committed checkpoint {stats['tag']} "
                f"({stats['bytes'] / 2**20:.1f} MiB, "
                f"stall {stats['stall_s'] * 1e3:.0f} ms, "
                f"write {stats['write_s'] * 1e3:.0f} ms"
                + (f", GC'd {stats['deleted']}" if stats["deleted"]
                   else "") + ")", ranks=[0])
            engine = self.engine
            monitor = getattr(engine, "monitor", None)
            if monitor is not None:
                monitor.record_checkpoint(engine.global_samples, stats)
        if err is not None and not self._error_logged:
            # keep self._error for wait() to raise; warn now, once
            self._error_logged = True
            logger.error(f"async checkpoint writer failed: {err}")

    # ------------------------------------------------------------------
    # preemption (SIGTERM from a scheduler, SIGINT from a human)
    # ------------------------------------------------------------------

    def _install_signal_handlers(self):
        if threading.current_thread() is not threading.main_thread():
            logger.warning("save_on_preemption: not on the main thread; "
                           "signal handlers not installed")
            return
        manager_ref = weakref.ref(self)

        def handler(signum, frame):
            manager = manager_ref()
            if manager is not None:
                manager._on_signal(signum, frame)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover
                pass

    def _on_signal(self, signum, frame):  # noqa: ARG002
        # only flip flags here; the save runs on the main thread at the
        # next step boundary (mid-step state is not a consistent snapshot)
        self.preemption_requested = True
        self._preempt_signum = signum

    def restore_signal_handlers(self):
        for sig, handler in self._prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev_handlers = {}

    def _emergency_save(self, engine):
        signum = self._preempt_signum
        self.preemption_requested = False
        log_dist(f"Preemption signal {signum}: saving emergency "
                 f"checkpoint at step {engine.global_steps}", ranks=[0])
        self.save_sync(self.save_dir)
        self.restore_signal_handlers()
        if signum == signal.SIGINT:
            raise KeyboardInterrupt("preemption checkpoint saved")
        raise SystemExit(128 + int(signum or signal.SIGTERM))

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------

    def _drain_at_exit(self):  # pragma: no cover - interpreter teardown
        try:
            self.wait()
        except Exception as e:
            logger.error(f"checkpoint writer failed during shutdown: {e}")

    def close(self):
        """Flush the in-flight save and detach signal/atexit hooks."""
        try:
            self.wait()
        finally:
            self.restore_signal_handlers()
            atexit.unregister(self._atexit)
