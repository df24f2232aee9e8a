"""Training-health sentinel: in-band anomaly detection + automatic
recovery, and the hang watchdog.

The port of `deeperspeed_tpu/runtime/sentinel.py`:

- **Device-side probe** (`probe_update`): a handful of 0-d tensor ops on
  the engine's device. It reuses the global gradient norm the step
  computes for clipping (`engine._apply_update`) and flags non-finite
  loss/grads plus EMA z-score spikes in loss and grad norm. The debiased
  EMA mean/variance ride in `HealthState` (``engine.health``), so
  detection costs one norm over the flat gradient and no host read
  beyond the flags.
- **Quarantine**: with policy `skip_batch` or higher, a flagged step's
  optimizer update is skipped, so a NaN gradient never reaches the
  master weights. The JAX step selects the old state branchlessly; the
  port reads the probe's hard-anomaly flag on the host once, before the
  Adam launch, and skips the launch (a select over the flat masters and
  moments would be three more passes over them).
- **Host-side escalation** (`TrainingHealthSentinel.after_step`):
  `warn` -> `skip_batch` (quarantine + dataloader provenance epoch/
  offset) -> `rollback` (restore the last committed checkpoint through
  the engine's `checkpoint_manager`, keep the dataloader past the bad
  window) -> `abort` (raise `TrainingHealthError`) after K consecutive
  anomalies.
- **Hang watchdog** (`HangWatchdog`): a per-step wall-clock deadline.
  The training engine arms it around every `train_batch` whose kind of
  step has run before (the first one builds the kernels and sets up
  cuBLAS, which is not a hang); on expiry the sentinel dumps every
  thread's stack and requests the checkpoint manager's preemption save,
  which the next step boundary writes before it raises `SystemExit`.
  The serving engine arms the same watchdog around a step's dispatch
  (``inference.hang_timeout_s``) and drains on expiry.

Everything is driven by the validated ``"training_health"`` JSON block
(`runtime/config.py`); nothing is built when it is off.
`runtime/fault_injection.py` drives every path deterministically. The
JAX engine's peer-health monitor, telemetry and metrics monitor are not
in the port: their hooks here find nothing on the engine and do nothing,
as in JAX when those features are off.
"""

import sys
import threading
import time
import traceback
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..utils.logging import log_dist, logger

# anomaly bitmask (HealthState.flags)
ANOM_NONFINITE_LOSS = 1
ANOM_NONFINITE_GRAD = 2
ANOM_LOSS_SPIKE = 4
ANOM_GRAD_SPIKE = 8

FLAG_NAMES = {
    ANOM_NONFINITE_LOSS: "nonfinite_loss",
    ANOM_NONFINITE_GRAD: "nonfinite_grad",
    ANOM_LOSS_SPIKE: "loss_spike",
    ANOM_GRAD_SPIKE: "grad_norm_spike",
}

# escalation ladder; the configured `policy` is the HIGHEST rung allowed
POLICIES = ("warn", "skip_batch", "rollback", "abort")


class TrainingHealthError(RuntimeError):
    """Raised when the sentinel escalates to `abort` (or a rollback is
    requested but impossible): the run is sick beyond automatic repair."""


class HealthState(NamedTuple):
    """Probe state on the engine's device, 0-d tensors.

    EMAs are stored un-debiased (`ema / (1 - beta^count)` is the mean);
    `count` only advances on healthy steps so anomalies never poison the
    statistics they are measured against."""
    loss_ema: torch.Tensor      # f32: EMA of loss
    loss_sq_ema: torch.Tensor   # f32: EMA of loss^2
    gnorm_ema: torch.Tensor     # f32: EMA of grad norm
    gnorm_sq_ema: torch.Tensor  # f32: EMA of grad norm^2
    count: torch.Tensor         # i32: healthy samples incorporated
    flags: torch.Tensor         # i32: bitmask for the LAST step
    anomalies: torch.Tensor     # i32: cumulative anomalous steps
    quarantined: torch.Tensor   # i32: cumulative skipped updates


class ProbeConfig(NamedTuple):
    """Static probe knobs from the training_health block."""
    loss_zscore: float
    grad_norm_zscore: float
    ema_beta: float
    warmup_steps: int
    quarantine: bool    # policy >= skip_batch: hard anomalies skip


def init_health_state(device="cpu"):
    """A fresh `HealthState` on ``device`` (filled there: no copy from
    the host)."""
    def z32():
        return torch.zeros((), dtype=torch.float32, device=device)

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return HealthState(loss_ema=z32(), loss_sq_ema=z32(), gnorm_ema=z32(),
                       gnorm_sq_ema=z32(), count=i32(), flags=i32(),
                       anomalies=i32(), quarantined=i32())


def _f32(x):
    """A Python float holding ``x`` rounded to fp32: multiplied into an
    fp32 tensor it acts as the JAX package's ``jnp.float32`` constant."""
    return float(np.float32(x))


def _zscore(value, ema, sq_ema, count, beta):
    """Debiased EMA z-score; robust to the flat-metric case (var -> 0).

    The sd gets a floor of 2% of the mean: right after warmup the EMA
    variance is built from few samples and can be arbitrarily small, so
    a raw z-score flags ordinary jitter. With the floor, a z of 6
    requires a deviation of at least ~12% of the running mean: noise
    never clears it, while real blow-ups (orders of magnitude) always
    do."""
    n = torch.clamp(count, min=1).to(torch.float32)
    corr = 1.0 - torch.pow(_f32(beta), n)
    mean = ema / corr
    var = torch.clamp(sq_ema / corr - mean * mean, min=0.0)
    sd = torch.sqrt(var) + 0.02 * torch.abs(mean) + 1e-12
    return (value - mean) / sd


def probe_update(health, loss, grad_norm, bad_grad, cfg):
    """One probe step: (new HealthState, hard-anomaly 0-d bool tensor).

    The JAX `probe_update`'s scalar math, in its order, on the state's
    device. `loss` may be None (the legacy loop's update). `bad_grad` is
    the CALLER's non-finite-gradient verdict (a tensor, or a Python bool):
    see `grad_anomaly` for why it depends on the precision."""
    dev = health.count.device
    gn = torch.as_tensor(grad_norm).to(device=dev, dtype=torch.float32)
    gn_finite = torch.isfinite(gn)
    if isinstance(bad_grad, torch.Tensor):
        flags = torch.where(bad_grad.to(dev), ANOM_NONFINITE_GRAD,
                            0).to(torch.int32)
    else:
        flags = torch.full((), ANOM_NONFINITE_GRAD if bad_grad else 0,
                           dtype=torch.int32, device=dev)

    warm = health.count >= cfg.warmup_steps
    if cfg.grad_norm_zscore > 0:
        gz = _zscore(gn, health.gnorm_ema, health.gnorm_sq_ema,
                     health.count, cfg.ema_beta)
        g_spike = warm & gn_finite & (gz > cfg.grad_norm_zscore)
        flags = flags | torch.where(g_spike, ANOM_GRAD_SPIKE, 0).to(
            torch.int32)

    ls = None
    if loss is not None:
        ls = torch.as_tensor(loss).to(device=dev, dtype=torch.float32)
        l_finite = torch.isfinite(ls)
        flags = flags | torch.where(l_finite, 0, ANOM_NONFINITE_LOSS).to(
            torch.int32)
        if cfg.loss_zscore > 0:
            lz = _zscore(ls, health.loss_ema, health.loss_sq_ema,
                         health.count, cfg.ema_beta)
            l_spike = warm & l_finite & (lz > cfg.loss_zscore)
            flags = flags | torch.where(l_spike, ANOM_LOSS_SPIKE, 0).to(
                torch.int32)

    anomalous = flags != 0
    hard = anomalous & cfg.quarantine

    beta = _f32(cfg.ema_beta)
    one_minus_beta = float(np.float32(1) - np.float32(cfg.ema_beta))

    def ema(prev, value):
        # frozen on anomalous steps: a spike must not drag the baseline
        # toward itself (the next spike would then look normal)
        value = torch.where(torch.isfinite(value), value, prev)
        return torch.where(anomalous, prev,
                           beta * prev + one_minus_beta * value)

    new = HealthState(
        loss_ema=(ema(health.loss_ema, ls) if ls is not None
                  else health.loss_ema),
        loss_sq_ema=(ema(health.loss_sq_ema, torch.square(ls))
                     if ls is not None else health.loss_sq_ema),
        gnorm_ema=ema(health.gnorm_ema, gn),
        gnorm_sq_ema=ema(health.gnorm_sq_ema, torch.square(gn)),
        count=health.count + torch.where(anomalous, 0, 1).to(torch.int32),
        flags=flags,
        anomalies=health.anomalies +
        torch.where(anomalous, 1, 0).to(torch.int32),
        quarantined=health.quarantined +
        torch.where(hard, 1, 0).to(torch.int32))
    return new, hard


def grad_anomaly(engine, scale_state, grad_norm, overflow):
    """The `bad_grad` input for `probe_update` (the JAX package's
    `grad_anomaly_in_jit`).

    - loss-scaled (fp16): overflow steps are the dynamic scaler's normal
      startup search and already skip their update; they count as an
      anomaly only once the scale is pinned at `min_loss_scale` (no room
      left to self-correct). A static scale never self-corrects, so its
      overflow IS the anomaly. The non-finite norm on such steps is the
      overflow itself, so the norm check is NOT applied separately.
      ``overflow`` and the scale are host values here: a Python bool.
    - unscaled (bf16/fp32): nothing else catches a NaN, so a non-finite
      global norm IS the anomaly (a device tensor).
    """
    if engine._config.loss_scaling_enabled:
        if not engine.dynamic_loss_scale():
            return bool(overflow)
        args = engine._config.dynamic_loss_scale_args or {}
        min_scale = float(args.get("min_loss_scale", 1))
        return bool(overflow) and float(scale_state.cur_scale) <= min_scale
    return ~torch.isfinite(torch.as_tensor(grad_norm).float())


def decode_flags(flags):
    """Human-readable anomaly names for a flags bitmask."""
    return [name for bit, name in FLAG_NAMES.items() if flags & bit]


def dump_all_stacks():
    """Format every thread's current Python stack (watchdog expiry)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out)


class HangWatchdog:
    """Per-step wall-clock deadline on a daemon thread.

    `arm()` at step entry, `feed()` when the step's host work is done.
    On expiry the callback ``owner.<on_expire_name>()`` fires ONCE per
    armed window. The thread holds only a weakref to its owner, so a
    dropped engine (and its page pools) stays collectable: the thread
    exits at its next poll after the owner is gone."""

    def __init__(self, timeout_s, owner, on_expire_name):
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._deadline = None
        self._fired = False
        self._stop = threading.Event()
        owner_ref = weakref.ref(owner)
        poll = max(min(self.timeout_s / 4.0, 1.0), 0.02)

        def loop():
            while not self._stop.wait(poll):
                owner = owner_ref()
                if owner is None:
                    return
                with self._lock:
                    expired = (self._deadline is not None
                               and not self._fired
                               and time.monotonic() > self._deadline)
                    if expired:
                        # one-shot per armed step: only the next arm()
                        # re-enables expiry
                        self._fired = True
                        self._deadline = None
                if expired:
                    try:
                        getattr(owner, on_expire_name)()
                    except Exception as e:  # pragma: no cover
                        logger.error(f"hang watchdog callback failed: {e}")
                del owner

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ds-hang-watchdog")
        self._thread.start()

    def arm(self):
        with self._lock:
            self._deadline = time.monotonic() + self.timeout_s
            self._fired = False

    def feed(self):
        with self._lock:
            self._deadline = None
            self._fired = False

    def stop(self):
        self._stop.set()


class TrainingHealthSentinel:
    """Host-side policy engine over the device probe's verdicts.

    Owned by the engine (constructed from the "training_health" config
    block); holds only a weakref back so the engine stays collectable.
    The port has no host-optimizer tier, so the probe always runs on the
    device inside the engine's update."""

    def __init__(self, engine, policy="warn", loss_zscore=6.0,
                 grad_norm_zscore=6.0, ema_beta=0.98, warmup_steps=20,
                 rollback_after=2, abort_after=5, max_rollbacks=2,
                 hang_timeout_seconds=0.0, max_quarantine_records=64):
        self.policy = policy
        self.policy_rank = POLICIES.index(policy)
        self.rollback_after = int(rollback_after)
        self.abort_after = int(abort_after)
        self.max_rollbacks = int(max_rollbacks)
        self.max_quarantine_records = int(max_quarantine_records)
        self._engine_ref = weakref.ref(engine)
        self.probe_config = ProbeConfig(
            loss_zscore=float(loss_zscore),
            grad_norm_zscore=float(grad_norm_zscore),
            ema_beta=float(ema_beta),
            warmup_steps=int(warmup_steps),
            quarantine=self.policy_rank >= POLICIES.index("skip_batch"))

        # host-side mirrors
        self.anomalies = 0
        self.quarantined = 0
        self.consecutive = 0
        self.rollbacks = 0
        self.quarantined_windows = []   # provenance records
        self.last_flags = 0
        self.watchdog_fires = 0
        self.last_stack_dump = None
        self._warned = 0

        self.watchdog = None
        if hang_timeout_seconds and hang_timeout_seconds > 0:
            self.watchdog = HangWatchdog(hang_timeout_seconds, self,
                                         "_on_hang")

    # ------------------------------------------------------------------
    # watchdog plumbing (called by the engine around every step)
    # ------------------------------------------------------------------

    def watchdog_arm(self):
        if self.watchdog is not None:
            self.watchdog.arm()

    def watchdog_feed(self):
        if self.watchdog is not None:
            self.watchdog.feed()

    def _on_hang(self):
        """Runs on the watchdog thread: the armed step blew its deadline."""
        self.watchdog_fires += 1
        dump = dump_all_stacks()
        self.last_stack_dump = dump
        logger.error(
            f"hang watchdog: step exceeded the "
            f"{self.watchdog.timeout_s:.1f}s deadline; all-thread stack "
            f"dump follows\n{dump}")
        engine = self._engine_ref()
        if engine is None:
            return
        self._telemetry_anomaly(engine, "watchdog_hang")
        manager = getattr(engine, "checkpoint_manager", None)
        if manager is not None and manager.save_on_preemption and \
                manager.save_dir:
            # preemption-style: flag only; the emergency save runs on the
            # main thread at the next step boundary (if the hang clears)
            manager.preemption_requested = True
            logger.error("hang watchdog: requested a preemption-style "
                         "emergency checkpoint at the next step boundary")

    # ------------------------------------------------------------------
    # per-step verdict + escalation
    # ------------------------------------------------------------------

    def after_step(self, engine):
        """Read the probe's verdict for the step that just ran and apply
        the escalation policy. Returns one of "ok", "warned",
        "quarantined", "rollback"; raises TrainingHealthError on abort."""
        flags = int(engine.health.flags)
        self.last_flags = flags
        if flags == 0:
            self.consecutive = 0
            return "ok"

        self.anomalies += 1
        self.consecutive += 1
        record = self._provenance(engine, flags)
        quarantined = self.probe_config.quarantine
        if quarantined:
            self.quarantined += 1
            self.quarantined_windows.append(record)
            del self.quarantined_windows[:-self.max_quarantine_records]
        self._warn(record, quarantined)
        self._record_monitor(engine)
        self._telemetry_anomaly(engine, "+".join(record["kinds"]))

        if self.policy_rank >= POLICIES.index("rollback") and \
                self.consecutive >= self.rollback_after and \
                self._can_rollback(engine):
            if self.rollbacks >= self.max_rollbacks:
                raise TrainingHealthError(
                    f"training health: {self.consecutive} consecutive "
                    f"anomalous steps and the rollback budget "
                    f"({self.max_rollbacks}) is exhausted; aborting. "
                    f"Last anomaly: {record}")
            self._do_rollback(engine, record)
            return "rollback"
        if self.policy_rank >= POLICIES.index("abort") and \
                self.consecutive >= self.abort_after:
            raise TrainingHealthError(
                f"training health: {self.consecutive} consecutive "
                f"anomalous steps (abort_after={self.abort_after}); "
                f"aborting. Last anomaly: {record}")
        return "quarantined" if quarantined else "warned"

    # ------------------------------------------------------------------
    # actions
    # ------------------------------------------------------------------

    def _provenance(self, engine, flags):
        """Where in the data stream the anomaly happened (the
        dataloader's epoch + batch offset)."""
        record = {"step": int(engine.global_steps),
                  "flags": flags,
                  "kinds": decode_flags(flags)}
        loader = getattr(engine, "training_dataloader", None)
        if loader is not None and hasattr(loader, "position"):
            record.update(loader.position())
        return record

    def _warn(self, record, quarantined):
        self._warned += 1
        # rate-limited: first 5, then every 50th; a pathological run
        # must not drown the log in per-step anomaly lines
        if self._warned <= 5 or self._warned % 50 == 0:
            action = "update quarantined" if quarantined else \
                "detection only (policy=warn)"
            log_dist(f"TRAINING HEALTH: anomalous step "
                     f"{record['kinds']} at {record} — {action}; "
                     f"{self.consecutive} consecutive", ranks=[0])

    def _telemetry_anomaly(self, engine, kind):
        """Hand the anomaly to the engine's telemetry: with
        ``capture_on_anomaly`` it snapshots device memory now and arms a
        trace of the next step(s), once an episode."""
        telemetry = getattr(engine, "telemetry", None)
        if telemetry is not None:
            telemetry.on_anomaly(engine, kind)

    def _record_monitor(self, engine):
        monitor = getattr(engine, "monitor", None)
        if monitor is not None and hasattr(monitor, "record_health"):
            monitor.record_health(engine.global_samples, {
                "anomalies": self.anomalies,
                "quarantined": self.quarantined,
                "rollbacks": self.rollbacks,
                "consecutive": self.consecutive,
                "watchdog_fires": self.watchdog_fires,
            })

    def _can_rollback(self, engine):
        manager = getattr(engine, "checkpoint_manager", None)
        return manager is not None and manager.save_dir is not None

    def _do_rollback(self, engine, record):
        """Restore the last committed checkpoint; keep the dataloader at
        its CURRENT position (already past the bad window) instead of
        rewinding it with the checkpoint: replaying the quarantined
        batch would re-trigger the same anomaly on real data corruption.
        The probe's EMAs are not in a checkpoint and carry over."""
        manager = engine.checkpoint_manager
        from .telemetry import NULL_TELEMETRY
        telemetry = getattr(engine, "telemetry", NULL_TELEMETRY)
        with telemetry.span("rollback_restore"):
            manager.wait()   # newest commit must be durable before load
            path, _ = engine.load_checkpoint(manager.save_dir,
                                             load_dataloader_states=False)
        if path is None:
            raise TrainingHealthError(
                f"training health: rollback requested after {record} but "
                f"no committed checkpoint exists under "
                f"{manager.save_dir}")
        self.rollbacks += 1
        self.consecutive = 0
        log_dist(f"TRAINING HEALTH: rolled back to {path} after "
                 f"anomaly {record}; dataloader continues past the "
                 f"quarantined window (rollback {self.rollbacks}/"
                 f"{self.max_rollbacks})", ranks=[0])
        self._record_monitor(engine)
