"""Deterministic fault injection.

The port of `deeperspeed_tpu/runtime/fault_injection.py`. It drives
the serving engine's robustness paths on demand (quarantine → retry →
poison, the hang watchdog, eviction under page-pool pressure) and the
training engine's (the sentinel's quarantine, rollback and abort, the
training hang watchdog, the loss-scale floor watch).

Gating (nothing is built when both are absent):

- config: ``{"training_health": {"fault_injection": {"faults": [...]}}}``
  for the training engine, ``{"inference": {"fault_injection":
  {"faults": [...]}}}`` for the serving engine;
- env: ``DS_FAULT_INJECT='{"faults": [...]}'`` (JSON, same schema).

Fault schema (validated at parse time)::

    {"kind": "nan_grads" | "loss_spike" | "stall"
             | "peer_death" | "slow_peer" | "barrier_timeout"
             | "dcn_delay" | "slice_kill"
             | "prefill_error" | "decode_error" | "decode_stall"
             | "page_pool_pressure",
     "step": N,          # 0-based step serial in this process
     "times": 1,         # fires on serials [step, step+times)
     "factor": 1e3,      # loss_spike: loss multiplier;
                         # page_pool_pressure: fraction of the FREE
                         # page pool seized for the step (0 < f <= 1,
                         # default 0.9)
     "seconds": 1.0,     # stall / decode_stall: sleep length;
                         # slow_peer: heartbeat gap; dcn_delay: latency
                         # a cross-slice crossing
     "peer": "sim0",     # peer_death / slow_peer: simulated peer name
     "slice": "slice1"}  # slice_kill: the slice to kill

``step`` counts `InferenceEngine.step()` calls, or `train_batch` calls,
of the engine that owns the injector (a monotonic serial: warm-up steps
count too, and a retried request or a step replayed after a rollback
does not re-trigger a one-shot fault).

The training kinds: the engine's `train_batch` plans each step once;
``nan_grads`` and ``loss_spike`` corrupt the step's mean loss and its
accumulated gradient through `apply_fault` before the update, and
``stall`` sleeps before the step runs (with the watchdog armed). The
peer-health and multislice kinds (``peer_death``, ``slow_peer``,
``barrier_timeout``, ``dcn_delay``, ``slice_kill``) need the JAX
engine's peer monitor and slices, which the port does not have yet: the
training engine refuses them.

The serving kinds are host faults, consumed by `InferenceEngine`:
``prefill_error`` / ``decode_error`` raise an `InjectedServingFault` in
place of the prefill / decode call; ``decode_stall`` sleeps inside the
decode phase; ``page_pool_pressure`` seizes a fraction of the free page
pool for the step.
"""

import json
import os

import torch

from .config_utils import DeepSpeedConfigError

SERVING_FAULT_KINDS = ("prefill_error", "decode_error", "decode_stall",
                       "page_pool_pressure")
MULTISLICE_FAULT_KINDS = ("dcn_delay", "slice_kill")
FAULT_KINDS = ("nan_grads", "loss_spike", "stall",
               "peer_death", "slow_peer", "barrier_timeout") + \
    MULTISLICE_FAULT_KINDS + SERVING_FAULT_KINDS
HOST_FAULT_KINDS = ("peer_death", "slow_peer", "barrier_timeout") + \
    MULTISLICE_FAULT_KINDS + SERVING_FAULT_KINDS
DEFAULT_SIM_PEER = "sim_peer_0"
PAGE_POOL_PRESSURE_DEFAULT_FRACTION = 0.9


class InjectedServingFault(RuntimeError):
    """What ``prefill_error`` / ``decode_error`` faults raise in place of
    the serving call: a stand-in for a real transient step failure,
    typed so that injected failures can be told from real ones."""


# device-side injection modes (the (mode, factor) pair of apply_fault)
MODE_NONE = 0
MODE_NAN_GRADS = 1
MODE_LOSS_SPIKE = 2

ENV_VAR = "DS_FAULT_INJECT"


def validate_fault_spec(spec, where="training_health.fault_injection"):
    """Validate an injection spec dict → normalized list of fault dicts.
    Raises DeepSpeedConfigError on any malformed entry (a typo'd fault
    plan must fail at start-up, not silently never fire)."""
    if not isinstance(spec, dict):
        raise DeepSpeedConfigError(
            f"{where} must be an object with a 'faults' list, got "
            f"{type(spec).__name__}")
    unknown = sorted(set(spec) - {"faults"})
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown {where} key(s) {unknown}; valid keys: ['faults']")
    faults = spec.get("faults", [])
    if not isinstance(faults, (list, tuple)):
        raise DeepSpeedConfigError(
            f"{where}.faults must be a list, got "
            f"{type(faults).__name__}")
    known = {"kind", "step", "times", "factor", "seconds", "peer",
             "slice"}
    out = []
    for i, fault in enumerate(faults):
        if not isinstance(fault, dict):
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}] must be an object, got "
                f"{type(fault).__name__}")
        unknown = sorted(set(fault) - known)
        if unknown:
            raise DeepSpeedConfigError(
                f"Unknown {where}.faults[{i}] key(s) {unknown}; valid "
                f"keys: {sorted(known)}")
        kind = fault.get("kind")
        if kind not in FAULT_KINDS:
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].kind must be one of "
                f"{list(FAULT_KINDS)}, got {kind!r}")
        step = fault.get("step")
        if not isinstance(step, int) or isinstance(step, bool) or step < 0:
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].step must be an int >= 0, got "
                f"{step!r}")
        times = fault.get("times", 1)
        if not isinstance(times, int) or isinstance(times, bool) \
                or times < 1:
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].times must be an int >= 1, got "
                f"{times!r}")
        factor = fault.get("factor",
                           PAGE_POOL_PRESSURE_DEFAULT_FRACTION
                           if kind == "page_pool_pressure" else 1e3)
        seconds = fault.get("seconds", 1.0)
        for key, value in (("factor", factor), ("seconds", seconds)):
            if not isinstance(value, (int, float)) or \
                    isinstance(value, bool) or value <= 0:
                raise DeepSpeedConfigError(
                    f"{where}.faults[{i}].{key} must be a number > 0, "
                    f"got {value!r}")
        if kind == "page_pool_pressure" and factor > 1:
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].factor is the fraction of the "
                f"free page pool to seize for a page_pool_pressure "
                f"fault — must be in (0, 1], got {factor!r}")
        peer = fault.get("peer", DEFAULT_SIM_PEER)
        if not isinstance(peer, str) or not peer:
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].peer must be a non-empty string, "
                f"got {peer!r}")
        if "peer" in fault and kind not in ("peer_death", "slow_peer"):
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].peer only applies to "
                f"peer_death/slow_peer faults, not {kind!r}")
        slice_name = fault.get("slice")
        if kind == "slice_kill":
            if not isinstance(slice_name, str) or not slice_name:
                raise DeepSpeedConfigError(
                    f"{where}.faults[{i}].slice is required for a "
                    f"slice_kill fault (the multislice slice name to "
                    f"kill), got {slice_name!r}")
        elif "slice" in fault:
            raise DeepSpeedConfigError(
                f"{where}.faults[{i}].slice only applies to slice_kill "
                f"faults, not {kind!r}")
        out.append({"kind": kind, "step": step, "times": times,
                    "factor": float(factor), "seconds": float(seconds),
                    "peer": peer, "slice": slice_name,
                    "remaining": times})
    return out


class FaultInjector:
    """Per-process deterministic fault plan.

    `plan_next_step()` is called exactly once a step and returns ``(mode,
    factor, stall_seconds)`` for the training kinds; host faults fired on
    that serial are popped with `take_host_faults()`. ``fired`` is the
    ``(serial, kind)`` audit trail."""

    def __init__(self, faults):
        self.faults = faults
        self.serial = 0       # monotonic step counter
        self.fired = []       # (serial, kind) audit trail
        self._pending_host = []   # host faults fired by the last plan

    @classmethod
    def from_config_env(cls, config_spec=None, env=None):
        """Build from the config block and / or the DS_FAULT_INJECT env
        var (faults of both are merged); None when neither is present."""
        env = os.environ if env is None else env
        faults = []
        if config_spec:
            faults += validate_fault_spec(config_spec)
        raw = env.get(ENV_VAR)
        if raw:
            try:
                spec = json.loads(raw)
            except json.JSONDecodeError as e:
                raise DeepSpeedConfigError(
                    f"{ENV_VAR} is not valid JSON: {e}") from e
            faults += validate_fault_spec(spec, where=ENV_VAR)
        if not faults:
            return None
        return cls(faults)

    @property
    def has_device_faults(self):
        return any(f["kind"] in ("nan_grads", "loss_spike")
                   for f in self.faults)

    @property
    def has_serving_faults(self):
        return any(f["kind"] in SERVING_FAULT_KINDS for f in self.faults)

    @property
    def has_multislice_faults(self):
        return any(f["kind"] in MULTISLICE_FAULT_KINDS
                   for f in self.faults)

    @property
    def simulated_peers(self):
        """Names of the simulated peers the plan acts on."""
        return sorted({f["peer"] for f in self.faults
                       if f["kind"] in ("peer_death", "slow_peer")})

    def plan_next_step(self):
        serial = self.serial
        self.serial += 1
        mode, factor, stall = MODE_NONE, 1.0, 0.0
        for fault in self.faults:
            if fault["remaining"] <= 0:
                continue
            if not (fault["step"] <= serial
                    < fault["step"] + fault["times"]):
                continue
            fault["remaining"] -= 1
            self.fired.append((serial, fault["kind"]))
            if fault["kind"] == "nan_grads":
                mode = MODE_NAN_GRADS
            elif fault["kind"] == "loss_spike":
                mode = MODE_LOSS_SPIKE
                factor = fault["factor"]
            elif fault["kind"] == "stall":
                stall = max(stall, fault["seconds"])
            elif fault["kind"] in HOST_FAULT_KINDS:
                self._pending_host.append(dict(fault))
        return mode, factor, stall

    def take_host_faults(self):
        """Host faults fired by the most recent `plan_next_step`; drains
        the queue."""
        out, self._pending_host = self._pending_host, []
        return out


def apply_fault(loss, grads, fault):
    """Corrupt the step's loss and gradients by the ``(mode, factor)``
    pair: NaN gradients under MODE_NAN_GRADS, the loss times ``factor``
    under MODE_LOSS_SPIKE, the identity under MODE_NONE. ``grads`` is a
    tensor, or a list, tuple or dict of tensors; the selects are
    `torch.where`s, so no branch depends on a device value."""
    mode, factor = fault
    mode = torch.as_tensor(mode, device=loss.device)
    is_nan = mode == MODE_NAN_GRADS

    def nan_where(g):
        return torch.where(is_nan.to(g.device),
                           torch.full_like(g, float("nan")), g)

    if isinstance(grads, dict):
        grads = {k: nan_where(g) for k, g in grads.items()}
    elif isinstance(grads, (list, tuple)):
        grads = type(grads)(nan_where(g) for g in grads)
    else:
        grads = nan_where(grads)
    loss = torch.where(mode == MODE_LOSS_SPIKE,
                       loss * torch.as_tensor(factor, dtype=loss.dtype,
                                              device=loss.device), loss)
    return loss, grads
