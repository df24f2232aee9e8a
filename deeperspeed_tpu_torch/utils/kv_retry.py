"""Shared retry/degrade policy: the capped exponential backoff law and a
retrying wrapper for key-value transports.

The port of `deeperspeed_tpu/utils/kv_retry.py`, pure Python:

- `backoff_delay` is THE capped-exponential-backoff × uniform-jitter
  law. The serving quarantine (`inference.engine._quarantine_batch`)
  draws its retry delays from it with a `random.Random(seed)` of its
  own, so the port's delays equal the JAX package's for the same seed.
- `RetryingKVTransport` wraps any transport exposing
  ``publish(peer, payload)`` / ``read_all()`` with those retries. With
  ``degrade_to_local=True`` an op whose attempts run out logs ONE
  warning and degrades to a process-local `InMemoryTransport`, re-probing
  the real transport on a capped backoff and promoting back on the first
  success; with ``degrade_to_local=False`` the final error is re-raised,
  so a caller's outage escalation still sees it.

Retries sleep at most ``sum(min(base·2^i, cap))`` per op — keep
``attempts`` small on paths polled from daemon threads.
"""

import random
import threading
import time

from .logging import logger


def backoff_delay(attempt, base, cap, jitter, rng=None):
    """Delay before 1-based retry ``attempt``: ``min(base ·
    2^(attempt-1), cap)`` scaled by a uniform factor in ``[1 - jitter,
    1 + jitter]`` drawn from ``rng`` (anything with ``.random()``; the
    module's generator when None). Units are those of ``base`` / ``cap``
    (the serving quarantine passes milliseconds)."""
    delay = min(float(base) * 2.0 ** (int(attempt) - 1), float(cap))
    if jitter:
        r = random.random() if rng is None else rng.random()
        delay *= 1.0 + float(jitter) * (2.0 * r - 1.0)
    return max(delay, 0.0)


class InMemoryTransport:
    """Process-local key-value store: the stand-in a degraded
    `RetryingKVTransport` falls back to (the JAX package keeps it in
    `elasticity/heartbeat.py`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._beats = {}

    def publish(self, peer, payload):
        with self._lock:
            self._beats[str(peer)] = dict(payload)

    def read_all(self):
        with self._lock:
            return {k: dict(v) for k, v in self._beats.items()}

    def discard(self, peer):
        """Drop a key (absent is fine)."""
        with self._lock:
            self._beats.pop(str(peer), None)


class RetryingKVTransport:
    """Capped-exponential-backoff × jitter retry wrapper over a KV
    transport (see the module docstring for the two degrade
    postures)."""

    def __init__(self, transport, attempts=3, backoff_base_s=0.05,
                 backoff_cap_s=1.0, jitter=0.5, degrade_to_local=False,
                 name="kv", rng=None, sleep=time.sleep,
                 reprobe_base_s=5.0, reprobe_cap_s=300.0,
                 clock=time.monotonic):
        if attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {attempts}")
        if not 0 <= jitter < 1:
            raise ValueError(f"jitter must be in [0, 1), got {jitter}")
        self.transport = transport
        self.attempts = int(attempts)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.jitter = float(jitter)
        self.degrade_to_local = bool(degrade_to_local)
        self.name = str(name)
        self._rng = rng if rng is not None else random.Random()
        self._sleep = sleep
        self._clock = clock
        self._local = None           # set while degraded
        self.retry_count = 0
        self.error_count = 0
        # re-probe intervals of the real transport while degraded follow
        # the same law (base·2^k up to cap)
        self.reprobe_base_s = float(reprobe_base_s)
        self.reprobe_cap_s = float(reprobe_cap_s)
        self._reprobe_failures = 0
        self._next_reprobe_at = None
        self.reprobe_count = 0
        self.recovered_count = 0

    @property
    def degraded(self):
        return self._local is not None

    def _backoff_s(self, attempt):
        """Delay before retry ``attempt`` (1-based): independent callers
        must not stampede a recovering service in lockstep."""
        return backoff_delay(attempt, self.backoff_base_s,
                             self.backoff_cap_s, self.jitter, self._rng)

    def _schedule_reprobe(self):
        self._reprobe_failures += 1
        delay = backoff_delay(self._reprobe_failures, self.reprobe_base_s,
                              self.reprobe_cap_s, self.jitter, self._rng)
        self._next_reprobe_at = self._clock() + delay

    def _try_reprobe(self, op, args):
        """While degraded, one bare call of the REAL transport once the
        probe deadline has passed. Success promotes back and returns the
        real result; failure re-schedules and returns None (the caller
        falls through to the local store)."""
        if self._next_reprobe_at is None or \
                self._clock() < self._next_reprobe_at:
            return None
        self.reprobe_count += 1
        try:
            out = getattr(self.transport, op)(*args)
        except Exception as e:  # noqa: BLE001 - the policy seam
            self.error_count += 1
            self._schedule_reprobe()
            logger.debug(f"{self.name}: re-probe {self.reprobe_count} "
                         f"failed ({type(e).__name__}: {e})")
            return None
        self._local = None
        self._reprobe_failures = 0
        self._next_reprobe_at = None
        self.recovered_count += 1
        logger.warning(
            f"{self.name}: KV transport recovered after "
            f"{self.reprobe_count} re-probe(s) — promoting back from the "
            f"local in-memory store")
        return out

    def _call(self, op, *args):
        if self._local is not None:
            out = self._try_reprobe(op, args)
            if out is not None or not self.degraded:
                return out
            return getattr(self._local, op)(*args)
        last = None
        for attempt in range(1, self.attempts + 1):
            try:
                return getattr(self.transport, op)(*args)
            except Exception as e:  # noqa: BLE001 - the policy seam
                last = e
                self.error_count += 1
                if attempt < self.attempts:
                    self.retry_count += 1
                    self._sleep(self._backoff_s(attempt))
        if not self.degrade_to_local:
            raise last
        self._local = InMemoryTransport()
        self._reprobe_failures = 0
        self._schedule_reprobe()
        logger.warning(
            f"{self.name}: KV {op} still failing after {self.attempts} "
            f"attempt(s) ({type(last).__name__}: {last}) — degrading to a "
            f"local in-memory store (this host only; re-probing with "
            f"capped backoff from {self.reprobe_base_s:.0f}s)")
        return getattr(self._local, op)(*args)

    def publish(self, peer, payload):
        return self._call("publish", peer, payload)

    def read_all(self):
        return self._call("read_all")


def wrap_kv_transport(transport, degrade_to_local, name):
    """The standard wrapping (one knob site)."""
    return RetryingKVTransport(transport,
                               degrade_to_local=degrade_to_local,
                               name=name)
