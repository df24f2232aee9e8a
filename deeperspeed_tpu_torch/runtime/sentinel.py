"""The hang watchdog and the all-thread stack dump.

The port of `dump_all_stacks` and `HangWatchdog` from
`deeperspeed_tpu/runtime/sentinel.py`. The serving engine arms the
watchdog around a step's dispatch (``inference.hang_timeout_s``) and
feeds it when the step returns or dies; on expiry the owner's callback
dumps every thread's stack and requests a drain.

Not ported yet (ROADMAP.md, A.8.1, the training sentinel):
`TrainingHealthSentinel`, the device-side anomaly probe and its
escalation ladder (warn → skip_batch → rollback → abort). The training
engine refuses the ``training_health`` block until they land.
"""

import sys
import threading
import time
import traceback
import weakref

from ..utils.logging import logger


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
