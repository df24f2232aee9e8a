"""SLO-aware admission control + load shedding for the serving engine.

The plain scheduler's only overload behavior is FIFO back-pressure: the
waiting deque grows without bound, every queued request eventually
runs, and a client cannot tell "30s queueing delay ahead" from
"healthy".
Production serving treats tail-latency SLOs under bursty load as
the headline metric, which needs the opposite discipline: **shed early,
shed the right requests, and tell the client when to come back**.

`AdmissionController` gates `InferenceEngine.submit()` on the three
saturation signals the engine exports per step:

- **queue depth** — the bounded admission queue: past
  ``max_queue_depth`` every class sheds (an unbounded queue converts
  overload into unbounded latency, the worst possible SLO response);
- **page-pool utilization** — past ``shed_page_pool_util`` the pool is
  one burst away from eviction thrash, so ``batch``-priority requests
  shed while ``interactive`` ones still admit (the priority classes'
  whole point);
- **TTFT EMA** — an exponential moving average of measured
  time-to-first-token. Past ``shed_ttft_ema_ms`` batch requests shed;
  independently, a request carrying its own ``ttft_slo_ms`` is shed
  (any class) when the measured EMA already exceeds what it asks for —
  admitting it would burn compute on a guaranteed SLO miss. Both EMA
  signals require a LIVE backlog (``queue_depth > 0``): the EMA only
  refreshes on admitted requests' first tokens, so a stale high EMA on
  an idle server must not shed traffic forever.

Shed requests surface as a typed `RequestRejected` carrying the
terminal ``shed`` status, the triggering reason, and a **retry-after
hint computed from the measured drain rate** (an EMA of request
completions per second): ``excess backlog / drain rate``, clamped to
``[0.05s, retry_after_cap_s]``. Clients that honor the hint arrive
when the queue has actually drained instead of dog-piling.

The typed request-terminal errors live here too (`DeadlineExceeded`,
`RequestFailed`, `DrainAborted`): every request the engine accepts
reaches exactly one terminal status — ``ok`` / ``shed`` /
``deadline_exceeded`` / ``failed`` — and the non-``ok`` ones carry one
of these exceptions in ``Request.error`` (docs/inference.md lists the
taxonomy).
"""

import time

# priority classes, high to low. `interactive` is user-facing traffic
# (shed last, evicted last); `batch` is offline/bulk traffic (shed
# first under overload, evicted first under page pressure).
PRIORITIES = ("interactive", "batch")
PRIORITY_RANK = {name: i for i, name in enumerate(PRIORITIES)}

# terminal request statuses — every accepted request reaches exactly
# one (scheduler enforces single assignment); shed requests never enter
# the scheduler and carry STATUS_SHED on the RequestRejected error
STATUS_OK = "ok"
STATUS_SHED = "shed"
STATUS_DEADLINE = "deadline_exceeded"
STATUS_FAILED = "failed"
REQUEST_STATUSES = (STATUS_OK, STATUS_SHED, STATUS_DEADLINE,
                    STATUS_FAILED)


class RequestRejected(RuntimeError):
    """Typed shed verdict from admission control. ``retry_after_s`` is
    the drain-rate-derived back-off hint; ``reason`` is one of
    ``queue_full`` / ``overload`` / ``slo_unattainable``."""

    def __init__(self, message, retry_after_s, reason, request=None):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.reason = str(reason)
        self.request = request


class DeadlineExceeded(RuntimeError):
    """A request's ``deadline_ms`` elapsed before it finished — it is
    terminated with status ``deadline_exceeded`` instead of consuming
    further decode cadence (the client has already given up)."""


class RequestFailed(RuntimeError):
    """Terminal step-failure verdict: the request failed
    ``retry.max_attempts`` consecutive prefill/decode steps and is
    poisoned permanently (the serving mirror of the training poison-step
    detector). ``last_error`` holds the final underlying exception."""

    def __init__(self, message, last_error=None, attempts=0):
        super().__init__(message)
        self.last_error = last_error
        self.attempts = int(attempts)


class DrainAborted(RequestFailed):
    """The graceful-drain deadline elapsed with this request still in
    flight: it is failed (typed, flushed to metrics) rather than
    silently abandoned, so the client can tell drain from crash."""


def validate_priority(priority):
    """Priority-class name -> rank; typos raise with the choices listed
    (the same strictness the config parser applies)."""
    if priority not in PRIORITY_RANK:
        raise ValueError(
            f"unknown priority class {priority!r}; choices: "
            f"{list(PRIORITIES)}")
    return PRIORITY_RANK[priority]


class AdmissionController:
    """The submit-time gate. Host-side and O(1) per decision — the
    serving hot loop never waits on it.

    ``params`` is the validated ``inference.admission`` dict
    (`runtime.config.parse_inference_block`). Signals are pushed by the
    engine: `observe_ttft` after each first token, `note_finished` at
    each step end (feeds the drain-rate EMA the retry-after hint is
    computed from)."""

    def __init__(self, params, clock=time.perf_counter):
        self.max_queue_depth = int(params["max_queue_depth"])
        self.shed_page_pool_util = float(params["shed_page_pool_util"])
        self.shed_ttft_ema_ms = params["shed_ttft_ema_ms"]
        self.ttft_ema_beta = float(params["ttft_ema_beta"])
        self.retry_after_cap_s = float(params["retry_after_cap_s"])
        self._clock = clock

        self._ttft_ema_ms = None
        self._drain_rate = None       # finished requests / second (EMA)
        self._last_finish_at = None
        self.shed_counts = {"queue_full": 0, "overload": 0,
                            "slo_unattainable": 0}

    # -- signal intake -----------------------------------------------------

    @property
    def ttft_ema_ms(self):
        return self._ttft_ema_ms

    @property
    def drain_rate(self):
        """Measured request completions per second (None pre-warmup)."""
        return self._drain_rate

    def observe_ttft(self, ms):
        ms = float(ms)
        if self._ttft_ema_ms is None:
            self._ttft_ema_ms = ms
        else:
            b = self.ttft_ema_beta
            self._ttft_ema_ms = b * self._ttft_ema_ms + (1.0 - b) * ms

    def note_finished(self, n, now=None):
        """n requests reached a terminal status this step — update the
        drain-rate EMA from the inter-completion interval."""
        if n <= 0:
            return
        now = self._clock() if now is None else now
        if self._last_finish_at is not None:
            dt = now - self._last_finish_at
            if dt > 0:
                rate = n / dt
                if self._drain_rate is None:
                    self._drain_rate = rate
                else:
                    b = self.ttft_ema_beta
                    self._drain_rate = b * self._drain_rate + \
                        (1.0 - b) * rate
        self._last_finish_at = now

    # -- the verdict -------------------------------------------------------

    def retry_after_s(self, queue_depth):
        """Back-off hint from the measured drain rate: how long until
        the current backlog (plus the rejected request) has drained.
        Conservative 1s default before any completion was measured."""
        if not self._drain_rate or self._drain_rate <= 0:
            return 1.0
        hint = (queue_depth + 1) / self._drain_rate
        return min(max(hint, 0.05), self.retry_after_cap_s)

    def admit(self, request, queue_depth, page_pool_util):
        """Admit or shed one request. Returns None on admit; raises
        `RequestRejected` (after stamping the request's terminal
        ``shed`` status) on shed."""
        reason = None
        # TTFT-EMA sheds require a LIVE backlog: the EMA only refreshes
        # when admitted requests deliver first tokens, so on an idle
        # server (empty queue) a stale high EMA from a past burst would
        # otherwise shed SLO-carrying traffic forever — with nothing
        # admitted, nothing could ever bring the EMA back down
        backlogged = queue_depth > 0
        if queue_depth >= self.max_queue_depth:
            reason = "queue_full"
            detail = (f"admission queue is full "
                      f"({queue_depth}/{self.max_queue_depth})")
        elif backlogged and request.ttft_slo_ms is not None and \
                self._ttft_ema_ms is not None and \
                self._ttft_ema_ms > request.ttft_slo_ms:
            # any class: the measured TTFT already misses what this
            # request asks for — admitting it burns compute on a
            # guaranteed SLO violation
            reason = "slo_unattainable"
            detail = (f"measured TTFT EMA {self._ttft_ema_ms:.0f}ms "
                      f"exceeds the request's ttft_slo_ms "
                      f"{request.ttft_slo_ms:.0f}ms")
        elif PRIORITY_RANK.get(request.priority, 0) > 0:
            # batch-class traffic sheds on the soft overload signals
            # interactive traffic rides out
            if page_pool_util >= self.shed_page_pool_util:
                reason = "overload"
                detail = (f"page pool {page_pool_util:.0%} utilized "
                          f"(>= shed_page_pool_util "
                          f"{self.shed_page_pool_util:.0%})")
            elif backlogged and self.shed_ttft_ema_ms is not None and \
                    self._ttft_ema_ms is not None and \
                    self._ttft_ema_ms > self.shed_ttft_ema_ms:
                reason = "overload"
                detail = (f"TTFT EMA {self._ttft_ema_ms:.0f}ms past the "
                          f"shed threshold {self.shed_ttft_ema_ms:.0f}ms")
        if reason is None:
            return None
        self.shed_counts[reason] += 1
        request.status = STATUS_SHED
        hint = self.retry_after_s(queue_depth)
        err = RequestRejected(
            f"request shed ({reason}): {detail}; retry after "
            f"{hint:.2f}s", retry_after_s=hint, reason=reason,
            request=request)
        request.error = err
        raise err
