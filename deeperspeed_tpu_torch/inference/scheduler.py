"""Continuous-batching scheduler for the serving engine.

Per engine step the scheduler builds ONE `StepPlan`: a (possibly empty)
prefill batch of newly admitted requests plus the decode batch of every
in-flight sequence — at FIXED compiled shapes. Batch and length are
bucketed (`prefill_lengths`, `prefill_batch_sizes`,
`decode_batch_sizes`), so after the bucket ladder has warmed up, XLA
never recompiles no matter how requests arrive (`InferenceEngine.
compile_count` pins this in tests).

Admission policy (in order, per step):

1. Every running sequence decodes this step — decode is never starved
   by prefill. A sequence crossing into a page it does not own yet gets
   one page from the pool first; if the pool is empty, the YOUNGEST
   running request is evicted (pages freed, request requeued at the
   front of the waiting queue with its generated prefix intact as
   prompt) until the allocation succeeds — oldest work finishes first,
   and an evicted request re-prefills its whole context on readmission.
2. Waiting requests admit FIFO while (a) the step's token budget holds
   — a prefill costs its padded bucket length, a decode costs 1 token —
   (b) a decode slot is free (`max_batch_size` bounds in-flight
   sequences), (c) the prefill batch bucket has room, and (d) the pool
   can hand the request all pages of its padded prompt bucket up front
   (the whole-page prefill scatter writes every bucket page, and the
   tail pages double as growth room — no per-token allocation until the
   sequence outgrows its bucket). One prefill call runs ONE length
   bucket: shorter queued prompts pad up into the batch's bucket, a
   longer one closes the batch and leads the next step's.

Token accounting uses PADDED bucket sizes, not raw prompt lengths: the
budget is a compute bound, and compute is spent at compiled shapes.
The budget must cover the largest user prefill bucket (validated at
init — a smaller budget could never admit such a prompt); an evicted
request whose regrown context buckets above the user ladder is exempt
from the budget for the step's first prefill, so the queue can never
wedge behind it.

Robustness layer (docs/inference.md "Serving under failure"):

- every request reaches exactly ONE terminal status — ``ok`` /
  ``shed`` / ``deadline_exceeded`` / ``failed`` (`Request.status`;
  single assignment enforced) — surfaced via `pop_finished()` and the
  per-status ``Serve/requests_*`` counters;
- requests carrying a ``deadline_ms`` are expired at the top of every
  `schedule()` (waiting AND running) with a typed `DeadlineExceeded`
  instead of consuming further decode cadence;
- eviction picks the LOWEST-priority / LATEST-deadline victim
  (`_evict_victim`) instead of blanket youngest-first — ``batch``
  traffic is preempted before ``interactive``, and within a class the
  request with the most deadline slack goes first (youngest as the
  final tiebreak, preserving the original policy for homogeneous
  streams);
- step-failure quarantine: the engine parks implicated requests here
  (`quarantine_request`) with a capped-jittered ``retry_at``; they
  re-admit at the queue front once eligible (eviction-regrowth
  machinery reused: budget exemption, drain re-admission).

Serving-speedup layer (docs/inference.md "Prefix/radix cache" +
"Speculative decoding"; both default-off):

- with a `PrefixCache`, `add_request` (retried at admission) attaches
  the longest registered page chain matching the prompt — the request
  shares those pages by refcount and its prefill covers only the
  SUFFIX (a "chunk" step plan); `complete_prefill` registers the full
  prompt pages back into the chain;
- with ``spec_tokens`` = k > 0, decode rows budget/grow for a k-token
  draft window; `complete_speculative` applies the accepted run and
  rolls tail pages the next window cannot reach back to the allocator.
"""

import math
from collections import deque
from dataclasses import dataclass, field

from .admission import (DeadlineExceeded, PRIORITY_RANK, STATUS_DEADLINE,
                        STATUS_FAILED, STATUS_OK)
from .kv_cache import pages_for_tokens

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


@dataclass
class Request:
    """One generation request. `prompt` is a list/array of token ids."""
    prompt: list
    max_new_tokens: int
    request_id: object = None
    eos_token_id: int = None
    # SLO contract (admission.py): priority class, wall-clock deadline,
    # TTFT service objective — all optional
    priority: str = "interactive"
    deadline_ms: float = None
    ttft_slo_ms: float = None
    # runtime state (owned by the scheduler/engine)
    generated: list = field(default_factory=list)
    pages: list = field(default_factory=list)
    cached: int = 0          # tokens whose K/V sit in `pages`
    # prefix-cache attachment: the first `n_shared` entries of `pages`
    # are registry pages this request only READS (retained, never
    # written); `prefix_node` is the deepest matched/registered chain
    # node (kv_cache.PrefixCache)
    n_shared: int = 0
    prefix_node: object = None
    state: str = WAITING
    evictions: int = 0
    enqueued_at: float = None
    admitted_at: float = None
    deadline_at: float = None   # absolute clock: enqueue + deadline_ms
    # terminal outcome: exactly one of ok/shed/deadline_exceeded/failed,
    # assigned once; non-ok outcomes carry the typed error
    status: str = None
    error: Exception = None
    # step-failure quarantine bookkeeping (engine `_quarantine_batch`):
    # consecutive failed steps (reset on any completed step) and the
    # earliest re-admission time of the current backoff window
    failures: int = 0
    retry_at: float = None
    # request-level latency observability (inference/metrics.py):
    # submitted_at survives evictions (TTFT measures from first submit,
    # once); last_token_at feeds the inter-token histogram
    submitted_at: float = None
    first_token_at: float = None
    last_token_at: float = None

    @property
    def context(self):
        """Prompt + generated so far (what an eviction re-prefills)."""
        return list(self.prompt) + list(self.generated)

    @property
    def done(self):
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (self.eos_token_id is not None and self.generated and
                self.generated[-1] == self.eos_token_id)


@dataclass
class StepPlan:
    """One engine step at fixed compiled shapes."""
    prefills: list            # requests entering this step
    prefill_batch: int        # batch bucket (0 = no prefill this step)
    prefill_len: int          # length bucket
    decodes: list             # in-flight requests decoding this step
    decode_batch: int         # batch bucket (0 = no decode this step)
    evicted: list             # requests preempted while planning
    # "full" = whole-context prefill (every page written); "chunk" =
    # prefix-cache suffix prefill (rows carry shared pages that are
    # only read; prefill_len buckets the SUFFIX) — one kind per call,
    # like the length bucket
    prefill_kind: str = "full"

    @property
    def empty(self):
        return not self.prefills and not self.decodes


def _bucket(value, buckets):
    """Smallest bucket >= value; None when value exceeds the ladder."""
    for b in buckets:
        if value <= b:
            return b
    return None


class ContinuousBatchingScheduler:
    """Admission/eviction over a `PagedKVCache` pool under a per-step
    token budget. Host-side and deterministic: the same request arrival
    order always produces the same step plans (the serving bench's
    fixed-seed open-loop stream relies on this)."""

    def __init__(self, cache, max_seq_len, token_budget, max_batch_size,
                 prefill_lengths, prefill_batch_sizes, decode_batch_sizes,
                 prefix_cache=None, spec_tokens=0):
        self.cache = cache
        self.page_size = cache.page_size
        self.max_seq_len = int(max_seq_len)
        self.token_budget = int(token_budget)
        self.max_batch_size = int(max_batch_size)
        # prefix/radix reuse (kv_cache.PrefixCache) and speculative
        # decoding (k draft tokens verified per decode step); both off
        # by default — the plain behavior is bit-identical then
        self.prefix_cache = prefix_cache
        self.spec_tokens = int(spec_tokens)
        if self.max_seq_len % self.page_size:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} is not a multiple of "
                f"page_size {self.page_size}: the page-aligned re-prefill "
                f"ladder could not cover a context in the misaligned "
                f"tail, so an evicted request there could never readmit")
        self.prefill_lengths = sorted(int(b) for b in prefill_lengths)
        self.prefill_batch_sizes = sorted(int(b) for b in
                                          prefill_batch_sizes)
        self.decode_batch_sizes = sorted(int(b) for b in decode_batch_sizes)
        for length in self.prefill_lengths:
            if length % self.page_size:
                raise ValueError(
                    f"prefill length bucket {length} is not a multiple "
                    f"of page_size {self.page_size} (the prefill scatter "
                    f"writes whole pages)")
        if self.token_budget < self.prefill_lengths[-1]:
            raise ValueError(
                f"token_budget {self.token_budget} is smaller than the "
                f"largest prefill bucket {self.prefill_lengths[-1]}: a "
                f"prompt in that bucket could never be admitted (the "
                f"queue would livelock)")
        # Re-prefill ladder: an evicted request's context (prompt +
        # generated) can legitimately outgrow the user ladder while
        # staying under max_seq_len, so extend it with doubled
        # page-aligned buckets up to the (page-aligned, validated
        # above) window. Readmission then always has a shape; the
        # doubling keeps the lazily compiled program set logarithmic,
        # and eviction-regrowth is the only path that ever warms these
        # extra buckets.
        top = self.max_seq_len
        ladder = set(self.prefill_lengths)
        length = self.prefill_lengths[-1]
        while length < top:
            length = min(length * 2, top)
            ladder.add(length)
        self._prefill_ladder = sorted(ladder)
        self.waiting = deque()
        self.running = []
        self.finished = []
        self.quarantined = []    # step-failure backoff (retry_at gates)
        self.status_counts = {STATUS_OK: 0, STATUS_DEADLINE: 0,
                              STATUS_FAILED: 0}
        self._counter = 0
        self.draining = False

    # -- intake ------------------------------------------------------------

    def add_request(self, request, now=None):
        prompt_len = len(request.prompt)
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got "
                f"{request.max_new_tokens} (prefill always samples the "
                f"first token)")
        if _bucket(prompt_len, self.prefill_lengths) is None:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest prefill "
                f"bucket {self.prefill_lengths[-1]}")
        if prompt_len + request.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt {prompt_len} + max_new_tokens "
                f"{request.max_new_tokens} exceeds max_seq_len "
                f"{self.max_seq_len}")
        if request.request_id is None:
            request.request_id = self._counter
        self._counter += 1
        request.state = WAITING
        request.enqueued_at = now
        if request.submitted_at is None:
            request.submitted_at = now
        if request.deadline_at is None and request.deadline_ms is not None \
                and now is not None:
            request.deadline_at = now + float(request.deadline_ms) / 1e3
        if self.prefix_cache is not None:
            self._attach_prefix(request, count_lookup=True)
        self.waiting.append(request)
        return request.request_id

    # -- prefix/radix cache (kv_cache.PrefixCache) -------------------------

    def _attach_prefix(self, request, count_lookup=False):
        """Share the longest registered page chain matching the
        prompt: bump refcounts and start the request's page list with
        the shared pages — its prefill then covers only the suffix.
        Runs at `add_request` and retried at admission for misses (the
        registry may have warmed in between); hit/shared stats count
        once per request either way."""
        pc = self.prefix_cache
        if count_lookup:
            pc.stats["lookups"] += 1
        chain = pc.lookup(request.prompt)
        if not chain:
            return
        pages = [n.page for n in chain]
        self.cache.retain(pages)
        request.pages = list(pages)
        request.n_shared = len(pages)
        request.prefix_node = chain[-1]
        pc.stats["hits"] += 1
        pc.stats["pages_shared"] += len(pages)
        pc.stats["saved_prefill_tokens"] += len(pages) * self.page_size

    def _register_prefix(self, request):
        """After a completed prefill, register every FULL prompt page
        not already covered by the matched chain (generated tokens and
        partial tail pages never register — their content is not a pure
        function of the prompt prefix)."""
        ps = self.page_size
        n_full = len(request.prompt) // ps
        if n_full <= request.n_shared:
            return
        keys = [self.prefix_cache.page_key(request.prompt[i * ps:
                                                          (i + 1) * ps])
                for i in range(request.n_shared, n_full)]
        pages = request.pages[request.n_shared:n_full]
        request.prefix_node = self.prefix_cache.register(
            request.prefix_node, keys, pages)

    def detach_waiting_prefixes(self):
        """Drop prefix attachments from every not-yet-admitted request
        (waiting + quarantined): on a weight hot-swap or pool loss the
        shared pages' K/V no longer matches the model, so the requests
        must re-prefill their full prompt. Admitted (running) requests
        are the engine's problem — it evicts them on pool loss."""
        for req in list(self.waiting) + list(self.quarantined):
            if req.n_shared:
                self.cache.free(req.pages[:req.n_shared])
                req.pages = req.pages[req.n_shared:]
                req.n_shared = 0
            req.prefix_node = None

    @property
    def has_work(self):
        return bool(self.waiting or self.running or self.quarantined)

    # -- graceful drain ----------------------------------------------------

    def stop_admissions(self):
        """Graceful-drain mode (SIGTERM): `schedule()` stops admitting
        FRESH requests from the queue. Eviction-regrowth re-prefills
        (evicted in-flight sequences, whose K/V must be rebuilt to
        finish) still admit — they count as in-flight work."""
        self.draining = True

    @property
    def has_inflight_work(self):
        """Work a graceful drain should still finish: running sequences,
        evicted ones awaiting re-prefill, and quarantined ones awaiting
        a retry (their generation is partial). Fresh queued requests do
        NOT count — a draining server leaves them for the replacement
        instance."""
        return bool(self.running or self.quarantined or
                    any(r.evictions for r in self.waiting))

    def inflight_requests(self):
        """Every request a drain is still responsible for (the
        complement of the fresh queued ones `has_inflight_work`
        excludes) — what the drain-deadline path fails with a typed
        terminal status instead of silently abandoning."""
        return (list(self.running) + list(self.quarantined) +
                [r for r in self.waiting if r.evictions])

    def pop_finished(self):
        """Drain completed requests (the caller owns them afterwards).
        Long-lived serving loops must consume this (the engine's
        `generate` does) — `finished` otherwise grows without bound."""
        out, self.finished = self.finished, []
        return out

    # -- terminal statuses -------------------------------------------------

    def _release_pages(self, request):
        """Drop every page reference a request holds (owned AND
        prefix-shared — shared pages just lose one refcount and live on
        under the registry) and reset its prefix attachment."""
        self.cache.free(request.pages)
        request.pages = []
        request.n_shared = 0
        request.prefix_node = None

    def _finish(self, request, status, error=None):
        """The ONLY exit gate: pull the request out of whatever
        collection holds it, free its pages, and stamp its terminal
        status exactly once (a second assignment is an invariant
        violation, raised loudly — the chaos soak pins this)."""
        if request.status is not None:
            raise RuntimeError(
                f"request {request.request_id} already reached terminal "
                f"status {request.status!r}; refusing to overwrite with "
                f"{status!r}")
        if request in self.running:
            self.running.remove(request)
        if request in self.quarantined:
            self.quarantined.remove(request)
        try:
            self.waiting.remove(request)
        except ValueError:
            pass
        self._release_pages(request)
        request.status = status
        if error is not None:
            request.error = error
        request.state = FINISHED
        self.status_counts[status] += 1
        self.finished.append(request)

    def finish_failed(self, request, error):
        """Terminal step failure (poison / drain abort): status
        ``failed`` with the typed error attached."""
        self._finish(request, STATUS_FAILED, error)

    # -- deadline expiry ---------------------------------------------------

    def expire_deadlines(self, now=None):
        """Terminate every request whose ``deadline_ms`` elapsed —
        waiting, quarantined, or running — with a typed
        `DeadlineExceeded` and status ``deadline_exceeded``. Runs at
        the top of every `schedule()` so an expired request never
        consumes another decode step. Returns the expired requests."""
        if now is None:
            return []
        expired = [r for r in list(self.waiting) + list(self.quarantined)
                   + list(self.running)
                   if r.deadline_at is not None and now >= r.deadline_at]
        for req in expired:
            self._finish(req, STATUS_DEADLINE, DeadlineExceeded(
                f"request {req.request_id} missed its deadline "
                f"(deadline_ms={req.deadline_ms}) with "
                f"{len(req.generated)}/{req.max_new_tokens} tokens "
                f"generated"))
        return expired

    # -- step-failure quarantine (engine `_quarantine_batch`) --------------

    def quarantine_request(self, request, retry_at, now=None):
        """Park a step-failed request for a capped-jittered retry:
        evict it (pages freed, full-context re-prefill on readmission —
        the eviction machinery's budget exemption and drain
        re-admission apply) but gate re-admission on ``retry_at``."""
        if request in self.running:
            self.running.remove(request)
        try:
            # cache-loss recovery may have already evicted it into the
            # waiting queue — it must not sit in BOTH collections
            self.waiting.remove(request)
        except ValueError:
            pass
        self._release_pages(request)
        request.cached = 0
        request.evictions += 1
        request.state = WAITING
        request.enqueued_at = now
        request.retry_at = float(retry_at)
        self.quarantined.append(request)

    def admit_handoff(self, request, now=None):
        """Admit a request whose prefill happened on ANOTHER pool
        (disaggregated serving): its pages are already allocated and
        written, its first token already sampled — it enters `running`
        directly, bypassing admission and the prefill queue. The
        decode-role drain gate does not apply: a handed-off request IS
        in-flight work."""
        if request.request_id is None:
            request.request_id = self._counter
        self._counter += 1
        request.state = RUNNING
        request.admitted_at = now
        self.running.append(request)

    def requeue_handoff(self, request, now=None):
        """Put a request whose handoff failed (rejected / timed-out
        offer) back at the FRONT of the waiting queue with eviction
        semantics: pages freed, K/V rebuilt by a full-context
        re-prefill, then a fresh offer. `evictions` counting keeps it
        admissible through a prefill-pool drain."""
        if request in self.running:
            self.running.remove(request)
        self._release_pages(request)
        request.cached = 0
        request.evictions += 1
        request.state = WAITING
        request.enqueued_at = now
        self.waiting.appendleft(request)

    def _release_quarantined(self, now):
        """Move backoff-expired quarantined requests to the FRONT of
        the waiting queue (like any evicted request — their partial
        generation finishes before fresh work starts)."""
        if not self.quarantined or now is None:
            return
        due = [r for r in self.quarantined if r.retry_at is None or
               now >= r.retry_at]
        for req in due:
            self.quarantined.remove(req)
            req.retry_at = None
            self.waiting.appendleft(req)

    # -- planning ----------------------------------------------------------

    def _evict_victim(self, now=None):
        """Preempt the lowest-priority / latest-deadline running
        request: free its pages and requeue it (front of the queue,
        full context as the new prompt). Victim order: ``batch`` before
        ``interactive``; within a class, the request with the MOST
        deadline slack (no deadline = infinite slack) goes first;
        youngest-first as the final tiebreak (the pre-robustness
        policy, preserved exactly for homogeneous streams). Returns the
        request, or None if nothing to evict."""
        if not self.running:
            return None
        req = max(
            enumerate(self.running),
            key=lambda kv: (PRIORITY_RANK.get(kv[1].priority, 0),
                            kv[1].deadline_at if kv[1].deadline_at
                            is not None else math.inf,
                            kv[0]))[1]
        self.running.remove(req)
        self._release_pages(req)
        req.cached = 0
        req.evictions += 1
        req.state = WAITING
        # admission wait restarts from the requeue, else readmission
        # re-counts the first wait AND the time spent running
        req.enqueued_at = now
        self.waiting.appendleft(req)
        return req

    # youngest-first was the pre-robustness policy; the name survives
    # for callers/tests that drive an explicit eviction round-trip
    _evict_youngest = _evict_victim

    def _spec_window(self, req):
        """Draft tokens to propose for `req` this step: the configured
        k, capped so (a) the request can still USE that many — accepting
        w drafts appends w+1 tokens, bounded by max_new_tokens — and
        (b) every window position cached..cached+w stays inside the
        serving window. 0 when speculation is off (or the request can
        only take one more token: plain decode)."""
        if not self.spec_tokens:
            return 0
        remaining = req.max_new_tokens - len(req.generated)
        return max(0, min(self.spec_tokens, remaining - 1,
                          self.max_seq_len - 1 - req.cached))

    def _grow_running(self, evicted, now=None):
        """Give every running sequence the page(s) its next step needs
        — one token, or the whole speculative window cached..cached+w;
        evict youngest-first when the pool runs dry. A sequence can
        never evict itself out of existence: with one running request
        the pool math guarantees its page fits or the config was
        rejected at engine init."""
        for req in list(self.running):
            if req not in self.running:           # evicted by an earlier turn
                continue
            # last slot this step's writes reach (the speculative
            # verify writes the full window before acceptance)
            pos = req.cached + self._spec_window(req)
            page_idx = pos // self.page_size
            while page_idx >= len(req.pages):
                got = self.cache.allocate(1)
                if got is not None:
                    req.pages.extend(got)
                    continue
                victim = self._evict_youngest(now)
                if victim is None:
                    raise RuntimeError(
                        "page pool exhausted with nothing left to evict "
                        "— num_pages is too small for max_seq_len")
                evicted.append(victim)
                if victim is req:                 # req evicted itself
                    break

    def schedule(self, now=None):
        """Build this step's `StepPlan` (see the module docstring for
        the policy). Mutates scheduler state: admitted requests move to
        `running` with pages allocated; evicted ones back to `waiting`;
        deadline-expired ones terminate first (typed, never another
        decode step); backoff-expired quarantined ones re-enter the
        queue front."""
        self.expire_deadlines(now)
        self._release_quarantined(now)
        evicted = []
        self._grow_running(evicted, now)
        decodes = list(self.running)
        # a decode step costs 1 token per row — plus its speculative
        # window: the verify forward computes window+1 positions
        budget = self.token_budget - sum(1 + self._spec_window(r)
                                         for r in decodes)

        prefills = []
        step_len = 0
        step_kind = "full"
        max_prefill_batch = self.prefill_batch_sizes[-1]
        while self.waiting and len(prefills) < max_prefill_batch and \
                len(self.running) < self.max_batch_size:
            req = self.waiting[0]
            if self.draining and not req.evictions:
                # drain: fresh requests stay queued (the front of the
                # queue is fresh ⇒ everything behind it is too — evicted
                # requests requeue at the FRONT)
                break
            if self.prefix_cache is not None and not req.n_shared and \
                    not req.evictions and not req.generated:
                # miss at submit time — the registry may have warmed
                # since (the bursty shared-prefix case: the whole burst
                # queues before the first prefill registers)
                self._attach_prefix(req)
            # a prefix-attached request prefills only its SUFFIX (the
            # shared pages already hold the prefix K/V): bucket that
            req_kind = "chunk" if req.n_shared else "full"
            suffix_len = len(req.context) - req.n_shared * self.page_size
            length = _bucket(suffix_len, self._prefill_ladder)
            if length is None:
                # unreachable: the ladder tops at the aligned window and
                # running contexts stay below it (_maybe_finish) — kept
                # as a loud invariant guard rather than a queue wedge
                self.finish_failed(req, RuntimeError(
                    "context outgrew the prefill bucket ladder"))
                raise RuntimeError(
                    f"request {req.request_id} context "
                    f"({len(req.context)} tokens) outgrew the prefill "
                    f"bucket ladder after eviction; raise "
                    f"prefill_lengths or num_pages")
            # one length bucket AND one kind per prefill call: shorter
            # prompts pad up into the batch's bucket, a LONGER one (or
            # a kind mismatch — the chunk and full programs have
            # different shapes) waits for the next step
            if prefills and (length > step_len or req_kind != step_kind):
                break
            row_len = step_len if prefills else length
            if row_len > budget and (prefills or not req.evictions):
                # the step's first prefill is budget-exempt for EVICTED
                # requests: their regrown context can bucket above the
                # user ladder (and the validated budget floor), and they
                # requeue at the queue front — holding them to the
                # budget would wedge the queue behind them forever
                break
            pages = self.cache.allocate(pages_for_tokens(row_len,
                                                         self.page_size))
            if pages is None:
                break                      # pool full: wait for completions
            budget -= row_len
            step_len = row_len
            step_kind = req_kind
            self.waiting.popleft()
            # shared prefix pages (if any) stay in front; the freshly
            # allocated suffix/bucket pages follow — page i of the list
            # always holds context tokens [i·ps, (i+1)·ps)
            req.pages = req.pages + pages
            req.cached = 0
            req.state = RUNNING
            req.admitted_at = now
            self.running.append(req)
            prefills.append(req)

        prefill_len = step_len if prefills else 0
        prefill_batch = (_bucket(len(prefills), self.prefill_batch_sizes)
                         if prefills else 0)
        decode_batch = (_bucket(len(decodes), self.decode_batch_sizes)
                        if decodes else 0)
        if decodes and decode_batch is None:
            raise RuntimeError(
                f"{len(decodes)} in-flight sequences exceed the decode "
                f"bucket ladder {self.decode_batch_sizes}")
        return StepPlan(prefills=prefills, prefill_batch=prefill_batch or 0,
                        prefill_len=prefill_len, decodes=decodes,
                        decode_batch=decode_batch or 0, evicted=evicted,
                        prefill_kind=step_kind)

    # -- results -----------------------------------------------------------

    def complete_prefill(self, request, first_token):
        """Record a prefill's result: the prompt's K/V is cached and the
        first generated token sampled."""
        request.cached = len(request.context)
        if self.prefix_cache is not None:
            self._register_prefix(request)
        request.generated.append(int(first_token))
        request.failures = 0     # a completed step ends the failure run
        self._maybe_finish(request)

    def complete_decode(self, request, token):
        """Record a decode step: the previous token's K/V entered the
        cache at slot `cached`, and `token` was sampled from it."""
        request.cached += 1
        request.generated.append(int(token))
        request.failures = 0
        self._maybe_finish(request)

    def complete_speculative(self, request, tokens):
        """Record one speculative window: `tokens` are the accepted
        draft tokens plus the verifier's correction/bonus token, in
        order. Each appended token's PREDECESSOR has its K/V in the
        cache (the verify forward wrote the whole window), so `cached`
        advances one per append — exactly the sequential `complete_
        decode` accounting, n times. Appending stops at the request's
        natural end (eos / max_new_tokens / window), dropping the rest
        of the accepted tokens; surviving requests then roll back the
        tail pages the next window can no longer reach. Returns the
        number of tokens actually appended."""
        appended = 0
        for t in tokens:
            request.cached += 1
            request.generated.append(int(t))
            appended += 1
            total = len(request.prompt) + len(request.generated)
            if request.done or total >= self.max_seq_len:
                break
        request.failures = 0
        self._maybe_finish(request)
        if request.status is None:
            self._rollback_spec_pages(request)
        return appended

    def _rollback_spec_pages(self, request):
        """Release owned tail pages past the NEXT speculative window's
        horizon — the allocator-rollback of pages grown for rejected
        tokens the shrinking window (max_new_tokens nearly spent, or
        the serving window's edge) will never write again. Growth and
        rollback use the same horizon, so pages a full-k window still
        needs are kept, not churned. Shared prefix pages are never
        rolled back."""
        if not self.spec_tokens:
            return
        limit = min(request.cached + self._spec_window(request),
                    self.max_seq_len - 1)
        needed = max(limit // self.page_size + 1, request.n_shared)
        while len(request.pages) > needed:
            self.cache.free([request.pages.pop()])

    def _maybe_finish(self, request):
        total = len(request.prompt) + len(request.generated)
        if request.done or total >= self.max_seq_len:
            self._finish(request, STATUS_OK)
