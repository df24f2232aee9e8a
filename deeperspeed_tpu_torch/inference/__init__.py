"""Serving subsystem of the port: continuous batching over a paged KV
cache, with the hand-written flash-prefill and paged-decode kernels.

- `InferenceEngine` — the serving loop: bucketed prefill/decode split.
- `PagedKVCache` — the preallocated page pool + its host-side
  refcounting allocator.
- `ContinuousBatchingScheduler` / `Request` — per-step admission and
  eviction under a token + page budget (copied from the JAX package).
"""

from .admission import (DeadlineExceeded, PRIORITIES, RequestFailed,
                        REQUEST_STATUSES)
from .engine import InferenceEngine
from .kv_cache import PagedKVCache, pages_for_tokens
from .scheduler import ContinuousBatchingScheduler, Request, StepPlan

__all__ = ["InferenceEngine", "PagedKVCache", "pages_for_tokens",
           "ContinuousBatchingScheduler", "Request", "StepPlan",
           "DeadlineExceeded", "RequestFailed", "PRIORITIES",
           "REQUEST_STATUSES"]
