"""Serving subsystem of the port: continuous batching over a paged KV
cache, with the hand-written flash-prefill, paged-decode (bf16/fp32 and
int8 pages) and weight-only int8 matmul kernels.

- `InferenceEngine` — the serving loop: bucketed prefill/decode split,
  the prefix cache and speculative decoding with a draft model.
- `PagedKVCache` — the preallocated page pool + its host-side
  refcounting allocator; `QuantizedPages` / `quantize_kv` — the int8
  pools of ``kv_cache_dtype: "int8"``; `PrefixCache` — the page-chain
  prefix registry of ``inference.prefix_cache``.
- `ContinuousBatchingScheduler` / `Request` — per-step admission and
  eviction under a token + page budget (copied from the JAX package).
- `AdmissionController` and the typed request-terminal errors
  (`RequestRejected` / `DeadlineExceeded` / `RequestFailed` /
  `DrainAborted`): the serving-under-failure layer, with the engine's
  quarantine / retry / poison, fault injection, hang watchdog and
  graceful drain.
"""

from .admission import (AdmissionController, DeadlineExceeded,
                        DrainAborted, PRIORITIES, RequestFailed,
                        RequestRejected, REQUEST_STATUSES)
from .engine import InferenceEngine
from .kv_cache import (PagedKVCache, PrefixCache, QuantizedPages,
                       pages_for_tokens, quantize_kv)
from .scheduler import ContinuousBatchingScheduler, Request, StepPlan

__all__ = ["InferenceEngine", "PagedKVCache", "PrefixCache",
           "QuantizedPages", "quantize_kv", "pages_for_tokens",
           "ContinuousBatchingScheduler", "Request", "StepPlan",
           "AdmissionController", "RequestRejected", "DeadlineExceeded",
           "RequestFailed", "DrainAborted", "PRIORITIES",
           "REQUEST_STATUSES"]
