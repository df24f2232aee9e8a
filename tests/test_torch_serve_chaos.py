"""The port's serving engine under a fault storm, against the JAX
engine's, on the CPU.

- The chaos soak (the port's counterpart of the JAX package's
  `TestChaosSoak.test_fault_storm_invariants`): injected decode and
  prefill errors, a decode stall, page-pool pressure and an overload
  burst against a bounded admission queue, with mixed priorities and
  expiring deadlines. Both engines run on the same weights, stream,
  fault script and fake clock; every request's terminal status and
  greedy tokens, ``fault_injector.fired``, the quarantine, retry,
  eviction and shed counts are equal; every accepted request reaches
  exactly one terminal status, no page leaks, no bucket program is new
  after the warm-up, and every request that ends ok carries a clean
  engine's greedy tokens. It runs once plain and once with the prefix
  cache and speculative decoding on, over a stream that shares a prefix.
- The engine-level triple interleaving: page-pool pressure evicts, an
  injected decode fault quarantines and a tight deadline expires in one
  stream; both engines agree and the free list is exact.
"""

import numpy as np
import pytest
import torch

from deeperspeed_tpu.inference import RequestRejected as JaxRejected
from deeperspeed_tpu_torch import InferenceEngine
from deeperspeed_tpu_torch.inference import RequestRejected
from torch_serving import (DRAFT, engines, fake_clocks, on_clock, pair)

torch.set_num_threads(2)

COUNTERS = ("quarantines", "retries", "evictions", "requests_shed",
            "requests_ok", "requests_failed", "requests_deadline_exceeded",
            "spec_steps", "spec_proposed", "spec_accepted")
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=128)
STORM = [
    {"kind": "decode_error", "step": 24, "times": 2},
    {"kind": "prefill_error", "step": 31, "times": 1},
    {"kind": "decode_stall", "step": 36, "seconds": 0.02},
    {"kind": "page_pool_pressure", "step": 40, "times": 3, "factor": 0.9},
    {"kind": "decode_error", "step": 48, "times": 1},
]


@pytest.fixture(scope="module")
def models():
    """The tiny GPT-NeoX target of the JAX soak (seed 13) and a draft of
    the same shape (seed 3), in both packages."""
    return {"gpt_neox": {"target": pair("gpt_neox", TINY, 13),
                         "draft": pair("gpt_neox", DRAFT, 3)}}


def _block(**kw):
    block = {"enabled": True, "page_size": 16, "num_pages": 17,
             "max_batch_size": 4, "token_budget": 256, "max_seq_len": 64,
             "prefill_lengths": [16, 32, 64], "prefill_batch_sizes": [2],
             "decode_batch_sizes": [4]}
    block.update(kw)
    return {"inference": block}


def _collect(eng, statuses):
    for r in eng.scheduler.pop_finished():
        assert r.request_id not in statuses         # exactly once
        statuses[r.request_id] = (r.status, list(r.generated))


def _storm(eng, clock, shared):
    """The soak's stream: a warm-up over every prefill bucket, then 60
    steps of bursty arrivals (3 every second step against a queue of 3),
    every third request ``batch`` class, every seventh with a 1 ms
    deadline; ``shared`` prompts start with one 20-token prefix. Then
    the remaining work runs down. The fake clock ticks 1 ms a step."""
    rng = np.random.default_rng(14)
    prefix = list(rng.integers(1, 512, size=20))
    eng.generate([list(rng.integers(1, 512, size=n))
                  for n in (10, 30, 40)], max_new_tokens=3)
    if shared:
        # a miss, then a hit: the hit's suffix-window program runs too
        for _ in range(2):
            eng.generate([prefix + list(rng.integers(1, 512, size=12))],
                         max_new_tokens=3)
    warm = eng.compile_count()
    base = {k: eng.stats[k] for k in COUNTERS}
    accepted, statuses, prompts = [], {}, {}
    shed = arrival = 0
    for step in range(250):
        clock.tick(1e-3)
        if step < 60 and step % 2 == 0:
            for _ in range(3):
                n = int(rng.integers(3, 30))
                prompt = list(rng.integers(1, 512, size=n))
                if shared and arrival % 2:
                    prompt = prefix + prompt[:12]
                kw = {"priority": ("batch" if arrival % 3 == 0
                                   else "interactive")}
                if arrival % 7 == 0:
                    kw["deadline_ms"] = 1.0
                arrival += 1
                try:
                    rid = eng.submit(prompt, max_new_tokens=6, **kw)
                    accepted.append(rid)
                    prompts[rid] = prompt
                except (RequestRejected, JaxRejected) as e:
                    assert e.retry_after_s > 0
                    shed += 1
        if eng.scheduler.has_work:
            eng.step()                          # must never raise
        _collect(eng, statuses)
        if not eng.scheduler.has_work and step >= 60:
            break
    for _ in range(10_000):
        if not eng.scheduler.has_work:
            break
        clock.tick(1e-3)
        eng.step()
        _collect(eng, statuses)
    assert not eng.scheduler.has_work
    assert sorted(statuses) == sorted(accepted)
    assert shed + len(accepted) == arrival
    pc = eng.prefix_cache
    registered = pc.stats["registered_pages"] if pc is not None else 0
    return {"statuses": statuses, "prompts": prompts, "shed": shed,
            "stats": {k: eng.stats[k] - base[k] for k in COUNTERS},
            "fired": list(eng.fault_injector.fired),
            "leaked": eng.cache.num_pages - 1 - registered -
            eng.cache.num_free,
            "refcounts": sorted(eng.cache._refcount.values()),
            "registered": registered,
            "compile_delta": eng.compile_count() - warm}


@pytest.mark.parametrize("variant", ["plain", "prefix_spec"])
def test_fault_storm_matches_jax(models, monkeypatch, variant):
    clocks = fake_clocks(monkeypatch)
    extra = {}
    if variant == "prefix_spec":
        extra = {"prefix_cache": {"enabled": True},
                 "speculative": {"enabled": True, "num_draft_tokens": 2}}
    conf = _block(admission={"max_queue_depth": 3},
                  retry={"max_attempts": 3, "backoff_base_ms": 1,
                         "backoff_cap_ms": 5, "jitter": 0.5},
                  fault_injection={"faults": STORM}, **extra)
    pair_ = engines(models, "gpt_neox", conf,
                    draft="draft" if extra else None)
    runs = [_storm(on_clock(eng, clock), clock, bool(extra))
            for eng, clock in zip(pair_, clocks)]
    assert runs[0] == runs[1]
    run = runs[1]
    counts = {}
    for status, _ in run["statuses"].values():
        counts[status] = counts.get(status, 0) + 1
    assert set(counts) <= {"ok", "deadline_exceeded", "failed"}
    assert counts["ok"] > 0                     # the storm did not win
    assert run["shed"] == run["stats"]["requests_shed"] > 0
    assert sum(run["stats"][f"requests_{s}"] for s in (
        "ok", "deadline_exceeded", "failed")) == len(run["statuses"])
    assert run["stats"]["quarantines"] >= 2
    assert run["leaked"] == 0 and run["compile_delta"] == 0
    assert run["refcounts"] == [1] * run["registered"]
    assert [k for _, k in run["fired"]] == [
        "decode_error", "decode_error", "prefill_error", "decode_stall",
        "page_pool_pressure", "page_pool_pressure", "page_pool_pressure",
        "decode_error"]
    if extra:
        assert run["stats"]["spec_steps"] > 0
        assert run["registered"] > 0
    # every request that ended ok carries the greedy tokens of a clean,
    # cache-off, non-speculative engine: retries and re-prefills are exact
    ok = sorted(i for i, (s, _) in run["statuses"].items() if s == "ok")
    clean = InferenceEngine(models["gpt_neox"]["target"][2],
                            config=_block(), device="cpu")
    assert clean.generate([run["prompts"][i] for i in ok],
                          max_new_tokens=6) == \
        [run["statuses"][i][1] for i in ok]


def test_triple_interleaving_matches_jax(models, monkeypatch):
    """Page-pool pressure evicts, an injected decode fault quarantines and
    a tight deadline expires, all in one stream."""
    clocks = fake_clocks(monkeypatch)
    conf = _block(num_pages=9, prefill_lengths=[32], max_batch_size=2,
                  decode_batch_sizes=[1, 2], prefill_batch_sizes=[1, 2],
                  retry={"max_attempts": 3, "backoff_base_ms": 1,
                         "backoff_cap_ms": 2, "jitter": 0.0},
                  fault_injection={"faults": [
                      {"kind": "decode_error", "step": 3, "times": 1},
                      {"kind": "page_pool_pressure", "step": 5, "times": 2,
                       "factor": 0.9}]})
    rng = np.random.default_rng(21)
    prompts = [list(rng.integers(1, 512, size=30)) for _ in range(3)]
    runs = []
    for eng, clock in zip(engines(models, "gpt_neox", conf), clocks):
        ids = [eng.submit(p, max_new_tokens=6) for p in prompts[:2]]
        doomed = eng.submit(prompts[2], max_new_tokens=34, deadline_ms=1.0)
        statuses = {}
        while eng.scheduler.has_work:
            clock.tick(1e-3)
            eng.step()
            _collect(eng, statuses)
        assert statuses[doomed][0] == "deadline_exceeded"
        assert [statuses[i][0] for i in ids] == ["ok", "ok"]
        assert eng.cache.num_free == eng.cache.num_pages - 1
        assert sorted(eng.cache._free) == \
            list(range(1, eng.cache.num_pages))
        runs.append((statuses, {k: eng.stats[k] for k in COUNTERS},
                     list(eng.fault_injector.fired)))
    assert runs[0] == runs[1]
    assert runs[1][1]["quarantines"] >= 1
