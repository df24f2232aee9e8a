"""The port's serving-under-failure layer against the JAX package's, on
the CPU.

- Config: the ``fault_injection``, ``admission`` and ``retry`` blocks
  parse to the JAX dicts and fail where JAX fails; the fault specs
  normalize alike and the injectors fire on the same serials.
- `utils.kv_retry`: `backoff_delay` draws the JAX delays from the same
  seeded generator; `RetryingKVTransport` retries, degrades and re-raises
  as the JAX wrapper does. `fault_injection.apply_fault` selects as the
  JAX one does.
- The engine, each case run by the JAX engine (tiny GPT-NeoX,
  use_pallas=False) and the port's on the same weights, prompts, fault
  script and fake clock: shedding with a typed `RequestRejected`,
  deadlines, quarantine with an exact retry and a typed poison, the
  backoff gate, the innocent co-batched reset, a step that loses the
  pools mid-execution, page-pool pressure, drain with `DrainAborted`.
  Statuses, greedy tokens, ``fired``, the counters and leaked pages are
  equal.
- The hang watchdog fires on a stall and not on a cold program, and its
  thread exits with its engine; SIGTERM through `install_drain_handler`
  makes `run()` drain and exit 0, and the handlers are restored.
"""

import gc
import os
import random
import signal
import time

import numpy as np
import pytest
import torch

import jax

from deeperspeed_tpu.inference import InferenceEngine as JaxEngine
from deeperspeed_tpu.inference import RequestRejected as JaxRejected
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.runtime import fault_injection as jfi
from deeperspeed_tpu.runtime.config import \
    parse_inference_block as jax_parse
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.utils import kv_retry as jkv
from deeperspeed_tpu_torch import GPTNeoX, GPTNeoXConfig, InferenceEngine
from deeperspeed_tpu_torch.inference import RequestFailed, RequestRejected
from deeperspeed_tpu_torch.runtime import fault_injection as fi
from deeperspeed_tpu_torch.runtime.config import parse_inference_block
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.utils import kv_retry as kv
from torch_serving import fake_clocks, on_clock

torch.set_num_threads(2)

COUNTERS = ("quarantines", "retries", "evictions", "requests_shed",
            "requests_ok", "requests_failed", "requests_deadline_exceeded")
FAST_RETRY = {"max_attempts": 3, "backoff_base_ms": 1,
              "backoff_cap_ms": 2, "jitter": 0.0}
LONG_RETRY = {"max_attempts": 3, "backoff_base_ms": 60000,
              "backoff_cap_ms": 60000, "jitter": 0.0}


def _config(**kw):
    block = {"enabled": True, "page_size": 16, "num_pages": 64,
             "max_batch_size": 4, "token_budget": 256,
             "prefill_lengths": [16, 32, 64],
             "prefill_batch_sizes": [1, 2],
             "decode_batch_sizes": [1, 2, 4]}
    block.update(kw)
    return {"inference": block}


@pytest.fixture(scope="module")
def models():
    """The tiny GPT-NeoX of the JAX robustness tests, in both packages."""
    jmodel = jneox.GPTNeoX(jneox.GPTNeoXConfig.tiny(), use_pallas=False)
    jparams = jax.device_get(jmodel.init_params(jax.random.PRNGKey(1)))
    model = GPTNeoX(GPTNeoXConfig.tiny(), device="cpu")
    return jmodel, jparams, model.load_jax_params(jparams)


@pytest.fixture
def clocks(monkeypatch):
    return fake_clocks(monkeypatch)


def _pair(models, clocks=None, **kw):
    jmodel, jparams, model = models
    conf = _config(**kw)
    jeng = JaxEngine(jmodel, config=conf, params=jparams)
    eng = InferenceEngine(model, config=conf, device="cpu")
    if clocks is not None:
        on_clock(jeng, clocks[0])
        on_clock(eng, clocks[1])
    return jeng, eng


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(1, 512, size=n)) for n in sizes]


def _drive(eng, clock, sink=None, max_steps=10_000):
    """Step until the engine has no work, ticking the fake clock 1 ms a
    step → {request id: (status, tokens, error type)}; the finished
    requests themselves go to ``sink`` when one is given."""
    done = {}
    for _ in range(max_steps):
        if not eng.scheduler.has_work:
            break
        if clock is not None:
            clock.tick(1e-3)
        eng.step()
        for r in eng.scheduler.pop_finished():
            done[r.request_id] = (r.status, list(r.generated),
                                  type(r.error).__name__
                                  if r.error is not None else None)
            if sink is not None:
                sink.append(r)
    assert not eng.scheduler.has_work
    return done


def _tokens(run):
    """The greedy tokens of a run's requests in submission order."""
    return [run["done"][i][1] for i in sorted(run["done"])]


def _summary(eng, done):
    fired = eng.fault_injector.fired if eng.fault_injector else []
    return {"done": done, "stats": {k: eng.stats[k] for k in COUNTERS},
            "fired": list(fired), "free": eng.cache.num_free,
            "free_list": sorted(eng.cache._free)}


def _assert_no_leaks(eng):
    assert eng.cache.num_free == eng.cache.num_pages - 1
    assert sorted(eng.cache._free) == list(range(1, eng.cache.num_pages))


# ---------------------------------------------------------------------------
# config and the pure-Python modules
# ---------------------------------------------------------------------------

VALID = [
    {"admission": {"max_queue_depth": 4, "shed_page_pool_util": 0.5,
                   "shed_ttft_ema_ms": 250, "ttft_ema_beta": 0.8,
                   "retry_after_cap_s": 10}},
    {"admission": {"enabled": False, "max_queue_depth": 4}},
    {"admission": {}},
    {"retry": {"max_attempts": 5, "backoff_base_ms": 5,
               "backoff_cap_ms": 50, "jitter": 0.25}},
    {"hang_timeout_s": 0.25, "drain_deadline_s": 3},
    {"fault_injection": {"faults": []}},
    {"fault_injection": {"faults": [
        {"kind": "prefill_error", "step": 1},
        {"kind": "decode_error", "step": 2, "times": 3},
        {"kind": "decode_stall", "step": 3, "seconds": 0.5},
        {"kind": "page_pool_pressure", "step": 4, "factor": 0.5},
        {"kind": "nan_grads", "step": 7}]}},
]

INVALID = [
    {"default_priority": "interactiv"},
    {"hang_timeout_s": -1},
    {"admission": {"max_queue_dpeth": 4}},
    {"admission": {"max_queue_depth": 0}},
    {"admission": {"shed_page_pool_util": 1.5}},
    {"admission": {"shed_ttft_ema_ms": 0}},
    {"admission": {"ttft_ema_beta": 1.0}},
    {"admission": {"retry_after_cap_s": 0}},
    {"admission": {"enabled": "yes"}},
    {"admission": 7},
    {"retry": {"max_attempt": 3}},
    {"retry": {"max_attempts": 0}},
    {"retry": {"backoff_base_ms": 0}},
    {"retry": {"backoff_base_ms": 100, "backoff_cap_ms": 10}},
    {"retry": {"jitter": 1}},
    {"fault_injection": {"faults": [{"kind": "chaos_monkey", "step": 0}]}},
    {"fault_injection": {"faults": [{"kind": "page_pool_pressure",
                                     "step": 0, "factor": 2.0}]}},
    {"fault_injection": {"faults": [{"kind": "decode_error"}]}},
    {"fault_injection": {"faults": [{"kind": "decode_stall", "step": 0,
                                     "seconds": 0}]}},
    {"fault_injection": {"faults": [{"kind": "decode_error", "step": 0,
                                     "peer": "x"}]}},
    {"fault_injection": {"faults": "decode_error"}},
    {"fault_injection": {"fault": []}},
    {"fault_injection": []},
]


@pytest.mark.parametrize("block", VALID)
def test_robustness_blocks_parse_like_jax(block):
    conf = {"inference": dict({"enabled": True}, **block)}
    assert parse_inference_block(conf) == jax_parse(conf)


@pytest.mark.parametrize("block", INVALID)
def test_robustness_blocks_reject_like_jax(block):
    conf = {"inference": dict({"enabled": True}, **block)}
    with pytest.raises(JaxConfigError) as want:
        jax_parse(conf)
    with pytest.raises(DeepSpeedConfigError) as got:
        parse_inference_block(conf)
    assert str(got.value) == str(want.value)


def test_fault_specs_and_injectors_match_jax():
    spec = {"faults": [
        {"kind": "decode_error", "step": 2, "times": 3},
        {"kind": "page_pool_pressure", "step": 1},
        {"kind": "decode_stall", "step": 4, "seconds": 0.5},
        {"kind": "loss_spike", "step": 3, "factor": 8.0},
        {"kind": "stall", "step": 5, "seconds": 0.1},
        {"kind": "slice_kill", "step": 6, "slice": "s1"}]}
    assert fi.validate_fault_spec(spec) == jfi.validate_fault_spec(spec)
    for kinds in (fi, jfi):
        assert kinds.SERVING_FAULT_KINDS == jfi.SERVING_FAULT_KINDS
        assert kinds.FAULT_KINDS == jfi.FAULT_KINDS
        assert kinds.HOST_FAULT_KINDS == jfi.HOST_FAULT_KINDS
    env = {"DS_FAULT_INJECT": '{"faults": [{"kind": "prefill_error", '
                              '"step": 0, "times": 2}]}'}
    ours = fi.FaultInjector.from_config_env(spec, env=env)
    ref = jfi.FaultInjector.from_config_env(spec, env=env)
    for _ in range(9):
        assert ours.plan_next_step() == ref.plan_next_step()
        assert ours.take_host_faults() == ref.take_host_faults()
    assert ours.fired == ref.fired and len(ours.fired) == 10
    assert (ours.has_device_faults, ours.has_serving_faults,
            ours.has_multislice_faults) == (True, True, True)
    assert fi.FaultInjector.from_config_env(None, env={}) is None
    with pytest.raises(DeepSpeedConfigError, match="not valid JSON"):
        fi.FaultInjector.from_config_env(None,
                                         env={"DS_FAULT_INJECT": "{"})


@pytest.mark.parametrize("mode", [fi.MODE_NONE, fi.MODE_NAN_GRADS,
                                  fi.MODE_LOSS_SPIKE])
def test_apply_fault_matches_jax(mode):
    g = np.random.default_rng(mode).standard_normal((3, 5)).astype(
        np.float32)
    loss, grads = fi.apply_fault(torch.tensor(2.5),
                                 {"w": torch.from_numpy(g)}, (mode, 1e3))
    jloss, jgrads = jfi.apply_fault(jax.numpy.asarray(2.5),
                                    {"w": jax.numpy.asarray(g)}, (mode, 1e3))
    np.testing.assert_array_equal(grads["w"].numpy(), np.asarray(jgrads["w"]))
    assert float(loss) == float(jloss)


@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.5])
def test_backoff_delay_draws_the_jax_delays(jitter):
    ours, ref = random.Random(7), random.Random(7)
    for attempt in range(1, 9):
        for base, cap in ((5, 50), (1, 2), (0.05, 1.0)):
            assert kv.backoff_delay(attempt, base, cap, jitter, ours) == \
                jkv.backoff_delay(attempt, base, cap, jitter, ref)


class _FlakyTransport:
    def __init__(self, fail_times):
        self.fail_times = fail_times
        self.calls = 0
        self.store = {}

    def _maybe_fail(self):
        self.calls += 1
        if self.fail_times:
            self.fail_times -= 1
            raise ConnectionError("coordination service unavailable")

    def publish(self, peer, payload):
        self._maybe_fail()
        self.store[str(peer)] = dict(payload)

    def read_all(self):
        self._maybe_fail()
        return {k: dict(v) for k, v in self.store.items()}


def _wrapped(module, fail_times, **kw):
    inner = _FlakyTransport(fail_times)
    kw = dict({"attempts": 3, "backoff_base_s": 0.0, "backoff_cap_s": 0.0},
              **kw)
    return inner, module.RetryingKVTransport(inner, **kw)


def test_retrying_transport_matches_jax():
    # transient blips absorbed, the same retry counts
    for module in (kv, jkv):
        inner, w = _wrapped(module, 2)
        w.publish("0", {"serial": 1})
        assert (inner.store, w.retry_count, w.degraded) == \
            ({"0": {"serial": 1}}, 2, False)
    # the capped exponential law with jitter, from the same generator
    ours = kv.RetryingKVTransport(_FlakyTransport(0), backoff_base_s=0.1,
                                  backoff_cap_s=0.25, jitter=0.5,
                                  rng=random.Random(3))
    ref = jkv.RetryingKVTransport(_FlakyTransport(0), backoff_base_s=0.1,
                                  backoff_cap_s=0.25, jitter=0.5,
                                  rng=random.Random(3))
    assert [ours._backoff_s(a) for a in range(1, 6)] == \
        [ref._backoff_s(a) for a in range(1, 6)]
    # persistent failure: degrade once to a local store, then re-probe on
    # the clock and promote back
    now = [0.0]
    inner, w = _wrapped(kv, 10**6, attempts=2, degrade_to_local=True,
                        clock=lambda: now[0], jitter=0.0,
                        reprobe_base_s=5.0)
    w.publish("0", {"serial": 1})
    w.publish("0", {"serial": 2})
    assert w.degraded and inner.calls == 2
    assert w.read_all() == {"0": {"serial": 2}}
    inner.fail_times = 0
    now[0] = 6.0
    assert w.read_all() == {} and not w.degraded
    assert (w.reprobe_count, w.recovered_count) == (1, 1)
    # no degrade: the final error is re-raised for the caller's escalation
    for module in (kv, jkv):
        _, w = _wrapped(module, 10**6, attempts=2)
        with pytest.raises(ConnectionError):
            w.publish("0", {"serial": 1})
        assert (w.degraded, w.error_count) == (False, 2)
    assert isinstance(kv.wrap_kv_transport(_FlakyTransport(0), True, "t"),
                      kv.RetryingKVTransport)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_shed_path_typed_like_jax(models, clocks):
    runs = []
    for eng, clock, rejected in zip(
            _pair(models, clocks, admission={"max_queue_depth": 2}),
            clocks, (JaxRejected, RequestRejected)):
        (p,) = _prompts(0, (5,))
        eng.submit(p, max_new_tokens=2)
        eng.submit(p, max_new_tokens=2)
        with pytest.raises(rejected) as ei:
            eng.submit(p, max_new_tokens=2)
        assert ei.value.retry_after_s > 0
        assert ei.value.reason == "queue_full"
        with pytest.raises(ValueError, match="ttft_slo_ms"):
            eng.submit(p, max_new_tokens=2, ttft_slo_ms=0)
        runs.append(_summary(eng, _drive(eng, clock)))
    assert runs[0] == runs[1]
    assert runs[1]["stats"]["requests_shed"] == 1
    assert runs[1]["stats"]["requests_ok"] == 2


def test_deadlines_to_terminal_status_like_jax(models, clocks):
    runs = []
    for eng, clock in zip(_pair(models, clocks), clocks):
        (p,) = _prompts(1, (5,))
        eng.submit(p, max_new_tokens=2)
        eng.submit(p, max_new_tokens=64, deadline_ms=1.0)
        clock.tick(0.01)
        eng.run()
        runs.append(_summary(eng, {r.request_id: (r.status, r.generated)
                                   for r in eng.scheduler.pop_finished()}))
    assert runs[0] == runs[1]
    assert {i: s for i, (s, _) in runs[1]["done"].items()} == \
        {0: "ok", 1: "deadline_exceeded"}
    assert runs[1]["free"] == 63


QUARANTINE_CASES = {
    "decode_error": ({"faults": [{"kind": "decode_error", "step": 3}]},
                     FAST_RETRY, (9,), 6),
    "prefill_error": ({"faults": [{"kind": "prefill_error", "step": 0}]},
                      FAST_RETRY, (5,), 4),
    "poison": ({"faults": [{"kind": "prefill_error", "step": 0,
                            "times": 10**6}]},
               dict(FAST_RETRY, max_attempts=2), (5,), 4),
    "innocent_cobatched": ({"faults": [{"kind": "decode_error", "step": 4}]},
                           dict(FAST_RETRY, max_attempts=2), (5, 12), 8),
    "jittered_storm": ({"faults": [
        {"kind": "decode_error", "step": 3, "times": 2},
        {"kind": "prefill_error", "step": 9},
        {"kind": "decode_stall", "step": 10, "seconds": 0.01}]},
        {"max_attempts": 3, "backoff_base_ms": 5, "backoff_cap_ms": 50,
         "jitter": 0.25}, (5, 12, 20, 7), 10),
}


@pytest.mark.parametrize("case", sorted(QUARANTINE_CASES))
def test_quarantine_retry_poison_like_jax(models, clocks, case):
    faults, retry, sizes, new = QUARANTINE_CASES[case]
    prompts = _prompts(2, sizes)
    runs, poisoned = [], []
    for eng, clock in zip(_pair(models, clocks, fault_injection=faults,
                                retry=retry), clocks):
        for p in prompts:
            eng.submit(p, max_new_tokens=new)
        runs.append(_summary(eng, _drive(eng, clock, poisoned)))
    assert runs[0] == runs[1]
    clean = InferenceEngine(models[2], config=_config(), device="cpu")
    statuses = [s for s, _, _ in runs[1]["done"].values()]
    if case == "poison":
        assert statuses == ["failed"] and runs[1]["stats"]["retries"] == 1
        req = poisoned[-1]
        assert isinstance(req.error, RequestFailed)
        assert isinstance(req.error.last_error, fi.InjectedServingFault)
        assert req.error.attempts == 2
        assert req.error.last_error.__traceback__ is None
    else:
        # an exact retry: the clean engine's greedy tokens
        assert statuses == ["ok"] * len(prompts)
        assert _tokens(runs[1]) == \
            clean.generate(prompts, max_new_tokens=new)
        assert runs[1]["stats"]["quarantines"] >= 1
    assert runs[1]["free"] == 63


def test_backoff_gates_readmission_like_jax(models, clocks):
    runs = []
    for eng, clock in zip(_pair(models, clocks, retry=LONG_RETRY,
                                fault_injection={"faults": [
                                    {"kind": "prefill_error", "step": 0}]}),
                          clocks):
        eng.submit(_prompts(5, (5,))[0], max_new_tokens=2)
        eng.step()                                # fails -> quarantined
        (req,) = eng.scheduler.quarantined
        assert req.retry_at == pytest.approx(clock.t + 60.0)
        eng.step()                                # the window is open
        assert eng.scheduler.quarantined == [req]
        assert req.state != "running"
        assert clock.t == pytest.approx(1000.05)  # one capped idle sleep
        req.retry_at = 0.0                        # collapse the window
        eng.run(max_steps=20)
        assert req.status == "ok"
        runs.append(_summary(eng, {req.request_id: list(req.generated)}))
    assert runs[0] == runs[1]


def _lose_pools(eng):
    """Release a pool's storage, as a step that died mid-execution would
    leave it: JAX consumes the donated buffers, the port's predicate
    reads a released storage."""
    if isinstance(eng, JaxEngine):
        eng.cache.k.delete()
        eng.cache.v.delete()
    else:
        for pool in (eng.cache.k, eng.cache.v):
            eng.cache.data_array(pool).untyped_storage().resize_(0)
        assert eng.cache.pools_lost()


def test_mid_execution_cache_loss_recovers_like_jax(models, clocks):
    prompts = _prompts(15, (5, 12))
    runs = []
    for eng, clock in zip(_pair(models, clocks, retry=FAST_RETRY), clocks):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        while not eng.scheduler.running:
            eng.step()
        running = list(eng.scheduler.running)
        _lose_pools(eng)
        eng._quarantine_batch([running[0]], RuntimeError("device OOM"),
                              "decode")
        for r in running:
            places = sum([r in eng.scheduler.running,
                          r in eng.scheduler.quarantined,
                          r in list(eng.scheduler.waiting)])
            assert places == 1                    # never double-queued
        runs.append(_summary(eng, _drive(eng, clock)))
    assert runs[0] == runs[1]
    assert not eng.cache.pools_lost()
    clean = InferenceEngine(models[2], config=_config(), device="cpu")
    assert _tokens(runs[1]) == \
        clean.generate(prompts, max_new_tokens=6)
    assert runs[1]["free"] == 63


def test_mid_execution_prefill_death_skips_stale_decode_like_jax(
        models, clocks):
    p1, p2 = _prompts(16, (5, 12))
    runs = []
    for eng, clock in zip(_pair(models, clocks, retry=FAST_RETRY), clocks):
        eng.submit(p1, max_new_tokens=6)
        eng.step()                                # p1 running, 1 token
        (r1,) = list(eng.scheduler.running)
        before = list(r1.generated)
        eng.submit(p2, max_new_tokens=6)
        real = eng._run_prefill

        def dying_prefill(plan, eng=eng):
            _lose_pools(eng)
            raise RuntimeError("mid-execution death")

        eng._run_prefill = dying_prefill
        summary = eng.step()      # the prefill dies, recovery evicts r1
        eng._run_prefill = real
        assert summary["decoded"] == 0            # stale decode skipped
        assert list(r1.generated) == before       # no garbage token
        runs.append(_summary(eng, _drive(eng, clock)))
    assert runs[0] == runs[1]
    clean = InferenceEngine(models[2], config=_config(), device="cpu")
    assert _tokens(runs[1]) == \
        clean.generate([p1, p2], max_new_tokens=6)
    assert [s for s, _, _ in runs[1]["done"].values()] == ["ok", "ok"]


def test_page_pool_pressure_forces_evictions_like_jax(models, clocks):
    prompts = _prompts(7, (30, 30))
    runs = []
    for eng, clock in zip(_pair(
            models, clocks, num_pages=9, max_seq_len=64,
            prefill_lengths=[32], max_batch_size=2,
            decode_batch_sizes=[1, 2],
            fault_injection={"faults": [
                {"kind": "page_pool_pressure", "step": 3, "times": 2,
                 "factor": 0.9}]}), clocks):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        runs.append(_summary(eng, _drive(eng, clock)))
        _assert_no_leaks(eng)
    assert runs[0] == runs[1]
    assert runs[1]["stats"]["evictions"] >= 1
    clean = InferenceEngine(models[2], config=_config(), device="cpu")
    assert _tokens(runs[1]) == \
        clean.generate(prompts, max_new_tokens=6)


def test_drain_fails_inflight_and_quarantined_typed_like_jax(models):
    """drain(deadline_s=0) on the wall clock: the deadline passes at once,
    the running and the quarantined request both end ``failed`` with a
    typed `DrainAborted`, the fresh queued one stays unserved."""
    runs = []
    a, b, c = _prompts(10, (6, 5, 7))
    for eng in _pair(models, retry=LONG_RETRY, fault_injection={
            "faults": [{"kind": "prefill_error", "step": 1}]}):
        eng.submit(a, max_new_tokens=64)
        eng.step()                                 # a running
        eng.submit(b, max_new_tokens=2)
        eng.step()                                 # b quarantined
        assert len(eng.scheduler.quarantined) == 1
        eng.submit(c, max_new_tokens=2)            # fresh, queued
        summary = eng.drain(deadline_s=0.0)
        done = {r.request_id: (r.status, type(r.error).__name__,
                               "drain" in str(r.error))
                for r in eng.scheduler.pop_finished()}
        runs.append((done, {k: summary[k] for k in (
            "deadline_hit", "inflight_abandoned", "unserved")},
            {k: eng.stats[k] for k in COUNTERS}, eng.cache.num_free))
    assert runs[0] == runs[1]
    assert runs[1][0] == {0: ("failed", "DrainAborted", True),
                          1: ("failed", "DrainAborted", True)}
    assert runs[1][1] == {"deadline_hit": True, "inflight_abandoned": 2,
                          "unserved": 1}
    assert runs[1][3] == 63


# ---------------------------------------------------------------------------
# the hang watchdog and the drain handler (wall clock)
# ---------------------------------------------------------------------------

def test_watchdog_fires_on_a_stall_not_on_a_cold_program(models):
    jmodel, jparams, model = models
    conf = _config(hang_timeout_s=0.05, fault_injection={"faults": [
        {"kind": "decode_stall", "step": 6, "seconds": 0.4}]})
    for eng in (JaxEngine(jmodel, config=conf, params=jparams),
                InferenceEngine(model, config=conf, device="cpu")):
        assert eng.watchdog is not None
        (p,) = _prompts(8, (5,))
        eng.generate([p], max_new_tokens=3)       # warm the programs
        assert eng.watchdog_fires == 0
        eng.submit(p, max_new_tokens=4)
        while eng.scheduler.has_work:
            eng.step()
        # the stall fires it once; a loaded host can stretch another step
        # past 0.05 s too, which fires its own armed window
        assert eng.watchdog_fires >= 1
        assert "thread" in eng.last_stack_dump
        assert "ds-hang-watchdog" in eng.last_stack_dump
        assert eng._drain_requested               # emergency drain armed
        eng.watchdog.stop()
    # every program cold: a first call (the kernel build on a card) is
    # not a hang
    cold = InferenceEngine(model, config=_config(hang_timeout_s=0.001),
                           device="cpu")
    cold.generate(_prompts(9, (5,)), max_new_tokens=2)
    assert cold.watchdog_fires == 0
    assert cold.program_calls == {("prefill", 1, 16): 1, ("decode", 1): 1}
    cold.watchdog.stop()


def test_watchdog_thread_exits_with_its_engine(models):
    eng = InferenceEngine(models[2], config=_config(hang_timeout_s=0.08),
                          device="cpu")
    eng.install_drain_handler()
    thread = eng.watchdog._thread
    assert thread.is_alive()
    eng.generate(_prompts(11, (5,)), max_new_tokens=2)
    eng.restore_signal_handlers()
    del eng
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive()


def test_sigterm_drains_and_exits_zero(models):
    jmodel, jparams, model = models
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    conf = _config(drain_deadline_s=30.0)
    for eng in (JaxEngine(jmodel, config=conf, params=jparams),
                InferenceEngine(model, config=conf, device="cpu")):
        eng.install_drain_handler()
        assert signal.getsignal(signal.SIGTERM) is not \
            before[signal.SIGTERM]
        ids = [eng.submit(p, max_new_tokens=4)
               for p in _prompts(12, (5, 9))]
        eng.step()
        os.kill(os.getpid(), signal.SIGTERM)
        assert eng._drain_requested
        eng.submit(_prompts(13, (6,))[0], max_new_tokens=2)  # queued
        with pytest.raises(SystemExit) as ei:
            eng.run()
        assert ei.value.code == 0
        done = {r.request_id: r.status for r in eng.scheduler.pop_finished()}
        assert [done[i] for i in ids] == ["ok", "ok"]
        assert len(done) == 2                      # the fresh one unserved
        assert {s: signal.getsignal(s) for s in before} == before
    idle = InferenceEngine(model, config=conf, device="cpu")
    idle.request_drain()
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as ei:
        idle.run()
    assert ei.value.code == 0 and time.perf_counter() - t0 < 5.0
