"""The training engine's hang watchdog, the port alone, on the CPU.

`train_batch` arms the watchdog (``training_health.hang_timeout_seconds``)
once a step of the same kind has run: the engine's first step, which
builds the kernels on the card, is never armed. An armed step that blows
its deadline fires once, with every thread's stack; a step that raises
disarms it; with ``checkpoint.save_on_preemption`` the fire requests the
preemption save, which the next step boundary writes before it raises
`SystemExit`.

Margins. The unstalled step of the model below takes about 7 ms on this
host, but bursts of load on a shared host were seen to stretch a step to
0.4 s. An armed deadline is 2.0 s (about 280 steps, 5 bursts) and the
stall that must trip it 5.0 s (2.5x). The cases whose armed step raises
at once, or that run no armed step, use 0.5 s.
"""

import time

import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.checkpoint import manifest
from deeperspeed_tpu_torch.models import gpt_neox as neox

torch.set_num_threads(2)

SIZE = dict(vocab_size=128, hidden_size=64, num_layers=1, num_heads=2,
            max_seq_len=64)
DEADLINE_S, STALL_S = 2.0, 5.0
SHORT_DEADLINE_S = 0.5


def _engine(timeout, faults=(), **extra):
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE),
                         device="cpu").init_params(0)
    conf = {"train_batch_size": 2, "steps_per_print": 1000,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "training_health": {
                "enabled": True, "hang_timeout_seconds": timeout,
                "fault_injection": {"faults": list(faults)}},
            **extra}
    eng, *_ = dst.initialize(model=model, config_params=conf)
    return eng


def _batch(seed=0):
    toks = np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=(1, 2, SIZE["max_seq_len"]))
    return toks, toks


def test_first_step_is_never_armed():
    """The first step of a kind builds the kernels: a stall there longer
    than the deadline must not fire."""
    eng = _engine(SHORT_DEADLINE_S, [{"kind": "stall", "step": 0,
                                      "seconds": 2.5 * SHORT_DEADLINE_S}])
    eng.train_batch(batch=_batch())
    time.sleep(SHORT_DEADLINE_S)
    assert eng.sentinel.watchdog_fires == 0
    assert eng._steps_run == {(1, True)}


def test_stall_fires_once_with_the_stacks():
    eng = _engine(DEADLINE_S, [{"kind": "stall", "step": 2,
                                "seconds": STALL_S}])
    for i in range(4):
        eng.train_batch(batch=_batch(i))
    assert eng.sentinel.watchdog_fires == 1
    dump = eng.sentinel.last_stack_dump
    assert "train_batch" in dump and "MainThread" in dump
    # no preemption requested: save_on_preemption is unconfigured
    assert not eng.checkpoint_manager.preemption_requested
    assert eng.global_steps == 4


def test_an_exception_disarms():
    eng = _engine(SHORT_DEADLINE_S)
    eng.train_batch(batch=_batch())
    toks, _ = _batch()
    with pytest.raises(ValueError, match="gas=1"):
        # armed (a step of this kind has run), then dies on the shape
        eng.train_batch(batch=(toks[0], toks[0]))
    time.sleep(2.5 * SHORT_DEADLINE_S)
    assert eng.sentinel.watchdog_fires == 0


def test_hang_requests_the_preemption_save(tmp_path):
    eng = _engine(DEADLINE_S, [{"kind": "stall", "step": 1,
                                "seconds": STALL_S}],
                  checkpoint={"save_dir": str(tmp_path),
                              "save_on_preemption": True})
    try:
        eng.train_batch(batch=_batch())
        # the stalled step trips the watchdog, which requests the
        # preemption save; this step's boundary writes it and exits
        with pytest.raises(SystemExit):
            eng.train_batch(batch=_batch(1))
    finally:
        eng.checkpoint_manager.restore_signal_handlers()
    assert eng.sentinel.watchdog_fires == 1
    assert manifest.read_latest(str(tmp_path)) == "global_step2"
    assert not eng.checkpoint_manager.preemption_requested
