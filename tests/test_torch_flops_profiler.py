"""The port's flops profiler (`profiling/flops_profiler`) against counts
reckoned from the shapes, on the CPU, and its formatting helpers against
the JAX package's: `profile_fn` and `get_model_profile` count 2·M·N·K a
matrix product (the JAX profiler, which reads XLA's cost analysis,
counts at least that); `count_train_flops` and `FlopsProfiler(engine)`
count one train step of a tiny GPT-NeoX exactly (the same shape formula
as `test_torch_telemetry_engine.py`), over fake tensors and outside the
telemetry's step window; the flash forward op, which hides its body
from the counter, counts by its registered formula, on real and on fake
tensors.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.profiling.flops_profiler import profiler as jprof
from deeperspeed_tpu_torch.ops.hopper import flash_attention as fa
from deeperspeed_tpu_torch.profiling.flops_profiler import profiler as prof

from tests.test_torch_telemetry_engine import _tokens, reckoned_flops
from tests.torch_sentinel import GAS, MICRO, config, jax_weights, port_engine

torch.set_num_threads(2)


def test_profile_fn_counts_matmul_flops():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    got = prof.profile_fn(lambda a, b: a @ b, a, b)
    want = 2 * 64 * 128 * 32
    assert got["flops"] == want and got["duration"] > 0
    assert got["bytes_accessed"] is None
    ref = jprof.profile_fn(lambda a, b: a @ b, jnp.ones((64, 128)),
                           jnp.ones((128, 32)))
    assert ref["flops"] >= want


def test_get_model_profile_of_a_module():
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                                torch.nn.Linear(32, 8))
    x = torch.ones(5, 16)
    flops, duration = prof.get_model_profile(model, args=[x],
                                             print_profile=False,
                                             as_string=False)
    assert flops == 2 * 5 * (16 * 32 + 32 * 8) and duration > 0
    as_str = prof.get_model_profile(model, args=[x], print_profile=False)
    assert as_str[0] == prof.flops_to_string(flops)
    assert prof.params_count(model) == 16 * 32 + 32 + 32 * 8 + 8
    assert prof.params_count({"a": np.ones((2, 3)), "b": [np.ones(4)]}) == 10


def test_flash_op_counts_its_formula():
    B, S, H, D = 2, 128, 2, 16
    q, k, v = (torch.randn(B, S, H, D) for _ in range(3))
    _, flops = prof.count_flops(lambda: fa.flash_fwd(
        q, k, v, None, None, None, None, None, True, 0.0, True))
    assert flops == 4 * B * H * S * S * D


@pytest.fixture(scope="module")
def jparams():
    return jax_weights()


def test_count_train_flops_is_the_shape_count(jparams):
    eng = port_engine(jparams, config("fp32"))
    tokens = torch.from_numpy(_tokens()).long()
    before = eng._grads_flat.clone()
    flops = prof.count_train_flops(eng, (tokens[0], tokens[0]))
    assert flops == reckoned_flops(gas=1)
    # nothing of the engine moved, and the kernels switch came back on
    assert torch.equal(eng._grads_flat, before)
    assert eng.module.use_kernels and eng.global_steps == 0


def test_count_train_flops_runs_on_fake_tensors(jparams, monkeypatch):
    """The count computes nothing: the loss sees fake parameters and a
    fake batch (no device memory, no sync), and a packed batch through
    the flash op (registered fake shapes) counts as the shapes say."""
    from torch._subclasses.fake_tensor import FakeTensor
    eng = port_engine(jparams, config("fp32"))
    seen = []
    loss_fn = eng.module.loss_fn

    def spy(params, batch, *a, **k):
        leaf = next(iter(torch.utils._pytree.tree_leaves(params)))
        seen.append((type(leaf), type(batch[0])))
        return loss_fn(params, batch, *a, **k)
    monkeypatch.setattr(eng.module, "loss_fn", spy)
    tokens = torch.from_numpy(_tokens()).long()
    assert prof.count_train_flops(eng, (tokens[0], tokens[0])) == \
        reckoned_flops(gas=1)
    assert seen == [(FakeTensor, FakeTensor)]
    q = torch.randn(2, 64, 2, 16)
    with prof.FakeTensorMode(allow_non_fake_inputs=True):
        _, flops = prof.count_flops(lambda: fa.flash_fwd(
            q, q, q, None, None, None, None, None, True, 0.0, True))
    assert flops == 4 * 2 * 2 * 64 * 64 * 16


def test_count_stays_outside_the_step_window(jparams, monkeypatch):
    """The count's seconds (here a 0.3 s stall in it) are no part of the
    first step's window: its MFU is the count over the step alone."""
    import time
    eng = port_engine(jparams, config("fp32", telemetry={"enabled": True}))
    count = prof.count_train_flops

    def slow(*a, **k):
        time.sleep(0.3)
        return count(*a, **k)
    monkeypatch.setattr(prof, "count_train_flops", slow)
    records = []
    eng.telemetry.monitor = types.SimpleNamespace(
        record=lambda sample, scalars: records.append(scalars))
    tokens = _tokens()
    t0 = time.perf_counter()
    eng.train_batch(batch=(tokens, tokens))
    call_s = time.perf_counter() - t0
    mfu = records[0]["Train/Samples/mfu"]
    window_s = reckoned_flops() / (mfu * eng.telemetry._peak())
    assert call_s > 0.3 and window_s < call_s - 0.25


def test_profiler_on_engine_train_step(jparams):
    eng = port_engine(jparams, config(
        "fp32", flops_profiler={"enabled": True, "profile_step": 1}))
    profiler = prof.FlopsProfiler(engine=eng)
    profiler.start_profile()
    tokens = _tokens()
    res = profiler.profile_train_step((tokens, tokens))
    assert res["flops"] == profiler.get_total_flops() == reckoned_flops()
    assert profiler.get_total_params() == eng.num_params
    assert profiler.get_total_duration() > 0
    profiler.end_profile()
    report = profiler.print_model_profile()
    assert "Flops Profiler" in report and "params" in report
    # the engine's own hook: nothing at step 0, once at profile_step
    assert eng.flops_profiler.get_total_flops() == 0
    eng.train_batch(batch=(tokens, tokens))
    eng.train_batch(batch=(tokens, tokens))
    eng.train_batch(batch=(tokens, tokens))
    assert eng.flops_profiler.get_total_flops() == reckoned_flops()
    assert eng._flops_profiled and GAS * MICRO == eng.train_batch_size()


@pytest.mark.parametrize("value", [0, 999, 2e3, 3.5e6, 4e9, 2e12, 7.25e15])
def test_string_helpers_match_jax(value):
    assert prof.flops_to_string(value) == jprof.flops_to_string(value)
    assert prof.params_to_string(value) == jprof.params_to_string(value)
    assert prof.duration_to_string(value / 1e12) == \
        jprof.duration_to_string(value / 1e12)


SPARSE_SIZE = dict(vocab_size=256, hidden_size=128, num_layers=1,
                   num_heads=2, max_seq_len=4096)
# density 0.56 at S 1024 (the masked flash arm), 0.19 at 4096 (block-sparse)
SPARSE_BLOCK = {"mode": "fixed", "block": 128, "num_local_blocks": 8,
                "num_global_blocks": 1, "attention": "unidirectional"}


def _sparse_engine():
    from deeperspeed_tpu_torch import initialize
    from deeperspeed_tpu_torch.models import gpt_neox as neox
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SPARSE_SIZE),
                         device="cpu").init_params(0)
    eng, *_ = initialize(model=model, config_params={
        "train_batch_size": 1, "train_micro_batch_size_per_gpu": 1,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "sparse_attention": SPARSE_BLOCK})
    return eng


@pytest.mark.parametrize("seq,arm", [(1024, "masked_flash"),
                                     (4096, "block_sparse")])
def test_count_leaves_the_sparse_arms_real(seq, arm):
    """The count builds the sparse arm's layout and LUTs on first use,
    under FakeTensorMode: none of them is kept, so the first real step
    after it equals that of an engine that never counted, bit for bit.
    The count: the masked arm's flash op 2 products forward and its
    plain backward 5 over the S×S square; the block-sparse arm's plain
    version 2 + 5 over each query block's LUT width of key blocks."""
    h, L, V = (SPARSE_SIZE[k] for k in ("hidden_size", "num_layers",
                                         "vocab_size"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, size=(1, 1, seq)))
    counted, fresh = _sparse_engine(), _sparse_engine()
    sa = counted.module.sparse_self_attention
    assert sa.arm(seq, h // SPARSE_SIZE["num_heads"]) == arm
    flops = prof.count_train_flops(counted, (tokens[0], tokens[0]))
    if arm == "masked_flash":
        attn = 14 * L * seq * seq * h
    else:
        lut = sa.get_layout(seq)[1].luts.fwd[0]
        attn = 14 * L * (seq // 128) * lut.shape[-1] * 128 * 128 * h
    assert flops == 72 * L * h * h * seq + 6 * h * V * (seq - 1) + attn
    assert counted.train_batch(batch=(tokens, tokens)) == \
        fresh.train_batch(batch=(tokens, tokens))
