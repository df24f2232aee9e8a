"""The port's fp16 training engine against the JAX package's, on the
CPU (every kernel wrapper takes its plain version on CPU tensors).

- `initialize` → `train_batch` in fp16 on a tiny GPT-NeoX from the same
  JAX-made weights and numpy batches, over eight steps whose first two
  overflow (hysteresis 2: the first keeps the scale, the second halves
  it) and whose window of 2 clean steps then doubles it: losses rtol
  2e-2 (fp16 activations round apart on the two sides), the loss
  scale, skipped and taken steps equal after every step (the window
  overflows again after it doubles), the fp32 masters within atol =
  rtol = 2e-3 after the last;
- the legacy forward / backward / step loop in fp16 equal to
  `train_batch` bit for bit (one thread), overflows included;
- the lean fp16 state (fp16 masters, fp16 moments, gas 2: an fp32
  accumulator) against the JAX engine, losses rtol 2e-2;
- fp16 JAX parameters carried across in fp16 (`state_dict_from_jax`);
- the block-sparse, int8 matmul and int8 decode wrappers taking fp16
  tensors on to their kernels (float64 is refused), and on the CPU an
  fp16 sparse-attention engine training and an fp16 serving engine with
  int8 pages serving;
- the "amp" block: parsed as the JAX config parses it, and an engine
  with it trains."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt_neox as jneox
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.models.convert import (flat_from_jax,
                                                  state_dict_from_jax)
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=128)
GAS, MICRO, S = 2, 2, 128
FP16 = {"enabled": True, "type": "float16", "initial_scale_power": 19,
        "hysteresis": 2, "loss_scale_window": 2, "min_loss_scale": 1}


def _config(fp16=FP16, **extra):
    conf = {
        "train_batch_size": GAS * MICRO,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS, "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
            "warmup_num_steps": 5}},
        "gradient_clipping": 1.0, "fp16": fp16,
        "zero_optimization": {"stage": 2}}
    conf.update(extra)
    return conf


@pytest.fixture(scope="module")
def weights():
    jcfg = jneox.GPTNeoXConfig(**SIZE)
    return jcfg, jax.device_get(jneox.init_params(jcfg,
                                                  jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S)).astype(np.int32)


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _port(weights):
    return neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu") \
        .load_jax_params(weights[1])


def _jax_engine(weights, conf):
    jcfg, jparams = weights
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    return deeperspeed_tpu.initialize(
        model=jneox.GPTNeoX(jcfg, use_pallas=False), model_parameters=jparams,
        config_params=conf, mesh=mesh)[0]


def test_fp16_train_batch_matches_jax_through_overflows(weights, tokens):
    conf = _config()
    jeng = _jax_engine(weights, conf)
    eng, *_ = dst.initialize(model=_port(weights), config_params=conf)
    assert eng.compute_dtype == torch.float16
    rows, scales = [], []
    for _ in range(8):
        jl = float(jeng.train_batch(batch=(tokens, tokens)))
        pl = eng.train_batch(batch=(tokens, tokens))
        rows.append((jl, pl))
        assert eng.loss_scale == float(jeng.state.scale.cur_scale)
        assert eng.skipped_steps == int(jeng.skipped_steps)
        assert eng.global_steps == int(jeng.global_steps)
        scales.append(eng.loss_scale)
    rows = np.array(rows)
    np.testing.assert_allclose(rows[:, 1], rows[:, 0], rtol=2e-2)
    # the first overflow keeps 2^19 (hysteresis), the second halves it;
    # later a clean window doubles it and it overflows again
    assert scales[:2] == [2.0 ** 19, 2.0 ** 18]
    assert any(b == 2 * a for a, b in zip(scales, scales[1:]))
    assert 2 <= eng.skipped_steps < 8
    np.testing.assert_allclose(
        eng._master.numpy(),
        flat_from_jax(jax.device_get(jeng.state.master),
                      eng.param_names).numpy(), atol=2e-3, rtol=2e-3)
    assert eng._params_flat.dtype == torch.float16
    assert torch.equal(eng._params_flat, eng._master.to(torch.float16))


def test_fp16_legacy_loop_equals_train_batch(weights, tokens, one_thread):
    conf = _config()
    a, *_ = dst.initialize(model=_port(weights), config_params=conf)
    b, *_ = dst.initialize(model=_port(weights), config_params=conf)
    fused = [a.train_batch(batch=(tokens, tokens)) for _ in range(4)]
    legacy = []
    for _ in range(4):
        for i in range(GAS):
            b.backward(b((tokens[i], tokens[i])))
            got = b.step()
        legacy.append(got)
    assert legacy == fused
    assert a.skipped_steps == b.skipped_steps == 2
    assert a.loss_scale == b.loss_scale
    assert torch.equal(a._master, b._master)
    assert torch.equal(a.opt_state.exp_avg, b.opt_state.exp_avg)


def test_lean_fp16_state_with_accumulation_matches_jax(weights, tokens):
    conf = _config({**FP16, "fp16_master_weights_and_grads": True},
                   zero_optimization={"stage": 0})
    conf["optimizer"]["params"]["state_dtype"] = "float16"
    jeng = _jax_engine(weights, conf)
    eng, *_ = dst.initialize(model=_port(weights), config_params=conf)
    assert eng._master is eng._params_flat
    assert eng._master.dtype == eng.opt_state.exp_avg.dtype == torch.float16
    assert eng._grad_acc.dtype == torch.float32
    rows = np.array([(float(jeng.train_batch(batch=(tokens, tokens))),
                      eng.train_batch(batch=(tokens, tokens)))
                     for _ in range(5)])
    np.testing.assert_allclose(rows[:, 1], rows[:, 0], rtol=2e-2)
    assert eng.skipped_steps == int(jeng.skipped_steps) >= 2
    assert eng.loss_scale == float(jeng.state.scale.cur_scale)


def test_fp16_jax_parameters_stay_fp16(weights):
    jp16 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16),
                                  weights[1])
    sd = state_dict_from_jax(jp16)
    assert all(t.dtype == torch.float16 for t in sd.values())
    assert torch.equal(sd["embed.wte"], torch.from_numpy(
        np.asarray(jp16["embed"]["wte"])))
    model = neox.GPTNeoX(neox.GPTNeoXConfig(param_dtype=torch.float16,
                                            **SIZE), device="cpu")
    model.load_state_dict(sd)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float16
        assert torch.equal(p.detach(), sd[name]), name


def test_fp16_sparse_and_int8_run_on_the_cpu():
    sp = neox.GPTNeoX(neox.GPTNeoXConfig(vocab_size=512, hidden_size=128,
                                         num_layers=1, num_heads=2),
                      device="cpu").init_params(0)
    eng, *_ = dst.initialize(model=sp, config_params={
        "train_batch_size": 1, "fp16": {"enabled": True,
                                        "initial_scale_power": 8},
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "sparse_attention": {"mode": "fixed", "block": 128}})
    x = torch.randint(0, 512, (1, 1, 256))
    assert np.isfinite(eng.train_batch(batch=(x, x)))
    from deeperspeed_tpu_torch import InferenceEngine
    m = neox.GPTNeoX(neox.GPTNeoXConfig.tiny(param_dtype=torch.float16),
                     device="cpu").init_params(0)
    e = InferenceEngine(m, config={
        "inference": {"enabled": True, "page_size": 16, "num_pages": 16,
                      "kv_cache_dtype": "int8"},
        "quantization": {"weights": "int8"}}, device="cpu")
    assert len(e.generate([[1, 2, 3]], max_new_tokens=2)[0]) == 2


AMP = [{"enabled": True}, {"enabled": True, "opt_level": "O2",
                           "loss_scale": "dynamic"},
       {"enabled": False, "keep_batchnorm_fp32": True}, {}]


@pytest.mark.parametrize("amp", AMP, ids=lambda a: str(sorted(a)))
def test_amp_block_parsed_as_jax_parses_it(amp):
    conf = {"train_batch_size": 4, "amp": amp}
    ours, ref = DeepSpeedConfig(conf), JaxConfig(conf, world_size=1)
    assert ours.amp_enabled == ref.amp_enabled
    assert ours.amp_params == ref.amp_params


def test_engine_with_amp_trains(weights, tokens):
    eng, *_ = dst.initialize(model=_port(weights), config_params=_config(
        {"enabled": False}, amp={"enabled": True, "opt_level": "O1"}))
    assert eng._config.amp_enabled and eng._config.amp_params == {
        "opt_level": "O1"}
    assert np.isfinite(eng.train_batch(batch=(tokens, tokens)))


def test_int8_and_block_sparse_kernels_refuse_fp16_tensors(monkeypatch):
    """The wrappers of the int8 matmul, the int8 paged decode and the
    block-sparse attention take fp16 tensors on to their kernels: the
    dtype checks pass and the call reaches the library (stubbed here by
    one that raises); float64 is refused with a typed error first."""
    from deeperspeed_tpu_torch.ops.hopper import _build
    from deeperspeed_tpu_torch.ops.hopper import block_sparse_attention as bsa
    from deeperspeed_tpu_torch.ops.hopper import decode_attention as da
    from deeperspeed_tpu_torch.ops.hopper import quant_matmul as qm

    class Reached(Exception):
        pass

    def reached():
        raise Reached

    monkeypatch.setattr(_build, "load_library", reached)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    qw = qm.quantize_weight(torch.randn(64, 32))
    q = torch.zeros(2, 2, 64)
    pages = torch.zeros(4, 2, 16, 64, dtype=torch.int8)
    scales = torch.ones(4, 2, 16, dtype=torch.bfloat16)
    table = torch.zeros(2, 2, dtype=torch.int32)
    lengths = torch.ones(2, dtype=torch.int32)
    t = torch.zeros(1, 256, 2, 64)
    luts = bsa.LayoutLuts(np.ones((2, 2, 2)))
    calls = (
        (lambda dt: qm.quant_matmul_cuda(torch.zeros(16, 64, dtype=dt), qw),
         "float32, bfloat16 or float16"),
        (lambda dt: da.paged_decode_int8_cuda(
            q.to(dt), pages, pages, scales, scales, table, lengths),
         "float32, bfloat16 or float16"),
        (lambda dt: bsa.block_sparse_attention_cuda(
            t.to(dt), t.to(dt), t.to(dt), luts, True),
         "float32, bfloat16 or float16"))
    for call, names in calls:
        with pytest.raises(Reached):
            call(torch.float16)
        with pytest.raises(TypeError, match=names):
            call(torch.float64)
