"""The port's checkpoint subsystem on its own, on the CPU, held to the
JAX package's behavior where both have it:

- exact resume: 4 steps against 2 + save + a fresh engine from other
  weights + load + 2, with bit-identical losses and state, for a bf16
  GPT-NeoX, a BERT with dropout 0.1 and an MoE GPT-NeoX with gate jitter
  (the last two draw from the per-micro-step generator);
- the dataloader's resume position (the JAX loader's keys and errors)
  and a resumed run on the same sample stream;
- the manifest fallback to the previous committed tag, and a corrupt
  named tag raising the JAX package's error;
- the async manager: a snapshot that later steps do not reach, overlap,
  back-pressure, the interval auto-save with `keep_last_n` /
  `keep_every_n_steps` GC, writer errors at `wait()`, the preemption
  save;
- both `zero_to_fp32.py` scripts on the port's checkpoints;
- the "checkpoint" config block's values and errors against JAX's.
"""

import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from deeperspeed_tpu.checkpoint import checkpointing as jckpt
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JaxLoader
from deeperspeed_tpu.utils import zero_to_fp32 as jz2f

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.checkpoint import manifest as mf
from deeperspeed_tpu_torch.models import bert
from deeperspeed_tpu_torch.models import gpt_neox as neox
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

torch.set_num_threads(2)

SIZE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=2,
            max_seq_len=64)
GAS, MICRO, S = 2, 2, 64
BERT_S = 32
ZERO_FILE = "zero_pp_rank_0_mp_rank_00_optim_states.pt"


def _config(bf16=True, zero=2, **extra):
    conf = {
        "train_batch_size": GAS * MICRO,
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {
            "lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-3,
            "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR", "params": {
            "warmup_min_lr": 1e-3, "warmup_max_lr": 1e-2,
            "warmup_num_steps": 5}},
        "gradient_clipping": 1.0,
        "fp16": {"enabled": True, "type": "bfloat16"} if bf16
        else {"enabled": False},
        "zero_optimization": {"stage": zero},
    }
    conf.update(extra)
    return conf


def _neox_batch(seed):
    t = np.random.default_rng(seed).integers(
        0, SIZE["vocab_size"], size=(GAS, MICRO, S))
    return (t, t)


def _bert_batch(seed):
    rng = np.random.default_rng(seed)
    lead = (GAS, MICRO)
    ids = rng.integers(0, 512, lead + (BERT_S,))
    labels = np.full(lead + (BERT_S,), -1)
    labels[..., ::5] = ids[..., ::5]
    mask = np.ones(lead + (BERT_S,), np.float32)
    mask[..., 0, 20:] = 0.0
    return {"input_ids": ids, "token_type_ids": np.zeros_like(ids),
            "attention_mask": mask, "masked_lm_labels": labels,
            "next_sentence_label": rng.integers(0, 2, lead)}


RUNS = {
    # name: (model factory by seed, config, batch factory by step)
    "neox_bf16": (lambda seed: neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE),
                                            device="cpu").init_params(seed),
                  _config(), _neox_batch),
    "bert_dropout": (lambda seed: bert.BertForPreTraining(
        bert.BertConfig.tiny(), device="cpu").init_params(seed),
        _config(bf16=False), _bert_batch),
    "moe_jitter": (lambda seed: neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE),
                                             device="cpu").init_params(seed),
                   _config(bf16=False, moe={
                       "num_experts": 4, "top_k": 2, "jitter_eps": 0.3,
                       "dispatch": "sort"}), _neox_batch),
}


def _engine(run, seed=0, **conf_extra):
    make, conf, _ = RUNS[run]
    return dst.initialize(model=make(seed),
                          config_params={**conf, **conf_extra})[0]


def _train(eng, run, steps):
    batch = RUNS[run][2]
    return [eng.train_batch(batch=batch(eng.global_steps))
            for _ in range(steps)]


def _same_state(a, b):
    assert torch.equal(a._master, b._master)
    assert torch.equal(a._params_flat, b._params_flat)
    assert torch.equal(a.opt_state.exp_avg, b.opt_state.exp_avg)
    assert torch.equal(a.opt_state.exp_avg_sq, b.opt_state.exp_avg_sq)
    assert a.opt_state.step == b.opt_state.step
    assert a.get_lr() == b.get_lr()
    assert a.scale_state == b.scale_state
    for counter in ("global_steps", "global_samples", "micro_steps",
                    "skipped_steps"):
        assert getattr(a, counter) == getattr(b, counter), counter


# ---------------------------------------------------------------------------
# exact resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", sorted(RUNS))
def test_resume_is_bit_identical(run, tmp_path):
    """BERT's dropout and the MoE gate jitter draw from the generator
    re-seeded from (1234, micro_steps), which the checkpoint restores."""
    whole = _engine(run)
    losses = _train(whole, run, 4)
    cut = _engine(run)
    assert _train(cut, run, 2) == losses[:2]
    cut.save_checkpoint(str(tmp_path))
    resumed = _engine(run, seed=7)
    assert not torch.equal(resumed._master, cut._master)
    resumed.load_checkpoint(str(tmp_path))
    _same_state(resumed, cut)
    assert _train(resumed, run, 2) == losses[2:]
    _same_state(resumed, whole)


def test_load_writes_the_flat_buffers_in_place(tmp_path):
    eng = _engine("neox_bf16")
    _train(eng, "neox_bf16", 1)
    eng.save_checkpoint(str(tmp_path))
    fresh = _engine("neox_bf16", seed=3)
    ptrs = [t.data_ptr() for t in (fresh._master, fresh._params_flat,
                                   fresh.opt_state.exp_avg,
                                   fresh.opt_state.exp_avg_sq)]
    views = [p.data_ptr() for p in fresh.module.parameters()]
    fresh.load_checkpoint(str(tmp_path))
    assert ptrs == [t.data_ptr() for t in (
        fresh._master, fresh._params_flat, fresh.opt_state.exp_avg,
        fresh.opt_state.exp_avg_sq)]
    assert views == [p.data_ptr() for p in fresh.module.parameters()]
    _same_state(fresh, eng)
    _train(fresh, "neox_bf16", 1)   # the gradient views still hold


def test_module_only_load_touches_only_the_parameters(tmp_path):
    eng = _engine("neox_bf16")
    _train(eng, "neox_bf16", 2)
    eng.save_checkpoint(str(tmp_path), client_state={"note": 5})
    fresh = _engine("neox_bf16", seed=3)
    master = fresh._master.clone()
    path, client = fresh.load_checkpoint(str(tmp_path), module_only=True)
    assert client["note"] == 5 and "module" not in client
    assert torch.equal(fresh._params_flat, eng._params_flat)
    assert torch.equal(fresh._master, master)
    assert fresh.global_steps == 0 and fresh.opt_state.step == 0
    _, params, _ = dst.checkpoint.load_module_checkpoint(
        str(tmp_path), like=fresh.param_names)
    model = RUNS["neox_bf16"][0](4).to(torch.bfloat16)
    model.load_state_dict(params)
    assert torch.equal(torch.cat([p.reshape(-1) for p in model.parameters()]),
                       eng._params_flat)


def test_a_deleted_engine_is_freed_at_once(tmp_path):
    """The checkpoint manager holds its engine weakly: no reference
    cycle keeps a deleted engine's flat buffers alive until a gc pass."""
    import gc
    import weakref
    eng = _engine("neox_bf16", checkpoint={"save_dir": str(tmp_path),
                                           "save_interval_steps": 1})
    _train(eng, "neox_bf16", 1)
    eng.checkpoint_manager.wait()
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_nothing_to_load_returns_none(tmp_path):
    eng = _engine("neox_bf16")
    assert eng.load_checkpoint(str(tmp_path)) == (None, {})
    assert jckpt._resolve_committed_state(str(tmp_path), None) == \
        (None, None, None)


@pytest.mark.parametrize("kind", ["streamed_nvme", "pipeline",
                                  "host_offload"])
def test_unported_checkpoint_kinds_raise(tmp_path, kind):
    """Checkpoints of engines the port's config refuses (the JAX
    package's streamed-NVMe, pipeline and host-offload tiers) raise "not
    ported" on load."""
    from deeperspeed_tpu_torch.checkpoint.serialization import (load_obj,
                                                                save_obj)
    eng = _engine("neox_bf16")
    eng.save_checkpoint(str(tmp_path))
    ckpt = str(tmp_path / "global_step0")
    name = ZERO_FILE if kind == "host_offload" else \
        "mp_rank_00_model_states.pt"
    obj = load_obj(os.path.join(ckpt, name))
    if kind == "host_offload":
        obj["optimizer_state_dict"]["host_offload"] = True
    else:
        obj[kind] = {"stages": 2} if kind == "pipeline" else True
    save_obj(obj, os.path.join(ckpt, name))
    mf.write_manifest(ckpt, "global_step0", 0)
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        eng.load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# the dataloader's resume position
# ---------------------------------------------------------------------------

def _dataset(n=40):
    rng = np.random.default_rng(0)
    return [(x, x) for x in rng.integers(0, 512, size=(n, S))]


def test_dataloader_state_matches_jax_and_resumes():
    data = _dataset()
    ours = DeepSpeedDataLoader(data, batch_size=2, shuffle=True, seed=3)
    ref = JaxLoader(data, batch_size=2, shuffle=True, seed=3)
    it, jit = iter(ours), iter(ref)
    for _ in range(3):
        a, b = next(it), next(jit)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert ours.state_dict() == ref.state_dict()
    again = DeepSpeedDataLoader(data, batch_size=2, shuffle=True, seed=0)
    again.load_state_dict(ours.state_dict())
    for a, b in zip(iter(again), it):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert again.epoch == 1


@pytest.mark.parametrize("change", [{"batch_size": 4}, {"shuffle": False},
                                    {"num_replicas": 2}])
def test_dataloader_resume_errors_match_jax(change):
    data = _dataset()
    sd = DeepSpeedDataLoader(data, batch_size=2, shuffle=True).state_dict()
    kw = {"batch_size": 2, "shuffle": True, **change}
    with pytest.raises(ValueError) as ours:
        DeepSpeedDataLoader(data, **kw).load_state_dict(sd)
    with pytest.raises(ValueError) as ref:
        JaxLoader(data, rank=0, **{"num_replicas": 1, **kw}) \
            .load_state_dict(sd)
    assert str(ours.value) == str(ref.value)
    kept = DeepSpeedDataLoader(data, **kw).reconcile_state_dict(sd)
    assert kept == JaxLoader(data, rank=0, **{"num_replicas": 1, **kw}) \
        .reconcile_state_dict(sd)


def test_resume_continues_the_sample_stream(tmp_path):
    data = _dataset()

    def engine(seed):
        make, conf, _ = RUNS["neox_bf16"]
        eng, _, loader, _ = dst.initialize(model=make(seed),
                                           config_params=conf,
                                           training_data=data)
        return eng, iter(dst.RepeatingLoader(loader))

    whole, it = engine(0)
    losses = [whole.train_batch(data_iter=it) for _ in range(4)]
    cut, it = engine(0)
    [cut.train_batch(data_iter=it) for _ in range(2)]
    cut.save_checkpoint(str(tmp_path))
    resumed, it = engine(5)
    resumed.load_checkpoint(str(tmp_path))
    assert resumed.training_dataloader.state_dict() == \
        cut.training_dataloader.state_dict()
    assert [resumed.train_batch(data_iter=it) for _ in range(2)] == \
        losses[2:]


# ---------------------------------------------------------------------------
# manifest fallback
# ---------------------------------------------------------------------------

def test_fallback_to_the_previous_committed_tag(tmp_path):
    save_dir = str(tmp_path)
    eng = _engine("neox_bf16")
    _train(eng, "neox_bf16", 1)
    eng.save_checkpoint(save_dir)
    master1 = eng._master.clone()
    _train(eng, "neox_bf16", 1)
    eng.save_checkpoint(save_dir)
    assert mf.read_latest(save_dir) == "global_step2"
    zero = tmp_path / "global_step2" / ZERO_FILE
    raw = bytearray(zero.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    zero.write_bytes(bytes(raw))

    fresh = _engine("neox_bf16", seed=3)
    path, _ = fresh.load_checkpoint(save_dir)
    assert path == os.path.join(save_dir, "global_step1")
    assert fresh.global_steps == 1 and torch.equal(fresh._master, master1)
    assert jckpt._resolve_committed_state(save_dir, None)[0] == \
        "global_step1"
    with pytest.raises(RuntimeError) as ours:
        fresh.load_checkpoint(save_dir, tag="global_step2")
    with pytest.raises(RuntimeError) as ref:
        jckpt._resolve_committed_state(save_dir, "global_step2")
    assert str(ours.value) == str(ref.value)
    assert "crc32 mismatch" in str(ours.value)


# ---------------------------------------------------------------------------
# async saves
# ---------------------------------------------------------------------------

def test_async_snapshot_is_not_reached_by_later_steps(tmp_path):
    eng = _engine("neox_bf16")
    _train(eng, "neox_bf16", 1)
    snap = {k: t.clone() for k, t in (
        ("master", eng._master), ("params", eng._params_flat),
        ("m", eng.opt_state.exp_avg))}
    manager = eng.checkpoint_manager
    gate = threading.Event()
    manager._pre_commit_hook = gate.wait
    assert eng.save_checkpoint_async(str(tmp_path)) == "global_step1"
    assert manager.in_flight
    _train(eng, "neox_bf16", 2)          # training overlaps the commit
    assert manager.in_flight and not torch.equal(eng._master, snap["master"])
    gate.set()
    manager.wait()
    assert not manager.in_flight and manager.saves_completed == 1
    assert manager.total_bytes > 0 and manager.total_stall_s > 0
    fresh = _engine("neox_bf16", seed=3)
    fresh.load_checkpoint(str(tmp_path))
    assert fresh.global_steps == 1
    assert torch.equal(fresh._master, snap["master"])
    assert torch.equal(fresh._params_flat, snap["params"])
    assert torch.equal(fresh.opt_state.exp_avg, snap["m"])


def test_async_back_pressure_orders_the_commits(tmp_path):
    save_dir = str(tmp_path)
    eng = _engine("neox_bf16")
    manager = eng.checkpoint_manager
    gate = threading.Event()
    manager._pre_commit_hook = gate.wait
    eng.save_checkpoint_async(save_dir, tag="a")
    threading.Timer(0.3, gate.set).start()
    eng.save_checkpoint_async(save_dir, tag="b")   # waits out "a"
    assert mf.is_committed(os.path.join(save_dir, "a"))
    eng.save_checkpoint(save_dir, tag="c")        # waits out "b"
    assert mf.is_committed(os.path.join(save_dir, "b"))
    assert mf.read_latest(save_dir) == "c"
    assert not manager.in_flight


@pytest.mark.parametrize("keep,want", [
    ({"keep_last_n": 2}, ["global_step3", "global_step4"]),
    ({"keep_last_n": 1, "keep_every_n_steps": 2},
     ["global_step2", "global_step4"]),
])
def test_interval_autosave_and_gc(tmp_path, keep, want):
    save_dir = str(tmp_path)
    eng = _engine("neox_bf16", checkpoint={
        "save_dir": save_dir, "save_interval_steps": 1, **keep})
    _train(eng, "neox_bf16", 4)
    eng.checkpoint_manager.wait()
    assert [t for _, t in mf.committed_tags(save_dir)] == want
    assert mf.read_latest(save_dir) == "global_step4"


def test_resume_resets_the_autosave_clock(tmp_path):
    save_dir = str(tmp_path)
    eng = _engine("neox_bf16", checkpoint={
        "save_dir": save_dir, "save_interval_steps": 2, "async_save": False})
    _train(eng, "neox_bf16", 2)
    assert [t for _, t in mf.committed_tags(save_dir)] == ["global_step2"]
    fresh = _engine("neox_bf16", seed=3, checkpoint={
        "save_dir": save_dir, "save_interval_steps": 2, "async_save": False})
    fresh.load_checkpoint(save_dir)
    _train(fresh, "neox_bf16", 1)
    assert [t for _, t in mf.committed_tags(save_dir)] == ["global_step2"]
    _train(fresh, "neox_bf16", 1)
    assert [t for _, t in mf.committed_tags(save_dir)] == [
        "global_step2", "global_step4"]


def test_writer_failure_raises_at_wait(tmp_path):
    eng = _engine("neox_bf16")

    def broken():
        raise OSError("disk full")

    eng.checkpoint_manager._pre_commit_hook = broken
    eng.save_checkpoint_async(str(tmp_path))
    with pytest.raises(RuntimeError,
                       match="async checkpoint save failed: disk full"):
        eng.checkpoint_manager.wait()
    eng.checkpoint_manager.wait()       # raised once, then clear
    assert mf.committed_tags(str(tmp_path)) == []


def test_preemption_saves_and_exits(tmp_path):
    save_dir = str(tmp_path)
    before = signal.getsignal(signal.SIGTERM)
    eng = _engine("neox_bf16", checkpoint={"save_dir": save_dir,
                                           "save_on_preemption": True})
    _train(eng, "neox_bf16", 1)
    eng.checkpoint_manager._on_signal(signal.SIGTERM, None)
    with pytest.raises(SystemExit) as exc:
        _train(eng, "neox_bf16", 1)
    assert exc.value.code == 128 + signal.SIGTERM
    assert mf.read_latest(save_dir) == "global_step2"
    assert signal.getsignal(signal.SIGTERM) == before
    eng.checkpoint_manager.close()


# ---------------------------------------------------------------------------
# zero_to_fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16,zero", [(True, 2), (False, 0)],
                         ids=["bf16_zero2", "fp32_no_zero"])
def test_both_zero_to_fp32_scripts_read_a_port_checkpoint(tmp_path, bf16,
                                                          zero):
    """The port's script (shipped in the checkpoint, run standalone) and
    the JAX package's give back the masters bit for bit: from the zero
    file, or from the module when there is none."""
    eng = dst.initialize(model=RUNS["neox_bf16"][0](0),
                         config_params=_config(bf16=bf16, zero=zero))[0]
    _train(eng, "neox_bf16", 2)
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    ckpt = tmp_path / "ckpt" / "global_step2"
    assert os.path.isfile(ckpt / ZERO_FILE) == eng.keep_master
    src = os.path.join(os.path.dirname(dst.__file__), "utils",
                       "zero_to_fp32.py")
    assert (ckpt / "zero_to_fp32.py").read_bytes() == open(src, "rb").read()
    out = tmp_path / "fp32.pt"
    res = subprocess.run([sys.executable, str(ckpt / "zero_to_fp32.py"),
                          str(ckpt), str(out)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for sd in (torch.load(out, weights_only=False),
               jz2f.get_fp32_state_dict_from_zero_checkpoint(str(ckpt))):
        assert sorted(sd) == sorted(n.replace(".", "/")
                                    for n in eng.param_names)
        got = torch.cat([torch.from_numpy(np.asarray(
            sd[n.replace(".", "/")], np.float32)).reshape(-1)
            for n in eng.param_names])
        assert torch.equal(got, eng._master)


# ---------------------------------------------------------------------------
# the "checkpoint" config block
# ---------------------------------------------------------------------------

GOOD_BLOCKS = [
    {},
    {"tag_validation": "fail", "save_dir": "/ckpt", "async_save": False,
     "save_interval_steps": 100, "keep_last_n": 3,
     "keep_every_n_steps": 1000, "save_on_preemption": True},
    {"tag_validation": "Ignore", "keep_last_n": 2.0},
]
BAD_BLOCKS = [
    {"bogus": 1},
    {"tag_validation": "maybe"},
    {"save_dir": 3},
    {"async_save": "yes"},
    {"save_on_preemption": 1},
    {"save_dir": "/ckpt", "save_interval_steps": -1},
    {"keep_last_n": 1.5},
    {"keep_every_n_steps": "x"},
    {"save_interval_steps": 5},
    {"save_on_preemption": True},
]


@pytest.mark.parametrize("block", GOOD_BLOCKS)
def test_checkpoint_block_matches_jax(block):
    conf = {"train_batch_size": 4, "checkpoint": block}
    ours, ref = DeepSpeedConfig(conf), JaxConfig(conf, world_size=1)
    assert ours.checkpoint_config == ref.checkpoint_config
    for f in ("checkpoint_tag_validation_mode",
              "checkpoint_tag_validation_enabled",
              "checkpoint_tag_validation_fail"):
        assert getattr(ours, f) == getattr(ref, f), f


@pytest.mark.parametrize("block", BAD_BLOCKS)
def test_checkpoint_block_errors_match_jax(block):
    conf = {"train_batch_size": 4, "checkpoint": block}
    with pytest.raises(JaxConfigError) as ref:
        JaxConfig(conf, world_size=1)
    with pytest.raises(DeepSpeedConfigError) as ours:
        DeepSpeedConfig(conf)
    assert str(ours.value) == str(ref.value)
