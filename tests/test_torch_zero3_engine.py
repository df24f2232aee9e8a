"""The port's ZeRO stage 3 on two gloo ranks against the JAX stage-3
engine on a 2-device data mesh, and with no process group against the
port's stage 0, on the CPU.

The port runs as one set of 2 gloo ranks (child processes, one thread
each, `tests/torch_dp_worker.py`) on a three-layer GPT-NeoX with the
data-parallel tests' odd widths, leaves under 500 elements persisted:
"gspmd" and "explicit" (a prefetch depth of 5 past the 3 layers,
buckets of 10,485 bytes with ragged tails, groups of two over three
layers; and without remat), in fp32, gradient accumulation 2, clipping
at 1.0, each rank on its columns of one global batch. The JAX
reference: its stage-3 engine on 2 devices under "gspmd" (the JAX modes
agree to float tolerance, so every port mode is held to it; the JAX
"explicit" schedule and bf16 are held to the port's 4 ranks in
`test_torch_zero3_checkpoint.py`).

Tolerances after 3 steps (`torch_zero3.TOL`): fp32 losses rtol 1e-5 and
masters atol = rtol = 1e-4 (only the summation order differs). Also:
stage 3 equals stage 2 at
world 2 (fp32, the same tolerances), the ranks agree bit for bit, the
legacy forward / backward / step loop equals `train_batch` bit for bit,
a rank's state bytes are the stage-3 formula, the activation capture
and `eval_batch` run through the gathers, what stage 3 refuses raises,
and with no process group stage 3 (both modes) takes stage 0's steps
bit for bit in fp32 and bf16.
"""

import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as dst
from deeperspeed_tpu_torch.models import gpt_neox as neox

import torch_dp as T
import torch_zero3 as Z

WORLD = 2
# the port's runs: (name, dtype, stage, schedule)
RUNS = (("g_fp32", "fp32", 3, Z.GSPMD),
        ("e_fp32", "fp32", 3, Z.EXPLICIT),
        ("n_fp32", "fp32", 3, Z.EXPLICIT_NO_REMAT),
        ("s2_fp32", "fp32", 2, None))


def _refusals():
    def c(**kw):
        return Z.conf(1, **kw)
    sparse = {"mode": "fixed", "block": 16, "num_local_blocks": 2}
    moe = {"num_experts": 4, "top_k": 2, "dispatch": "sort"}
    return {
        "gpt2": dict(c(), model="gpt2"),
        "moe_gspmd": dict(c(), moe=moe),
        "moe_explicit": dict(c(schedule=Z.EXPLICIT), moe=moe),
        "sparse_gspmd": dict(c(), sparse_attention=sparse),
        "sparse_explicit": dict(c(schedule=Z.EXPLICIT),
                                sparse_attention=sparse),
        "quant_gspmd": dict(c(), quantization={"ffn": {"recipe": "int8"}}),
        "quant_explicit": dict(c(schedule=Z.EXPLICIT),
                               quantization={"ffn": {"recipe": "int8"}}),
        "sparse_gradients": dict(c(), sparse_gradients=True),
        "store_gradients": dict(c(), store_gradients=True),
        "rl_gspmd": dict(c(), rl={
            "enabled": True, "loss": "ppo_clip",
            "rollouts_per_iteration": 8, "group_size": 2,
            "max_new_tokens": 4}),
        "lamb": dict(c(), optimizer={"type": "Lamb",
                                     "params": {"lr": 1e-2}}),
        "pld_explicit": dict(c(schedule=Z.EXPLICIT),
                             progressive_layer_drop={"enabled": True}),
        "ok": c(),
    }


@pytest.fixture(scope="module")
def weights():
    return T.jax_weights(Z.SIZE)


@pytest.fixture(scope="module")
def toks():
    return T.tokens(1, micro=Z.GLOBAL_MICRO)


@pytest.fixture(scope="module")
def runs(weights, toks, tmp_path_factory):
    """(the port's results by rank, the JAX references by name): the
    ranks train while the JAX engines compile."""
    cases = [Z.train(name, weights, toks,
                     Z.conf(WORLD, dtype, stage, schedule=sched),
                     eval=True, hook=[1, 3] if name in ("g_fp32", "s2_fp32")
                     else None)
             for name, dtype, stage, sched in RUNS]
    cases.append(Z.train("legacy", weights, toks, Z.conf(WORLD),
                         legacy=True))
    handle = T.start_ranks(WORLD, cases, tmp_path_factory.mktemp("z3e"))
    eng = T.jax_engine(WORLD, weights, Z.conf(WORLD), size=Z.SIZE)
    ref = (T.jax_steps(eng, toks, Z.STEPS), T.jax_masters(eng))
    return T.wait_ranks(handle), ref


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_ref(runs):
    return runs[1]


def _close(got, want_losses, want_master, dtype):
    tol = Z.TOL[dtype]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=tol["loss"])
    assert set(got["master"]) == set(want_master)
    for key, want in want_master.items():
        np.testing.assert_allclose(got["master"][key], want,
                                   atol=tol["atol"], rtol=tol["rtol"],
                                   err_msg=key)


@pytest.mark.parametrize("run", [r[0] for r in RUNS if r[2] == 3])
def test_steps_match_jax(port, jax_ref, run):
    losses, master = jax_ref
    got = port[0][run]
    assert got["dp_world_size"] == WORLD
    _close(got, losses, master, "fp32")
    assert got["losses"][-1] < got["losses"][0]


def test_stage3_equals_stage2(port):
    _close(port[0]["g_fp32"], port[0]["s2_fp32"]["losses"],
           port[0]["s2_fp32"]["master"], "fp32")
    np.testing.assert_allclose(port[0]["g_fp32"]["eval"],
                               port[0]["s2_fp32"]["eval"], rtol=1e-5)


def test_ranks_agree(port):
    """Every rank ends with the same losses, masters and (gathered)
    compute parameters, bit for bit."""
    first, other = port
    for name, got in first.items():
        if "losses" not in got:
            continue
        assert other[name]["losses"] == got["losses"], name
        for field in ("master", "params"):
            for key, value in got[field].items():
                np.testing.assert_array_equal(
                    other[name][field][key], value,
                    err_msg=f"{name} {field} {key}")


def test_legacy_loop_equals_train_batch(port):
    legacy, fused = port[0]["legacy"], port[0]["g_fp32"]
    assert legacy["losses"] == fused["losses"]
    for key, value in fused["master"].items():
        np.testing.assert_array_equal(legacy["master"][key], value,
                                      err_msg=key)


def test_capture_runs_through_the_gathers(port):
    """`set_layers_to_hook` at stage 3 gathers each layer's row under
    no_grad: the first step's activations are stage 2's bit for bit."""
    got, want = port[0]["g_fp32"]["hooked"], port[0]["s2_fp32"]["hooked"]
    assert sorted(got) == [1, 3]
    for i in got:
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("run", [r[0] for r in RUNS if r[2] == 3])
def test_state_bytes_are_the_stage3_formula(port, run):
    dtype = dict((r[0], r[1]) for r in RUNS)[run]
    for rank, res in enumerate(port):
        got = res[run]
        assert got["state_bytes"] == Z.state_bytes(dtype, got["layout"]), \
            rank
        # every rank holds 1/world of each row (rows padded to world x 8)
        n = got["num_params"]
        assert got["layout"]["part_size"] * WORLD < \
            n + 5 * WORLD * 8
    # gathers: per training forward the outer row and each layer's row,
    # again per layer in the recompute (without remat, once); the
    # activation capture and eval_batch gather each row once, under
    # no_grad. Reduce-scatters: the outer, the persisted and every layer
    # row once a backward, none under no_grad
    col = port[0]["g_fp32"]["collectives"]
    forwards = Z.STEPS * T.GAS
    assert col == {"gathers": forwards * (1 + 2 * 3) + 2 * (1 + 3),
                   "reduce_scatters": forwards * (2 + 3)}
    assert port[0]["n_fp32"]["collectives"] == {
        "gathers": forwards * (1 + 3) + (1 + 3),
        "reduce_scatters": forwards * (2 + 3)}


def _refused(conf):
    """The error `initialize` raises on ``conf`` (None: none), as
    "Type: message"."""
    conf = dict(conf)
    if conf.pop("model", None) == "gpt2":
        model = dst.GPT2(dst.GPT2Config.tiny(), device="cpu")
    else:
        model = neox.GPTNeoX(neox.GPTNeoXConfig(**Z.SIZE), device="cpu")
    try:
        dst.initialize(model=model, config_params=conf)
    except (dst.DeepSpeedConfigError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def test_stage3_refusals():
    """What stage 3 does not carry raises, on any world (here one rank
    without a group)."""
    msgs = {name: _refused(conf) for name, conf in _refusals().items()}
    assert msgs["ok"] is None
    for name in ("gpt2", "moe_gspmd", "sparse_gspmd", "quant_gspmd",
                 "sparse_gradients", "store_gradients", "rl_gspmd",
                 "lamb"):
        assert msgs[name] and "not ported" in msgs[name], (name, msgs[name])
    assert msgs["gpt2"].startswith("DeepSpeedConfigError") and \
        "GPT2" in msgs["gpt2"]
    # under "explicit" the JAX package's own errors, word for word
    assert msgs["moe_explicit"] == (
        "NotImplementedError: the explicit ZeRO-3 schedule does not "
        "support MoE blocks yet (aux-loss threading); use the GSPMD "
        "schedule (zero_optimization.schedule.mode \"gspmd\")")
    assert msgs["sparse_explicit"] == (
        "NotImplementedError: the explicit ZeRO-3 schedule runs the "
        "dense flash/XLA attention core; sparse_attention and "
        "sequence_parallel need the GSPMD schedule")
    assert msgs["quant_explicit"].startswith(
        "DeepSpeedConfigError: quantization.ffn with the explicit ZeRO-3 "
        "schedule is unsupported")
    assert msgs["pld_explicit"] == (
        "DeepSpeedConfigError: explicit schedule + progressive_layer_drop "
        "is unsupported (theta is not threaded through the scheduled "
        "block scan)")


# ---------------------------------------------------------------------------
# no process group: stage 3 is stage 0 bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _no_group(weights, toks, c):
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**Z.SIZE), device="cpu")
    eng, *_ = dst.initialize(model=model, config_params=c,
                             model_parameters=weights)
    assert eng.dp_group is None
    batch = torch.from_numpy(toks)
    losses = [eng.train_batch(batch=(batch, batch)) for _ in range(2)]
    return losses, eng._natural_flat(eng._master).clone(), eng


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_no_group_is_stage0_bit_for_bit(weights, toks, dtype, one_thread):
    want_losses, want_master, _ = _no_group(weights, toks,
                                            Z.conf(1, dtype, stage=0))
    for sched in (Z.GSPMD, Z.EXPLICIT):
        losses, master, eng = _no_group(weights, toks,
                                        Z.conf(1, dtype, schedule=sched))
        assert eng._z3 is not None and eng.dp_world_size == 1
        assert losses == want_losses, sched
        assert torch.equal(master, want_master), sched
        # the module holds no whole leaf but the persisted ones
        held = {n for n, p in eng.module.named_parameters() if p.numel()}
        assert held == {leaf.name for leaf in
                        eng._z3.layout.persisted.leaves}
