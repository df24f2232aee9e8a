"""The port's partition math, CSRTensor, barrier and loader defaults
against the JAX package, and two engine paths that ride a partition: the
fp16 overflow of one rank's partition and MoE with replicated experts.

Pure functions (no process group): the sub-partition math bit-equal to
JAX's over a grid of numel × world × sub_partition_count, the padding
and the partition layout (every partition's start 16-byte aligned),
`_shardable_dim`, `FlatPad` and the master layout rules against JAX's
`ZeroShardingRules` on a data mesh, the barrier's injected timeout and
`init_distributed`'s error without mpi4py.

On 2 gloo ranks (`tests/torch_dp_worker.py`; they run while the JAX
references compile): `csr_allreduce` against JAX's under `shard_map` on
2 devices (equal row counts, which JAX's tiled all-gather needs; ragged
counts against numpy); the standalone stage-1 and stage-2 optimizers
against one process stepping the mean gradient; the loader's defaults
and order against the JAX loader at the same rank and replica count;
fp16 with an inf placed in rank 1's partition at step 3 against the JAX
engine on a 2-device mesh with a NaN gradient injected at the same step
(its fault injection): both skip that step on every rank, and the loss
scale and the skip counts match (losses rtol 1e-4, masters atol 1e-3:
fp16 compute); MoE GPT-NeoX (4 experts, top 2, sort dispatch, capacity
factor 4 so that no token is dropped, the auxiliary loss off: its
batch statistics would be a rank's, not the global batch's) against
the JAX engine at dp 2 (fp32: losses rtol 1e-5, masters atol = rtol =
1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from deeperspeed_tpu.compat import shard_map
from deeperspeed_tpu.runtime import csr_tensor as jcsr
from deeperspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JaxLoader
from deeperspeed_tpu.runtime.zero import partition_parameters as jpp
from deeperspeed_tpu.runtime.zero import stage1 as jstage1

from deeperspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deeperspeed_tpu_torch.runtime.zero import partition_parameters as pp
from deeperspeed_tpu_torch.runtime.zero import stage1
from deeperspeed_tpu_torch.utils import distributed as ds_dist

import torch_dp as T

STEPS = 4
FP16_SKIP_STEP = 3
MOE_BLOCK = {"num_experts": 4, "top_k": 2, "capacity_factor": 4.0,
             "aux_loss_coef": 0.0, "dispatch": "sort"}
CSR_ROWS, CSR_COLS = 10, 3


def _csr_dense(rows_by_rank, seed):
    rng = np.random.default_rng(seed)
    out = []
    for rows in rows_by_rank:
        d = np.zeros((CSR_ROWS, CSR_COLS), np.float32)
        d[rows] = rng.standard_normal((len(rows), CSR_COLS))
        out.append(d)
    return out


CSR_EVEN = _csr_dense([[1, 4, 7], [0, 4, 9]], 0)
CSR_RAGGED = _csr_dense([[2, 5], [0, 2, 6, 8]], 1)
STAGE1_PARAMS = [np.random.default_rng(2).standard_normal(s).astype(
    np.float32) for s in ((5, 3), (7,), (2, 2))]
STAGE1_GRADS = [np.random.default_rng(3).standard_normal((2,) + p.shape)
                .astype(np.float32) for p in STAGE1_PARAMS]


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_sub_partition_math_matches_jax(world):
    for numel in (0, 1, 7, 8, 63, 64, 1000, 47565):
        for count in (1, 2, 3):
            if numel < world * count:
                continue
            assert stage1.sub_partition_sizes(numel, world, count) == \
                jstage1.sub_partition_sizes(numel, world, count)
            assert stage1.sub_partition_bounds(numel, world, count) == \
                jstage1.sub_partition_bounds(numel, world, count)
            flat = np.arange(numel, dtype=np.float32)
            for ours, theirs in zip(
                    stage1.flat_sub_partitions(flat, world, count),
                    jstage1.flat_sub_partitions(flat, world, count)):
                assert len(ours) == len(theirs)
                for a, b in zip(ours, theirs):
                    np.testing.assert_array_equal(a, b)
        for align in (1, 4, 8):
            assert stage1.get_group_alignment_padding(numel, world, align) \
                == jstage1.get_group_alignment_padding(numel, world, align)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_partitions_start_16_byte_aligned(world):
    for numel in (1, 47565, 162_322_944, 162_322_945):
        part = [stage1.flat_partition(numel, world, r) for r in range(world)]
        assert part[0].padded % world == 0
        assert 0 <= part[0].padded - numel < world * stage1.PARTITION_ALIGNMENT
        assert [p.lo for p in part] == [r * part[0].size
                                        for r in range(world)]
        assert part[-1].hi == part[0].padded
        for p in part:
            # fp32 masters and moments, bf16 / fp16 gradients and copy
            assert (p.lo * 4) % 16 == 0 and (p.lo * 2) % 16 == 0


SHAPES = [(), (1,), (3,), (8,), (251, 45), (45,), (45, 135), (45, 180),
          (4, 45, 180), (7, 9), (16, 3), (50304, 768), (3, 5, 7)]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_layout_rules_match_jax(world, stage):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    theirs = jpp.ZeroShardingRules(stage=stage, mesh=mesh,
                                   data_axis="data")
    ours = pp.ZeroShardingRules(stage, world)
    for shape in SHAPES:
        assert pp._shardable_dim(shape, world) == \
            jpp._shardable_dim(shape, world)
        assert ours.master_spec(shape) == tuple(theirs.master_spec(shape)) \
            + (None,) * (len(shape) - len(theirs.master_spec(shape))) \
            if stage else ours.master_spec(shape) == ()
        a, b = ours.master_pad_info(shape), theirs.master_pad_info(shape)
        assert (a is None) == (b is None), shape
        if a is not None:
            assert (a.shape, a.numel, a.padded) == (b.shape, b.numel,
                                                    b.padded)
            x = np.random.default_rng(0).standard_normal(shape).astype(
                np.float32)
            np.testing.assert_array_equal(pp.flat_pad(x, a),
                                          np.asarray(jpp.flat_pad(x, b)))
            np.testing.assert_array_equal(
                pp.flat_pad(torch.from_numpy(x), a).numpy(),
                pp.flat_pad(x, a))
            np.testing.assert_array_equal(
                pp.flat_unpad(pp.flat_pad(x, a), a), x)


def test_barrier_injected_timeout():
    ds_dist.barrier("untouched")   # one process: a no-op
    ds_dist.inject_barrier_timeout(tag="ckpt", times=1)
    ds_dist.barrier("other")       # another tag: not armed
    with pytest.raises(ds_dist.BarrierTimeoutError) as e:
        ds_dist.barrier("ckpt")
    assert e.value.tag == "ckpt" and "injected" in str(e.value)
    ds_dist.barrier("ckpt")        # fired once
    ds_dist.inject_barrier_timeout(times=2)
    for tag in ("a", "b"):
        with pytest.raises(ds_dist.BarrierTimeoutError):
            ds_dist.barrier(tag)
    ds_dist.barrier("a")


def test_init_distributed_without_mpi4py(monkeypatch):
    import importlib.util
    if importlib.util.find_spec("mpi4py") is not None:
        pytest.skip("mpi4py is installed here")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="mpi4py"):
        ds_dist.init_distributed(dist_backend="gloo", verbose=False)
    assert not ds_dist.is_initialized()
    assert ds_dist.default_backend("cpu") == "gloo"
    assert ds_dist.default_backend("cuda:0") == "nccl"


# ---------------------------------------------------------------------------
# on 2 gloo ranks
# ---------------------------------------------------------------------------

def _fp16_conf():
    conf = T.config(2, "fp16", 2)
    conf["fp16"] = dict(conf["fp16"], initial_scale_power=16)
    return conf


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    w = T.jax_weights()
    moe_size = dict(T.SIZE, **T.MOE_CFG)
    wm = T.jax_weights(moe_size)
    toks = T.tokens(2)
    moe_conf = T.config(2, "fp32", 2, moe=MOE_BLOCK)
    handle = T.start_ranks(2, [
        dict(kind="csr", name="csr_even", dense=CSR_EVEN),
        dict(kind="csr", name="csr_ragged", dense=CSR_RAGGED),
        dict(kind="stage1", name="stage1", params=STAGE1_PARAMS,
             grads=STAGE1_GRADS),
        dict(kind="loader", name="loader", n=23),
        dict(kind="train", name="fp16", size=T.SIZE, weights=w,
             conf=_fp16_conf(), tokens=toks, steps=STEPS,
             inject_inf={"step": FP16_SKIP_STEP, "rank": 1}),
        dict(kind="train", name="moe", size=moe_size, weights=wm,
             conf=moe_conf, tokens=toks, steps=3)],
        tmp_path_factory.mktemp("w2"))
    ref = {}
    # the JAX package's own fault injection: NaN gradients at step 3
    # (its serial counts from 0)
    jconf = dict(_fp16_conf(), training_health={
        "enabled": False, "fault_injection": {"faults": [
            {"kind": "nan_grads", "step": FP16_SKIP_STEP - 1}]}})
    eng = T.jax_engine(2, w, jconf)
    ref["fp16"] = dict(losses=T.jax_steps(eng, toks, STEPS),
                       master=T.jax_masters(eng), scale=eng.loss_scale,
                       skipped=eng.skipped_steps, steps=eng.global_steps)
    eng = T.jax_engine(2, wm, moe_conf, size=moe_size)
    ref["moe"] = dict(losses=T.jax_steps(eng, toks, 3),
                      master=T.jax_masters(eng))
    return T.wait_ranks(handle), ref


def test_csr_allreduce_matches_jax_shard_map(runs):
    port, _ = runs
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    parts = [jcsr.CSRTensor(jnp.asarray(d)) for d in CSR_EVEN]

    def body(ind, val):
        c = jcsr.CSRTensor()
        c.dense_size = (CSR_ROWS, CSR_COLS)
        c.indices, c.values = ind, val
        out = jcsr.csr_allreduce(c, "data")
        return out.indices, out.values

    ind, val = shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                         out_specs=(P(), P()), check_vma=False)(
        jnp.concatenate([p.indices for p in parts]),
        jnp.concatenate([p.values for p in parts]))
    for rank in range(2):
        got = port[rank]["csr_even"]
        np.testing.assert_array_equal(got["indices"], np.asarray(ind))
        np.testing.assert_array_equal(got["values"], np.asarray(val))
        np.testing.assert_allclose(got["dense"], sum(CSR_EVEN) / 2,
                                   rtol=1e-6)


def test_csr_allreduce_ragged_counts(runs):
    port, _ = runs
    rows = [np.nonzero(np.abs(d).sum(1))[0] for d in CSR_RAGGED]
    for rank in range(2):
        got = port[rank]["csr_ragged"]
        np.testing.assert_array_equal(got["indices"], np.concatenate(rows))
        np.testing.assert_array_equal(
            got["values"], np.concatenate([d[r] for d, r in
                                           zip(CSR_RAGGED, rows)]) / 2)
        np.testing.assert_allclose(got["dense"], sum(CSR_RAGGED) / 2,
                                   rtol=1e-6)


def test_standalone_zero_optimizers(runs):
    """Both ranks end where one process stepping the mean gradient ends
    (unscaled, clipped, Adam); the state dict's sub-partitions are the
    JAX layout of the whole masters, and a reload restores them."""
    port, _ = runs
    mean = [g.mean(0) for g in STAGE1_GRADS]
    flat_g = torch.from_numpy(np.concatenate([g.ravel() for g in mean]))
    flat_p = torch.from_numpy(np.concatenate(
        [p.ravel() for p in STAGE1_PARAMS]))
    norm = torch.linalg.vector_norm(flat_g)
    flat_g = flat_g * torch.clamp(1.0 / (norm + 1e-6), max=1.0)
    adam = FusedAdam(lr=0.1, eps=1e-3)
    st = adam.init_state(flat_p)
    adam.update(flat_g, st, flat_p)
    for rank in range(2):
        res = port[rank]["stage1"]
        assert res["alias"]
        for stage in (1, 2):
            got = res[stage]
            assert not got["overflow"] and got["scale"] == 4.0
            np.testing.assert_allclose(got["norm"], float(norm), rtol=1e-6)
            np.testing.assert_allclose(
                np.concatenate([p.ravel() for p in got["params"]]),
                flat_p.numpy(), rtol=1e-6, atol=1e-7)
            want = jstage1.flat_sub_partitions(
                np.concatenate([p.ravel() for p in got["params"]]), 2)
            for a, b in zip(got["sub_partitions"], want):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            assert got["reloaded_equal"]


def test_loader_defaults_to_the_group(runs):
    port, _ = runs
    for rank in range(2):
        got = port[rank]["loader"]
        assert (got["num_replicas"], got["rank"]) == (2, rank)
        want = JaxLoader(list(range(23)), batch_size=2, shuffle=True, seed=3,
                         num_replicas=2, rank=rank)
        assert got["order"] == [np.asarray(b).tolist() for b in want]


def test_fp16_overflow_on_one_rank_skips_on_every_rank(runs):
    port, ref = runs
    want = ref["fp16"]
    assert want["skipped"] == 1 and want["steps"] == STEPS - 1
    for rank in range(2):
        got = port[rank]["fp16"]
        assert got["skipped_steps"] == want["skipped"]
        assert got["global_steps"] == want["steps"]
        assert got["loss_scale"] == want["scale"] == 2.0 ** 15
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        for key, value in want["master"].items():
            np.testing.assert_allclose(got["master"][key], value,
                                       atol=1e-3, rtol=0, err_msg=key)
    for key, value in port[0]["fp16"]["master"].items():
        np.testing.assert_array_equal(port[1]["fp16"]["master"][key], value)


def test_moe_replicated_experts_match_jax(runs):
    port, ref = runs
    want = ref["moe"]
    got = port[0]["moe"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert any("expert" in k or "w_in" in k for k in got["master"])
    assert set(got["master"]) == set(want["master"])
    for key, value in want["master"].items():
        np.testing.assert_allclose(got["master"][key], value, atol=1e-4,
                                   rtol=1e-4, err_msg=key)
