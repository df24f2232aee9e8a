"""The ZeRO-3 numbers of the port against the JAX package's, with no
engine: the "schedule" sub-block and the stage-3 keys of the
"zero_optimization" block (the same attributes, or the same error), the
schedule's bucket, placement and layer-plan arithmetic
(`parallel/schedule.py`), the stage-3 sharding rules with the
persistence threshold, and the port's row layout
(`runtime/zero/stage3.Zero3Layout`): every element of the natural flat
order lands in exactly one rank's partition and comes back.

Everything is exact: these are integers, layouts and copies."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec

from deeperspeed_tpu.parallel import schedule as jsched
from deeperspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deeperspeed_tpu.runtime.config_utils import \
    DeepSpeedConfigError as JaxConfigError
from deeperspeed_tpu.runtime.zero import partition_parameters as jpp

from deeperspeed_tpu_torch.parallel import schedule as tsched
from deeperspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deeperspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigError
from deeperspeed_tpu_torch.runtime.zero import partition_parameters as tpp
from deeperspeed_tpu_torch.runtime.zero.stage3 import Zero3Layout

import torch_dp as T

# a three-layer GPT-NeoX with the data-parallel tests' odd widths: no
# dimension of most leaves divides a world of 2 or 4
SIZE = dict(T.SIZE, num_layers=3)


def _both(zero_block):
    """(the port's parse, the JAX parse) of a config with
    ``zero_block``; an error is returned as ("error", message)."""
    conf = {"train_batch_size": 8, "zero_optimization": zero_block}
    out = []
    for cls, err in ((DeepSpeedConfig, DeepSpeedConfigError),
                     (JaxConfig, JaxConfigError)):
        try:
            out.append(cls(None, param_dict=conf))
        except err as e:
            out.append(("error", str(e)))
    return out


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# ---------------------------------------------------------------------------
# the "schedule" sub-block (tests/test_explicit_schedule.py's
# TestScheduleConfigValidation cases)
# ---------------------------------------------------------------------------

SCHEDULES = [
    ({}, 3),
    ({"mode": "explicit", "prefetch_depth": 3, "bucket_mb": 8,
      "group_layers": 6}, 3),
    ({"mode": "explicit", "remat": False, "bucket_mb": 0.5}, 3),
    ({"mode": "magic"}, 3),
    ({"bogus_knob": 1}, 3),
    ({"prefetch_depth": 0}, 3),
    ({"prefetch_depth": "two"}, 3),
    ({"bucket_mb": 0}, 3),
    ({"bucket_mb": "big"}, 3),
    ({"group_layers": 0}, 3),
    ({"remat": "yes"}, 3),
    ({"mode": "explicit"}, 2),
    ([], 3), (0, 3), (False, 3), ("explicit", 3),
]


@pytest.mark.parametrize("sched,stage", SCHEDULES,
                         ids=[f"{i}" for i in range(len(SCHEDULES))])
def test_schedule_block_parses_like_jax(sched, stage):
    ours, theirs = _both({"stage": stage, "schedule": sched})
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple), ours
        assert ours[1] == theirs[1]
        return
    got, want = ours.zero_config.schedule, theirs.zero_config.schedule
    assert _fields(got) == _fields(want)
    assert got.bucket_bytes == want.bucket_bytes


def test_schedule_defaults_without_a_block():
    ours, theirs = _both(None)
    assert _fields(ours.zero_config.schedule) == \
        _fields(theirs.zero_config.schedule)


# ---------------------------------------------------------------------------
# the stage-3 keys
# ---------------------------------------------------------------------------

ZERO3_BLOCKS = [
    {"stage": 3},
    {"stage": 3, "stage3_max_live_parameters": 7, "stage3_max_reuse_distance":
     9, "stage3_prefetch_bucket_size": 5e6,
     "stage3_param_persistence_threshold": 1e3,
     "stage3_gather_fp16_weights_on_model_save": True,
     "allgather_bucket_size": 2e8, "reduce_bucket_size": 3e8,
     "contiguous_gradients": True, "sub_group_size": 1e9},
    {"stage": 3, "overlap_comm": False},
    {"stage": 2},          # overlap_comm's default is stage 3's only
    {"stage": 1, "allgather_size": 123},
    {"stage": 3, "stage3_param_persistence_threshold": -1},
    {"stage": 3, "stage3_max_live_parameters": -5},
    {"stage": 3, "stage3_prefetch_bucket_size": 1.5},
    {"stage": 4},
]


@pytest.mark.parametrize("block", ZERO3_BLOCKS,
                         ids=[f"{i}" for i in range(len(ZERO3_BLOCKS))])
def test_stage3_keys_parse_like_jax(block):
    ours, theirs = _both(block)
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple), ours
        assert ours[1] == theirs[1]
        return
    got, want = _fields(ours.zero_config), _fields(theirs.zero_config)
    for name in ("offload_param", "offload_optimizer", "schedule"):
        got.pop(name), want.pop(name)
    assert got == want
    assert ours.zero_optimization_stage == theirs.zero_optimization_stage


@pytest.mark.parametrize("block", [
    {"stage": 3, "offload_param": {"device": "cpu"}},
    {"stage": 3, "offload_optimizer": {"device": "cpu"}},
    {"stage": 3, "cpu_offload_params": True},
])
def test_offload_stays_not_ported(block):
    with pytest.raises(DeepSpeedConfigError, match="not ported"):
        DeepSpeedConfig(None, param_dict={"train_batch_size": 8,
                                          "zero_optimization": block})


# ---------------------------------------------------------------------------
# buckets, placements, layer plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,itemsize,bucket", [
    (64, 4, 64), (67, 4, 64), (67, 4, 1 << 30), (10, 4, 0), (0, 4, 64),
    (1, 1, 1), (7, 2, 8), (129, 4, 16), (1000, 2, 48), (6075, 4, 10485)])
def test_plan_buckets_match_jax(size, itemsize, bucket):
    assert tsched.plan_buckets(size, itemsize, bucket) == \
        jsched.plan_buckets(size, itemsize, bucket)


@pytest.mark.parametrize("layers,groups", [(3, 2), (12, 3), (5, 3),
                                           (1, 4), (7, 7)])
def test_segment_sizes_match_jax(layers, groups):
    assert tsched._segment_sizes(layers, groups) == \
        jsched._segment_sizes(layers, groups)


@pytest.mark.parametrize("shape,spec,pad", [
    ((8, 16), (None, "data"), None), ((8,), (), None),
    ((24,), ("data",), (17,)), ((4, 8, 6), (None, "data", None), None)])
def test_leaf_placement_matches_jax(shape, spec, pad):
    jpad = jpp.FlatPad(pad, int(np.prod(pad)), shape[0]) if pad else None
    tpad = tpp.FlatPad(pad, int(np.prod(pad)), shape[0]) if pad else None
    want = jsched.leaf_placement(shape, jnp.float32, PartitionSpec(*spec),
                                 jpad, "data", 8)
    got = tsched.leaf_placement(shape, np.float32, spec, tpad, "data", 8)
    for attr in ("kind", "dim", "shape", "local_shape", "size", "gathered"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_foreign_axis_refused_like_jax():
    with pytest.raises(JaxConfigError) as want:
        jsched.leaf_placement((8, 16), jnp.float32, PartitionSpec(
            None, "model"), None, "data", 8)
    with pytest.raises(DeepSpeedConfigError) as got:
        tsched.leaf_placement((8, 16), np.float32, (None, "model"), None,
                              "data", 8)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def block_template():
    """Block 0 of the three-layer model as numpy leaves."""
    return T.jax_weights(SIZE)["blocks"][0]


def _jax_layout(template, world, threshold):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    rules = jpp.ZeroShardingRules(3, mesh,
                                  param_persistence_threshold=threshold)
    specs = jax.tree_util.tree_map(lambda l: rules.param_spec(l.shape),
                                   template)
    # a leaf with no pad is a falsy leaf (None would vanish from the
    # tree), as in the JAX engine's pad-info trees
    pads = jax.tree_util.tree_map(
        lambda l: rules.param_pad_info(l.shape) or 0, template)
    return specs, pads


def _port_layout(template, world, threshold):
    rules = tpp.ZeroShardingRules(3, world,
                                  param_persistence_threshold=threshold)

    def mapped(fn):
        return {k: {n: fn(v.shape) for n, v in sub.items()}
                for k, sub in template.items()}
    return mapped(rules.param_spec), mapped(rules.param_pad_info)


@pytest.mark.parametrize("world,threshold,bucket", [
    (2, 500, 1 << 20), (4, 500, 10485), (4, 0, 4096), (2, 100_000, 64)])
def test_layer_plan_rows_and_rebuilds_match_jax(block_template, world,
                                                threshold, bucket):
    jspecs, jpads = _jax_layout(block_template, world, threshold)
    tspecs, tpads = _port_layout(block_template, world, threshold)
    jplan = jsched.LayerPlan(block_template, jspecs, jpads, "data", world,
                             bucket)
    tplan = tsched.LayerPlan(block_template, tspecs, tpads, "data", world,
                             bucket)
    assert tplan.shard_size == jplan.shard_size
    assert tplan.buckets == jplan.buckets
    assert tplan.offsets == jplan.offsets
    assert tplan.n_replicated == jplan.n_replicated
    assert [(p.kind, p.dim, p.local_shape) for p in tplan.placements] == \
        [(p.kind, p.dim, p.local_shape) for p in jplan.placements]
    leaves = [l for _, l in tsched.tree_paths(block_template)]
    assert [np.shape(l) for l in leaves] == \
        [np.shape(l) for l in jax.tree_util.tree_leaves(block_template)]
    # each rank's local leaves → its row; the rows stacked → the rebuild
    rows = []
    for rank in range(world):
        local = []
        for leaf, pl in zip(leaves, tplan.placements):
            if pl.kind == tsched.FLAT_SHARDED:
                flat = np.pad(leaf.ravel(), (0, pl.pad.padded - leaf.size))
                local.append(flat.reshape(world, -1)[rank])
            elif pl.kind == tsched.DIM_SHARDED:
                local.append(np.split(leaf, world, axis=pl.dim)[rank])
            else:
                local.append(leaf)
        row = tplan.concat_shards(local)
        want = jplan.concat_shards([jnp.asarray(l) for l in local])
        if row is None:
            assert want is None
            continue
        np.testing.assert_array_equal(row, np.asarray(want))
        rows.append(row)
    _, rep = tplan.split_leaves(leaves)
    if rows:
        gathered = np.stack(rows)
        got = tplan.rebuild(gathered, rep)
        want = jplan.rebuild(jnp.asarray(gathered),
                             [jnp.asarray(r) for r in rep])
        for (path, g), w in zip(tsched.tree_paths(got),
                                jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=path)
        for (path, g), (_, nat) in zip(tsched.tree_paths(got),
                                       tsched.tree_paths(block_template)):
            np.testing.assert_array_equal(g, nat, err_msg=str(path))


# ---------------------------------------------------------------------------
# the stage-3 sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("threshold", [0, 500, 100_000])
def test_stage3_rules_match_jax(world, threshold):
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    jr = jpp.ZeroShardingRules(3, mesh,
                               param_persistence_threshold=threshold)
    tr = tpp.ZeroShardingRules(3, world,
                               param_persistence_threshold=threshold)
    for shape in [(251, 45), (45, 135), (135,), (180, 45), (45,), (1,),
                  (8, 16), (1000,), (3, 7), (), (600, 3)]:
        assert tr.param_spec(shape) == tuple(jr.param_spec(shape)), shape
        jpad, tpad = jr.param_pad_info(shape), tr.param_pad_info(shape)
        assert (jpad is None) == (tpad is None), shape
        if jpad is not None:
            assert (tpad.shape, tpad.numel, tpad.padded) == \
                (jpad.shape, jpad.numel, jpad.padded)
        assert tr.master_spec(shape) == tuple(jr.master_spec(shape))
        # a persisted leaf is one JAX keeps whole on every device
        replicated = all(a is None for a in jr.param_spec(shape)) and \
            jpad is None
        assert tr.param_persisted(shape) == replicated, shape


# ---------------------------------------------------------------------------
# the port's row layout
# ---------------------------------------------------------------------------

def _slices():
    from deeperspeed_tpu_torch.models import gpt_neox as neox
    model = neox.GPTNeoX(neox.GPTNeoXConfig(**SIZE), device="cpu")
    out, off = [], 0
    for name, p in model.named_parameters():
        out.append((name, off, off + p.numel(), tuple(p.shape)))
        off += p.numel()
    return out, off


@pytest.mark.parametrize("world,threshold,bucket", [
    (1, 500, 0), (2, 500, 0), (4, 500, 10485), (4, 0, 64),
    (2, 100_000, 0), (3, 200, 1000)])
def test_row_layout_covers_every_element_once(world, threshold, bucket):
    slices, n = _slices()
    rules = tpp.ZeroShardingRules(3, world,
                                  param_persistence_threshold=threshold)
    layout = Zero3Layout(slices, world, rules, bucket_bytes=bucket,
                         itemsize=4)
    natural = torch.arange(1, n + 1, dtype=torch.float64)
    parts = torch.stack([layout.to_partition(natural, r)
                         for r in range(world)])
    seen = np.zeros(n, np.int64)
    for r in range(world):
        for nat, loc, k in layout.segments(r):
            seen[nat:nat + k] += 1
    assert (seen == 1).all()
    # pads are zero, and every rank's partition has the same size
    assert int((parts != 0).sum()) == n
    torch.testing.assert_close(layout.to_natural(parts.reshape(-1)),
                               natural, rtol=0, atol=0)
    for row in layout.rows:
        assert row.padded % (world * 8) == 0
        assert sum(s for _, s in row.chunks) == row.shard
    # the rows follow the JAX flatten order of each layer's leaves
    for i, row in layout.layers.items():
        names = [leaf.name for leaf in row.leaves]
        assert names == sorted(names)
        assert all(nm.startswith(f"blocks.{i}.") for nm in names)
    persisted = {leaf.name for leaf in layout.persisted.leaves} \
        if layout.persisted else set()
    assert persisted == {nm for nm, lo, hi, shape in slices
                         if rules.param_persisted(shape)}
