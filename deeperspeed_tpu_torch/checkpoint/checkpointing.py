"""Engine checkpoint save/load in the JAX package's directory layout.

The port of `deeperspeed_tpu/checkpoint/checkpointing.py`. Layout:

    {save_dir}/{tag}/mp_rank_00_model_states.pt
    {save_dir}/{tag}/zero_pp_rank_{dp}_mp_rank_00_optim_states.pt
    {save_dir}/{tag}/manifest.json
    {save_dir}/{tag}/zero_to_fp32.py
    {save_dir}/latest

Across data-parallel ranks each rank writes its own zero file,
``zero_pp_rank_{rank}``, in the JAX layout of a dp-``world`` engine:
every leaf of the masters and the moments sliced along the dimension the
JAX rules shard (`runtime.zero.partition_parameters`), a ragged leaf as
"flat" ranges of its raveled array, a leaf the rules replicate whole.
A rank holds one contiguous partition of the flat state, which cuts
across those slices, so the partitions are all-gathered (one role at a
time) before each rank cuts its own. Rank 0 writes the model states and
commits the manifest once every rank's file is written and
checksummed (the barrier of the JAX package's commit). Loads merge the
files of any saved world and copy this rank's partition: the elastic
resume of N saved ranks onto M. At ZeRO stage 3 a rank's partition is
its shard of every row of layers (`runtime.zero.stage3.Zero3Layout`):
the partitions are gathered and laid out in the natural order on the
device before the host copy, the files are the stage-2 layout with
``"zero_stage": 3``, and a load copies this rank's rows out of the
natural buffer, so a stage-2 and a stage-3 checkpoint load into either
engine, at any world.

The model-states file holds the module's parameters, the LR schedule,
the batch-size schedule, the dataloader position, the four counters, the
loss-scale state, the quantized FFN's amax history (``quantization_state``)
and the config. The zero file (written iff ZeRO is on or the compute dtype is
not fp32, the JAX engine's ``keep_master``) holds the fp32 masters and
the Adam state; otherwise the Adam state goes into the model-states
file. A JAX engine loads what the port writes and the port loads what a
JAX engine writes, at any data-parallel world on either side.

Saves are two-phase, as in the JAX package: `snapshot_checkpoint` copies
each flat buffer of the engine to the host once (the only part that
stalls training) and returns immutable host payloads; `write_and_commit`
turns them into a crash-consistent directory (`manifest.py`). Loads
verify the manifest and, when no tag is named, fall back to the newest
other committed checkpoint.

Loads write in place. The model's parameters are views into the
engine's flat compute buffer (and, with fp32 compute, that buffer is the
masters), so every leaf is copied into its slice of a host buffer and
each flat buffer gets one host-to-device copy; no engine tensor is
rebound.

Not ported: the streamed-NVMe, host-offload and pipeline checkpoints.
The port's config refuses those engines, and loading such a checkpoint
raises "not ported".
"""

import os
import shutil

import numpy as np
import torch

from ..runtime.config_utils import DeepSpeedConfigError
from ..runtime.fp16.loss_scaler import LossScaleState
from ..runtime.zero.partition_parameters import (ZeroShardingRules,
                                                 sharded_dim)
from ..runtime.zero.stage1 import gather_full
from ..utils.distributed import barrier, get_rank, get_world_size
from ..utils.logging import log_dist, logger
from . import manifest as mf
from .serialization import (load_obj, path_key, save_obj, shard_slice,
                            state_dict, to_tensor, unshard_concat)

LATEST_FILE = mf.LATEST_FILE
DS_VERSION = "0.3.15+tpu"

# model-state keys that are training state, not caller payload: both
# full and module-only loads exclude them from the returned client_state
_TRAINING_STATE_KEYS = ("module", "optimizer", "lr_scheduler",
                        "batch_size_scheduler", "dataloader",
                        "gradient_noise_scale", "quantization_state")


def _not_ported(what):
    return DeepSpeedConfigError(
        f"{what} is not ported yet (it comes with the scale-out slice, "
        f"offload tiers and pipeline; see ROADMAP.md A.7)")


def _model_states_name(mp_rank):
    return f"mp_rank_{mp_rank:02d}_model_states.pt"


def _zero_ckpt_name(dp_rank, mp_rank):
    return f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}_optim_states.pt"


class CheckpointTagMismatchError(RuntimeError):
    """Ranks tried to commit a checkpoint under different tags
    (``checkpoint.tag_validation`` "FAIL")."""


def check_checkpoint_tag_consistency(tag, fail=False, group=None):
    """Every rank saves under rank 0's tag: rank 0 broadcasts its tag
    over the process group and each rank compares (the JAX package's
    check through its coordination service). True when consistent or
    with one rank; on a mismatch warns, or raises
    `CheckpointTagMismatchError` where ``fail``."""
    tag = str(tag)
    if get_world_size(group) <= 1:
        return True
    import torch.distributed as dist
    box = [tag]
    dist.broadcast_object_list(box, src=0, group=group)
    if box[0] == tag:
        return True
    msg = (f"checkpoint tag mismatch across ranks: rank 0 is saving "
           f"{box[0]!r} but rank {get_rank(group)} is saving {tag!r}; the "
           f"per-rank files would land in different checkpoint "
           f"directories")
    if fail:
        raise CheckpointTagMismatchError(msg)
    logger.warning(msg)
    return False


def validate_checkpoint_tag(engine, tag):
    """The ``checkpoint.tag_validation`` knob's consumer."""
    cfg = engine._config
    if cfg.checkpoint_tag_validation_enabled:
        check_checkpoint_tag_consistency(
            tag, fail=cfg.checkpoint_tag_validation_fail,
            group=engine.dp_group)


# ---------------------------------------------------------------------------
# phase 1: snapshot (device → host; the only training stall)
# ---------------------------------------------------------------------------

def _host_flats(engine, flats):
    """One device-to-host copy of each flat buffer, as fp32, into host
    buffers the engine keeps across saves (pinned on a GPU). Returns
    when every copy is complete, so the next optimizer step, which
    writes the masters and moments in place, cannot reach the
    snapshot."""
    bufs = engine.__dict__.setdefault("_ckpt_host_buffers", {})
    cuda = engine.device.type == "cuda"
    part = engine._part
    out = {}
    for role, src in flats.items():
        if engine._z3 is not None:
            # every rank's rows, in the natural order
            src = engine._z3.gather_natural(src)
        elif engine._expert_range is not None:
            # every rank's experts: the whole model, in the natural order
            src = engine._ep_whole(src)
        elif part is not None and src.numel() == part.size:
            # a partition: every rank's, in rank order, one role at a
            # time on the device
            src = gather_full(src, part, engine.dp_group)
        buf = bufs.get(role)
        if buf is None:
            buf = bufs[role] = torch.empty(src.numel(), dtype=torch.float32,
                                           pin_memory=cuda)
        buf.copy_(src.float(), non_blocking=cuda)
        out[role] = buf
    if cuda:
        torch.cuda.synchronize(engine.device)
    return out


def _natural(engine, flat, prefix=""):
    """``{path key: numpy view}`` of one host flat buffer of the whole
    model, split in its natural layout (``natural_slices``)."""
    arr = flat.numpy()
    return {prefix + path_key(name): arr[lo:hi].reshape(shape)
            for name, lo, hi, shape in engine.natural_slices}


def _client_state_dict(engine, what):
    """A client optimizer's ``state_dict(state)`` (`engine.
    is_client_optimizer`), or a typed error where it has none."""
    fn = getattr(engine.optimizer, "state_dict", None)
    if fn is None or not hasattr(engine.optimizer, "load_state_dict"):
        raise DeepSpeedConfigError(
            f"{what} needs the client optimizer "
            f"{type(engine.optimizer).__name__} to have state_dict(state) "
            f"and load_state_dict(state_dict)")
    return {k: v for k, v in fn(engine.opt_state).items()
            if k != "param_groups"}


def _is_flat(engine, value):
    return torch.is_tensor(value) and value.numel() == engine.num_params


def _opt_flats(engine, client_sd):
    """{role: flat device tensor} of the optimizer state: Adam's (and
    Lamb's) moments, or the flat entries of a client's ``client_sd``
    under "opt/<key>"."""
    if client_sd is None:
        return {"exp_avg": engine.opt_state.exp_avg,
                "exp_avg_sq": engine.opt_state.exp_avg_sq}
    return {f"opt/{k}": v for k, v in client_sd.items()
            if _is_flat(engine, v)}


def _opt_arrays(engine, host, client_sd):
    """The optimizer state as the JAX package's checkpoint keys it: a
    flat entry split into natural leaves under "<key>/" (Adam's
    "exp_avg/...", a client's "momentum/..."), the rest (the step) as
    arrays."""
    if client_sd is None:
        arrays = {"step": np.asarray(engine.opt_state.step, np.int32)}
        arrays.update(_natural(engine, host["exp_avg"], "exp_avg/"))
        arrays.update(_natural(engine, host["exp_avg_sq"], "exp_avg_sq/"))
        return arrays
    arrays = {}
    for k, v in client_sd.items():
        if _is_flat(engine, v):
            arrays.update(_natural(engine, host[f"opt/{k}"], f"{k}/"))
        else:
            arrays[k] = np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                   else v)
    return arrays


def _param_groups(engine):
    return [dict(g) for g in engine.optimizer.param_groups]


def snapshot_checkpoint(engine, client_state=None):
    """``{relative path: payload}`` of the engine's current state, every
    array on the host. Once this returns, training may go on while a
    writer commits the payloads. Payloads are picklable objects (written
    with `save_obj`) or raw ``bytes``."""
    from ..runtime.engine import is_client_optimizer
    client_state = client_state or {}
    client_sd = _client_state_dict(engine, "save_checkpoint") \
        if is_client_optimizer(engine.optimizer) else None
    flats = {"params": engine._params_flat, **_opt_flats(engine, client_sd)}
    if engine._master is not engine._params_flat:
        flats["master"] = engine._master
    host = _host_flats(engine, flats)
    host.setdefault("master", host["params"])
    dataloader = engine.training_dataloader
    scale = engine.scale_state
    model_state = {
        # compute-dtype leaves as fp32 (exact for bf16); JAX casts back
        "module": state_dict(_natural(engine, host["params"])),
        "optimizer": None,
        "lr_scheduler": (engine.lr_scheduler.state_dict()
                         if engine.lr_scheduler is not None else None),
        "batch_size_scheduler": (engine.batch_size_scheduler.state_dict()
                                 if engine.batch_size_scheduler is not None
                                 else None),
        "dataloader": (dataloader.state_dict()
                       if dataloader is not None else None),
        "gradient_noise_scale": None,
        "csr_tensor_module_names": [],
        # the delayed-scaling FFN's amax history ({"amax", "ef": None}),
        # None when quantization.ffn is off: bit-exact resume needs it
        "quantization_state": engine._quant_state_dict(),
        "skipped_steps": engine.skipped_steps,
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "micro_steps": engine.micro_steps,
        "dp_world_size": engine.dp_world_size,
        "mp_world_size": engine.mp_world_size,
        "pipeline": None,
        "loss_scale_state": {
            "cur_scale": float(scale.cur_scale),
            "cur_iter": int(scale.cur_iter),
            "last_overflow_iter": int(scale.last_overflow_iter),
            "cur_hysteresis": int(scale.cur_hysteresis),
        },
        "ds_config": engine._config.param_dict,
        "ds_version": DS_VERSION,
    }
    model_state.update(client_state)
    if not engine.zero_optimization():
        model_state["optimizer"] = {
            "state": state_dict(_opt_arrays(engine, host, client_sd)),
            "param_groups": _param_groups(engine)}
    # rank 0 writes the rank-independent files, every rank its zero file
    payloads = {}
    if engine.dp_rank == 0:
        payloads[_model_states_name(0)] = model_state
        # ship the recovery script with the checkpoint, as the JAX
        # package does: fp32 weights come back later without the
        # framework
        from ..utils import zero_to_fp32 as _z2f
        with open(_z2f.__file__, "rb") as f:
            payloads["zero_to_fp32.py"] = f.read()
    if engine.keep_master:
        payloads.update(_zero_payloads(engine, host, client_sd))
    return payloads


def _zero_payloads(engine, host, client_sd):
    """This rank's zero file in the JAX layout of a dp-``world`` engine
    (`_jax_slices`): ``world`` is the data-parallel world from stage 1
    on, and 1 at stage 0, whose one file rank 0 writes, as the JAX
    package does."""
    stage = engine.zero_optimization_stage()
    dp = engine.dp_world_size if stage >= 1 else 1
    if engine.dp_rank >= dp:
        return {}
    rank = engine.dp_rank
    rules = ZeroShardingRules(stage, dp)
    opt, opt_dims, opt_shapes = _jax_slices(
        _opt_arrays(engine, host, client_sd), rules, rank)
    master, master_dims, master_shapes = _jax_slices(
        _natural(engine, host["master"]), rules, rank)
    return {_zero_ckpt_name(rank, 0): {
        "optimizer_state_dict": {
            "state": opt,
            "shard_dims": opt_dims,
            "flat_shapes": opt_shapes,
            "param_groups": _param_groups(engine),
        },
        "fp32_master": master,
        "fp32_master_dims": master_dims,
        "fp32_master_flat_shapes": master_shapes,
        "zero_stage": stage,
        "partition_count": dp,
        "dp_rank": rank,
    }}


def _jax_slices(arrays, rules, rank):
    """The JAX package's `_zero_payloads` slicing of natural arrays for
    dp rank ``rank``: (slices, dims, flat shapes). A leaf's dim is the
    one the rules shard, "flat" for a ragged leaf (rank ranges of its
    raveled array) or None (whole on every rank)."""
    dp = rules.world
    dims, out, shapes = {}, {}, {}
    for key, arr in arrays.items():
        arr = np.asarray(arr)
        if rules.master_pad_info(arr.shape) is not None:
            dims[key] = "flat"
            shapes[key] = tuple(arr.shape)
        else:
            dims[key] = sharded_dim(rules.master_spec(arr.shape))
        dim = dims[key]
        if dim is None or dp == 1:
            out[key] = arr
        elif dim == "flat":
            out[key] = np.ascontiguousarray(
                shard_slice(np.ravel(arr), dp, rank, 0))
        else:
            out[key] = np.ascontiguousarray(shard_slice(arr, dp, rank, dim))
    return out, dims, shapes


# ---------------------------------------------------------------------------
# phase 2: commit (file I/O only; the sync path and the async writer)
# ---------------------------------------------------------------------------

def write_and_commit(payloads, save_dir, tag, step, save_latest=True):
    """Write `payloads` into a staging dir, checksum-manifest + fsync +
    atomically rename it to ``{save_dir}/{tag}``, then flip ``latest``.
    A crash at any point leaves the previous committed state or the new
    one. Across ranks every rank writes its own payloads into rank 0's
    staging dir; rank 0 commits the manifest of every rank's files once
    all are written and flips ``latest`` after the commit barrier.
    Returns the bytes this rank wrote."""
    tag = str(tag)
    rank, world = get_rank(), get_world_size()
    staging = os.path.join(save_dir, mf.STAGING_PREFIX + tag)
    if rank == 0:
        os.makedirs(save_dir, exist_ok=True)
        if os.path.isdir(staging):  # leftover of a crashed earlier save
            shutil.rmtree(staging)
        os.makedirs(staging)
    barrier("deeperspeed_ckpt_staging")
    entries, nbytes = {}, 0
    for rel, payload in payloads.items():
        path = os.path.join(staging, rel)
        if isinstance(payload, (bytes, bytearray)):
            with open(path, "wb") as f:
                f.write(payload)
        else:
            save_obj(payload, path)
        mf._fsync_file(path)
        # checksum now, while the bytes are still in the page cache
        entries[rel] = mf.file_entry(path)
        nbytes += entries[rel]["bytes"]
    if world > 1:
        import torch.distributed as dist
        every = [None] * world
        dist.all_gather_object(every, entries)
        entries = {k: v for e in every for k, v in e.items()}
    if rank == 0:
        mf.commit_staged(save_dir, staging, tag, step, files=entries)
    # every rank's files are committed before anyone flips or reads
    # latest
    barrier("deeperspeed_ckpt_commit")
    if save_latest and rank == 0:
        mf.write_latest(save_dir, tag)
    barrier("deeperspeed_ckpt_latest")
    return nbytes


def save_checkpoint(engine, save_dir, tag=None, client_state=None,
                    save_latest=True):
    """Snapshot and commit inline, every rank under rank 0's tag where
    ``checkpoint.tag_validation`` asks it checked."""
    if tag is None:
        tag = f"global_step{engine.global_steps}"
    validate_checkpoint_tag(engine, tag)
    payloads = snapshot_checkpoint(engine, client_state)
    write_and_commit(payloads, save_dir, tag, step=engine.global_steps,
                     save_latest=save_latest)
    log_dist(f"Saved checkpoint {tag} to "
             f"{os.path.join(save_dir, str(tag))}", ranks=[0])
    return True


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _resolve_committed_state(load_dir, tag):
    """Verify the requested tag's manifest and read its model states;
    when resuming from `latest` (tag=None), fall back to the newest
    other committed checkpoint on corruption. A named tag that fails
    raises. Returns (tag, ckpt_dir, model_state) or (None, None,
    None)."""
    explicit_tag = tag is not None
    if tag is None:
        tag = mf.read_latest(load_dir)
        if tag is None:
            logger.warning(f"No '{LATEST_FILE}' file at "
                           f"{os.path.join(load_dir, LATEST_FILE)}; "
                           "cannot resume")
            return None, None, None

    candidates = [str(tag)]
    if not explicit_tag:
        candidates += [t for _, t in reversed(mf.committed_tags(load_dir))
                       if t != str(tag)]

    for cand in candidates:
        ckpt_dir = os.path.join(load_dir, cand)
        ok, problems = mf.verify_manifest(ckpt_dir)
        if not ok:
            if explicit_tag:
                raise RuntimeError(
                    f"checkpoint {cand} failed manifest verification: "
                    f"{'; '.join(problems[:3])}")
            logger.warning(
                f"Checkpoint {cand} failed manifest verification "
                f"({'; '.join(problems[:3])}); falling back to the "
                "previous committed checkpoint")
            continue
        model_path = os.path.join(ckpt_dir, _model_states_name(0))
        if not os.path.isfile(model_path):
            logger.warning(f"Checkpoint file {model_path} not found")
            continue
        try:
            model_state = load_obj(model_path)
        except Exception as e:  # torn legacy write (no manifest to catch)
            if explicit_tag:
                raise RuntimeError(
                    f"checkpoint {cand} is corrupt: failed to "
                    f"deserialize {model_path}") from e
            logger.warning(f"Failed to deserialize {model_path} "
                           f"({type(e).__name__}: {e})")
            continue
        if cand != str(tag):
            logger.warning(f"Resuming from fallback checkpoint {cand} "
                           f"instead of corrupt {tag}")
        return cand, ckpt_dir, model_state

    logger.warning(f"No loadable checkpoint under {load_dir}")
    return None, None, None


def _client_state(model_state):
    return {k: v for k, v in model_state.items()
            if k not in _TRAINING_STATE_KEYS}


def _module_arrays(model_state):
    if model_state.get("streamed_nvme"):
        raise _not_ported("a streamed-NVMe checkpoint")
    return model_state["module"]["arrays"]


def _copy_leaves(engine, dst, arrays, prefix=""):
    """Every leaf ``prefix + key`` of ``arrays`` into its slice of one
    host fp32 buffer, then one copy into the flat engine tensor ``dst``
    (cast to its dtype), in place: all of it, or this rank's partition
    where ``dst`` is one (at stage 3 its rows; the compute shard's copy
    also fills the persisted row; on an "expert" mesh this rank's rows
    of each whole expert leaf)."""
    part = engine._part
    z3 = engine._z3
    flat_n = part.padded if part is not None and z3 is None \
        else engine.num_params
    host = torch.zeros(flat_n, dtype=torch.float32)
    ep_lo = engine._expert_range[0] if engine._expert_range else None
    for name, lo, hi, shape in engine.param_slices:
        key = prefix + path_key(name)
        if key not in arrays:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        leaf = to_tensor(arrays[key])
        want = shape if ep_lo is None or lo < ep_lo else \
            (shape[0] * engine.ep,) + shape[1:]
        if tuple(leaf.shape) != want:
            raise ValueError(f"checkpoint leaf {key!r} has shape "
                             f"{tuple(leaf.shape)}, the model's is {want}")
        if want != shape:
            leaf = leaf[engine.dp_rank * shape[0]:
                        (engine.dp_rank + 1) * shape[0]]
        host[lo:hi] = leaf.reshape(-1)
    if z3 is not None:
        if dst is engine._params_flat:
            z3.load_natural(host.to(engine.device))
        else:
            dst.copy_(z3.layout.to_partition(host, engine.dp_rank))
        return
    if part is not None and dst.numel() == part.size:
        host = host[part.lo:part.hi]
    dst.copy_(host)


def _load_opt_arrays(engine, arrays, param_groups):
    from ..runtime.engine import is_client_optimizer
    if is_client_optimizer(engine.optimizer):
        # the client's own state_dict says which entries are flat; each
        # is read into a copy of it, then handed to load_state_dict
        sd = {}
        for k, v in _client_state_dict(engine, "load_checkpoint").items():
            if _is_flat(engine, v):
                sd[k] = torch.empty_like(v)
                _copy_leaves(engine, sd[k], arrays, f"{k}/")
            else:
                if k not in arrays:
                    raise KeyError(f"checkpoint missing optimizer entry "
                                   f"{k!r}")
                sd[k] = arrays[k].item() if np.ndim(arrays[k]) == 0 \
                    else torch.as_tensor(np.asarray(arrays[k]))
        sd["param_groups"] = [dict(g) for g in param_groups]
        engine.opt_state = engine.optimizer.load_state_dict(sd)
    else:
        _copy_leaves(engine, engine.opt_state.exp_avg, arrays, "exp_avg/")
        _copy_leaves(engine, engine.opt_state.exp_avg_sq, arrays,
                     "exp_avg_sq/")
        engine.opt_state = engine.opt_state._replace(
            step=int(np.asarray(arrays["step"])))
    engine.optimizer.param_groups = [dict(g) for g in param_groups]


def load_checkpoint(engine, load_dir, tag=None, load_optimizer_states=True,
                    load_lr_scheduler_states=True,
                    load_dataloader_states=True, module_only=False):
    cand, ckpt_dir, model_state = _resolve_committed_state(load_dir, tag)
    if cand is None:
        return None, {}
    if module_only:
        # the parameters only: optimizer moments, schedules, dataloader
        # position, loss scale and counters stay as they are
        _copy_leaves(engine, engine._params_flat, _module_arrays(model_state))
        if engine._params_flat is not engine._master:
            logger.warning(
                "module_only load on an engine with fp32 masters: the "
                "next train step overwrites params from the (stale) "
                "masters — use module_only for evaluation/serving only")
        log_dist(f"Loaded module-only checkpoint {cand} from {load_dir}",
                 ranks=[0])
        return os.path.join(load_dir, cand), _client_state(model_state)
    return _apply_checkpoint(engine, load_dir, cand, ckpt_dir, model_state,
                             load_optimizer_states, load_lr_scheduler_states,
                             load_dataloader_states)


def load_module_checkpoint(load_dir, tag=None, like=None):
    """Engine-free parameters-only load (serving restarts): the same
    manifest verification and committed-tag fallback as
    `load_checkpoint`, returning ``{dotted name: tensor}`` for
    ``model.load_state_dict``; ``like`` (the names, or a state dict)
    picks and requires the leaves. Returns (path, params, client_state)
    or (None, None, {})."""
    cand, _, model_state = _resolve_committed_state(load_dir, tag)
    if cand is None:
        return None, None, {}
    arrays = _module_arrays(model_state)
    names = list(like) if like is not None else \
        [k.replace("/", ".") for k in arrays]
    params = {}
    for name in names:
        if path_key(name) not in arrays:
            raise KeyError(f"checkpoint missing parameter "
                           f"{path_key(name)!r}")
        params[name] = to_tensor(arrays[path_key(name)])
    log_dist(f"Loaded module-only checkpoint {cand} from {load_dir}",
             ranks=[0])
    return os.path.join(load_dir, cand), params, _client_state(model_state)


def _apply_checkpoint(engine, load_dir, tag, ckpt_dir, model_state,
                      load_optimizer_states, load_lr_scheduler_states,
                      load_dataloader_states=True):
    if model_state.get("pipeline"):
        raise _not_ported("a pipeline checkpoint")
    saved_mp = model_state.get("mp_world_size")
    if saved_mp is not None and int(saved_mp) != engine.mp_world_size:
        raise _not_ported(f"a checkpoint saved at model-parallel world "
                          f"{saved_mp}")
    saved_dp = model_state.get("dp_world_size")
    if saved_dp is not None and int(saved_dp) != engine.dp_world_size and \
            engine.expert_mesh:
        raise DeepSpeedConfigError(
            f"an elastic resume of experts sharded over an \"expert\" "
            f"mesh (saved at world {saved_dp}, resumed at "
            f"{engine.dp_world_size}) is not ported yet (ROADMAP.md A.6)")
    if saved_dp is not None and int(saved_dp) != engine.dp_world_size:
        log_dist(f"elastic resume: dp world size changed {saved_dp} -> "
                 f"{engine.dp_world_size}; the zero shards merge and each "
                 f"rank takes its partition", ranks=[0])

    # --- params, then masters and moments --------------------------------
    _copy_leaves(engine, engine._params_flat, _module_arrays(model_state))
    if load_optimizer_states:
        if engine.keep_master:
            _load_zero_checkpoint(engine, ckpt_dir)
        elif model_state.get("optimizer"):
            _load_opt_arrays(engine, model_state["optimizer"]["state"]
                             ["arrays"],
                             model_state["optimizer"]["param_groups"])

    # --- schedules, dataloader, counters ---------------------------------
    if load_lr_scheduler_states and engine.lr_scheduler is not None and \
            model_state.get("lr_scheduler") is not None:
        engine.lr_scheduler.load_state_dict(model_state["lr_scheduler"])
    if engine.batch_size_scheduler is not None and \
            model_state.get("batch_size_scheduler") is not None:
        engine.batch_size_scheduler.load_state_dict(
            model_state["batch_size_scheduler"])
    # load_dataloader_states=False: the sentinel's rollback keeps the
    # loader at its CURRENT position (already past the quarantined
    # window) instead of rewinding it to the checkpoint's offset
    dataloader = engine.training_dataloader
    if load_dataloader_states and dataloader is not None and \
            model_state.get("dataloader") is not None:
        try:
            dataloader.load_state_dict(model_state["dataloader"])
        except ValueError as e:
            kept = dataloader.reconcile_state_dict(model_state["dataloader"])
            logger.warning(
                f"dataloader position not restored exactly ({e}); "
                f"reconciled under the current topology instead: {kept}")

    engine.global_steps = model_state.get("global_steps", 0)
    engine.global_samples = model_state.get("global_samples", 0)
    engine.skipped_steps = model_state.get("skipped_steps", 0)
    engine.micro_steps = model_state.get("micro_steps", 0)
    ls = model_state.get("loss_scale_state", {})
    engine.scale_state = LossScaleState(
        cur_scale=float(ls.get("cur_scale", 1.0)),
        cur_iter=int(ls.get("cur_iter", 0)),
        last_overflow_iter=int(ls.get("last_overflow_iter", -1)),
        cur_hysteresis=int(ls.get("cur_hysteresis", 1)))
    # the quantization state, with the JAX engine's rules and warnings
    engine._restore_quant_state(model_state.get("quantization_state"))
    log_dist(f"Loaded checkpoint {tag} from {load_dir}", ranks=[0])
    return os.path.join(load_dir, str(tag)), _client_state(model_state)


def _merge(flats, dims, saved_dp, flat_shapes=None):
    """Per-rank ``{key: slice}`` dicts → whole natural-shaped arrays.
    A dim of "flat" marks a ragged leaf saved as rank slices of its
    raveled array; ``flat_shapes`` gives its shape back."""
    out = {}
    for key in flats[0]:
        dim = dims.get(key) if dims else None
        if dim is None or saved_dp == 1:
            out[key] = flats[0][key]
        elif dim == "flat":
            merged = unshard_concat([np.asarray(f[key]) for f in flats], 0)
            out[key] = merged.reshape((flat_shapes or {})[key])
        else:
            out[key] = unshard_concat([np.asarray(f[key]) for f in flats],
                                      dim)
    return out


def _load_zero_checkpoint(engine, ckpt_dir):
    """Merge the per-dp-rank zero files (written at any data-parallel
    world size and ZeRO stage) and copy the masters and the Adam state
    into the engine's flat buffers (this rank's partition of them at
    stages 1-3)."""
    shards = []
    while True:
        path = os.path.join(ckpt_dir, _zero_ckpt_name(len(shards), 0))
        if not os.path.isfile(path):
            break
        shards.append(load_obj(path))
    if not shards:
        logger.warning(f"No zero checkpoint files in {ckpt_dir}")
        return
    osd = shards[0]["optimizer_state_dict"]
    if osd.get("host_offload"):
        raise _not_ported("a host-offload (ZeRO-Offload) checkpoint")
    saved_dp = shards[0]["partition_count"]
    opt = _merge([s["optimizer_state_dict"]["state"] for s in shards],
                 osd.get("shard_dims", {}), saved_dp,
                 osd.get("flat_shapes"))
    if shards[0].get("fp32_master") is not None:
        master = _merge([s["fp32_master"] for s in shards],
                        shards[0].get("fp32_master_dims", {}), saved_dp,
                        shards[0].get("fp32_master_flat_shapes"))
        _copy_leaves(engine, engine._master, master)
    if opt:
        _load_opt_arrays(engine, opt, osd["param_groups"])
