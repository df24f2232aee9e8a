"""The "zero_optimization" block → `DeepSpeedZeroConfig`.

The port of `deeperspeed_tpu/runtime/zero/config.py`: stages 0-3 on one
card or across data-parallel ranks (stage 1 partitions the fp32 masters
and moments, stage 2 the gradient accumulator too, stage 3 the
compute-dtype parameters as well; `runtime/engine.py`,
`runtime/zero/stage3.py`), the stage-3 knobs and the "schedule"
sub-block (`_parse_schedule_block`). The same keys, defaults and errors
as the JAX parser; the offload sub-blocks (and their deprecated boolean
spellings) raise `DeepSpeedConfigError` "not ported" (ROADMAP.md A.7).
"""

from dataclasses import dataclass, field

from ...parallel.schedule import SCHEDULE_MODES, ScheduleConfig
from ..config_utils import DeepSpeedConfigError, as_int, get_scalar_param
from . import constants as zc


def _not_ported(what):
    return DeepSpeedConfigError(
        f"zero_optimization: {what} is not ported yet (the port trains "
        f"with ZeRO stages 0-3 on the card; the offload tiers come with "
        f"A.7, see ROADMAP.md)")


def _parse_schedule_block(d, stage):
    """Parse and check ``zero_optimization.schedule`` at checkpoint-block
    strictness, with the JAX parser's defaults and messages: unknown keys
    and bad values raise with the valid choices listed."""
    sched = d.get(zc.ZERO_OPTIMIZATION_SCHEDULE)
    if sched is None:
        sched = {}
    if not isinstance(sched, dict):
        # only None means "absent": a falsy wrong type ([] / 0 / false)
        # must not fall back to the gspmd default
        raise DeepSpeedConfigError(
            f"zero_optimization.{zc.ZERO_OPTIMIZATION_SCHEDULE} must be "
            f"a dict, got {sched!r}")
    known = {"mode", "prefetch_depth", "bucket_mb", "group_layers",
             "remat"}
    unknown = sorted(set(sched) - known)
    if unknown:
        raise DeepSpeedConfigError(
            f"Unknown 'zero_optimization.schedule' key(s) {unknown}; "
            f"valid keys: {sorted(known)}")
    mode = str(sched.get("mode", "gspmd"))
    if mode not in SCHEDULE_MODES:
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.mode must be one of "
            f"{list(SCHEDULE_MODES)} (gspmd = partitioner-scheduled "
            f"collectives, explicit = shard_map schedule with "
            f"layer-ahead prefetch), got {mode!r}")
    if mode == "explicit" and stage != 3:
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.mode \"explicit\" requires "
            f"stage 3 (it schedules the stage-3 parameter all-gathers); "
            f"got stage {stage}")
    prefetch_depth = as_int(sched.get("prefetch_depth", 1),
                            "zero_optimization.schedule.prefetch_depth")
    if prefetch_depth < 1:
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.prefetch_depth must be >= 1 "
            f"(layers gathered ahead of compute), got {prefetch_depth}")
    try:
        bucket_mb = float(sched.get("bucket_mb", 32))
    except (TypeError, ValueError):
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.bucket_mb must be a number "
            f"(max MB per all-gather bucket), got "
            f"{sched.get('bucket_mb')!r}")
    if not bucket_mb > 0:
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.bucket_mb must be > 0, got "
            f"{bucket_mb}")
    group_layers = as_int(sched.get("group_layers", 4),
                          "zero_optimization.schedule.group_layers")
    if group_layers < 1:
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.group_layers must be >= 1 "
            f"(layers per remat/prefetch group), got {group_layers}")
    remat = sched.get("remat", True)
    if not isinstance(remat, bool):
        raise DeepSpeedConfigError(
            f"zero_optimization.schedule.remat must be a boolean "
            f"(True = backward re-gathers params, False = keep gathered "
            f"buffers as residuals), got {remat!r}")
    return ScheduleConfig(mode=mode, prefetch_depth=prefetch_depth,
                          bucket_mb=bucket_mb, group_layers=group_layers,
                          remat=remat)


def _int(d, key, default):
    return as_int(get_scalar_param(d, key, default), key)


def _bool(d, key, default):
    return bool(get_scalar_param(d, key, default))


@dataclass(frozen=True)
class DeepSpeedZeroConfig:
    """The parsed block. ``reduce_bucket_size`` is the elements of each
    partition one stage-2 reduce-scatter moves at a time; the stage-3
    schedule reads ``schedule`` and ``param_persistence_threshold``; the
    other bucket, overlap and fetch knobs are checked and kept as the
    JAX parser keeps them (hints there too)."""
    stage: int = zc.ZERO_OPTIMIZATION_STAGE_DEFAULT
    contiguous_gradients: bool = \
        zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT
    reduce_scatter: bool = zc.ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT
    reduce_bucket_size: int = zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT
    allgather_partitions: bool = \
        zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT
    allgather_bucket_size: int = \
        zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT
    overlap_comm: bool = False
    load_from_fp32_weights: bool = \
        zc.ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT
    elastic_checkpoint: bool = zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT
    offload_param: object = None
    offload_optimizer: object = None
    sub_group_size: int = zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT
    max_live_parameters: int = \
        zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT
    max_reuse_distance: int = zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT
    prefetch_bucket_size: int = \
        zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT
    param_persistence_threshold: int = \
        zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT
    gather_fp16_weights_on_model_save: bool = \
        zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)

    @property
    def enabled(self):
        return self.stage > zc.ZERO_OPTIMIZATION_DISABLED

    @classmethod
    def from_dict(cls, param_dict):
        d = param_dict.get(zc.ZERO_OPTIMIZATION)
        # Legacy form: "zero_optimization": true  (== stage 1).
        if d is True:
            d = {zc.ZERO_OPTIMIZATION_STAGE: 1}
        elif d is None or d is False:
            d = {}
        elif not isinstance(d, dict):
            raise DeepSpeedConfigError(
                f"'{zc.ZERO_OPTIMIZATION}' must be a dict or bool, got {d!r}")

        stage = _int(d, zc.ZERO_OPTIMIZATION_STAGE,
                     zc.ZERO_OPTIMIZATION_STAGE_DEFAULT)
        if not 0 <= stage <= zc.MAX_STAGE_ZERO_OPTIMIZATION:
            raise DeepSpeedConfigError(
                f"ZeRO stage must be in [0, {zc.MAX_STAGE_ZERO_OPTIMIZATION}],"
                f" got {stage}")
        for key in (zc.OFFLOAD_PARAM, zc.OFFLOAD_OPTIMIZER):
            if d.get(key) is not None:
                raise _not_ported(f"'{key}'")
        for key in (zc.ZERO_OPTIMIZATION_CPU_OFFLOAD,
                    zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS):
            if d.get(key):
                raise _not_ported(f"'{key}'")
        overlap_default = (zc.ZERO3_OPTIMIZATION_OVERLAP_COMM_DEFAULT
                           if stage == 3 else
                           zc.ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT)
        allgather_bucket = get_scalar_param(
            d, zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
            d.get(zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEPRECATED,
                  zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT))
        for key in zc.SIZE_KEYS:
            if key in d and as_int(d[key], key) < 0:
                raise DeepSpeedConfigError(
                    f"zero_optimization.{key} must be >= 0, got "
                    f"{d[key]!r}")
        return cls(
            stage=stage,
            contiguous_gradients=_bool(
                d, zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
                zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT),
            reduce_scatter=_bool(d, zc.ZERO_OPTIMIZATION_REDUCE_SCATTER,
                                 zc.ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT),
            reduce_bucket_size=_int(
                d, zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
                zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT),
            allgather_partitions=_bool(
                d, zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
                zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT),
            allgather_bucket_size=as_int(
                allgather_bucket, zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE),
            overlap_comm=_bool(d, zc.ZERO_OPTIMIZATION_OVERLAP_COMM,
                               overlap_default),
            load_from_fp32_weights=_bool(
                d, zc.ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS,
                zc.ZERO_OPTIMIZATION_LOAD_FROM_FP32_WEIGHTS_DEFAULT),
            elastic_checkpoint=_bool(
                d, zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
                zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT),
            sub_group_size=_int(d, zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE,
                                zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT),
            max_live_parameters=_int(
                d, zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS,
                zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT),
            max_reuse_distance=_int(
                d, zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE,
                zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT),
            prefetch_bucket_size=_int(
                d, zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE,
                zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT),
            param_persistence_threshold=_int(
                d, zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD,
                zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT),
            gather_fp16_weights_on_model_save=_bool(
                d, zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE,
                zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT),
            schedule=_parse_schedule_block(d, stage),
        )
