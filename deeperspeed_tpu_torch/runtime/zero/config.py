"""The "zero_optimization" block → `DeepSpeedZeroConfig`.

The port of `deeperspeed_tpu/runtime/zero/config.py` for the stages the
port trains with: 0, 1 and 2, on one card or across data-parallel
ranks (stage 1 partitions the fp32 masters and moments, stage 2 the
gradient accumulator too; `runtime/engine.py`). The same keys, defaults
and errors as the JAX parser; stage 3, the offload sub-blocks (and
their deprecated boolean spellings) and the explicit collective
schedule raise `DeepSpeedConfigError` "not ported" (ROADMAP.md A.6).
"""

from dataclasses import dataclass

from ..config_utils import DeepSpeedConfigError, as_int, get_scalar_param
from . import constants as zc


def _not_ported(what):
    return DeepSpeedConfigError(
        f"zero_optimization: {what} is not ported yet (the port trains "
        f"with ZeRO stages 0-2; stage 3 and the offload tiers come with "
        f"A.6 and A.7, see ROADMAP.md)")


@dataclass(frozen=True)
class DeepSpeedZeroConfig:
    """The ZeRO stage and ``reduce_bucket_size``, the elements of each
    partition one stage-2 reduce-scatter moves at a time; the other
    bucket and overlap knobs are checked as the JAX parser checks them
    and otherwise have nothing to tune."""
    stage: int = zc.ZERO_OPTIMIZATION_STAGE_DEFAULT
    reduce_bucket_size: int = zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT

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

        stage = as_int(
            get_scalar_param(d, zc.ZERO_OPTIMIZATION_STAGE,
                             zc.ZERO_OPTIMIZATION_STAGE_DEFAULT),
            zc.ZERO_OPTIMIZATION_STAGE)
        if not 0 <= stage <= zc.MAX_STAGE_ZERO_OPTIMIZATION:
            raise DeepSpeedConfigError(
                f"ZeRO stage must be in [0, {zc.MAX_STAGE_ZERO_OPTIMIZATION}],"
                f" got {stage}")
        if stage == zc.ZERO_OPTIMIZATION_WEIGHTS:
            raise _not_ported("stage 3")
        for key in (zc.OFFLOAD_PARAM, zc.OFFLOAD_OPTIMIZER,
                    zc.ZERO_OPTIMIZATION_SCHEDULE):
            if d.get(key) is not None:
                raise _not_ported(f"'{key}'")
        for key in (zc.ZERO_OPTIMIZATION_CPU_OFFLOAD,
                    zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS):
            if d.get(key):
                raise _not_ported(f"'{key}'")
        for key in zc.SIZE_KEYS:
            if key in d and as_int(d[key], key) < 0:
                raise DeepSpeedConfigError(
                    f"zero_optimization.{key} must be >= 0, got "
                    f"{d[key]!r}")
        return cls(stage=stage, reduce_bucket_size=as_int(get_scalar_param(
            d, zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
            zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT),
            zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE))
