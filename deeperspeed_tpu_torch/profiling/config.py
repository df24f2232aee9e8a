""""flops_profiler" config block (reference: `deepspeed/profiling/
constants.py`, `config.py`): the port of
`deeperspeed_tpu/profiling/config.py`, with its keys and defaults."""

from dataclasses import dataclass

from ..runtime.config_utils import as_int, get_scalar_param

FLOPS_PROFILER = "flops_profiler"
FLOPS_PROFILER_ENABLED = "enabled"
FLOPS_PROFILER_ENABLED_DEFAULT = False
FLOPS_PROFILER_PROFILE_STEP = "profile_step"
FLOPS_PROFILER_PROFILE_STEP_DEFAULT = 1
FLOPS_PROFILER_MODULE_DEPTH = "module_depth"
FLOPS_PROFILER_MODULE_DEPTH_DEFAULT = -1
FLOPS_PROFILER_TOP_MODULES = "top_modules"
FLOPS_PROFILER_TOP_MODULES_DEFAULT = 3
FLOPS_PROFILER_DETAILED = "detailed"
FLOPS_PROFILER_DETAILED_DEFAULT = True


@dataclass(frozen=True)
class DeepSpeedFlopsProfilerConfig:
    enabled: bool = FLOPS_PROFILER_ENABLED_DEFAULT
    profile_step: int = FLOPS_PROFILER_PROFILE_STEP_DEFAULT
    module_depth: int = FLOPS_PROFILER_MODULE_DEPTH_DEFAULT
    top_modules: int = FLOPS_PROFILER_TOP_MODULES_DEFAULT
    detailed: bool = FLOPS_PROFILER_DETAILED_DEFAULT

    @classmethod
    def from_dict(cls, param_dict):
        d = param_dict.get(FLOPS_PROFILER) or {}
        return cls(
            enabled=bool(get_scalar_param(
                d, FLOPS_PROFILER_ENABLED, FLOPS_PROFILER_ENABLED_DEFAULT)),
            profile_step=as_int(get_scalar_param(
                d, FLOPS_PROFILER_PROFILE_STEP,
                FLOPS_PROFILER_PROFILE_STEP_DEFAULT),
                FLOPS_PROFILER_PROFILE_STEP),
            module_depth=as_int(get_scalar_param(
                d, FLOPS_PROFILER_MODULE_DEPTH,
                FLOPS_PROFILER_MODULE_DEPTH_DEFAULT),
                FLOPS_PROFILER_MODULE_DEPTH),
            top_modules=as_int(get_scalar_param(
                d, FLOPS_PROFILER_TOP_MODULES,
                FLOPS_PROFILER_TOP_MODULES_DEFAULT),
                FLOPS_PROFILER_TOP_MODULES),
            detailed=bool(get_scalar_param(
                d, FLOPS_PROFILER_DETAILED, FLOPS_PROFILER_DETAILED_DEFAULT)),
        )
