from .profiler import (FlopsProfiler, count_train_flops, duration_to_string,
                       flops_to_string, get_model_profile, params_count,
                       params_to_string, profile_fn)

__all__ = ["FlopsProfiler", "count_train_flops", "duration_to_string",
           "flops_to_string", "get_model_profile", "params_count",
           "params_to_string", "profile_fn"]
