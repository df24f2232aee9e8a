"""Config parsing helpers (reference: `deepspeed/runtime/config_utils.py`)."""

import json


class DeepSpeedConfigError(Exception):
    """Raised when a config file is malformed or internally inconsistent."""


def _reject_duplicate_keys(pairs):
    seen = {}
    for key, value in pairs:
        if key in seen:
            raise DeepSpeedConfigError(
                f"Duplicate key '{key}' in DeepSpeed config JSON")
        seen[key] = value
    return seen


def load_config_json(path):
    """Load a config JSON file, rejecting duplicate keys."""
    with open(path, "r") as f:
        return json.load(f, object_pairs_hook=_reject_duplicate_keys)


def loads_config_json(text):
    return json.loads(text, object_pairs_hook=_reject_duplicate_keys)


def get_scalar_param(param_dict, param_name, param_default_value):
    return param_dict.get(param_name, param_default_value)


def get_dict_param(param_dict, param_name):
    value = param_dict.get(param_name)
    return dict(value) if isinstance(value, dict) else None


def as_int(value, name):
    """Coerce JSON numerics like 5e8 to int; reject non-integral values."""
    if value is None or isinstance(value, bool):
        raise DeepSpeedConfigError(f"'{name}' must be an integer, got {value!r}")
    try:
        ivalue = int(value)
    except (TypeError, ValueError):
        raise DeepSpeedConfigError(
            f"'{name}' must be an integer, got {value!r}") from None
    if float(ivalue) != float(value):
        raise DeepSpeedConfigError(
            f"'{name}' must be integral, got {value!r}")
    return ivalue


def strict_positive_int(param_dict, key, default, scope):
    """Checkpoint-block-strict positive-int knob: coerces JSON numerics,
    rejects < 1. ``scope`` prefixes the error ('aio',
    'zero_optimization.offload_param', ...)."""
    value = as_int(get_scalar_param(param_dict, key, default),
                   f"{scope}.{key}")
    if value < 1:
        raise DeepSpeedConfigError(
            f"'{scope}.{key}' must be a positive integer, got {value}")
    return value


def strict_bool(param_dict, key, default, scope):
    """Checkpoint-block-strict boolean knob: only real JSON booleans
    pass ('true'/1 must not silently truthy-coerce)."""
    value = get_scalar_param(param_dict, key, default)
    if not isinstance(value, bool):
        raise DeepSpeedConfigError(
            f"'{scope}.{key}' must be a boolean, got {value!r}")
    return value


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Alias kept for parity with the reference helper name."""
    return _reject_duplicate_keys(ordered_pairs)
