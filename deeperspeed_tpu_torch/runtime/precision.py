"""Precision resolution: config spellings → torch dtypes.

The port's counterpart of `deeperspeed_tpu/runtime/precision.py`: the
same spellings (`constants.PRECISION_TYPES`) map to torch dtypes.
"""

import torch

from .config_utils import DeepSpeedConfigError
from .constants import INFERENCE_KV_DTYPE_CHOICES, PRECISION_TYPES

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}


def resolve_precision(type_str):
    """Map a precision spelling ("bf16", "fp32", ...) to a torch dtype."""
    canonical = PRECISION_TYPES.get(str(type_str).lower())
    if canonical is None:
        raise DeepSpeedConfigError(
            f"Unknown precision type {type_str!r}; expected one of "
            f"{sorted(PRECISION_TYPES)}")
    return _DTYPES[canonical]


def resolve_kv_cache_dtype(type_str):
    """Map an "inference.kv_cache_dtype" spelling to a torch POOL dtype:
    the float spellings plus ``"int8"`` (quantized pages with bf16
    per-slot scales, `inference.kv_cache.QuantizedPages`)."""
    s = str(type_str).lower()
    if s not in INFERENCE_KV_DTYPE_CHOICES:
        raise DeepSpeedConfigError(
            f"Unknown kv_cache_dtype {type_str!r}; expected one of "
            f"{sorted(INFERENCE_KV_DTYPE_CHOICES)}")
    if s == "int8":
        return torch.int8
    return resolve_precision(s)

