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


def check_fp16_ported(device, dtype, sparse_attention=False,
                      int8_weights=False, int8_kv=False):
    """Refuse, before any launch, what fp16 on the GPU does not have yet:
    the block-sparse kernel (sparse attention) and the int8 matmul and
    int8 paged-decode kernels take fp32 and bf16 only. The CPU runs every
    plain version in fp16, so nothing is refused there."""
    if torch.device(device).type != "cuda" or dtype != torch.float16:
        return
    what = [name for name, on in (
        ("sparse attention (the block-sparse kernel)", sparse_attention),
        ("int8 weights (the int8 matmul kernel)", int8_weights),
        ("int8 KV pages (the int8 paged-decode kernel)", int8_kv)) if on]
    if what:
        raise DeepSpeedConfigError(
            f"fp16 on the GPU with {' and '.join(what)} is not ported yet: "
            f"those kernels are built for fp32 and bf16 (see ROADMAP.md)")
