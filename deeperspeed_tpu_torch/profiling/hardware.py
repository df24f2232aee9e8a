"""Per-device hardware peaks (shared by the in-engine telemetry layer,
`runtime/telemetry.py`, and the flops profiler's reports).

The port of `deeperspeed_tpu/profiling/hardware.py`: one table, several
consumers, so they can never disagree about what "peak" means for a
card. The JAX table's TPU rows and its interconnect table (the schedule
planner's) have no counterpart here.

Import-light on purpose: callers hand in a `torch.device`, a device
index or a name string; nothing here initializes CUDA unless a CUDA
device is named.
"""

# dense bf16 / fp16 tensor-core peak flop/s by card, matched as
# substrings against the lowercased device name. NVIDIA H100 80GB HBM3
# (SXM5) at its 700 W limit: 989 TFLOP/s dense (the published sheet's
# 1979 is with 2:4 sparsity).
PEAK_FLOPS_BY_NAME = {
    "h100": 989e12,
}

# An unknown device (the CPU of the tests, a card without a row)
# resolves to the H100 row: the MFU scalars of a CPU run are
# meaningless but well-defined.
PEAK_FLOPS_DEFAULT = PEAK_FLOPS_BY_NAME["h100"]


def device_name(device):
    """The device's name: `torch.cuda.get_device_name` for a CUDA device
    (a `torch.device`, an index), the string itself for a string that
    names no device type, else the device's ``str``."""
    import torch
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return device
    if isinstance(device, int):
        device = torch.device("cuda", device)
    if isinstance(device, torch.device) and device.type == "cuda" and \
            torch.cuda.is_available():
        return torch.cuda.get_device_name(device)
    return str(device)


def peak_flops_per_chip(device):
    """Dense bf16 peak flop/s of a device (or a device-name string)."""
    name = (device_name(device) if device is not None else "").lower()
    for key, val in PEAK_FLOPS_BY_NAME.items():
        if key in name:
            return val
    return PEAK_FLOPS_DEFAULT
