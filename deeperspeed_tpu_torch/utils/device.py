"""The device the port's entry points run on."""

import torch


def resolve_device(device, what):
    """``device`` as a `torch.device`; None means the GPU.

    The port's entry points (`GPTNeoX`, `InferenceEngine`) run on the
    card unless the caller asks for the CPU (``device="cpu"``). None
    without CUDA raises instead of carrying on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on the GPU by default and CUDA is not "
                f"available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)
