"""Inference-side parameter preparation for the serving engine.

The port of `prepare_inference_params` in
`deeperspeed_tpu/module_inject/replace_module.py`: every matmul weight
(ndim >= 2) is cast to the serving compute dtype once at load, so no
step pays a per-call cast; 1-D leaves (norm scales and biases,
projection biases) stay in fp32 for accumulation quality.
"""

import torch


def prepare_inference_params(params, dtype, weight_quant=None,
                             device=None):
    """``{name: tensor}`` → ``{name: tensor}`` with ndim >= 2 leaves at
    ``dtype`` and 1-D leaves at fp32, on ``device`` (default: where they
    are). The tensors are fresh copies or the originals when nothing
    changes; the caller's module is never modified."""
    if weight_quant is not None:
        raise NotImplementedError(
            f"quantization.weights={weight_quant!r} is not ported yet "
            f"(serving-quant slice: the int8 weight matmul kernel)")
    out = {}
    for name, leaf in params.items():
        target = dtype if leaf.dim() >= 2 else torch.float32
        out[name] = leaf.detach().to(device=device, dtype=target)
    return out
