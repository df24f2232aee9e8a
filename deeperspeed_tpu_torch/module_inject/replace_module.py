"""Inference-side parameter preparation for the serving engine.

The port of `prepare_inference_params` in
`deeperspeed_tpu/module_inject/replace_module.py`: every matmul weight
(ndim >= 2) is cast to the serving compute dtype once at load, so no
step pays a per-call cast; 1-D leaves (norm scales and biases,
projection biases) stay in fp32 for accumulation quality. With
``weight_quant="int8"`` the block matmul weights rest as int8 with
per-output-channel fp32 scales (`ops.hopper.quant_matmul`).
"""

import torch

from ..ops.hopper.quant_matmul import quantize_weight


def prepare_inference_params(params, dtype, weight_quant=None,
                             device=None):
    """``{name: tensor}`` → ``{name: tensor}`` with ndim >= 2 leaves at
    ``dtype`` and 1-D leaves at fp32, on ``device`` (default: where they
    are). The tensors are fresh copies or the originals when nothing
    changes; the caller's module is never modified.

    ``weight_quant="int8"`` (the ``quantization.weights`` choice) turns
    the ndim >= 2 leaves under ``blocks.`` into `QuantizedWeight`s,
    quantized from their compute-dtype values: int8 at rest, dequantized
    inside the matmul kernel. The embedding, LM head and final norm stay
    at the compute dtype (the embedding is also a gather table)."""
    if weight_quant not in (None, "int8"):
        raise ValueError(
            f"weight_quant must be None or 'int8', got {weight_quant!r}")
    if weight_quant and not any(n.startswith("blocks.") for n in params):
        raise ValueError(
            "weight_quant='int8' quantizes the block matmul weights and "
            "needs params with 'blocks.' entries (the GPT-NeoX / GPT-2 "
            "family layout)")
    out = {}
    for name, leaf in params.items():
        target = dtype if leaf.dim() >= 2 else torch.float32
        leaf = leaf.detach().to(device=device, dtype=target)
        if weight_quant and leaf.dim() >= 2 and name.startswith("blocks."):
            leaf = quantize_weight(leaf)
        out[name] = leaf
    return out
