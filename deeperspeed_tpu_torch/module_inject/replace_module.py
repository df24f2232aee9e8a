"""Model surgery: the port of
`deeperspeed_tpu/module_inject/replace_module.py`.

`prepare_inference_params` prepares the serving engine's parameters:
every matmul weight (ndim >= 2) is cast to the serving compute dtype
once at load, so no step pays a per-call cast; 1-D leaves (norm scales
and biases, projection biases) stay in fp32 for accumulation quality.
With ``weight_quant="int8"`` the block matmul weights rest as int8 with
per-output-channel fp32 scales (`ops.hopper.quant_matmul`).

`replace_transformer_layer` swaps HuggingFace BERT-style layers for the
fused `DeepSpeedTransformerLayer`: each `BertLayer`'s weights are copied
(torch to torch, transposed to the ``[in, out]`` layout) into a fused
layer, and the result is the JAX function's (layers, params_list,
encoder_fn) triple.
"""

import torch

from ..ops.hopper.quant_matmul import quantize_weight
from ..ops.transformer import (DeepSpeedTransformerConfig,
                               DeepSpeedTransformerLayer)


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


def _t(x):
    return x.detach()


def extract_bert_layer_params(bert_layer):
    """HF `BertLayer` → `DeepSpeedTransformerLayer` parameter dict (fresh
    tensors, ``[in, out]`` weights, QKV as [Q | K | V] column blocks)."""
    attn = bert_layer.attention
    selfattn = attn.self
    return {
        "attn_qkvw": torch.cat([_t(selfattn.query.weight).T,
                                _t(selfattn.key.weight).T,
                                _t(selfattn.value.weight).T], dim=1),
        "attn_qkvb": torch.cat([_t(selfattn.query.bias),
                                _t(selfattn.key.bias),
                                _t(selfattn.value.bias)]),
        "attn_ow": _t(attn.output.dense.weight).T.contiguous(),
        "attn_ob": _t(attn.output.dense.bias).clone(),
        "attn_nw": _t(attn.output.LayerNorm.weight).clone(),
        "attn_nb": _t(attn.output.LayerNorm.bias).clone(),
        "inter_w": _t(bert_layer.intermediate.dense.weight).T.contiguous(),
        "inter_b": _t(bert_layer.intermediate.dense.bias).clone(),
        "output_w": _t(bert_layer.output.dense.weight).T.contiguous(),
        "output_b": _t(bert_layer.output.dense.bias).clone(),
        "norm_w": _t(bert_layer.output.LayerNorm.weight).clone(),
        "norm_b": _t(bert_layer.output.LayerNorm.bias).clone(),
    }


def _find_bert_layers(model):
    """Locate the list of BertLayer-like submodules in an HF model."""
    for attr_chain in (("bert", "encoder", "layer"),
                       ("encoder", "layer"), ("layer",)):
        obj = model
        ok = True
        for attr in attr_chain:
            if not hasattr(obj, attr):
                ok = False
                break
            obj = getattr(obj, attr)
        if ok:
            return list(obj)
    raise ValueError("could not find a BERT encoder layer list in model")


def replace_transformer_layer(orig_layer_impl, model, micro_batch_size=-1,
                              bert_config=None, seed=-1, max_seq_length=512,
                              preln=False, fp16=True, huggingface=False,
                              local_rank=-1, training=True, device=None):
    """Build fused layers from a torch BERT model's weights, on
    ``device`` (None means the GPU, and raises without CUDA).

    Returns (layers, params_list, encoder_fn) where
    ``encoder_fn(params_list, hidden_states, attention_mask=None,
    rng=None, deterministic=True)`` runs the full fused encoder stack;
    with ``rng`` (a `torch.Generator`) each layer draws its own dropout
    seeds from it."""
    bert_layers = _find_bert_layers(model)
    cfg = DeepSpeedTransformerConfig(
        batch_size=micro_batch_size,
        hidden_size=bert_config.hidden_size,
        intermediate_size=bert_config.intermediate_size,
        heads=bert_config.num_attention_heads,
        attn_dropout_ratio=bert_config.attention_probs_dropout_prob,
        hidden_dropout_ratio=bert_config.hidden_dropout_prob,
        num_hidden_layers=bert_config.num_hidden_layers,
        initializer_range=bert_config.initializer_range,
        layer_norm_eps=getattr(bert_config, "layer_norm_eps", 1e-12),
        seed=seed,
        fp16=fp16,
        pre_layer_norm=preln,
        huggingface=huggingface,
        local_rank=local_rank,
        training=training)

    layers = []
    for bert_layer in bert_layers:
        layer = DeepSpeedTransformerLayer(cfg, device=device)
        with torch.no_grad():
            layer.load_state_dict(extract_bert_layer_params(bert_layer))
        layers.append(layer)
    params_list = [layer.params() for layer in layers]

    def encoder_fn(params_list, hidden_states, attention_mask=None,
                   rng=None, deterministic=True):
        x = torch.as_tensor(hidden_states, device=layers[0].attn_qkvw.device)
        for layer, params in zip(layers, params_list):
            x = layer.apply(params, x, attention_mask=attention_mask,
                            rng=rng, deterministic=deterministic)
        return x

    return layers, params_list, encoder_fn
