"""The fused BERT-style encoder layer: the port of
`deeperspeed_tpu/ops/transformer/transformer.py`.

The same option surface and the same dispatch as the JAX layer: the QKV
projection and the FFN are cuBLAS GEMMs and plain torch (the JAX layer
leaves them to XLA); the attention core takes the hand-written flash
kernels with the key-bias and dropout flags (`ops/hopper/
flash_attention.py`) when the mask reduces to a per-key row and S reaches
`_flash_min_seq`, else the materialized path in plain torch. Hidden-state
dropout is the JAX layer's hash dropout (`_dropout`), in int32 torch ops.

Randomness: the JAX layer splits a threefry key three ways (attention,
attention-output dropout, FFN dropout). The port draws those three seeds
as one int32 tensor on the device (``seeds``) from a `torch.Generator`,
so a step needs no host sync; a test hands JAX's seeds in to compare
masks bit for bit. The checkpoint knobs map to
`torch.utils.checkpoint` (non-reentrant): the seeds are inputs, so the
recomputation draws the same masks.

Packed rows (``segment_ids``, 0 = pad): attention is bidirectional
within a document. Without an additive mask or attention dropout, at
S >= `_flash_min_seq`, it takes the non-causal segmented flash kernels;
otherwise the materialized path adds a pairwise -1e30 penalty across
documents, as the JAX layer does (its flagged kernels carry no segment
gate).
"""

import json
import math
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...models.gpt_neox import layer_norm as _layer_norm
from ...utils.device import resolve_device
from ..hopper.flash_attention import (dropout_threshold,
                                      flash_attention_kbias,
                                      flash_attention_segmented,
                                      flash_attention_supported,
                                      flash_attention_train)

SEED_HIGH = 2 ** 31 - 1   # seeds are drawn from [0, 2**31 - 1), as in JAX


class TransformerConfig:
    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1):
        self.layer_id = -1
        self.batch_size = batch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.heads = heads
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range


class DeepSpeedTransformerConfig(TransformerConfig):
    """Config-compatible with the reference (same fields/defaults)."""

    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1,
                 layer_norm_eps=1e-12, local_rank=-1, seed=-1, fp16=False,
                 pre_layer_norm=True, normalize_invertible=False,
                 gelu_checkpoint=False, adjust_init_range=True,
                 attn_dropout_checkpoint=False, stochastic_mode=False,
                 huggingface=False, training=True):
        super().__init__(
            batch_size, hidden_size,
            intermediate_size if intermediate_size > 0 else 4 * hidden_size,
            heads, attn_dropout_ratio, hidden_dropout_ratio,
            num_hidden_layers, initializer_range)
        self.fp16 = fp16
        self.pre_layer_norm = pre_layer_norm
        self.local_rank = local_rank
        self.seed = seed
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.test_gemm = False
        self.layer_norm_eps = layer_norm_eps
        self.training = training
        self.is_grad_enabled = True
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.huggingface = huggingface

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            setattr(config, key, value)
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


def _flash_min_seq():
    """Shortest sequence the fused flash kernels take over the
    materialized [B, H, S, S] path: ``DS_FLASH_MIN_SEQ``, default 256,
    the JAX package's rule, kept so that both packages take the same
    path (this card's crossover is recorded in PERF.md)."""
    return int(os.environ.get("DS_FLASH_MIN_SEQ", "256"))


def _dropout(x, rate, seed, deterministic):
    """The JAX layer's hash dropout: an int32 avalanche hash of each
    element's flat index, seeded with one int32 (``seed``, a 0-d tensor
    on x's device), kept where its low 31 bits reach the threshold. The
    products wrap and ``>>`` is arithmetic, as in int32 XLA; survivors
    are ``x / (1 - rate)`` in x's dtype. (`dropout_keep` over one column
    at pid 0 gives the same mask, but builds its pid and column terms on
    the device: more launches and a host copy on the training path.)"""
    if deterministic or rate <= 0.0 or seed is None:
        return x
    idx = torch.arange(x.numel(), dtype=torch.int32, device=x.device)
    h = (idx * -1640531527) ^ seed.to(torch.int32)     # 0x9E3779B9
    h = (h ^ ((h >> 16) & 0xFFFF)) * 0x7FEB352D
    h = (h ^ ((h >> 15) & 0x1FFFF)) * -2073452917      # 0x84699E8B
    h = h ^ ((h >> 16) & 0xFFFF)
    keep = ((h & 0x7FFFFFFF) >= dropout_threshold(rate)).reshape(x.shape)
    # JAX divides by 1 - rate rounded to x's dtype (a weak-typed scalar)
    divisor = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / divisor, 0.0)


def draw_seeds(rng, shape):
    """int32 seeds in [0, 2**31 - 1) from ``rng`` (a `torch.Generator`),
    on its device."""
    return torch.randint(0, SEED_HIGH, shape, generator=rng,
                         device=rng.device, dtype=torch.int32)


def layer_param_shapes(hidden, inter):
    return {
        "attn_qkvw": (hidden, 3 * hidden), "attn_qkvb": (3 * hidden,),
        "attn_ow": (hidden, hidden), "attn_ob": (hidden,),
        "attn_nw": (hidden,), "attn_nb": (hidden,),
        "inter_w": (hidden, inter), "inter_b": (inter,),
        "output_w": (inter, hidden), "output_b": (hidden,),
        "norm_w": (hidden,), "norm_b": (hidden,),
    }


def attention_bias(attention_mask, b, s, device):
    """An attention mask → (kbias, additive): per-key masks ([B or 1, S]
    keep-masks, 1 = attend, and [B or 1, 1, 1, S] additive) reduce to a
    contiguous fp32 [B, S] additive row the flash kernels fuse, with
    ``additive`` its [B, 1, 1, S] view; a full [B, H, S, S] bias gives
    (None, the bias in fp32), which only the materialized path takes."""
    if attention_mask is None:
        return None, None
    am = torch.as_tensor(attention_mask, device=device)
    if am.dim() == 2:
        kb = torch.where(am > 0, 0.0, -1e30).to(torch.float32)
    elif am.dim() == 4 and am.shape[1] == 1 and am.shape[2] == 1:
        kb = am.reshape(am.shape[0], s).to(torch.float32)
    else:
        return None, am.to(torch.float32)
    kbias = kb.expand(b, s).contiguous()
    return kbias, kbias[:, None, None, :]


class DeepSpeedTransformerLayer(nn.Module):
    """BERT-style encoder layer with the reference's option surface.

    Parameters carry the JAX layer's names and ``[in, out]`` layout
    (``attn_qkvw`` [H, 3H] with [Q | K | V] column blocks, ...). They
    are created empty on ``device`` (None means the GPU, and raises
    without CUDA): call `init(seed)`.

    ``apply(params, x, attention_mask=None, rng=None, deterministic=None,
    segment_ids=None, seeds=None, key_bias=None)`` with x [B, S, H];
    attention_mask [B, S] (1 = attend) or additive [B, 1, 1, S] (or a
    full [B, H, S, S] bias), or instead ``key_bias``, the fp32 [B, S] key
    bias that `attention_bias` makes of a mask (a model builds it once
    for all its layers); ``rng`` a `torch.Generator` or ``seeds`` an
    int32 [3] tensor turns dropout on unless ``deterministic``. ``use_kernels`` False
    takes the flash kernels' plain versions.
    """

    layer_id = 0

    def __init__(self, config, initial_weights=None, initial_biases=None,
                 device=None, use_kernels=True):
        super().__init__()
        for name in ("attn_dropout_ratio", "hidden_dropout_ratio"):
            rate = getattr(config, name, -1)
            # -1/negative = unset (reference default); >= 1 would make
            # the survivor scale 1/(1-rate) inf/NaN instead of erroring
            if rate >= 1.0:
                raise ValueError(f"{name} must be < 1.0, got {rate}")
        device = resolve_device(device, "DeepSpeedTransformerLayer")
        self.config = config
        self.config.layer_id = DeepSpeedTransformerLayer.layer_id
        DeepSpeedTransformerLayer.layer_id += 1
        self.initial_weights = initial_weights
        self.initial_biases = initial_biases
        self.use_kernels = use_kernels
        for name, shape in layer_param_shapes(
                config.hidden_size, config.intermediate_size).items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=torch.float32, device=device)))

    # -- params ------------------------------------------------------------

    def init_param(self, name, param, gen):
        """The JAX `init`'s rule for one leaf: normal × std for the QKV
        and FFN-in weights, × std/√(2L) for the two out-projections
        (``adjust_init_range``), ones for the norm scales, zeros for the
        biases."""
        cfg = self.config
        std = cfg.initializer_range if cfg.initializer_range > 0 else 0.02
        out_std = std
        if cfg.adjust_init_range and cfg.num_hidden_layers > 0:
            out_std = std / math.sqrt(2.0 * cfg.num_hidden_layers)
        if name in ("attn_nw", "norm_w"):
            param.fill_(1.0)
        elif name.endswith("b"):
            param.zero_()
        else:
            param.normal_(0.0, out_std if name in ("attn_ow", "output_w")
                          else std, generator=gen)

    @torch.no_grad()
    def init(self, seed=0):
        """Seeded random init (a `torch.Generator`: not the JAX package's
        numbers), then ``initial_weights`` / ``initial_biases`` (HF
        `[out, in]` tensors: q, k, v, attention out, attention norm,
        intermediate, output, output norm) copied in."""
        gen = torch.Generator(device=self.attn_qkvw.device).manual_seed(
            int(seed))
        for name, param in self.named_parameters():
            self.init_param(name, param, gen)
        params = dict(self.named_parameters())
        if self.initial_weights is not None:
            w = [torch.as_tensor(t) for t in self.initial_weights]
            params["attn_qkvw"].copy_(torch.cat([t.T for t in w[:3]], dim=1))
            for name, t in zip(("attn_ow", "attn_nw", "inter_w", "output_w",
                                "norm_w"), w[3:8]):
                params[name].copy_(t.T if t.dim() == 2 else t)
        if self.initial_biases is not None:
            b = [torch.as_tensor(t) for t in self.initial_biases]
            params["attn_qkvb"].copy_(torch.cat(b[:3]))
            for name, t in zip(("attn_ob", "attn_nb", "inter_b", "output_b",
                                "norm_b"), b[3:8]):
                params[name].copy_(t)
        return self

    def params(self):
        return dict(self.named_parameters())

    # -- forward -----------------------------------------------------------

    def _attention(self, params, x, mask_bias, seed, drop_active,
                   use_kernels, segment_ids=None):
        cfg = self.config
        b, s, h = x.shape
        heads = cfg.heads
        hd = h // heads
        qkv = x @ params["attn_qkvw"].to(x.dtype) + \
            params["attn_qkvb"].to(x.dtype)
        # qkv columns are [Q | K | V] blocks (BERT convention); the views
        # keep their strides, which the kernels read
        q, k, v = (t.reshape(b, s, heads, hd) for t in qkv.split(h, dim=-1))

        kbias, additive_mask = mask_bias
        rate = float(cfg.attn_dropout_ratio)
        flash_ok = s >= _flash_min_seq() and \
            flash_attention_supported((b, s, heads, hd))
        # packed rows take the segmented flash only without a mask or
        # attention dropout: the flagged kernels carry no segment gate
        seg_flash = segment_ids is not None and flash_ok and \
            additive_mask is None and not drop_active
        if segment_ids is not None and not seg_flash:
            same = segment_ids[:, None, :, None] == \
                segment_ids[:, None, None, :]
            seg_pen = torch.where(same, 0.0, -1e30)           # [B,1,S,S]
            additive_mask = seg_pen if additive_mask is None else \
                additive_mask + seg_pen
        if seg_flash:
            ctx = flash_attention_segmented(q, k, v, segment_ids,
                                            causal=False,
                                            use_kernels=use_kernels)
        elif segment_ids is None and flash_ok and \
                (additive_mask is None or kbias is not None):
            if drop_active:
                ctx = flash_attention_train(
                    q, k, v, kbias, seed.reshape(1), dropout_rate=rate,
                    use_kernels=use_kernels)
            else:
                ctx = flash_attention_kbias(q, k, v, kbias,
                                            use_kernels=use_kernels)
        else:
            scale = 1.0 / math.sqrt(hd)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                                  k.float()) * scale
            if additive_mask is not None:
                logits = logits + additive_mask
            probs = torch.softmax(logits, dim=-1)
            probs = _dropout(probs.to(x.dtype), rate, seed,
                             not drop_active)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        ctx = ctx.reshape(b, s, h)
        return ctx @ params["attn_ow"].to(x.dtype) + \
            params["attn_ob"].to(x.dtype)

    def _ffn(self, params, x):
        inter = x @ params["inter_w"].to(x.dtype) + \
            params["inter_b"].to(x.dtype)
        inter = F.gelu(inter)                     # exact (erf) GELU
        return inter @ params["output_w"].to(x.dtype) + \
            params["output_b"].to(x.dtype)

    def apply(self, params, x, attention_mask=None, rng=None,
              deterministic=None, segment_ids=None, seeds=None,
              use_kernels=None, key_bias=None):
        cfg = self.config
        if deterministic is None:
            deterministic = not cfg.training
        if use_kernels is None:
            use_kernels = self.use_kernels
        if seeds is None and rng is not None and not deterministic:
            seeds = draw_seeds(rng, (3,))
        drop = seeds is not None and not deterministic
        attn_drop = drop and cfg.attn_dropout_ratio > 0
        s_attn, s_out, s_ffn = (seeds[0], seeds[1], seeds[2]) if drop \
            else (None, None, None)
        eps = cfg.layer_norm_eps
        hrate = cfg.hidden_dropout_ratio
        b, s = x.shape[:2]
        mask_bias = (key_bias, key_bias[:, None, None, :]) \
            if key_bias is not None \
            else attention_bias(attention_mask, b, s, x.device)

        def attn_span(x):
            if cfg.pre_layer_norm:
                normed = _layer_norm(x, params["attn_nw"], params["attn_nb"],
                                     eps)
                attn = self._attention(params, normed, mask_bias,
                                       s_attn, attn_drop, use_kernels,
                                       segment_ids)
                return x + _dropout(attn, hrate, s_out, not drop)
            attn = self._attention(params, x, mask_bias, s_attn,
                                   attn_drop, use_kernels, segment_ids)
            attn = _dropout(attn, hrate, s_out, not drop)
            return _layer_norm(x + attn, params["attn_nw"],
                               params["attn_nb"], eps)

        def ffn_span(y):
            if cfg.pre_layer_norm:
                normed = _layer_norm(y, params["norm_w"], params["norm_b"],
                                     eps)
                out = self._ffn(params, normed)
                return y + _dropout(out, hrate, s_ffn, not drop)
            out = _dropout(self._ffn(params, y), hrate, s_ffn, not drop)
            return _layer_norm(y + out, params["norm_w"], params["norm_b"],
                               eps)

        if cfg.attn_dropout_checkpoint or cfg.normalize_invertible:
            y = checkpoint(attn_span, x, use_reentrant=False)
        else:
            y = attn_span(x)
        if cfg.gelu_checkpoint or cfg.normalize_invertible:
            return checkpoint(ffn_span, y, use_reentrant=False)
        return ffn_span(y)

    def forward(self, hidden_states, attention_mask=None, **kw):
        return self.apply(self.params(), hidden_states,
                          attention_mask=attention_mask, **kw)
