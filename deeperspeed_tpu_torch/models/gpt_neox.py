"""GPT-NeoX family model in PyTorch.

The port of `deeperspeed_tpu/models/gpt_neox.py`: rotary position
embeddings on a fraction of the head dims, the parallel attention+MLP
residual, an untied final layernorm + output projection.

Two conventions are kept from the JAX package so weights interchange
without transposes and the tests compare like with like:

- weights are ``[in, out]`` (`init_block_params`), so every projection
  is ``x @ w``;
- parameters are named after the JAX pytree paths: ``embed.wte``,
  ``blocks.{i}.attn.qkv_w``, ``final_ln.scale``, ``embed_out.wte``.

The block body is written as plain functions on a parameter tree
(nested dicts and a ``blocks`` list, like the JAX pytree): the serving
engine runs prefill and decode through the same `_block_qkv` /
`_block_post_attn`, so the paths cannot drift from the full forward.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hopper.quant_matmul import QuantizedWeight, quant_matmul
from ..utils.device import resolve_device


@dataclass(frozen=True)
class GPTNeoXConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 2048
    rotary_pct: float = 0.25
    rotary_emb_base: int = 10000
    intermediate_mult: int = 4
    layernorm_eps: float = 1e-5
    use_parallel_residual: bool = True
    tie_word_embeddings: bool = False
    param_dtype: object = torch.float32
    # The remaining fields mirror the JAX config so one config object
    # describes one model in both packages. The port builds the dense
    # model only: an MoE FFN, the sparse attention engine, packed
    # segment ids in training and the quantized FFN wait for their
    # slices, and the serving engine refuses a config that asks for them.
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_jitter_eps: float = 0.0
    moe_aux_loss_coef: float = 0.01
    moe_num_groups: int = 1
    moe_dispatch: str = "einsum"
    moe_a2a_overlap_chunks: int = 1
    moe_renorm_kept_choices: bool = False
    moe_observability: bool = False
    use_segment_ids: bool = False
    attention_engine: str = "dense"
    ffn_quant_recipe: object = None
    ffn_quant_margin: float = 1.0
    ffn_quant_history: int = 16

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self):
        return self.intermediate_mult * self.hidden_size

    def num_params(self):
        h, v, L = self.hidden_size, self.vocab_size, self.num_layers
        i = self.intermediate_size
        mlp = 2 * h * i + i + h
        if self.moe_num_experts:
            E = self.moe_num_experts
            mlp = h * E + E * (2 * h * i + i + h)  # gate + experts
        per_layer = 4 * h * h + 3 * h + h + mlp + \
            4 * h  # qkv+out + biases + ln scales/biases + ffn
        embed = v * h * (1 if self.tie_word_embeddings else 2)
        return embed + L * per_layer + 2 * h

    # ---- presets (the same ladder as the JAX package) -------------------

    @classmethod
    def tiny(cls, **kw):
        return cls(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                   max_seq_len=128, **kw)

    @classmethod
    def small(cls, **kw):  # GPT-2 small scale
        return cls(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @classmethod
    def xl_1_5b(cls, **kw):  # Megatron-GPT2 1.5B rung
        return cls(hidden_size=1600, num_layers=48, num_heads=25, **kw)

    @classmethod
    def neox_20b(cls, **kw):  # GPT-NeoX-20B rung
        return cls(vocab_size=50432, hidden_size=6144, num_layers=44,
                   num_heads=64, rotary_pct=0.25, **kw)


# ---------------------------------------------------------------------------
# functional forward (shared by the module and the serving engine)
# ---------------------------------------------------------------------------

def layer_norm(x, scale, bias, eps):
    """LayerNorm with fp32 statistics; the result is cast back to x's
    dtype (`gpt_neox.layer_norm`)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def _rotary_cache(cfg, seq_len, device=None):
    """(cos [S, rot], sin [S, rot], rot_dim) in fp32, computed in numpy
    exactly as the JAX package does."""
    rot_dim = int(cfg.head_dim * cfg.rotary_pct)
    rot_dim -= rot_dim % 2
    inv_freq = 1.0 / (cfg.rotary_emb_base **
                      (np.arange(0, rot_dim, 2, dtype=np.float32) / rot_dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)                      # [S, rot/2]
    emb = np.concatenate([freqs, freqs], axis=-1)      # [S, rot]
    return (torch.as_tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(emb), dtype=torch.float32, device=device),
            rot_dim)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(q, k, cos, sin, rot_dim):
    """Rotary embedding on the first rot_dim dims of q/k [B, S, H, D].

    cos/sin are [S, rot] (one position stream) or [B, S, rot]
    (per-row positions: the decode step)."""
    q_rot, q_pass = q[..., :rot_dim], q[..., rot_dim:]
    k_rot, k_pass = k[..., :rot_dim], k[..., rot_dim:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    cos = cos.to(q.dtype)
    sin = sin.to(q.dtype)
    q_rot = q_rot * cos + _rotate_half(q_rot) * sin
    k_rot = k_rot * cos + _rotate_half(k_rot) * sin
    return (torch.cat([q_rot, q_pass], dim=-1),
            torch.cat([k_rot, k_pass], dim=-1))


def causal_attention(q, k, v, use_kernels=True, segment_ids=None):
    """Causal MHA core on [B, S, H, D] with fp32 softmax statistics.

    `segment_ids` [B, S] int32 makes attention intra-segment: the
    segment-equality mask is ANDed into the causal mask and masked
    scores are -1e30 (`gpt_neox.causal_attention`). ``use_kernels``
    routes through the flash-prefill wrapper, which launches the CUDA
    kernel on CUDA tensors and takes its plain version on CPU tensors;
    False always takes the plain version."""
    from ..ops.hopper.flash_attention import (
        flash_attention_segmented, flash_attention_segmented_reference)
    if use_kernels:
        return flash_attention_segmented(q, k, v, segment_ids)
    return flash_attention_segmented_reference(q, k, v, segment_ids)[0]


def _wmat(x, w, backend=None):
    """``x @ w`` for a plain weight or a serving-time `QuantizedWeight`
    (int8 at rest + per-output-channel scales): the one dispatch point of
    the four block matmuls, in prefill and in decode (`gpt_neox._wmat`).
    Training params are never quantized, so training keeps the plain
    matmul. ``backend`` is the serving engine's ``inference.kernel``,
    handed down through `_block_qkv` / `_block_post_attn`: "xla" takes
    the int8 matmul's plain version."""
    if isinstance(w, QuantizedWeight):
        return quant_matmul(x, w, backend=backend)
    return x @ w.to(x.dtype)


def _block_qkv(cfg, params, x, cos, sin, rot_dim, nh_local, backend=None):
    """ln1 + QKV projection + rotary; shared by the forward and decode.
    The QKV columns are per-head interleaved [q_h | k_h | v_h]."""
    B, S, _ = x.shape
    ln1 = layer_norm(x, params["ln_attn"]["scale"], params["ln_attn"]["bias"],
                     cfg.layernorm_eps)
    qkv = _wmat(ln1, params["attn"]["qkv_w"], backend) + \
        params["attn"]["qkv_b"].to(x.dtype)
    qkv = qkv.reshape(B, S, nh_local, 3 * cfg.head_dim)
    q, k, v = qkv.split(cfg.head_dim, dim=-1)
    q, k = apply_rotary(q, k, cos, sin, rot_dim)
    return q, k, v


def _block_post_attn(cfg, params, x, attn_flat, backend=None):
    """Everything after the attention core: out projection, residuals,
    ln2, dense MLP. `attn_flat` is the [B, S, h] attention output."""
    out_b = params["attn"]["out_b"].to(x.dtype)
    attn_partial = _wmat(attn_flat, params["attn"]["out_w"], backend)
    if cfg.use_parallel_residual:
        ln2_in = x
    else:
        ln2_in = x + (attn_partial + out_b)
    ln2 = layer_norm(ln2_in, params["ln_mlp"]["scale"],
                     params["ln_mlp"]["bias"], cfg.layernorm_eps)
    mlp_b = params["mlp"]["out_b"].to(x.dtype)
    hmid = _wmat(ln2, params["mlp"]["in_w"], backend) + \
        params["mlp"]["in_b"].to(x.dtype)
    hmid = F.gelu(hmid, approximate="tanh")        # jax.nn.gelu's default
    mlp_partial = _wmat(hmid, params["mlp"]["out_w"], backend)
    if cfg.use_parallel_residual:
        return x + (attn_partial + mlp_partial) + out_b + mlp_b
    return ln2_in + mlp_partial + mlp_b


def block_forward(cfg, params, x, cos_sin, use_kernels=True,
                  segment_ids=None):
    """One GPT-NeoX block: x + attn(ln1(x)) + ffn(ln2(x))."""
    B, S, h = x.shape
    cos, sin, rot_dim = cos_sin
    q, k, v = _block_qkv(cfg, params, x, cos, sin, rot_dim, cfg.num_heads)
    attn = causal_attention(q, k, v, use_kernels=use_kernels,
                            segment_ids=segment_ids)
    return _block_post_attn(cfg, params, x, attn.reshape(B, S, h))


def lm_head(params, h):
    """Final-norm hidden [..., H] → fp32 logits [..., V]."""
    wte = params.get("embed_out", params["embed"])["wte"]
    return (h @ wte.to(h.dtype).t()).float()


def forward_hidden(cfg, params, tokens, use_kernels=True):
    """tokens [B, S] int → final-norm hidden states [B, S, H]."""
    x = params["embed"]["wte"][tokens]
    cos_sin = _rotary_cache(cfg, tokens.shape[1], device=x.device)
    for bp in params["blocks"]:
        x = block_forward(cfg, bp, x, cos_sin, use_kernels=use_kernels)
    return layer_norm(x, params["final_ln"]["scale"],
                      params["final_ln"]["bias"], cfg.layernorm_eps)


def forward(cfg, params, tokens, use_kernels=True):
    """tokens [B, S] int → logits [B, S, V] (fp32)."""
    return lm_head(params, forward_hidden(cfg, params, tokens, use_kernels))


def lm_head_loss(params, x, labels, ignore_index=-100):
    """Next-token cross entropy of the LM head over final-norm hidden
    ``x`` [B, S, H]: predictions at x[:, :-1] against labels[:, 1:],
    targets equal to ``ignore_index`` skipped, mean over the valid ones
    (0 when there are none) — `gpt_neox.fused_lm_head_loss`. The logits
    come from cuBLAS in the compute dtype and the softmax runs in fp32;
    the JAX package tiles the same product through an XLA scan."""
    logits = lm_head(params, x[:, :-1])
    targets = labels[:, 1:].reshape(-1).long()
    loss_sum = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets, ignore_index=ignore_index,
                               reduction="sum")
    return loss_sum / (targets != ignore_index).sum().clamp(min=1)


def split_lm_batch(batch):
    """(tokens, labels, segment_ids) from an engine batch: bare tokens,
    a (tokens, labels) pair, or a packed (tokens, labels, segment_ids)
    triple (`gpt_neox.split_lm_batch`)."""
    if isinstance(batch, (tuple, list)):
        if len(batch) == 3:
            return batch[0], batch[1], batch[2]
        tokens, labels = batch
        return tokens, labels, None
    return batch, batch, None


def unflatten(flat):
    """Dotted names → the natural tree: nested dicts, with ``blocks`` a
    list indexed by layer (the JAX params pytree's structure)."""
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    if "blocks" in tree:
        blocks = tree["blocks"]
        tree["blocks"] = [blocks[str(i)] for i in range(len(blocks))]
    return tree


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def _holder(**shapes):
    """A parameter-only submodule, so the dotted names follow the JAX
    pytree paths (``blocks.0.attn.qkv_w``)."""
    m = nn.Module()
    for name, (shape, dtype, device) in shapes.items():
        m.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)))
    return m


class GPTNeoX(nn.Module):
    """The GPT-NeoX model with the JAX package's parameter names and
    ``[in, out]`` weight layout; its parameters are trainable (the
    training engine differentiates `loss_fn`, the serving engine takes
    detached copies). Parameters are created empty on
    ``device`` (None means the GPU, and raises without CUDA; the CPU
    must be asked for): call `init_params(seed)` or
    `load_jax_params(params)`.

    ``use_kernels`` (the counterpart of the JAX model's ``use_pallas``)
    sends attention through the hand-written flash-prefill kernel; False
    keeps the plain PyTorch version everywhere."""

    def __init__(self, config=None, use_kernels=True, device=None, **kwargs):
        super().__init__()
        cfg = config or GPTNeoXConfig(**kwargs)
        if cfg.moe_num_experts:
            raise NotImplementedError(
                "GPT-NeoX with an MoE FFN is not ported yet (MoE slice)")
        if cfg.attention_engine != "dense":
            raise NotImplementedError(
                "the sparse attention engine is not ported yet (sparse "
                "slice)")
        device = resolve_device(device, "GPTNeoX")
        self.config = cfg
        self.use_kernels = use_kernels
        h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        dt = cfg.param_dtype

        def p(*shape):
            return (shape, dt, device)

        self.embed = _holder(wte=p(v, h))
        self.blocks = nn.ModuleList()
        for _ in range(cfg.num_layers):
            blk = nn.Module()
            blk.ln_attn = _holder(scale=p(h), bias=p(h))
            blk.ln_mlp = _holder(scale=p(h), bias=p(h))
            blk.attn = _holder(qkv_w=p(h, 3 * h), qkv_b=p(3 * h),
                               out_w=p(h, h), out_b=p(h))
            blk.mlp = _holder(in_w=p(h, i), in_b=p(i), out_w=p(i, h),
                              out_b=p(h))
            self.blocks.append(blk)
        self.final_ln = _holder(scale=p(h), bias=p(h))
        if not cfg.tie_word_embeddings:
            self.embed_out = _holder(wte=p(v, h))

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random init: normal × 0.02 for matmul weights and
        embeddings, normal × 0.02/√(2L) for the two out-projections,
        ones/zeros for norms and biases (`gpt_neox.init_block_params`).
        The draws come from a `torch.Generator`, so they are not the JAX
        package's numbers; tests carry JAX weights over instead."""
        device = next(self.parameters()).device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        out_scale = 0.02 / math.sqrt(2 * self.config.num_layers)
        for name, param in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if param.dim() >= 2:
                scale = out_scale if leaf == "out_w" else 0.02
                param.normal_(0.0, scale, generator=gen)
            elif leaf == "scale":
                param.fill_(1.0)
            else:
                param.zero_()
        return self

    def load_jax_params(self, params):
        """Load the JAX package's natural params pytree (numpy leaves —
        call ``jax.device_get`` first) into this module."""
        from .convert import state_dict_from_jax
        self.load_state_dict(state_dict_from_jax(params))
        return self

    def params_tree(self):
        """The parameters as the natural tree the functional forward
        takes."""
        return unflatten(dict(self.named_parameters()))

    def forward(self, tokens):
        """tokens [B, S] → logits [B, S, V] (fp32)."""
        return forward(self.config, self.params_tree(), tokens,
                       use_kernels=self.use_kernels)

    def loss_fn(self, params, batch):
        """Scalar LM loss of ``batch`` (see `split_lm_batch`) under the
        parameter tree ``params`` (`params_tree()`), differentiable in
        it: `GPTNeoX.loss_fn` of the JAX package for the dense model."""
        tokens, labels, seg = split_lm_batch(batch)
        if seg is not None:
            raise NotImplementedError(
                "packed (tokens, labels, segment_ids) batches are not "
                "ported yet (long-context slice)")
        hidden = forward_hidden(self.config, params, tokens,
                                use_kernels=self.use_kernels)
        return lm_head_loss(params, hidden, labels)
