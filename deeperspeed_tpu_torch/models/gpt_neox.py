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

With ``moe_num_experts`` the FFN of every block is the MoE layer
(`moe/layer.py`, parameters ``blocks.{i}.mlp.{gate,w_in,b_in,w_out,
b_out}``), its load-balancing loss added to the LM loss; the JSON "moe"
block turns a dense model into one (`GPTNeoX.apply_ds_config`). With
``attention_engine="sparse"`` (or the JSON "sparse_attention" block) the
attention core is a `SparseSelfAttention` over the block's pattern
(`make_sparse_attention`).

With ``ffn_quant_recipe`` (the JSON "quantization.ffn" block) the FFN's
two matmuls, dense or the sort engine's grouped ones, run on
delayed-scaling fp8 / int8 fake-quantized operands; `loss_fn(...,
ffn_amax=)` threads the per-layer amax histories [L, 4, H] through the
blocks and returns the advanced ones (`ops/hopper/quant_matmul`).

Packed batches ((tokens, labels, segment_ids) triples, the JSON
"packing" block; `runtime/packing.py`) make attention intra-document on
every block and gather the rotary cache at intra-document positions.
Activation checkpointing (the JSON "activation_checkpointing" block, or
the ``remat_blocks`` / ``remat_policy`` / ``number_checkpoints`` knobs)
runs each block, or each of ``number_checkpoints`` groups of blocks, as
one recompute span (`runtime/activation_checkpointing/checkpointing.py`).
"""

import dataclasses
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..moe.layer import moe_ffn_dense
from ..ops.hopper.quant_matmul import (QuantizedWeight,
                                      ffn_scaled_matmuls,
                                      init_amax_history, quant_matmul)
from ..runtime.activation_checkpointing.checkpointing import (
    checkpoint_span, make_remat_policy, resolve_policy_name)
from ..runtime.config_utils import DeepSpeedConfigError
from ..runtime.packing import (mask_cross_document_labels,
                               segment_relative_positions)
from ..utils.device import resolve_device
from ..utils.logging import logger


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
    # describes one model in both packages. `GPTNeoX` builds the dense
    # and the MoE FFN, the dense or sparse attention engine, packed
    # segment ids and the delayed-scaling quantized FFN (the serving
    # engine refuses MoE and sparse models); the MoE routing statistics
    # wait for their slice, and `GPTNeoX` refuses a config that asks for
    # them.
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
    # delayed-scaling quantized FFN (`ops/hopper/quant_matmul`): None =
    # full precision, "int8"/"fp8" quantize both FFN matmul operands
    # against per-layer amax histories threaded through the blocks (the
    # JSON "quantization.ffn" block sets these)
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
    (per-row positions: the decode step). A zero ``rot_dim`` (GPT-2,
    whose positions come from its learned table) returns q and k as they
    are."""
    if rot_dim == 0:
        return q, k
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


def _block_post_attn(cfg, params, x, attn_flat, backend=None, rng=None,
                     use_kernels=True, ffn_quant=None):
    """Everything after the attention core: out projection, residuals,
    ln2, MLP (dense or MoE). `attn_flat` is the [B, S, h] attention
    output. With MoE the return is (out, aux_load_balance_loss); ``rng``
    (a `torch.Generator`) feeds the gate jitter and ``use_kernels`` the
    grouped matmul's kernel switch. ``ffn_quant`` = (recipe, margin,
    amax_row [4, H]) runs the FFN under delayed-scaling quantization and
    appends the advanced amax row to the return."""
    out_b = params["attn"]["out_b"].to(x.dtype)
    attn_partial = _wmat(attn_flat, params["attn"]["out_w"], backend)
    if cfg.use_parallel_residual:
        ln2_in = x
    else:
        ln2_in = x + (attn_partial + out_b)
    ln2 = layer_norm(ln2_in, params["ln_mlp"]["scale"],
                     params["ln_mlp"]["bias"], cfg.layernorm_eps)
    if cfg.moe_num_experts:
        B, S, h = ln2.shape
        y = moe_ffn_dense(
            params["mlp"], ln2.reshape(B * S, h),
            capacity_factor=cfg.moe_capacity_factor, top_k=cfg.moe_top_k,
            rng=rng, jitter_eps=cfg.moe_jitter_eps,
            groups=cfg.moe_num_groups, dispatch=cfg.moe_dispatch,
            renorm_kept_choices=cfg.moe_renorm_kept_choices,
            use_kernels=use_kernels, ffn_quant=ffn_quant,
            observe=cfg.moe_observability)
        moe_out = y[0].reshape(ln2.shape)
        if cfg.use_parallel_residual:
            out = x + attn_partial + out_b + moe_out
        else:
            out = ln2_in + moe_out
        return (out,) + tuple(y[1:])
    mlp_b = params["mlp"]["out_b"].to(x.dtype)
    new_row = None
    if ffn_quant is not None:
        recipe, margin, amax_row = ffn_quant
        B, S, h = ln2.shape
        y2d, new_row = ffn_scaled_matmuls(
            ln2.reshape(B * S, h), params["mlp"]["in_w"],
            params["mlp"]["in_b"], params["mlp"]["out_w"], amax_row, recipe,
            margin)
        mlp_partial = y2d.reshape(B, S, -1)
    else:
        hmid = _wmat(ln2, params["mlp"]["in_w"], backend) + \
            params["mlp"]["in_b"].to(x.dtype)
        hmid = F.gelu(hmid, approximate="tanh")    # jax.nn.gelu's default
        mlp_partial = _wmat(hmid, params["mlp"]["out_w"], backend)
    if cfg.use_parallel_residual:
        out = x + (attn_partial + mlp_partial) + out_b + mlp_b
    else:
        out = ln2_in + mlp_partial + mlp_b
    return out if new_row is None else (out, new_row)


def block_forward(cfg, params, x, cos_sin, use_kernels=True,
                  segment_ids=None, rng=None, attn_fn=None, ffn_quant=None):
    """One GPT-NeoX block: x + attn(ln1(x)) + ffn(ln2(x)); with MoE the
    return is (out, aux_loss), and with ``ffn_quant`` the advanced amax
    row is appended (`_block_post_attn`). ``attn_fn`` (the sparse engine
    of `make_sparse_attention`) replaces `causal_attention` as the
    core."""
    B, S, h = x.shape
    cos, sin, rot_dim = cos_sin
    q, k, v = _block_qkv(cfg, params, x, cos, sin, rot_dim, cfg.num_heads)
    if attn_fn is not None:
        attn = attn_fn(q, k, v, segment_ids=segment_ids,
                       use_kernels=use_kernels)
    else:
        attn = causal_attention(q, k, v, use_kernels=use_kernels,
                                segment_ids=segment_ids)
    return _block_post_attn(cfg, params, x, attn.reshape(B, S, h), rng=rng,
                            use_kernels=use_kernels, ffn_quant=ffn_quant)


def lm_head(params, h):
    """Final-norm hidden [..., H] → fp32 logits [..., V]."""
    wte = params.get("embed_out", params["embed"])["wte"]
    return (h @ wte.to(h.dtype).t()).float()


def segment_sizes(n_layers, n_segments):
    """Span lengths for segmented checkpointing: n_segments as-equal-as-
    possible groups over n_layers (earlier spans get the remainder).
    Shared by the GPT-NeoX and BERT span loops (`gpt_neox.segment_sizes`)."""
    n = max(1, min(int(n_segments), n_layers))
    return [n_layers // n + (1 if i < n_layers % n else 0)
            for i in range(n)]


def resolve_remat(remat_blocks, remat_policy, number_checkpoints):
    """Shared knob resolution for the model families: returns
    (do_remat, policy, number_checkpoints), `policy` a
    `make_remat_policy` result. `remat_blocks=True` with no explicit
    policy keeps whole-block save-nothing remat ('full'); a policy or
    segment count alone also switches remat on ('none' resolves to no
    remat at all — keep everything — unless segments are asked for,
    whose spans then run plainly)."""
    do_remat = bool(remat_blocks or remat_policy is not None
                    or number_checkpoints is not None)
    if not do_remat:
        return False, None, None
    policy, is_remat = make_remat_policy(remat_policy)
    if not is_remat and number_checkpoints is None:
        return False, None, None   # 'none': saving everything == no remat
    return True, policy, number_checkpoints


def block_stack(cfg, blocks, x, cos_sin, use_kernels=True, rng=None,
                attn_fn=None, remat_blocks=False, remat_policy=None,
                number_checkpoints=None, segment_ids=None, hidden=None,
                ffn_amax=None):
    """The blocks over the embedded ``x`` [B, S, H] → the last block's
    output; with MoE (out, the blocks' aux losses summed). Shared by the
    GPT-NeoX and GPT-2 forwards (the JAX package's
    `gpt_neox.forward_hidden` and `gpt2.forward_hidden` loop over the
    same block). The
    blocks draw their gate jitter from ``rng`` in turn; ``attn_fn`` is
    their attention core when set (`block_forward`); ``segment_ids``
    (int32) makes attention intra-document.

    Remat knobs (see `resolve_remat`): ``remat_policy`` names what a
    span keeps ('none'/'full'/'dots'/'attn_residuals'/'offload_dots');
    with ``number_checkpoints`` the blocks run as that many spans
    (`segment_sizes`, a Python loop), else each block is a span. A
    span's gate-jitter draws replay in its recompute.

    ``hidden`` (a list, the capture path of `hidden_states`) receives
    every block's output; it runs the blocks without remat, as the JAX
    package's ``collect_hidden`` path does.

    ``ffn_amax`` [L, 4, H] (the delayed-scaling quantized FFN's amax
    histories, `cfg.ffn_quant_recipe`): block i quantizes its FFN
    against row i, and the advanced rows come back stacked as one more
    return value. A row goes into its span as an argument and comes out
    as an output, so a span's recompute in the backward reads the same
    row and its second copy of the new row is dropped: the history
    advances once a forward."""
    moe = bool(cfg.moe_num_experts)
    quant = ffn_amax is not None
    do_remat, policy, n_ckpt = (False, None, None) if hidden is not None \
        else resolve_remat(remat_blocks, remat_policy, number_checkpoints)
    if quant and n_ckpt is not None:
        raise ValueError(
            "quantization.ffn + number_checkpoints (segmented-scan "
            "checkpointing) is unsupported: the amax rows do not "
            "thread through the segment spans; use a remat policy "
            "without number_checkpoints")
    if quant and hidden is not None:
        raise ValueError(
            "quantization.ffn does not thread amax through the "
            "hidden-state capture path (collect_hidden)")
    if n_ckpt is not None and moe:
        raise ValueError(
            "number_checkpoints (segmented-scan checkpointing) needs a "
            "uniform block stack: incompatible with MoE aux-loss "
            "threading and collect_hidden — drop number_checkpoints or "
            "use per-block remat (a policy alone)")
    quant_args = (cfg.ffn_quant_recipe, cfg.ffn_quant_margin) \
        if quant else None

    def run_blocks(group, x, arow=None):
        aux_sum = None
        for bp in group:
            y = block_forward(
                cfg, bp, x, cos_sin, use_kernels=use_kernels,
                segment_ids=segment_ids, rng=rng, attn_fn=attn_fn,
                ffn_quant=None if arow is None else (*quant_args, arow))
            if moe or quant:
                x = y[0]
                if moe:
                    aux_sum = y[1] if aux_sum is None else aux_sum + y[1]
            else:
                x = y
            if hidden is not None:
                hidden.append(x)
        if quant:
            return (x, aux_sum, y[-1]) if moe else (x, y[-1])
        return (x, aux_sum) if moe else x

    if n_ckpt is not None:
        # the spans own the remat; blocks inside run bare
        groups, idx = [], 0
        for size in segment_sizes(len(blocks), n_ckpt):
            groups.append(blocks[idx:idx + size])
            idx += size
    else:
        groups = [[bp] for bp in blocks]
    aux_total, new_rows = None, []
    for i, group in enumerate(groups):
        args = (x,) if not quant else (x, ffn_amax[i])
        if do_remat:
            y = checkpoint_span(functools.partial(run_blocks, group), *args,
                                policy=policy, generators=(rng,))
        else:
            y = run_blocks(group, *args)
        if not (moe or quant):
            x = y
            continue
        x = y[0]
        if moe:
            aux_total = y[1] if aux_total is None else aux_total + y[1]
        if quant:
            new_rows.append(y[-1])
    out = (x, aux_total) if moe else (x,)
    if quant:
        out += (torch.stack(new_rows),)
    return out if len(out) > 1 else x


def forward_hidden(cfg, params, tokens, use_kernels=True, rng=None,
                   attn_fn=None, remat_blocks=False, remat_policy=None,
                   number_checkpoints=None, segment_ids=None, hidden=None,
                   ffn_amax=None):
    """tokens [B, S] int → final-norm hidden states [B, S, H]; with MoE
    (out, the blocks' aux losses summed); with ``ffn_amax`` [L, 4, H]
    (the quantized FFN's amax histories) the advanced histories are
    appended. The blocks run through `block_stack` (its remat knobs,
    ``rng``, ``attn_fn``, ``hidden`` and ``ffn_amax``).

    ``segment_ids`` [B, S] int (packed ragged batches, 0 = pad — see
    `runtime.packing`): attention becomes intra-document on every block,
    and the rotary cache is gathered at each token's intra-document
    position, so a packed document sees the position stream of the same
    document padded alone.

    ``hidden`` (a list) receives the embedding, every block's output and
    the final-norm output (`GPTNeoX.hidden_states`)."""
    x = params["embed"]["wte"][tokens]
    cos, sin, rot_dim = _rotary_cache(cfg, tokens.shape[1], device=x.device)
    if segment_ids is not None:
        # int32 once for every block's kernels
        segment_ids = segment_ids.to(torch.int32).contiguous()
        if rot_dim:
            # the rotary cache at intra-document positions: [B, S, rot]
            pos = segment_relative_positions(segment_ids).long()
            cos, sin = cos[pos], sin[pos]
    if hidden is not None:
        hidden.append(x)
    x = block_stack(cfg, params["blocks"], x, (cos, sin, rot_dim),
                    use_kernels=use_kernels, rng=rng, attn_fn=attn_fn,
                    remat_blocks=remat_blocks, remat_policy=remat_policy,
                    number_checkpoints=number_checkpoints,
                    segment_ids=segment_ids, hidden=hidden,
                    ffn_amax=ffn_amax)
    rest = ()
    if cfg.moe_num_experts or ffn_amax is not None:
        x, *rest = x
    out = layer_norm(x, params["final_ln"]["scale"],
                     params["final_ln"]["bias"], cfg.layernorm_eps)
    if hidden is not None:
        hidden.append(out)
    return (out, *rest) if rest else out


def forward(cfg, params, tokens, use_kernels=True, attn_fn=None,
            **remat):
    """tokens [B, S] int → logits [B, S, V] (fp32); ``remat`` takes
    `forward_hidden`'s remat knobs."""
    x = forward_hidden(cfg, params, tokens, use_kernels, attn_fn=attn_fn,
                       **remat)
    if cfg.moe_num_experts:
        x, _ = x
    return lm_head(params, x)


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
    """Dotted names → the natural tree: nested dicts, with a level whose
    keys are layer indices (``blocks``, BERT's ``layers``) a list (the
    JAX params pytree's structure)."""
    tree = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return _listify(tree)


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

def make_sparse_attention(cfg, sparse_params=None):
    """The config-selectable block-sparse attention engine
    (`cfg.attention_engine == "sparse"`, `gpt_neox.make_sparse_attention`
    of the JAX package): a `SparseSelfAttention` over the JSON
    "sparse_attention" block's pattern, used as the blocks' attention
    core.

    A causal LM needs a unidirectional pattern: `attention` defaults to
    "unidirectional" here (the reference's block default is
    bidirectional, which would leak future tokens into the LM loss), and
    an explicitly bidirectional pattern, or the dense mode (which cannot
    express a direction), raises ValueError.

    Returns ``attn_fn(q, k, v, segment_ids=None, use_kernels=True)`` for
    `forward_hidden(attn_fn=...)`; ``use_kernels=False`` takes the plain
    versions of the arm's kernels."""
    d = dict(sparse_params or {})
    d.setdefault("mode", "fixed")
    d.setdefault("block", 128)
    d["num_heads"] = cfg.num_heads
    if d.get("attention") is None:
        # the JSON parse leaves an unset `attention` as None, so "unset"
        # and "asked for bidirectional" differ; only the latter is an
        # error on a causal LM
        d["attention"] = "unidirectional"
    from ..ops.sparse_attention import (SparseSelfAttention,
                                        sparsity_config_from_dict)
    sc = sparsity_config_from_dict(d)
    # a config class without an `attention` attribute (dense) cannot
    # express directionality, and `get_layout` reads a missing attribute
    # as bidirectional
    if getattr(sc, "attention", "bidirectional") != "unidirectional":
        raise ValueError(
            f"attention_engine 'sparse' on a causal LM needs a "
            f"unidirectional sparsity pattern; mode {d['mode']!r} with "
            f"attention={getattr(sc, 'attention', None)!r} attends "
            f"bidirectionally (future-token leak). Use mode 'fixed' or "
            f"'variable' with attention='unidirectional'")
    sp = SparseSelfAttention(sc, max_seq_length=cfg.max_seq_len)

    def attn_fn(q, k, v, segment_ids=None, use_kernels=True):
        if segment_ids is not None:
            raise NotImplementedError(
                "the block-sparse attention engine is not segment-aware; "
                "packed batches need attention_engine='dense'")
        return sp(q, k, v, use_kernels=use_kernels)

    attn_fn.sparse_self_attention = sp
    return attn_fn


def reject_unsupported_ds_blocks(ds_config, family):
    """Refuse the config blocks a family does not implement, as the
    JAX package's `reject_unsupported_ds_blocks` does (same errors):
    accepting them would train without them. Shared by GPT-2 and
    BERT."""
    if getattr(ds_config, "moe_params", None) or \
            getattr(ds_config, "sequence_parallel_params", None):
        raise NotImplementedError(
            f"{family} does not implement the moe/sequence_parallel "
            "config blocks; use models.gpt_neox.GPTNeoX")
    if getattr(ds_config, "sparse_attention", None):
        raise NotImplementedError(
            f"{family} does not implement the sparse_attention config "
            "block (the run would silently train with dense attention); "
            "the block-sparse engine lives on models.gpt_neox.GPTNeoX")
    qz = getattr(ds_config, "quantization_config", None)
    if qz and qz.get("ffn"):
        raise NotImplementedError(
            f"{family} does not implement the quantization.ffn block "
            "(the run would silently train full-precision); the "
            "delayed-scaling FFN lives on models.gpt_neox.GPTNeoX")


def apply_activation_checkpointing_config(model, ds_config):
    """Thread the JSON "activation_checkpointing" block into a model's
    remat knobs (shared by the GPT-NeoX, GPT-2 and BERT families; the engine
    calls it through `apply_ds_config`): `number_checkpoints` → span
    groups, `cpu_checkpointing` → the host-offload policy
    (`offload_dots`), fork key `policy` → the named policy;
    `partition_activations` has no model axis to shard over on one rank
    (the JAX package's boundary constraint is None there). Validates
    `number_checkpoints` against the model's layer count (parse time
    cannot: it does not know it).

    An active block always implies remat (the reference block is a
    checkpointing block): with no explicit policy, whole-block 'full'
    remat."""
    ac = getattr(ds_config, "activation_checkpointing_config", None)
    if ac is None or not getattr(ac, "active", False):
        return
    n_layers = getattr(model.config, "num_layers", None)
    if ac.number_checkpoints is not None and n_layers is not None and \
            ac.number_checkpoints > n_layers:
        raise DeepSpeedConfigError(
            f"activation_checkpointing.number_checkpoints "
            f"({ac.number_checkpoints}) exceeds the model's num_layers "
            f"({n_layers})")
    policy = resolve_policy_name(ac.policy, ac.cpu_checkpointing)
    model.remat_policy = policy if policy is not None else "full"
    model.number_checkpoints = ac.number_checkpoints


def _refuse_unported(cfg):
    """Raise on config fields whose paths are not ported yet, instead of
    training without them."""
    if cfg.attention_engine not in ("dense", "sparse"):
        raise ValueError(
            f"attention_engine must be 'dense' or 'sparse', got "
            f"{cfg.attention_engine!r}")


def _holder(**shapes):
    """A parameter-only submodule, so the dotted names follow the JAX
    pytree paths (``blocks.0.attn.qkv_w``)."""
    m = nn.Module()
    for name, (shape, dtype, device) in shapes.items():
        m.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device)))
    return m


def _mlp_holder(cfg, device):
    """A block's FFN parameters with the JAX shapes (`_init_ffn_params`):
    dense ``in_w``/``in_b``/``out_w``/``out_b``, or with experts the gate
    [h, E] and the stacked ``w_in`` [E, h, i], ``b_in``, ``w_out`` [E, i,
    h], ``b_out``."""
    h, i, E, dt = (cfg.hidden_size, cfg.intermediate_size,
                   cfg.moe_num_experts, cfg.param_dtype)
    if not E:
        return _holder(in_w=((h, i), dt, device), in_b=((i,), dt, device),
                       out_w=((i, h), dt, device), out_b=((h,), dt, device))
    return _holder(gate=((h, E), dt, device), w_in=((E, h, i), dt, device),
                   b_in=((E, i), dt, device), w_out=((E, i, h), dt, device),
                   b_out=((E, h), dt, device))


def _init_param(cfg, name, param, gen):
    """`GPTNeoX.init_params`'s rule for one leaf: ones for norm scales,
    zeros for biases (the experts' [E, ·] ones too), normal × 0.02 for
    the rest, × 0.02/√(2L) for the two out-projections."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        param.fill_(1.0)
    elif leaf in ("bias", "b_in", "b_out") or leaf.endswith("_b"):
        param.zero_()
    else:
        scale = 0.02 / math.sqrt(2 * cfg.num_layers) \
            if leaf in ("out_w", "w_out") else 0.02
        param.normal_(0.0, scale, generator=gen)


class LMModule(nn.Module):
    """The module glue GPT-NeoX and GPT-2 share: the remat knobs and
    ``scan_blocks``, loading a JAX tree, the natural tree of the
    parameters, a packed batch's checks and the layer names of the
    activation capture.

    ``remat_blocks``, ``remat_policy`` and ``number_checkpoints`` are the
    JAX models' remat knobs (`forward_hidden`); the JSON
    "activation_checkpointing" block sets them. ``scan_blocks`` (the JAX
    models' compile-time knob: one `lax.scan` body for the stack) is
    accepted and stored, and does nothing: eager PyTorch compiles
    nothing."""

    def __init__(self, cfg, use_kernels, remat_blocks, scan_blocks,
                 remat_policy, number_checkpoints):
        super().__init__()
        self.config = cfg
        self.use_kernels = use_kernels
        self.remat_blocks = remat_blocks
        self.scan_blocks = scan_blocks
        self.remat_policy = remat_policy
        self.number_checkpoints = number_checkpoints

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

    def _remat_knobs(self):
        return dict(remat_blocks=self.remat_blocks,
                    remat_policy=self.remat_policy,
                    number_checkpoints=self.number_checkpoints)

    def _lm_batch(self, batch):
        """(tokens, labels, segment ids or None) of an LM batch (see
        `split_lm_batch`). A packed batch's labels lose their pad and
        cross-document targets (`mask_cross_document_labels`); with
        ``use_segment_ids`` (the "packing" block) a batch without segment
        ids raises."""
        tokens, labels, seg = split_lm_batch(batch)
        if self.config.use_segment_ids and seg is None:
            raise ValueError(
                "packing is enabled (use_segment_ids) but the batch has "
                "no segment_ids: feed (tokens, labels, segment_ids) "
                "triples (runtime.packing.PackedDataset emits them)")
        if seg is not None:
            labels = mask_cross_document_labels(labels, seg)
        return tokens, labels, seg

    # -- layer-activation capture (engine.set_layers_to_hook) ------------

    def layer_names(self):
        return ["embedding"] + \
            ["transformerlayer"] * self.config.num_layers + ["final_ln"]


class GPTNeoX(LMModule):
    """The GPT-NeoX model with the JAX package's parameter names and
    ``[in, out]`` weight layout; its parameters are trainable (the
    training engine differentiates `loss_fn`, the serving engine takes
    detached copies). Parameters are created empty on
    ``device`` (None means the GPU, and raises without CUDA; the CPU
    must be asked for): call `init_params(seed)` or
    `load_jax_params(params)`.

    ``use_kernels`` (the counterpart of the JAX model's ``use_pallas``)
    sends attention through the hand-written flash-prefill kernel; False
    keeps the plain PyTorch version everywhere. The remat knobs and
    ``scan_blocks``: `LMModule`."""

    def __init__(self, config=None, use_kernels=True, device=None,
                 remat_blocks=False, scan_blocks=False, remat_policy=None,
                 number_checkpoints=None, **kwargs):
        cfg = config or GPTNeoXConfig(**kwargs)
        _refuse_unported(cfg)
        device = resolve_device(device, "GPTNeoX")
        super().__init__(cfg, use_kernels, remat_blocks, scan_blocks,
                         remat_policy, number_checkpoints)
        self._init_seed = 0
        # the sparse engine: set by apply_ds_config, or built lazily for
        # attention_engine="sparse" set on the config
        self._attn_fn = None
        self._sparse_params = None
        h, v = cfg.hidden_size, cfg.vocab_size
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
            blk.mlp = _mlp_holder(cfg, device)
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
        for name, param in self.named_parameters():
            _init_param(self.config, name, param, gen)
        self._init_seed = int(seed)
        return self

    def _attention_fn(self):
        """The attention core `forward_hidden` uses: the sparse engine
        when configured (built here for ``attention_engine="sparse"`` set
        on the config without a JSON block), else None (dense)."""
        if self._attn_fn is None and \
                self.config.attention_engine == "sparse":
            self._attn_fn = make_sparse_attention(self.config,
                                                  self._sparse_params)
        return self._attn_fn

    @property
    def sparse_self_attention(self):
        """The sparse engine's `SparseSelfAttention` (its layouts and the
        arm each sequence length takes), or None with dense attention."""
        fn = self._attention_fn()
        return None if fn is None else fn.sparse_self_attention

    @torch.no_grad()
    def apply_ds_config(self, ds_config):
        """Wire the JSON "moe", "packing", "quantization",
        "sparse_attention" and "activation_checkpointing" blocks into the
        model
        (`GPTNeoX.apply_ds_config` of the JAX package); the training
        engine calls it before it builds its flat state. "moe": the
        config takes the block's values; each block's FFN holder whose
        shapes differ from the new config's (a dense model made MoE) is
        rebuilt and its leaves drawn with `init_params`' rule from a
        generator seeded with the last `init_params` seed, and one whose
        shapes match keeps its weights. "packing": batches must carry
        segment ids (``use_segment_ids``). "quantization" with an "ffn"
        object: the FFN runs the delayed-scaling recipe (``ffn_quant_*``;
        an MoE model needs sort dispatch). "sparse_attention": the
        attention core becomes the sparse engine over the block's pattern
        (the same parameters). "activation_checkpointing": the remat
        knobs (`apply_activation_checkpointing_config`). The other blocks
        the JAX method wires are refused by `DeepSpeedConfig` until their
        slices."""
        moe = getattr(ds_config, "moe_params", None)
        if moe:
            self._apply_moe(moe)
        packing = getattr(ds_config, "packing_params", None)
        if packing:
            self.config = dataclasses.replace(self.config,
                                              use_segment_ids=True)
        qz = getattr(ds_config, "quantization_config", None)
        if qz and qz.get("ffn"):
            f = qz["ffn"]
            if self.config.moe_num_experts and \
                    self.config.moe_dispatch != "sort":
                raise ValueError(
                    "quantization.ffn on an MoE model requires "
                    "moe.dispatch = \"sort\" (the delayed-scaling path "
                    "quantizes the grouped expert matmul; the einsum "
                    "engine's flops sit in the one-hot dispatch tensor)")
            self.config = dataclasses.replace(
                self.config,
                ffn_quant_recipe=f["recipe"],
                ffn_quant_margin=f["margin"],
                ffn_quant_history=f["amax_history_len"])
        sparse = getattr(ds_config, "sparse_attention", None)
        if sparse:
            if packing:
                # also rejected at config parse; kept here for direct
                # apply_ds_config callers
                raise ValueError(
                    "packing + sparse_attention is unsupported: the "
                    "sparse kernels are not segment-aware")
            self.config = dataclasses.replace(self.config,
                                              attention_engine="sparse")
            self._sparse_params = dict(sparse)
            self._attn_fn = make_sparse_attention(self.config,
                                                  self._sparse_params)
        apply_activation_checkpointing_config(self, ds_config)

    def _apply_moe(self, moe):
        self.config = dataclasses.replace(
            self.config,
            moe_num_experts=moe["num_experts"],
            moe_top_k=moe["top_k"],
            moe_capacity_factor=moe["capacity_factor"],
            moe_jitter_eps=moe["jitter_eps"],
            moe_aux_loss_coef=moe["aux_loss_coef"],
            moe_num_groups=moe.get("num_groups", 1),
            moe_dispatch=moe.get("dispatch", "einsum"),
            moe_a2a_overlap_chunks=moe.get("a2a_overlap_chunks", 1),
            moe_renorm_kept_choices=moe.get("renorm_kept_choices", False),
            moe_observability=moe.get("observability", False))
        _refuse_unported(self.config)
        if self.config.moe_a2a_overlap_chunks > 1:
            logger.warning(
                "moe.a2a_overlap_chunks > 1 has no effect on the GPT-NeoX "
                "MoE path on one card; it applies to the expert-parallel "
                "exchange (moe_ffn_expert_parallel), not ported yet")
        device = self.embed.wte.device
        gen = torch.Generator(device=device).manual_seed(self._init_seed)
        for i, blk in enumerate(self.blocks):
            mlp = _mlp_holder(self.config, device)
            if {n: p.shape for n, p in mlp.named_parameters()} == \
                    {n: p.shape for n, p in blk.mlp.named_parameters()}:
                continue
            for name, param in mlp.named_parameters():
                _init_param(self.config, f"blocks.{i}.mlp.{name}", param,
                            gen)
            blk.mlp = mlp

    def apply(self, params, tokens):
        """tokens [B, S] → logits [B, S, V] (fp32) under the parameter
        tree ``params`` (the JAX model's ``apply``), differentiable in
        it: what the RL losses run."""
        return forward(self.config, params, tokens,
                       use_kernels=self.use_kernels,
                       attn_fn=self._attention_fn(), **self._remat_knobs())

    def forward(self, tokens):
        """tokens [B, S] → logits [B, S, V] (fp32)."""
        return self.apply(self.params_tree(), tokens)

    def _lm_forward(self, params, batch, rng=None, ffn_amax=None):
        """Shared body of `loss_fn` / `loss_and_logits`: one block-stack
        forward → (final-norm hidden, masked labels, the MoE aux loss or
        None, the advanced amax histories or None)."""
        tokens, labels, seg = self._lm_batch(batch)
        cfg = self.config
        hidden = forward_hidden(cfg, params, tokens,
                                use_kernels=self.use_kernels, rng=rng,
                                attn_fn=self._attention_fn(),
                                segment_ids=seg, ffn_amax=ffn_amax,
                                **self._remat_knobs())
        aux = new_amax = None
        if cfg.moe_num_experts and ffn_amax is not None:
            hidden, aux, new_amax = hidden
        elif cfg.moe_num_experts:
            hidden, aux = hidden
        elif ffn_amax is not None:
            hidden, new_amax = hidden
        return hidden, labels, aux, new_amax

    def _head_loss(self, params, hidden, labels, aux):
        cfg = self.config
        loss = lm_head_loss(params, hidden, labels)
        if aux is None:
            return loss
        return loss + cfg.moe_aux_loss_coef * aux / max(cfg.num_layers, 1)

    def loss_fn(self, params, batch, rng=None, ffn_amax=None):
        """Scalar LM loss of ``batch`` (see `split_lm_batch`) under the
        parameter tree ``params`` (`params_tree()`), differentiable in
        it: `GPTNeoX.loss_fn` of the JAX package. With MoE it adds
        ``moe_aux_loss_coef`` times the blocks' mean aux loss; ``rng`` (a
        `torch.Generator` on the model's device) feeds the gate jitter.
        A packed batch's labels lose their pad and cross-document targets
        (`mask_cross_document_labels`), so packing changes the loss only
        through the attention it removes; with ``use_segment_ids`` (the
        "packing" block) a batch without segment ids raises. With
        ``ffn_amax`` (the quantized FFN's state, [L, 4, H] from
        `init_ffn_amax`) the return is (loss, new_ffn_amax): the engine
        threads the state from one micro-step to the next."""
        hidden, labels, aux, new_amax = self._lm_forward(
            params, batch, rng, ffn_amax=ffn_amax)
        loss = self._head_loss(params, hidden, labels, aux)
        return loss if ffn_amax is None else (loss, new_amax)

    def init_ffn_amax(self):
        """Zero amax-history state for `loss_fn(..., ffn_amax=)`,
        [num_layers, 4, ffn_quant_history] fp32 on the model's device;
        None when the config has no quantized-FFN recipe."""
        if self.config.ffn_quant_recipe is None:
            return None
        return init_amax_history(self.config.num_layers,
                                 self.config.ffn_quant_history,
                                 device=self.embed.wte.device)

    def loss_and_logits(self, params, batch, rng=None):
        """(loss, [B, S, V] fp32 logits) from one forward: what the
        engine's `eval_batch(return_logits=True)` runs."""
        hidden, labels, aux, _ = self._lm_forward(params, batch, rng)
        return self._head_loss(params, hidden, labels, aux), \
            lm_head(params, hidden)

    @torch.no_grad()
    def hidden_states(self, params, batch, rng=None):
        """The embedding, every block's output and the final-norm output
        of ``batch``'s tokens (the JAX model's ``collect_hidden`` forward:
        the same blocks, without remat), for the engine's
        activation capture."""
        tokens, _, seg = split_lm_batch(batch)
        hidden = []
        forward_hidden(self.config, params, tokens,
                       use_kernels=self.use_kernels, rng=rng,
                       attn_fn=self._attention_fn(), segment_ids=seg,
                       hidden=hidden)
        return hidden
