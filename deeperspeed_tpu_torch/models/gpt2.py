"""Megatron-GPT2 model family in PyTorch.

The port of `deeperspeed_tpu/models/gpt2.py` (the reference's
integration target, `tests/model/Megatron_GPT2/`). Differences from
GPT-NeoX (`models/gpt_neox.py`), as in Megatron GPT-2: learned absolute
position embeddings (``embed.wpe``) instead of rotary, the sequential
residual (x + attn; then + mlp) instead of the parallel one, input and
output embeddings tied (the LM head reads ``embed.wte``), pre-LN blocks.
The block body, the block stack with its remat spans, the layer norm
and the LM-head loss are GPT-NeoX's (`gpt_neox.block_stack`,
`lm_head_loss`): the block runs with ``use_parallel_residual=False`` and
a zero-width rotary cache, as the JAX model runs the NeoX `_block_core`.

Parameters carry the JAX pytree paths (``embed.wte``, ``embed.wpe``,
``blocks.{i}.attn.qkv_w``, ``final_ln.scale``) and the ``[in, out]``
weight layout, so `convert.state_dict_from_jax` carries a JAX GPT-2 tree
across unchanged.
"""

import dataclasses
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..runtime.packing import segment_relative_positions
from ..utils.device import resolve_device
from . import gpt_neox as neox


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_mult: int = 4
    layernorm_eps: float = 1e-5
    param_dtype: object = torch.float32
    # consumed by the shared NeoX block body: sequential residuals
    # (rotary is structurally absent: order comes from wpe)
    use_parallel_residual: bool = False
    # packed ragged batches (runtime/packing.py): loss_fn requires
    # (tokens, labels, segment_ids) and attention/wpe/loss become
    # segment-aware (the JSON "packing" block sets it)
    use_segment_ids: bool = False
    # the shared block reads it: a dense FFN
    moe_num_experts = 0

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def intermediate_size(self):
        return self.intermediate_mult * self.hidden_size

    def num_params(self):
        h, v, L = self.hidden_size, self.vocab_size, self.num_layers
        per_layer = (4 * h * h + 3 * h + h            # qkv (+bias), out w+b
                     + 2 * h * self.intermediate_size
                     + self.intermediate_size + h     # mlp w+b
                     + 4 * h)                         # 2x LN scale+bias
        return v * h + self.max_seq_len * h + L * per_layer + 2 * h

    # presets: the reference's Megatron_GPT2 test/perf configs
    @classmethod
    def small(cls, **kw):            # GPT-2 117M / Megatron "345M" shape
        return cls(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @classmethod
    def megatron_345m(cls, **kw):
        return cls(hidden_size=1024, num_layers=24, num_heads=16, **kw)

    @classmethod
    def megatron_1_5b(cls, **kw):    # the ZeRO-1 memory-demo model
        return cls(hidden_size=1600, num_layers=48, num_heads=25, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 64)
        return cls(hidden_size=32, num_layers=2, num_heads=2, **kw)


def param_shapes(cfg):
    """(dotted name, shape) of every parameter, in the module's
    registration order (the engine's flat layout)."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    out = [("embed.wte", (v, h)), ("embed.wpe", (cfg.max_seq_len, h))]
    for b in range(cfg.num_layers):
        out += [(f"blocks.{b}.{name}", shape) for name, shape in (
            ("ln_attn.scale", (h,)), ("ln_attn.bias", (h,)),
            ("attn.qkv_w", (h, 3 * h)), ("attn.qkv_b", (3 * h,)),
            ("attn.out_w", (h, h)), ("attn.out_b", (h,)),
            ("ln_mlp.scale", (h,)), ("ln_mlp.bias", (h,)),
            ("mlp.in_w", (h, i)), ("mlp.in_b", (i,)),
            ("mlp.out_w", (i, h)), ("mlp.out_b", (h,)))]
    return out + [("final_ln.scale", (h,)), ("final_ln.bias", (h,))]


def _init_leaf(cfg, name, param, gen):
    """The JAX `init_params` rule for one leaf: ones for norm scales,
    zeros for biases, normal × 0.02 for the weights and ``wte``, × 0.01
    for ``wpe``, × 0.02/√(2L) for the two out-projections."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        param.fill_(1.0)
    elif leaf == "bias" or leaf.endswith("_b"):
        param.zero_()
    elif leaf == "wpe":
        param.normal_(0.0, 0.01, generator=gen)
    elif leaf == "out_w":
        param.normal_(0.0, 0.02 / math.sqrt(2.0 * cfg.num_layers),
                      generator=gen)
    else:
        param.normal_(0.0, 0.02, generator=gen)


@torch.no_grad()
def init_params(cfg, gen, device=None):
    """Seeded random weights as the natural tree (nested dicts, a
    ``blocks`` list) on ``gen``'s device (or ``device``), in
    ``cfg.param_dtype``: the JAX `init_params(cfg, rng)` rule, drawn
    from the explicit `torch.Generator` ``gen`` in `param_shapes` order
    (so they are not the JAX package's numbers). `GPT2.init_params`
    fills a module with the same draws."""
    device = device if device is not None else gen.device
    flat = {}
    for name, shape in param_shapes(cfg):
        t = torch.empty(shape, dtype=cfg.param_dtype, device=device)
        _init_leaf(cfg, name, t, gen)
        flat[name] = t
    return neox.unflatten(flat)


def embed(params, tokens, positions=None):
    """tokens [B, S] → [B, S, H]: ``wte[tokens]`` plus the learned
    positions, ``wpe[:S]`` or ``wpe[positions]`` (per-token absolute or
    intra-document positions [B, S])."""
    e = params["embed"]
    if positions is None:
        wpe = e["wpe"][:tokens.shape[1]][None]
    else:
        wpe = e["wpe"][positions.long()]
    return e["wte"][tokens] + wpe


def forward_hidden(cfg, params, tokens, use_kernels=True, remat_blocks=False,
                   remat_policy=None, number_checkpoints=None,
                   segment_ids=None, hidden=None):
    """tokens [B, S] → final-norm hidden [B, S, H] (`gpt2.forward_hidden`
    of the JAX package). The blocks run through `gpt_neox.block_stack`
    (its remat knobs); ``hidden`` (a list) receives the embedding, every
    block's output and the final-norm output.

    ``segment_ids`` [B, S] (packed ragged batches, 0 = pad): attention
    becomes intra-document, and the learned position table is gathered
    at each token's intra-document position (a packed document sees the
    same wpe rows as the same document padded alone)."""
    positions = None
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
        positions = segment_relative_positions(segment_ids)
    x = embed(params, tokens, positions)
    if hidden is not None:
        hidden.append(x)
    S = tokens.shape[1]
    no_rotary = (torch.zeros((S, 0), device=x.device),
                 torch.zeros((S, 0), device=x.device), 0)
    x = neox.block_stack(cfg, params["blocks"], x, no_rotary,
                         use_kernels=use_kernels, remat_blocks=remat_blocks,
                         remat_policy=remat_policy,
                         number_checkpoints=number_checkpoints,
                         segment_ids=segment_ids, hidden=hidden)
    out = neox.layer_norm(x, params["final_ln"]["scale"],
                          params["final_ln"]["bias"], cfg.layernorm_eps)
    if hidden is not None:
        hidden.append(out)
    return out


def forward(cfg, params, tokens, use_kernels=True, **remat):
    """tokens [B, S] → logits [B, S, V] fp32 (tied embeddings);
    ``remat`` takes `forward_hidden`'s remat knobs."""
    return neox.lm_head(params, forward_hidden(cfg, params, tokens,
                                               use_kernels, **remat))


class GPT2(neox.LMModule):
    """The GPT-2 model with the JAX package's parameter names and
    ``[in, out]`` weight layout. Parameters are created empty on
    ``device`` (None means the GPU, and raises without CUDA; the CPU
    must be asked for): call `init_params(seed)` or
    `load_jax_params(params)`, or hand a tree to `initialize(...,
    model_parameters=)`.

    ``use_kernels`` (the JAX model's ``use_pallas``) sends attention
    through the hand-written flash kernels; False keeps the plain
    PyTorch versions. The remat knobs, ``scan_blocks``, the JAX tree's
    loading, the packed batch's checks and the layer names are GPT-NeoX's
    (`gpt_neox.LMModule`)."""

    def __init__(self, config=None, use_kernels=True, device=None,
                 remat_blocks=False, scan_blocks=False, remat_policy=None,
                 number_checkpoints=None, **kwargs):
        cfg = config or GPT2Config(**kwargs)
        device = resolve_device(device, "GPT2")
        super().__init__(cfg, use_kernels, remat_blocks, scan_blocks,
                         remat_policy, number_checkpoints)
        shapes = dict(param_shapes(cfg))
        h, dt = cfg.hidden_size, cfg.param_dtype

        def p(name):
            return (shapes[name], dt, device)

        self.embed = neox._holder(wte=p("embed.wte"), wpe=p("embed.wpe"))
        self.blocks = nn.ModuleList()
        for b in range(cfg.num_layers):
            blk = nn.Module()
            for part, leaves in (("ln_attn", ("scale", "bias")),
                                 ("attn", ("qkv_w", "qkv_b", "out_w",
                                           "out_b")),
                                 ("ln_mlp", ("scale", "bias")),
                                 ("mlp", ("in_w", "in_b", "out_w",
                                          "out_b"))):
                setattr(blk, part, neox._holder(**{
                    leaf: p(f"blocks.{b}.{part}.{leaf}") for leaf in leaves}))
            self.blocks.append(blk)
        self.final_ln = neox._holder(scale=((h,), dt, device),
                                     bias=((h,), dt, device))

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random init (`init_params`' rule and draws, from a
        `torch.Generator` on the parameters' device seeded ``seed``)."""
        device = next(self.parameters()).device
        gen = torch.Generator(device=device).manual_seed(int(seed))
        for name, param in self.named_parameters():
            _init_leaf(self.config, name, param, gen)
        return self

    @torch.no_grad()
    def apply_ds_config(self, ds_config):
        """Wire the JSON "activation_checkpointing" and "packing" blocks
        into the model (the JAX `GPT2.apply_ds_config`): "moe",
        "sparse_attention" and sequence parallelism are refused with the
        JAX package's errors (`gpt_neox.reject_unsupported_ds_blocks`)."""
        neox.reject_unsupported_ds_blocks(ds_config, "GPT2")
        if getattr(ds_config, "packing_params", None):
            self.config = dataclasses.replace(self.config,
                                              use_segment_ids=True)
        neox.apply_activation_checkpointing_config(self, ds_config)

    def apply(self, params, tokens):
        """tokens [B, S] → logits [B, S, V] fp32 under ``params``."""
        return forward(self.config, params, tokens, self.use_kernels,
                       **self._remat_knobs())

    def forward(self, tokens):
        """tokens [B, S] → logits [B, S, V] fp32."""
        return self.apply(self.params_tree(), tokens)

    def _lm_forward(self, params, batch):
        """Shared body of `loss_fn` / `loss_and_logits`: one block-stack
        forward → (final-norm hidden, masked labels)."""
        tokens, labels, seg = self._lm_batch(batch)
        hidden = forward_hidden(self.config, params, tokens,
                                use_kernels=self.use_kernels,
                                segment_ids=seg, **self._remat_knobs())
        return hidden, labels

    def loss_fn(self, params, batch, rng=None):
        """Scalar LM loss of ``batch`` (bare tokens, (tokens, labels) or
        a packed (tokens, labels, segment_ids) triple) under the tree
        ``params``, differentiable in it: the tied head's next-token
        cross entropy (`gpt_neox.lm_head_loss`). ``rng`` is accepted for
        the engine's protocol; GPT-2 draws nothing."""
        return neox.lm_head_loss(params, *self._lm_forward(params, batch))

    def loss_and_logits(self, params, batch, rng=None):
        """(loss, [B, S, V] fp32 logits) from one forward: what the
        engine's `eval_batch(return_logits=True)` runs."""
        hidden, labels = self._lm_forward(params, batch)
        return neox.lm_head_loss(params, hidden, labels), \
            neox.lm_head(params, hidden)

    # -- layer-activation capture (engine.set_layers_to_hook) ------------

    @torch.no_grad()
    def hidden_states(self, params, batch, rng=None):
        """The embedding, every block's output and the final-norm output
        of ``batch``'s tokens (the same blocks, without remat), for the
        engine's activation capture."""
        tokens, _, seg = neox.split_lm_batch(batch)
        hidden = []
        forward_hidden(self.config, params, tokens,
                       use_kernels=self.use_kernels, segment_ids=seg,
                       hidden=hidden)
        return hidden
