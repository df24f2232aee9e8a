"""BERT model family in PyTorch: the port of
`deeperspeed_tpu/models/bert.py`.

The encoder stacks `DeepSpeedTransformerLayer` (`ops/transformer`), the
fused layer whose attention takes the hand-written flash kernels with
the key-bias and dropout flags. Heads follow the JAX package: the
masked-LM transform with a decoder tied to the word embedding and the
next-sentence head (`BertForPreTraining`), and the SQuAD span head
(`BertForQuestionAnswering`).

As in `models/gpt_neox.py`, parameters carry the JAX pytree paths and
the ``[in, out]`` layout (``embeddings.word``, ``layers.0.attn_qkvw``,
``pooler.w``, ``cls.transform_w``), so `load_jax_params` takes the JAX
params with ``strict=True``; the forward is written on a parameter tree
(`params_tree()`), which the training engine differentiates. The heads
subclass `BertModel`, so their parameters sit at the top level, as in
the JAX pytree, and ``model.bert`` is the model itself.

Dropout: the JAX model runs it whenever its loss gets an rng
(``deterministic = rng is None``), and the JAX engine's `eval_batch`
passes ``PRNGKey(0)``, so its eval loss includes dropout; the port's
engine passes a generator seeded 0 and its eval loss does too. The
seeds of every layer (attention, attention-output dropout, FFN dropout)
are drawn as one int32 [L, 3] tensor on the device.

The remat knobs run the encoder as recompute spans
(`runtime/activation_checkpointing`), and `encode(segment_ids=)` takes
packed rows. The pipeline factories (`BertEmbeddingsPipe` …
`to_layer_specs`) wait for the pipeline and tensor-parallel
`param_specs` for the ranks (ROADMAP.md).
"""

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.transformer.transformer import (DeepSpeedTransformerConfig,
                                           DeepSpeedTransformerLayer,
                                           _layer_norm, attention_bias,
                                           draw_seeds)
from ..runtime.activation_checkpointing.checkpointing import \
    checkpoint_span
from ..runtime.packing import segment_relative_positions
from ..utils.device import resolve_device
from .gpt_neox import (_holder, apply_activation_checkpointing_config,
                       reject_unsupported_ds_blocks, resolve_remat,
                       segment_sizes, unflatten)


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528          # 30522 padded to a 64-multiple
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layernorm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = True      # reference kernels default preLN
    param_dtype: object = torch.float32
    # MLM logits rest in the activation dtype (bf16) by default, as in
    # the JAX package; True keeps them fp32
    fp32_mlm_logits: bool = False

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        return cls(vocab_size=512, hidden_size=64, num_layers=2,
                   num_heads=4, intermediate_size=256,
                   max_position_embeddings=128, **kw)

    def num_params(self):
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = 4 * h * h + 2 * h * i + 9 * h + i
        embed = (v + self.max_position_embeddings +
                 self.type_vocab_size) * h + 2 * h
        pooler = h * h + h
        mlm = h * h + h + 2 * h + v      # transform + LN + decoder bias
        nsp = h * 2 + 2
        return embed + self.num_layers * per_layer + pooler + mlm + nsp

    def transformer_config(self, training=True):
        return DeepSpeedTransformerConfig(
            hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            heads=self.num_heads,
            attn_dropout_ratio=self.attn_dropout,
            hidden_dropout_ratio=self.hidden_dropout,
            num_hidden_layers=self.num_layers,
            initializer_range=self.initializer_range,
            layer_norm_eps=self.layernorm_eps,
            pre_layer_norm=self.pre_layer_norm,
            training=training,
            adjust_init_range=True)


class BertModel(nn.Module):
    """Embeddings + encoder + pooler. Parameters are created empty on
    ``device`` (None means the GPU, and raises without CUDA): call
    `init_params(seed)` or `load_jax_params(params)`. ``use_kernels``
    False keeps the flash kernels' plain versions. The remat knobs
    (`gpt_neox.resolve_remat` semantics): ``remat_policy`` names what a
    span keeps and ``number_checkpoints`` groups the encoder into that
    many spans (per layer without it); the JSON
    "activation_checkpointing" block sets them."""

    def __init__(self, config=None, remat_policy=None,
                 number_checkpoints=None, use_kernels=True, device=None,
                 **kw):
        super().__init__()
        self.remat_policy = remat_policy
        self.number_checkpoints = number_checkpoints
        cfg = config or BertConfig(**kw)
        device = resolve_device(device, type(self).__name__)
        self.config = cfg
        self.use_kernels = use_kernels
        h, dt = cfg.hidden_size, cfg.param_dtype

        def p(*shape):
            return (shape, dt, device)

        self.embeddings = _holder(
            word=p(cfg.vocab_size, h),
            position=p(cfg.max_position_embeddings, h),
            token_type=p(cfg.type_vocab_size, h),
            ln_scale=p(h), ln_bias=p(h))
        tcfg = cfg.transformer_config()
        self.layers = nn.ModuleList(
            DeepSpeedTransformerLayer(tcfg, device=device)
            for _ in range(cfg.num_layers))
        self.pooler = _holder(w=p(h, h), b=p(h))

    @property
    def bert(self):
        """The encoder (the JAX heads' ``.bert``): the model itself."""
        return self

    def apply_ds_config(self, ds_config):
        """Refuse the blocks BERT does not implement and take the
        "activation_checkpointing" block's remat knobs (the JAX
        `BertModel.apply_ds_config`); the training engine calls it."""
        reject_unsupported_ds_blocks(ds_config, "BERT")
        if getattr(ds_config, "packing_params", None):
            # the BERT loss paths consume MLM/classification batches, not
            # the LM (tokens, labels, segment_ids) triples the packing
            # block promises; the encoder itself takes segment ids
            raise NotImplementedError(
                "the packing config block targets the LM families "
                "(GPT-NeoX / GPT-2); for packed encoder runs pass "
                "segment_ids to BertModel.encode() directly")
        apply_activation_checkpointing_config(self, ds_config)

    # -- params -----------------------------------------------------------

    def _init_head_param(self, name, param, gen):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "ln_scale":
            param.fill_(1.0)
        elif leaf in ("b", "ln_bias") or leaf.endswith("_b") or \
                leaf.endswith("_bias"):
            param.zero_()
        else:
            param.normal_(0.0, self.config.initializer_range, generator=gen)

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random init with the JAX rules (normal × 0.02 for the
        embeddings and dense weights, the layer's rule in each layer,
        ones/zeros for norms and biases). The draws come from a
        `torch.Generator`, not the JAX package's numbers; tests carry
        JAX weights over instead."""
        gen = torch.Generator(device=self.embeddings.word.device) \
            .manual_seed(int(seed))
        for name, param in self.named_parameters():
            if name.startswith("layers."):
                _, i, leaf = name.split(".")
                self.layers[int(i)].init_param(leaf, param, gen)
            else:
                self._init_head_param(name, param, gen)
        return self

    def load_jax_params(self, params):
        """Load the JAX package's natural params pytree (numpy leaves —
        call ``jax.device_get`` first) into this module."""
        from .convert import state_dict_from_jax
        self.load_state_dict(state_dict_from_jax(params))
        return self

    def params_tree(self):
        """The parameters as the natural tree the functional forward
        takes (``layers`` a list)."""
        return unflatten(dict(self.named_parameters()))

    # -- forward ----------------------------------------------------------

    def embed(self, params, input_ids, token_type_ids=None,
              segment_ids=None):
        """Word + position + token-type embeddings, normed. With
        ``segment_ids`` (packed rows) the position table is gathered at
        each token's intra-document position, so a packed document sees
        the position rows of the same document alone."""
        e = params["embeddings"]
        input_ids = input_ids.long()
        S = input_ids.shape[1]
        if segment_ids is None:
            pos = e["position"][None, :S, :]
        else:
            pos = e["position"][
                segment_relative_positions(segment_ids).long()]
        x = e["word"][input_ids] + pos
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = x + e["token_type"][token_type_ids.long()]
        return _layer_norm(x, e["ln_scale"], e["ln_bias"],
                           self.config.layernorm_eps)

    def encode(self, params, input_ids, token_type_ids=None,
               attention_mask=None, rng=None, deterministic=True,
               collect_hidden=False, segment_ids=None):
        """Embeddings + encoder → [B, S, H]; with ``collect_hidden``
        also the per-layer outputs. ``rng`` (a `torch.Generator` on the
        model's device) feeds every layer's dropout seeds unless
        ``deterministic``; they are drawn before the layers, so a span's
        recompute draws the same masks.

        ``segment_ids`` [B, S] int (packed rows, 0 = pad): every layer's
        attention becomes intra-document (bidirectional within a
        document) and the position embedding is gathered at
        intra-document positions.

        With remat knobs set (and no hidden collection) the encoder runs
        as `number_checkpoints` recompute spans (one per layer without
        it) under the named policy."""
        x = self.embed(params, input_ids, token_type_ids,
                       segment_ids=segment_ids)
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        hidden = [x] if collect_hidden else None
        L = self.config.num_layers
        seeds = draw_seeds(rng, (L, 3)) \
            if rng is not None and not deterministic else [None] * L
        # the mask's key bias, built once for every layer
        kbias, _ = attention_bias(attention_mask, *x.shape[:2], x.device)
        mask = attention_mask if kbias is None else None

        def run_layers(first, last, x, seeds):
            for layer, lp, sd in zip(self.layers[first:last],
                                     params["layers"][first:last], seeds):
                x = layer.apply(lp, x, attention_mask=mask, key_bias=kbias,
                                deterministic=deterministic, seeds=sd,
                                segment_ids=segment_ids,
                                use_kernels=self.use_kernels)
            return x

        do_remat, policy, n_ckpt = (False, None, None) if collect_hidden \
            else resolve_remat(False, self.remat_policy,
                               self.number_checkpoints)
        if do_remat:
            idx = 0
            for size in segment_sizes(L, n_ckpt if n_ckpt is not None
                                      else L):
                x = checkpoint_span(
                    functools.partial(run_layers, idx, idx + size), x,
                    seeds[idx:idx + size], policy=policy)
                idx += size
            return x
        for i in range(L):
            x = run_layers(i, i + 1, x, seeds[i:i + 1])
            if collect_hidden:
                hidden.append(x)
        if collect_hidden:
            return x, hidden
        return x

    def pool(self, params, sequence_output):
        first = sequence_output[:, 0, :]
        return torch.tanh(first @ params["pooler"]["w"].to(first.dtype) +
                          params["pooler"]["b"].to(first.dtype))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """[B, S] ids → (sequence output [B, S, H], pooled [B, H]),
        without dropout."""
        params = self.params_tree()
        seq = self.encode(params, input_ids, token_type_ids,
                          attention_mask)
        return seq, self.pool(params, seq)


def _unpack_pretraining(batch):
    if isinstance(batch, dict):
        return (batch["input_ids"], batch.get("token_type_ids"),
                batch.get("attention_mask"), batch["masked_lm_labels"],
                batch["next_sentence_label"])
    return batch


class BertForPreTraining(BertModel):
    """MLM + NSP pretraining heads (the bert-pretraining workload).

    Batch: a dict with ``input_ids``, ``token_type_ids``,
    ``attention_mask``, ``masked_lm_labels`` (the label id at masked
    positions, -1 elsewhere) and ``next_sentence_label``, or the tuple
    of those five.
    """

    def __init__(self, config=None, use_kernels=True, device=None, **kw):
        super().__init__(config, use_kernels=use_kernels, device=device,
                         **kw)
        cfg = self.config
        h, dt, dev = cfg.hidden_size, cfg.param_dtype, \
            self.embeddings.word.device
        self.cls = _holder(
            transform_w=((h, h), dt, dev), transform_b=((h,), dt, dev),
            ln_scale=((h,), dt, dev), ln_bias=((h,), dt, dev),
            decoder_bias=((cfg.vocab_size,), dt, dev),
            nsp_w=((h, 2), dt, dev), nsp_b=((2,), dt, dev))

    def apply(self, params, input_ids, token_type_ids=None,
              attention_mask=None, rng=None, deterministic=True):
        """→ (MLM logits [B, S, V] in the activation dtype, or fp32 with
        ``fp32_mlm_logits``; NSP logits [B, 2] fp32)."""
        cfg = self.config
        seq = self.encode(params, input_ids, token_type_ids,
                          attention_mask, rng, deterministic)
        c = params["cls"]
        t = seq @ c["transform_w"].to(seq.dtype) + \
            c["transform_b"].to(seq.dtype)
        t = F.gelu(t)
        t = _layer_norm(t, c["ln_scale"], c["ln_bias"], cfg.layernorm_eps)
        # the decoder is tied to the word embedding; its products sum in
        # fp32 and the logits rest in the activation dtype
        word = params["embeddings"]["word"]
        if cfg.fp32_mlm_logits:
            mlm_logits = t.float() @ word.to(t.dtype).float().t() + \
                c["decoder_bias"].float()
        else:
            mlm_logits = t @ word.to(t.dtype).t() + \
                c["decoder_bias"].to(t.dtype)
        pooled = self.pool(params, seq)
        nsp_logits = pooled @ c["nsp_w"].to(pooled.dtype) + \
            c["nsp_b"].to(pooled.dtype)
        return mlm_logits, nsp_logits.float()

    def loss_fn(self, params, batch, rng=None):
        """MLM loss (the lse of the logits minus the label's logit, in
        fp32, over the labelled positions) plus the NSP loss; dropout is
        on whenever ``rng`` is given."""
        input_ids, token_type_ids, attention_mask, mlm_labels, nsp_label = \
            self._unpack(batch)
        mlm_logits, nsp_logits = self.apply(
            params, input_ids, token_type_ids, attention_mask, rng,
            deterministic=rng is None)
        l32 = mlm_logits.float()
        lse = torch.logsumexp(l32, dim=-1)                     # [B, S]
        valid = mlm_labels >= 0
        safe = torch.where(valid, mlm_labels, 0).long()
        picked = torch.gather(l32, -1, safe[..., None]).squeeze(-1)
        mlm_loss = ((lse - picked) * valid).sum() / \
            valid.sum().clamp(min=1)
        nsp_logp = F.log_softmax(nsp_logits, dim=-1)
        nsp_loss = -torch.gather(nsp_logp, -1,
                                 nsp_label.long()[:, None]).mean()
        return mlm_loss + nsp_loss

    _unpack = staticmethod(_unpack_pretraining)

    # -- layer-activation capture ----------------------------------------

    def layer_names(self):
        return ["embedding"] + \
            ["transformerlayer"] * self.config.num_layers

    @torch.no_grad()
    def hidden_states(self, params, batch, rng=None):
        """The embedding output and every layer's output, without
        dropout or gradients."""
        input_ids, token_type_ids, attention_mask, *_ = self._unpack(batch)
        _, outs = self.encode(params, input_ids, token_type_ids,
                              attention_mask, rng=None, deterministic=True,
                              collect_hidden=True)
        return outs


class BertForQuestionAnswering(BertModel):
    """SQuAD span head. Batch: (input_ids, token_type_ids,
    attention_mask, start_positions, end_positions), or a dict of those
    names."""

    def __init__(self, config=None, use_kernels=True, device=None, **kw):
        super().__init__(config, use_kernels=use_kernels, device=device,
                         **kw)
        cfg = self.config
        dev = self.embeddings.word.device
        self.qa = _holder(w=((cfg.hidden_size, 2), cfg.param_dtype, dev),
                          b=((2,), cfg.param_dtype, dev))

    def apply(self, params, input_ids, token_type_ids=None,
              attention_mask=None, rng=None, deterministic=True):
        seq = self.encode(params, input_ids, token_type_ids,
                          attention_mask, rng, deterministic)
        logits = seq @ params["qa"]["w"].to(seq.dtype) + \
            params["qa"]["b"].to(seq.dtype)
        start, end = logits.float().split(1, dim=-1)
        return start.squeeze(-1), end.squeeze(-1)

    def loss_fn(self, params, batch, rng=None):
        if isinstance(batch, dict):
            batch = (batch["input_ids"], batch.get("token_type_ids"),
                     batch.get("attention_mask"), batch["start_positions"],
                     batch["end_positions"])
        input_ids, token_type_ids, attention_mask, start_pos, end_pos = batch
        start_logits, end_logits = self.apply(
            params, input_ids, token_type_ids, attention_mask, rng,
            deterministic=rng is None)

        def xent(logits, pos):
            logp = F.log_softmax(logits, dim=-1)
            return -torch.gather(logp, -1, pos.long()[:, None]).mean()

        return 0.5 * (xent(start_logits, start_pos) +
                      xent(end_logits, end_pos))
