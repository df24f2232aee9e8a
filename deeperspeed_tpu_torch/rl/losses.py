"""Pluggable RL loss registry: the port of `deeperspeed_tpu/rl/losses.py`.

Each entry is a BUILDER ``build(model, rl_params) -> loss_fn`` where the
returned ``loss_fn(params, batch, rng=None)`` has the signature
`DeepSpeedEngine` expects of its ``loss_fn``: a scalar tensor,
differentiable in the parameter tree ``params`` (autograd gives the
gradients the JAX package takes with ``jax.value_and_grad``). ``batch``
is a dict of tensors; the engine moves each leaf to the device with its
kind kept and hands it over one micro-batch at a time.

Both losses consume TEACHER-FORCED token logprobs: one full forward over
the padded rollout ``tokens [B, S]``, ``log_softmax`` over positions
``[:, :-1]`` gathered at the next token ``tokens[:, 1:]`` -> ``[B, S-1]``,
with a ``mask [B, S-1]`` selecting the response (generated) transitions.
Prompt and pad positions carry zero weight, so the pad id is
loss-irrelevant by construction.
"""

import torch
import torch.nn.functional as F

from ..runtime import constants as c
from ..runtime.config_utils import DeepSpeedConfigError

_RL_LOSSES = {}


def register_rl_loss(name):
    """Decorator: register ``build(model, rl_params) -> loss_fn`` under
    ``name`` (the value of the ``rl.loss`` config key)."""

    def wrap(build):
        _RL_LOSSES[name] = build
        return build

    return wrap


def get_rl_loss(name):
    """Look up a registered RL loss builder by ``rl.loss`` name."""
    try:
        return _RL_LOSSES[name]
    except KeyError:
        raise DeepSpeedConfigError(
            f"Unknown RL loss {name!r}; registered: "
            f"{sorted(_RL_LOSSES)}") from None


def token_logprobs(logits, tokens):
    """Next-token logprobs: ``[B, S, V]`` logits + ``[B, S]`` tokens ->
    ``[B, S-1]`` logprob of ``tokens[:, j]`` under position ``j-1``.

    log_softmax runs in fp32: PPO ratios exponentiate a logprob
    DIFFERENCE, and bf16 rounding there is a spurious off-policy
    signal, not noise."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    target = tokens[:, 1:].long()
    return logp.gather(-1, target[..., None])[..., 0]


def _masked_mean(x, mask):
    return (x * mask).sum() / mask.sum().clamp(min=1.0)


@register_rl_loss("ppo_clip")
def build_ppo_clip(model, rl_params):
    """PPO-clip with a k1 KL penalty against the frozen reference.

    batch: tokens [B,S] int, mask [B,S-1] f32, behavior_logp [B,S-1],
    ref_logp [B,S-1], advantages [B]. ``behavior_logp`` is the policy
    that SAMPLED the rollout (pre-update weights), recomputed
    teacher-forced through ``eval_batch`` so sampler-side dtype and
    kernel choices cannot skew the ratio."""
    clip_ratio = rl_params[c.RL_CLIP_RATIO]
    kl_coef = rl_params[c.RL_KL_COEF]

    def loss_fn(params, batch, rng=None):
        del rng  # sampling happened serve-side; the update is deterministic
        logits = model.apply(params, batch["tokens"])
        logp = token_logprobs(logits, batch["tokens"])
        mask = batch["mask"].float()
        ratio = torch.exp(logp - batch["behavior_logp"])
        adv = batch["advantages"][:, None]
        clipped = ratio.clamp(1.0 - clip_ratio, 1.0 + clip_ratio)
        pg = -_masked_mean(torch.minimum(ratio * adv, clipped * adv), mask)
        kl = _masked_mean(logp - batch["ref_logp"], mask)
        return pg + kl_coef * kl

    return loss_fn


@register_rl_loss("dpo")
def build_dpo(model, rl_params):
    """DPO over chosen/rejected pairs (2305.18290).

    batch: tokens [2P,S] with chosen rollouts at even rows and their
    rejected partners at the following odd rows, mask [2P,S-1],
    ref_logp [2P,S-1]. Sequence logprob = masked token-logprob sum;
    loss = -mean log sigmoid(beta * (margin_chosen - margin_rejected))
    where margin = policy seq-logprob minus frozen-reference
    seq-logprob."""
    beta = rl_params[c.RL_BETA]

    def loss_fn(params, batch, rng=None):
        del rng
        logits = model.apply(params, batch["tokens"])
        logp = token_logprobs(logits, batch["tokens"])
        mask = batch["mask"].float()
        seq_logp = (logp * mask).sum(dim=-1)
        ref_seq_logp = (batch["ref_logp"] * mask).sum(dim=-1)
        margin = seq_logp - ref_seq_logp
        pref = margin[0::2] - margin[1::2]
        return -F.logsigmoid(beta * pref).mean()

    return loss_fn
