"""RolloutBuffer: engine-generated rollouts -> fixed-shape RL batches.

The port of `deeperspeed_tpu/rl/buffer.py`. The buffer owns the
geometry contract of the loop: every iteration's rollouts are padded to
ONE ``[rollouts_per_iteration, sequence_length]`` shape, so the
training step, the behavior-logprob eval and the frozen-reference
forward take the same shapes every iteration. It also holds the frozen
reference parameters and recomputes reference logprobs through the
model's ``loss_and_logits`` single-forward path (fp32 logits; the path
``eval_batch`` takes), so policy and reference logprobs are
numerically comparable by construction.

The host side (padding, the mask, advantages, DPO pairs) is numpy, as
in the JAX package; only the reference forward runs on the device.
"""

import numpy as np
import torch

from ..runtime import constants as c
from ..runtime.config_utils import DeepSpeedConfigError
from .losses import token_logprobs

# pad id for positions past the rollout; never enters the loss (the
# response mask zeroes prompt and pad transitions alike)
PAD_ID = 0


class RolloutBuffer:
    """Pads, masks and scores one iteration's rollouts at a time.

    ``rollouts`` is a list of dicts with ``prompt`` (list[int]),
    ``response`` (list[int], the generated continuation) and ``reward``
    (float), grouped contiguously: rollouts ``[g*group_size, (g+1)*
    group_size)`` share prompt ``g``.

    ``ref_params`` is the frozen reference: a natural parameter tree
    (`GPTNeoX.params_tree()`'s structure) of tensors on the model's
    device, kept as it is. The caller hands detached copies: a tree of
    views into a training buffer would follow the updates and zero the
    KL anchor."""

    def __init__(self, model, ref_params, rl_params, sequence_length):
        self.model = model
        self.rl_params = rl_params
        self.group_size = rl_params[c.RL_GROUP_SIZE]
        self.sequence_length = int(sequence_length)
        if self.sequence_length < 2:
            raise DeepSpeedConfigError(
                f"RolloutBuffer sequence_length must be >= 2, got "
                f"{self.sequence_length}")
        # frozen on the device for the life of the run
        self.device = next(model.parameters()).device
        self._ref_params = ref_params
        # rollouts consumed over the run; checkpointed so a resumed
        # driver reports continuous telemetry
        self.consumed = 0

    # -- geometry ----------------------------------------------------------

    def pad(self, rollouts):
        """-> (tokens [N,S] int32, mask [N,S-1] float32). ``mask[i, j]``
        weights the transition predicting ``tokens[i, j+1]``: 1 exactly
        when that token was GENERATED (not prompt, not pad)."""
        n, s = len(rollouts), self.sequence_length
        tokens = np.full((n, s), PAD_ID, dtype=np.int32)
        mask = np.zeros((n, s - 1), dtype=np.float32)
        for i, r in enumerate(rollouts):
            prompt, response = list(r["prompt"]), list(r["response"])
            total = len(prompt) + len(response)
            if total > s:
                raise DeepSpeedConfigError(
                    f"Rollout {i} is {total} tokens but rl sequence_length "
                    f"is {s}: raise rl.sequence_length (fixed shapes are "
                    f"the zero-recompile contract; there is no bucket "
                    f"ladder on the training side)")
            if not response:
                raise DeepSpeedConfigError(
                    f"Rollout {i} has an empty response: nothing to score")
            tokens[i, :total] = prompt + response
            mask[i, len(prompt) - 1:total - 1] = 1.0
        return tokens, mask

    # -- scoring -----------------------------------------------------------

    @torch.no_grad()
    def ref_logprobs(self, tokens):
        """Teacher-forced logprobs [N,S-1] (numpy fp32) under the frozen
        reference."""
        t = torch.as_tensor(np.asarray(tokens)).to(self.device, torch.long)
        # loss_and_logits returns fp32 logits from the single-forward
        # path, the one the training-side eval also takes
        _, logits = self.model.loss_and_logits(self._ref_params, t)
        return token_logprobs(logits, t).cpu().numpy()

    def advantages(self, rewards):
        """Group-normalized advantages [N] (GRPO-style): each rollout's
        reward centered and scaled within its prompt group; with
        group_size 1 the whole iteration is the baseline group."""
        r = np.asarray(rewards, dtype=np.float32)
        g = self.group_size if self.group_size > 1 else len(r)
        grouped = r.reshape(-1, g)
        mean = grouped.mean(axis=1, keepdims=True)
        std = grouped.std(axis=1, keepdims=True)
        return ((grouped - mean) / (std + 1e-6)).reshape(-1)

    # -- batch assembly ----------------------------------------------------

    def build_ppo_batch(self, tokens, mask, behavior_logp, ref_logp,
                        rewards):
        self.consumed += len(tokens)
        return {
            "tokens": tokens,
            "mask": mask,
            "behavior_logp": np.asarray(behavior_logp, dtype=np.float32),
            "ref_logp": np.asarray(ref_logp, dtype=np.float32),
            "advantages": self.advantages(rewards),
        }

    def build_dpo_batch(self, tokens, mask, ref_logp, rewards):
        """Pick the (argmax, argmin)-reward pair inside each prompt
        group and interleave them chosen-first: rows [2P, S] with chosen
        at ::2, rejected at 1::2 (the layout `build_dpo` slices).
        Deterministic ties: numpy arg* take the first index."""
        self.consumed += len(tokens)
        r = np.asarray(rewards, dtype=np.float32).reshape(
            -1, self.group_size)
        groups = np.arange(r.shape[0]) * self.group_size
        chosen = groups + r.argmax(axis=1)
        rejected = groups + r.argmin(axis=1)
        order = np.stack([chosen, rejected], axis=1).reshape(-1)
        return {
            "tokens": tokens[order],
            "mask": mask[order],
            "ref_logp": np.asarray(ref_logp, dtype=np.float32)[order],
        }

    # -- resume ------------------------------------------------------------

    def state_dict(self):
        return {"consumed": int(self.consumed)}

    def load_state_dict(self, state):
        self.consumed = int(state["consumed"])
