"""RLDriver: the co-located train+serve online-RL loop.

The port of `deeperspeed_tpu/rl/driver.py`. One process holds both
engines on one device: the `DeepSpeedEngine` whose ``loss_fn`` the "rl"
config block swapped for PPO-clip or DPO, and an `InferenceEngine`
generating rollouts under the continuous-batching scheduler from the
SAME initial weights. Each iteration:

    rollout (serve) -> reward -> reference/behavior logprobs ->
    train_batch (one update) -> hot_swap_weights (train->serve)

Neither engine shares storage with the other. The serving engine and
the frozen reference hold copies (`DeepSpeedEngine.params_to_natural`):
the trainer's parameters are views into a flat buffer that Adam writes
in place, so a serving engine or a reference built on views would move
with every update (the rollouts would change weights without a swap,
and the KL to the reference would read 0).

The loop is deterministic and replayable: rollout sampling is a function
of (inference.seed, the sampler's program counter), the training side of
the engine's full-state resume (``micro_steps`` seeds the step's
generator), and checkpoints COMMIT only at iteration boundaries with the
driver state (iteration counter, prompt cursor, sampler state, buffer
counters) in ``client_state["rl"]``, so a kill mid-iteration resumes
from the last committed boundary and replays the killed iteration bit
for bit.
"""

import os
import time

import numpy as np
import torch

from ..checkpoint.serialization import (bf16_leaf, load_obj, save_obj,
                                       to_tensor)
from ..inference.engine import InferenceEngine
from ..models.convert import _flatten
from ..models.gpt_neox import unflatten
from ..runtime import constants as c
from ..runtime.config_utils import DeepSpeedConfigError
from ..utils.logging import logger
from .buffer import RolloutBuffer
from .losses import token_logprobs

# the frozen-reference snapshot rides NEXT TO the engine checkpoints:
# written exactly once (iteration 0), loaded on every later construction;
# re-snapshotting the CURRENT (trained) params as "reference" would
# silently zero the KL anchor every restart
REF_SNAPSHOT = "rl_ref_params.pt"


def _round_up8(n):
    return -(-n // 8) * 8


def snapshot_tree(natural):
    """``{dotted name: tensor}`` → the JAX driver's snapshot layout: the
    natural tree of numpy arrays in the leaves' own dtypes, bf16 as
    `ml_dtypes.bfloat16` arrays (`bf16_leaf`). The JAX driver loads the
    file with no template and casts nothing, so a leaf's dtype there is
    the dtype its reference forward computes in."""
    return unflatten({
        name: bf16_leaf(t) if t.dtype == torch.bfloat16
        else t.detach().cpu().numpy()
        for name, t in natural.items()})


def load_snapshot(path, like, device):
    """A snapshot file (written by either package) → ``{dotted name:
    tensor}`` on ``device`` with the dtypes of ``like`` (the trainer's
    natural parameters): exact for leaves the file holds at or above
    that precision (bf16 leaves, of either package's file, arrive as their
    words through `load_obj`)."""
    flat = _flatten(load_obj(path), "", {})
    if set(flat) != set(like):
        raise DeepSpeedConfigError(
            f"rl reference snapshot {path} holds parameters "
            f"{sorted(set(flat) ^ set(like))} that do not match the "
            f"model's")
    return {name: to_tensor(flat[name]).to(device=device,
                                           dtype=like[name].dtype)
            for name in like}


class RLDriver:
    """Drives the online-RL loop over a training engine built with an
    enabled "rl" config block.

    ``prompts`` is a list of token-id lists, cycled deterministically;
    ``reward_fn(prompt_tokens, response_tokens) -> float`` scores each
    engine-generated rollout; ``serve_config`` is the co-resident
    serving engine's config (a dict with an "inference" block, or a JSON
    path); its ``seed`` is the rollout sampling seed. The serving engine
    runs on the training engine's device."""

    def __init__(self, engine, prompts, reward_fn, serve_config,
                 draft_model=None, draft_params=None, checkpoint_dir=None,
                 eos_token_id=None):
        p = getattr(engine._config, "rl_params", None)
        if not p:
            raise DeepSpeedConfigError(
                "RLDriver needs an engine built with an enabled \"rl\" "
                "config block (it installs the RL loss_fn at engine "
                "init; there is no post-hoc swap)")
        if engine.gradient_accumulation_steps() != 1:
            raise DeepSpeedConfigError(
                "the RL driver updates on exactly one rollout batch per "
                "iteration: set gradient_accumulation_steps to 1")
        if not prompts:
            raise DeepSpeedConfigError("RLDriver needs at least one prompt")
        prompts = [list(map(int, pr)) for pr in prompts]
        if any(not pr for pr in prompts):
            raise DeepSpeedConfigError("RLDriver prompts must be non-empty")

        self.engine = engine
        self.rl_params = p
        self.prompts = prompts
        self.reward_fn = reward_fn
        self.checkpoint_dir = checkpoint_dir
        self.eos_token_id = eos_token_id
        self.loss_name = p[c.RL_LOSS]
        self.group_size = p[c.RL_GROUP_SIZE]
        self.rollouts_per_iteration = p[c.RL_ROLLOUTS_PER_ITERATION]
        self.max_new_tokens = p[c.RL_MAX_NEW_TOKENS]
        self.group_count = self.rollouts_per_iteration // self.group_size
        self.checkpoint_interval = p[c.RL_CHECKPOINT_INTERVAL]

        # ONE train/eval shape for the whole run
        longest = max(len(pr) for pr in prompts)
        seq_len = p[c.RL_SEQUENCE_LENGTH] or _round_up8(
            longest + self.max_new_tokens)
        if longest + self.max_new_tokens > seq_len:
            raise DeepSpeedConfigError(
                f"rl.{c.RL_SEQUENCE_LENGTH} {seq_len} cannot hold the "
                f"longest prompt ({longest}) + {c.RL_MAX_NEW_TOKENS} "
                f"({self.max_new_tokens})")
        model = engine.module
        if seq_len > model.config.max_seq_len:
            raise DeepSpeedConfigError(
                f"rl sequence_length {seq_len} exceeds the model's "
                f"max_seq_len {model.config.max_seq_len}")
        self.sequence_length = seq_len

        # the update batch the engine was configured for must match the
        # rollout geometry EXACTLY: a mismatch is a silent wrong batch
        update_rows = (self.rollouts_per_iteration
                       if self.loss_name == "ppo_clip"
                       else 2 * self.group_count)
        if engine.train_batch_size() != update_rows:
            rows = ("rollouts_per_iteration" if self.loss_name == "ppo_clip"
                    else "one chosen/rejected pair per prompt group")
            raise DeepSpeedConfigError(
                f"train_batch_size {engine.train_batch_size()} != the RL "
                f"update batch {update_rows} rows ({rows}): align the "
                f"batch triad with the rl block")

        # -- frozen reference: a detached copy, never views into the
        #    trainer's flat buffer ---------------------------------------
        natural = engine.params_to_natural()
        ref = None
        if checkpoint_dir is not None:
            ref_path = os.path.join(checkpoint_dir, REF_SNAPSHOT)
            if os.path.exists(ref_path):
                ref = load_snapshot(ref_path, natural, engine.device)
                logger.info(f"rl: loaded frozen reference from {ref_path}")
        if ref is None:
            ref = natural
            if checkpoint_dir is not None:
                os.makedirs(checkpoint_dir, exist_ok=True)
                save_obj(snapshot_tree(ref),
                         os.path.join(checkpoint_dir, REF_SNAPSHOT))
            # the serving engine gets a copy of its own
            natural = engine.params_to_natural()

        self.buffer = RolloutBuffer(model, unflatten(ref), p, seq_len)

        # -- co-resident serving engine (BORROWED monitor: Train/* and
        #    Serve/* scalars interleave into one event stream without the
        #    serve drain closing it under the training engine) -------------
        self.serve = InferenceEngine(
            model, config=serve_config, params=natural,
            device=engine.device, monitor=engine.monitor,
            owns_monitor=False, draft_model=draft_model,
            draft_params=draft_params)

        self.iteration = 0
        self.cursor = 0
        self.last_iteration_stats = None
        self.stats = {"iterations": 0, "rollout_tokens": 0,
                      "rollout_s": 0.0, "swap_ms": 0.0,
                      "compile_delta": 0}

    # -- checkpoint / resume -----------------------------------------------

    def _client_state(self):
        return {"rl": {
            "iteration": int(self.iteration),
            "cursor": int(self.cursor),
            "sampler": self.serve.sampler_state(),
            "buffer": self.buffer.state_dict(),
        }}

    def save_checkpoint(self, tag=None):
        if self.checkpoint_dir is None:
            raise DeepSpeedConfigError(
                "RLDriver was built without checkpoint_dir")
        return self.engine.save_checkpoint(
            self.checkpoint_dir, tag=tag,
            client_state=self._client_state())

    def resume(self, tag=None):
        """Restore the last committed iteration boundary: the engine's
        full state (params, optimizer, ``micro_steps``), the driver's
        counters, the serving sampler's state; then hot-swap the restored
        weights into the serving engine so both sides resume from the
        SAME policy. Returns True when a checkpoint was found."""
        if self.checkpoint_dir is None:
            raise DeepSpeedConfigError(
                "RLDriver was built without checkpoint_dir")
        path, client = self.engine.load_checkpoint(self.checkpoint_dir,
                                                   tag=tag)
        if path is None:
            return False
        rl = (client or {}).get("rl")
        if rl is None:
            raise DeepSpeedConfigError(
                f"checkpoint {path} has no \"rl\" client_state: it was "
                f"not written by an RLDriver (a pretraining checkpoint "
                f"cannot pin the sampler streams)")
        self.iteration = int(rl["iteration"])
        self.cursor = int(rl["cursor"])
        self.serve.restore_sampler_state(rl["sampler"])
        self.buffer.load_state_dict(rl["buffer"])
        self.serve.hot_swap_weights(self.engine.params_to_natural())
        logger.info(f"rl: resumed at iteration {self.iteration} "
                    f"from {path}")
        return True

    # -- the loop ------------------------------------------------------------

    def _iteration_prompts(self):
        idx = [(self.cursor + i) % len(self.prompts)
               for i in range(self.group_count)]
        return [self.prompts[i]
                for i in idx for _ in range(self.group_size)]

    def _behavior_logprobs(self, tokens):
        """Teacher-forced logprobs [N, S-1] (numpy fp32) of the weights
        that sampled this batch (pre-update), through the engine's fused
        eval path."""
        _, logits = self.engine.eval_batch(tokens, return_logits=True)
        t = torch.as_tensor(tokens).to(logits.device, torch.long)
        return token_logprobs(logits, t).cpu().numpy()

    def run_iteration(self):
        """One full rollout->update->swap iteration; returns its stats
        dict. Determinism contract: everything here is a function of
        (committed engine state, committed sampler state, prompt cursor);
        the only checkpoint commit happens AFTER the swap, at the
        iteration boundary."""
        engine, serve = self.engine, self.serve
        batch_prompts = self._iteration_prompts()
        outputs, rstats = serve.generate_rollouts(
            batch_prompts, self.max_new_tokens,
            eos_token_id=self.eos_token_id)
        rewards = [float(self.reward_fn(pr, out))
                   for pr, out in zip(batch_prompts, outputs)]
        rollouts = [{"prompt": pr, "response": out, "reward": rw}
                    for pr, out, rw in zip(batch_prompts, outputs, rewards)]

        tokens, mask = self.buffer.pad(rollouts)
        ref_logp = self.buffer.ref_logprobs(tokens)
        mean_kl = 0.0
        if self.loss_name == "ppo_clip":
            behavior = self._behavior_logprobs(tokens)
            denom = max(float(mask.sum()), 1.0)
            mean_kl = float(((behavior - ref_logp) * mask).sum() / denom)
            batch = self.buffer.build_ppo_batch(tokens, mask, behavior,
                                                ref_logp, rewards)
        else:
            batch = self.buffer.build_dpo_batch(tokens, mask, ref_logp,
                                                rewards)

        # gas == 1: one pre-stacked [1, rows, ...] micro-batch
        stacked = {k: v[None] for k, v in batch.items()}
        loss = float(engine.train_batch(batch=stacked))

        # the train->serve weight flow: the copy of the trainer's weights
        # (JAX's arrays are immutable; the flat buffer is not) and the
        # serving engine's swap, which ends on a device sync
        t0 = time.perf_counter()
        swap = serve.hot_swap_weights(engine.params_to_natural())
        swap_ms = (time.perf_counter() - t0) * 1e3

        self.iteration += 1
        self.cursor = (self.cursor + self.group_count) % len(self.prompts)

        out = {
            "iteration": self.iteration,
            "loss": loss,
            "mean_reward": float(np.mean(rewards)),
            "mean_kl": mean_kl,
            "rollout_tokens": rstats["rollout_tokens"],
            "rollout_tokens_per_s": rstats["tokens_per_s"],
            "rollout_s": rstats["rollout_s"],
            # the copy and the swap (the serving engine's own swap_ms
            # leaves the copy out)
            "swap_ms": swap_ms,
            # new bucket programs this iteration (rollout + swap); 0 after
            # the warm-up iteration
            "compile_delta": rstats["compile_delta"]
            + swap["compile_delta"],
        }
        if "spec_acceptance_rate" in rstats:
            out["spec_acceptance_rate"] = rstats["spec_acceptance_rate"]
        self.last_iteration_stats = out
        self.stats["iterations"] += 1
        self.stats["rollout_tokens"] += out["rollout_tokens"]
        self.stats["rollout_s"] += out["rollout_s"]
        self.stats["swap_ms"] += out["swap_ms"]
        self.stats["compile_delta"] += out["compile_delta"]

        if engine.monitor is not None:
            engine.monitor.record(engine.global_samples, {
                f"Train/RL/{k}": float(v) for k, v in out.items()})

        if self.checkpoint_dir is not None and \
                self.iteration % self.checkpoint_interval == 0:
            self.save_checkpoint()
        return out

    def train(self, num_iterations):
        """Run ``num_iterations`` iterations; returns the per-iteration
        stats list."""
        return [self.run_iteration() for _ in range(num_iterations)]
