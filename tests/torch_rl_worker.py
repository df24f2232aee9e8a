"""Deterministic-resume child for the port's online-RL driver (the
counterpart of `tests/rl_worker.py`): runs the co-located train+serve
PPO loop with a committed checkpoint at every iteration, crashes hard
(`os._exit`, no cleanup: the stand-in for a supervisor's kill)
MID-ITERATION inside the reward callback on its first incarnation, and
on the next incarnation resumes from the last committed iteration
boundary. Every COMPLETED iteration appends one JSON line (iteration,
full-precision loss, the sampled rollout token lists) to the given log,
so the caller can check that the resumed trajectory is bit-identical to
an uninterrupted run.

Usage: python torch_rl_worker.py <workdir> <log_name> <total_iters>
<kill_iter> [<spec json>]

kill_iter 0 never crashes (the reference run); otherwise the crash fires
in that iteration's second reward call, after the rollouts and before
the update. The optional spec (a JSON object) sets ``device`` ("cpu" by
default), ``model`` (GPTNeoXConfig fields; default the tiny config),
``dtype`` ("float32" or "bfloat16"), ``ds_config`` and ``serve_config``
(the DeepSpeed and serving configs), ``prompts`` ({"n", "len", "seed"}:
n seeded prompts of len tokens) and ``seed`` (the weights' seed).
"""

import json
import os
import sys
import time

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=128)
DEFAULT_SPEC = {
    "device": "cpu",
    "model": TINY,
    "dtype": "float32",
    "seed": 0,
    "ds_config": {
        "train_batch_size": 4,
        "steps_per_print": 1000,
        "optimizer": {"type": "Adam", "params": {"lr": 0.01}},
        "rl": {"enabled": True, "loss": "ppo_clip",
               "rollouts_per_iteration": 4, "group_size": 2,
               "max_new_tokens": 4},
    },
    "serve_config": {"inference": {
        "enabled": True, "page_size": 16, "num_pages": 32,
        "max_batch_size": 4, "token_budget": 128,
        "prefill_lengths": [16], "prefill_batch_sizes": [1, 2],
        "decode_batch_sizes": [1, 2, 4],
        "temperature": 1.0, "seed": 11,
    }},
    "prompts": {"n": 3, "len": 6, "seed": 3},
}


def main():
    t0 = time.perf_counter()
    workdir, log_name = sys.argv[1], sys.argv[2]
    total_iters, kill_iter = int(sys.argv[3]), int(sys.argv[4])
    spec = dict(DEFAULT_SPEC)
    if len(sys.argv) > 5:
        spec.update(json.loads(sys.argv[5]))

    import numpy as np
    import torch

    import deeperspeed_tpu_torch as dst
    from deeperspeed_tpu_torch.models.gpt_neox import GPTNeoX, GPTNeoXConfig
    from deeperspeed_tpu_torch.rl import RLDriver

    if spec["device"] == "cpu":
        # one thread: bit-for-bit comparisons between CPU runs
        torch.set_num_threads(1)
    dtype = getattr(torch, spec["dtype"])
    cfg = GPTNeoXConfig(param_dtype=dtype, **spec["model"])
    model = GPTNeoX(cfg, device=spec["device"]).init_params(spec["seed"])
    engine, *_ = dst.initialize(model=model, config_params=spec["ds_config"])
    rollouts = spec["ds_config"]["rl"]["rollouts_per_iteration"]
    pr = spec["prompts"]
    prng = np.random.default_rng(pr["seed"])
    prompts = [list(map(int, prng.integers(1, cfg.vocab_size,
                                           size=pr["len"])))
               for _ in range(pr["n"])]

    responses = []
    calls = {"n": 0}

    def reward_fn(prompt, response):
        calls["n"] += 1
        if kill_iter and driver.iteration + 1 == kill_iter and \
                calls["n"] % rollouts == 2:
            os._exit(9)  # mid-iteration: nothing committed for this one
        responses.append(list(map(int, response)))
        return float(sum(response) % 7)

    driver = RLDriver(engine, prompts, reward_fn, spec["serve_config"],
                      checkpoint_dir=os.path.join(workdir, "ckpt"))
    if os.path.exists(os.path.join(workdir, "ckpt", "latest")):
        assert driver.resume(), "committed checkpoint must load"
    # the seconds to here and each iteration's (its checkpoint included),
    # on stdout for the caller
    print(f"worker: ready at iteration {driver.iteration} after "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    with open(os.path.join(workdir, log_name), "a") as log:
        while driver.iteration < total_iters:
            responses.clear()
            t1 = time.perf_counter()
            out = driver.run_iteration()
            print(f"worker: iteration {out['iteration']} in "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
            log.write(json.dumps({"iteration": out["iteration"],
                                  "loss": out["loss"],
                                  "responses": responses}) + "\n")
            log.flush()


if __name__ == "__main__":
    main()
