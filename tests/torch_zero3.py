"""Shared set-up of the ZeRO-3 tests: the data-parallel tests' tiny
GPT-NeoX at three layers, stage-3 configs for the port and the JAX
engine, and the state-bytes formula of a stage-3 rank."""

import torch_dp as T

# three layers, so groups of two are ragged ([2, 1]) and a prefetch depth
# of 5 passes the layer count; the odd widths leave most leaves ragged at
# worlds 2 and 4
SIZE = dict(T.SIZE, num_layers=3)
GLOBAL_MICRO = 4
STEPS = 3
# leaves under 500 elements (biases, layer norms) stay whole on every
# rank; the four matrices of a layer and the embeddings are gathered
THRESHOLD = 500
GSPMD = {"mode": "gspmd"}
# a depth past the layer count, buckets of 10,485 bytes (a layer's shard
# of 2,621-6,080 fp32 elements at worlds 4-2 takes ragged tails) and
# groups of two over three layers ([2, 1])
EXPLICIT = {"mode": "explicit", "prefetch_depth": 5, "bucket_mb": 0.01,
            "group_layers": 2}
EXPLICIT_NO_REMAT = {"mode": "explicit", "prefetch_depth": 2,
                     "remat": False}
# fp32: the summation order differs (rtol 1e-5 on the losses, atol =
# rtol = 1e-4 on the masters, as the data-parallel tests); bf16: bf16
# gradients round apart
TOL = {"fp32": dict(loss=1e-5, atol=1e-4, rtol=1e-4),
       "bf16": dict(loss=2e-2, atol=2e-2, rtol=0.0)}


def conf(world, dtype="fp32", stage=3, schedule=None, **extra):
    """A rank's config (the JAX engine's is the same: the batch triple
    resolves against its world)."""
    zero = {"stage": stage}
    if stage == 3:
        zero.update(stage3_param_persistence_threshold=THRESHOLD,
                    schedule=dict(schedule or GSPMD))
    return T.config(world, dtype, stage, micro=GLOBAL_MICRO // world,
                    zero_optimization=zero, **extra)


def train(name, weights, toks, c, steps=STEPS, **kw):
    return dict(kind="train", name=name, size=SIZE, weights=weights,
                conf=c, tokens=toks, steps=steps, **kw)


def state_bytes(dtype, layout):
    """A stage-3 rank's state bytes: 18 bytes a partition element in
    bf16 (2 compute shard, 4 master, 8 moments, 4 accumulator; in fp32
    the shard is the master: 16), and the persisted row whole in the
    compute dtype."""
    c = 4 if dtype == "fp32" else 2
    part = layout["part_size"]
    out = {"params": c * part, "exp_avg": 4 * part, "exp_avg_sq": 4 * part,
           "grad_acc": 4 * part, "persist": c * layout["persisted_padded"]}
    if dtype != "fp32":
        out["master"] = 4 * part
    return out
