"""Online RL: the co-located train+serve loop (the port of
`deeperspeed_tpu/rl`).

The training engine (`DeepSpeedEngine`) and the serving engine
(`InferenceEngine`) live in ONE process on one device: rollouts are
generated under the continuous-batching scheduler, PPO-clip / DPO losses
train on the engine through the loss registry the "rl" config block
selects, and updated weights flow train->serve by in-process hot-swap
(eager programs take the weights as they run, so nothing is rebuilt).
"""

from .buffer import RolloutBuffer
from .driver import RLDriver
from .losses import get_rl_loss, register_rl_loss, token_logprobs

__all__ = [
    "RLDriver",
    "RolloutBuffer",
    "get_rl_loss",
    "register_rl_loss",
    "token_logprobs",
]
