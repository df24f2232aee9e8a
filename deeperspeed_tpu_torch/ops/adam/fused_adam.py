"""Adam/AdamW over the engine's flat partition.

The port of `deeperspeed_tpu/ops/adam/fused_adam.py`. The JAX optimizer
updates leaf by leaf and lets XLA fuse each leaf's update; eager
PyTorch fuses nothing, so here the masters, moments and gradients are
one flat buffer each and `update` is one launch of the flat kernel
(`ops/hopper/adam.py`, `csrc/adam.cu`) over the whole partition.

``state_dtype`` (the JAX class's extension): the moments rest in
float32 (the default), bfloat16 or float16, and the math runs in fp32
either way.
The masters are fp32, or, in the engine's lean state
(``fp16_master_weights_and_grads``), the compute-dtype parameters
themselves.

API shape follows the JAX class: hyperparameters live in
``param_groups[0]``, where the LR schedules write ``lr`` (and
``betas``); `init_state` / `update` take and return an `AdamState`.
Unlike the JAX class, `update` writes the masters and moments in place:
the engine owns them and keeps no second copy.
"""

from typing import NamedTuple

import torch

from ..hopper.adam import fused_adam_flat_

# the moment storage dtypes the flat kernel is built for, by the names
# the JSON config and the JAX class take
_STATE_DTYPES = {"float32": torch.float32, "torch.float32": torch.float32,
                 "bfloat16": torch.bfloat16,
                 "torch.bfloat16": torch.bfloat16,
                 "float16": torch.float16, "torch.float16": torch.float16}


class AdamState(NamedTuple):
    step: int                    # optimizer steps taken
    exp_avg: torch.Tensor        # [n] in state_dtype
    exp_avg_sq: torch.Tensor     # [n] in state_dtype


class FusedAdam:
    """Adam / AdamW ("adam_w_mode") with optional bias correction."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, amsgrad=False, set_grad_none=True,
                 state_dtype="float32"):
        if amsgrad:
            raise ValueError("FusedAdam does not support amsgrad "
                             "(reference parity: fused_adam.py:47)")
        self.state_dtype = _STATE_DTYPES.get(str(state_dtype))
        if self.state_dtype is None:
            raise ValueError(
                f"FusedAdam state_dtype must be one of "
                f"{sorted(_STATE_DTYPES)}, got {state_dtype!r} (the flat "
                f"kernel keeps its moments in float32, bfloat16 or "
                f"float16)")
        self.adam_w_mode = adam_w_mode
        self.param_groups = [{
            "lr": lr,
            "betas": tuple(betas),
            "eps": eps,
            "weight_decay": weight_decay,
            "bias_correction": bias_correction,
        }]
        self.defaults = dict(self.param_groups[0])

    def init_state(self, master):
        """Zero moments in ``state_dtype``, shaped like the flat
        ``master``."""
        return AdamState(
            step=0,
            exp_avg=torch.zeros_like(master, dtype=self.state_dtype),
            exp_avg_sq=torch.zeros_like(master, dtype=self.state_dtype))

    def update(self, grads, state, master, lr=None, compute_out=None,
               use_kernel=True):
        """One optimizer step: ``master`` (flat fp32, or the lean
        state's compute-dtype parameters) and the moments of
        ``state`` are updated in place from the flat ``grads``; the new
        masters are also written into ``compute_out`` (the flat compute
        parameters) when given. ``use_kernel=False`` takes the plain
        version on any device (the model's ``use_kernels=False`` path).
        Returns the state with the step advanced."""
        group = self.param_groups[0]
        beta1, beta2 = group["betas"]
        step = state.step + 1
        fused_adam_flat_(
            master, grads, state.exp_avg, state.exp_avg_sq,
            group["lr"] if lr is None else lr, step, beta1=beta1,
            beta2=beta2, eps=group["eps"],
            weight_decay=group["weight_decay"], adam_w=self.adam_w_mode,
            bias_correction=group["bias_correction"], p_out=compute_out,
            use_kernel=use_kernel)
        return state._replace(step=step)

    # -- state (de)serialization (the JAX class's surface) ----------------

    def state_dict(self, state):
        return {
            "step": int(state.step),
            # copies: `update` writes the moments in place
            "exp_avg": state.exp_avg.detach().clone(),
            "exp_avg_sq": state.exp_avg_sq.detach().clone(),
            "param_groups": [dict(g) for g in self.param_groups],
        }

    def load_state_dict(self, sd, device=None):
        """The state of a `state_dict` (moments as tensors or numpy
        arrays, put on ``device``); the param groups are restored."""
        self.param_groups = [dict(g) for g in sd["param_groups"]]
        m, v = (torch.as_tensor(sd[k], device=device)
                for k in ("exp_avg", "exp_avg_sq"))
        return AdamState(step=int(sd["step"]), exp_avg=m, exp_avg_sq=v)
