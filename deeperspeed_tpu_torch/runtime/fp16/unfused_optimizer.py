"""FP16 optimizer with per-parameter fp32 masters.

The port of `deeperspeed_tpu/runtime/fp16/unfused_optimizer.py`
(reference `deepspeed/runtime/fp16/unfused_optimizer.py:21`), the LAMB
path: the base optimizer must see real parameter boundaries for its
per-tensor trust ratio. The port keeps the masters in one flat fp32
buffer all the same and hands the base optimizer each parameter's span
of it (`FusedLamb`'s ``segments``); ``state.master`` is the pytree of
per-parameter fp32 views into that buffer, the JAX state's ``master``.
Grad-norm clipping against the global norm scales every leaf by one
coefficient, which is the reference's leaf-wise clip
(unfused_optimizer.py:188).
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from .fused_optimizer import FP16_Optimizer, tree_leaves, tree_unflatten
from .loss_scaler import LossScaleState


class FP16UnfusedState(NamedTuple):
    params: Any            # compute-dtype pytree of tensors
    master: Any            # fp32 pytree, same structure (views)
    opt_state: Any
    scale: LossScaleState
    flat_master: torch.Tensor   # the fp32 buffer the views share


class FP16_UnfusedOptimizer(FP16_Optimizer):
    """Loss-scaled wrapper keeping per-leaf fp32 masters (LAMB path)."""

    _per_leaf = True

    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=False, mpu=None, clip_grad=0.0,
                 fused_lamb_legacy=False):
        super().__init__(init_optimizer, static_loss_scale=static_loss_scale,
                         dynamic_loss_scale=dynamic_loss_scale,
                         dynamic_loss_args=dynamic_loss_args, verbose=verbose,
                         mpu=mpu, clip_grad=clip_grad)

    def _master_tree(self, params, flat):
        return tree_unflatten(params, [
            flat[lo:hi].view(leaf.shape)
            for leaf, (lo, hi) in zip(self._leaves, self._bounds)])

    def init_state(self, params):
        s = super().init_state(params)
        return FP16UnfusedState(
            params=params, master=self._master_tree(params, s.flat_master),
            opt_state=s.opt_state, scale=s.scale, flat_master=s.flat_master)

    def state_dict(self, state):
        sd = super().state_dict(state)
        del sd["fp32_groups_flat"]
        sd["fp32_groups"] = tree_unflatten(
            state.params, [m.detach().cpu().numpy()
                           for m in tree_leaves(state.master)])
        return sd

    def load_state_dict(self, state, sd, load_optimizer_states=True):
        flat = torch.cat([torch.as_tensor(np.asarray(x),
                                          dtype=torch.float32).reshape(-1)
                          for x in tree_leaves(sd["fp32_groups"])])
        return self._restore(state, flat, sd, load_optimizer_states)
