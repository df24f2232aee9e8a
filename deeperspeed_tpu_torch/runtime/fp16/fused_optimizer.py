"""FP16 optimizer with a flat fp32 master copy.

The port of `deeperspeed_tpu/runtime/fp16/fused_optimizer.py` (reference
`deepspeed/runtime/fp16/fused_optimizer.py:51`): the compute-dtype
(fp16) parameters of one group are flattened into ONE fp32 master
vector (``fp32_groups_flat``), leaves in the JAX package's pytree order
(dict keys sorted, lists in order), so that the base optimizer steps one
flat buffer: on CUDA tensors `FusedAdam` is one launch of the flat Adam
kernel (`csrc/adam.cu`, the classic fp16 variant: fp32 masters and
moments, the fp16 copy of the new masters written in the same pass).
Loss scaling, the overflow skip and the dynamic scale are the JAX
state machine (`loss_scaler.update_loss_scale`); the overflow flag is
read on the host before the update, which a skipped step then does not
launch (the JAX step selects the old state branchlessly), as the port's
engine does.

Usage, as in the JAX package:

    opt = FP16_Optimizer(FusedAdam(lr=1e-3), dynamic_loss_scale=True)
    state = opt.init_state(params)            # fp16 tensors (a pytree)
    opt.scale_loss(loss, state).backward()    # == loss * cur_scale
    state, info = opt.step(state, grads)      # grads of the scaled loss

Unlike the JAX class, `step` writes the masters, the moments and the
parameter tensors of ``state.params`` in place (the engine-style flat
buffers the port keeps everywhere) and returns the state with its scale
advanced.
"""

from typing import Any, NamedTuple

import numpy as np
import torch

from ...ops.lamb.fused_lamb import FusedLamb
from ..utils import clip_grad_norm_, global_norm
from .loss_scaler import (LossScaleState, grads_finite,
                          init_loss_scale_state, update_loss_scale)


class FP16OptimizerState(NamedTuple):
    """``flat_master`` is the single fp32 buffer the reference calls
    ``fp32_groups_flat`` (fused_optimizer.py:77)."""
    params: Any                 # compute-dtype pytree of tensors
    flat_master: torch.Tensor   # fp32 [total_numel]
    opt_state: Any              # the base optimizer's state over it
    scale: LossScaleState


class StepInfo(NamedTuple):
    overflow: bool
    grad_norm: torch.Tensor
    loss_scale: float


def tree_leaves(tree):
    """The leaves of a pytree of tensors in the JAX package's order:
    dict keys sorted, lists and tuples in order; ``None`` is an empty
    subtree with no leaf, as in `jax.tree_util`."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A pytree shaped like ``like`` holding ``leaves`` (in
    `tree_leaves` order); a ``None`` of ``like`` stays ``None``."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _flatten(leaves, device):
    if not leaves:
        return torch.zeros(0, dtype=torch.float32, device=device)
    return torch.cat([torch.as_tensor(x, device=device).reshape(-1).float()
                      for x in leaves])


class FP16_Optimizer:
    """Loss-scaled master-weight wrapper over a flat base optimizer.

    The base optimizer must expose ``init_state(flat)``, ``update(grads,
    state, flat, lr=, compute_out=)``, ``state_dict(state)`` /
    ``load_state_dict(sd)`` and ``param_groups`` (the port's `FusedAdam`
    and `FusedLamb`). It sees one 1-D fp32 buffer, as the reference's
    fused kernels do."""

    # the masters as one buffer (FP16_UnfusedOptimizer: one segment a
    # leaf, so a per-tensor statistic sees real parameter boundaries)
    _per_leaf = False

    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 initial_dynamic_scale=2 ** 32, verbose=False, mpu=None,
                 clip_grad=0.0, fused_adam_legacy=False):
        self.optimizer = init_optimizer
        self.clip_grad = clip_grad
        self.dynamic = dynamic_loss_scale
        args = dynamic_loss_args or {}
        if dynamic_loss_scale:
            self._init_scale = 2 ** args["init_scale_power"] \
                if "init_scale_power" in args else \
                args.get("init_scale", initial_dynamic_scale)
        else:
            self._init_scale = static_loss_scale
        self.scale_window = args.get("scale_window", 1000)
        self.min_scale = args.get("min_scale", 1)
        self.delayed_shift = args.get("delayed_shift",
                                      args.get("hysteresis", 1))
        self.verbose = verbose
        self.mpu = mpu
        self._leaves = None
        self._bounds = None
        self._flat_params = None

    # -- torch-ish surface -------------------------------------------------

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def loss_scale(self):
        return self._init_scale

    # -- the state ---------------------------------------------------------

    def init_state(self, params):
        """The state over ``params`` (a pytree of tensors in the compute
        dtype, all on one device), which `step` updates in place."""
        self._leaves = tree_leaves(params)
        if not all(isinstance(x, torch.Tensor) for x in self._leaves):
            raise TypeError("FP16_Optimizer takes a pytree of tensors")
        device = self._leaves[0].device if self._leaves else "cpu"
        sizes = [x.numel() for x in self._leaves]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self._bounds = list(zip(offsets[:-1].tolist(), offsets[1:].tolist()))
        flat_master = _flatten(self._leaves, device)
        dtype = self._leaves[0].dtype if self._leaves else torch.float16
        # the compute copy the base optimizer writes in its pass (none
        # when the parameters are fp32 themselves)
        self._flat_params = None if dtype == torch.float32 else \
            flat_master.to(dtype)
        opt_state = self._init_opt_state(flat_master)
        scale = init_loss_scale_state(init_scale=self._init_scale,
                                      delayed_shift=self.delayed_shift,
                                      static=not self.dynamic)
        return FP16OptimizerState(params=params, flat_master=flat_master,
                                  opt_state=opt_state, scale=scale)

    def _init_opt_state(self, flat_master):
        if self._per_leaf and isinstance(self.optimizer, FusedLamb):
            return self.optimizer.init_state(flat_master,
                                             segments=self._bounds)
        return self.optimizer.init_state(flat_master)

    def scale_loss(self, loss, state):
        """The reference's ``backward(loss)`` scaling half: the caller
        differentiates scale_loss(...) instead of loss."""
        return loss * state.scale.cur_scale

    def _write_params(self, flat):
        """The new masters into the parameter tensors, in place."""
        src = self._flat_params if self._flat_params is not None else flat
        with torch.no_grad():
            for leaf, (lo, hi) in zip(self._leaves, self._bounds):
                leaf.copy_(src[lo:hi].view(leaf.shape))

    def step(self, state, grads, lr=None):
        """One update from the gradients of the SCALED loss (a pytree
        shaped like the params). An overflow (a non-finite unscaled
        gradient) skips the update and moves only the scale."""
        leaves = tree_leaves(grads)
        if len(leaves) != len(self._leaves):
            raise ValueError(f"{len(leaves)} gradient leaves for "
                             f"{len(self._leaves)} parameters")
        flat_grads = _flatten(leaves, state.flat_master.device) / \
            state.scale.cur_scale
        overflow = not bool(grads_finite(flat_grads))
        grad_norm = global_norm(flat_grads)
        opt_state = state.opt_state
        if not overflow:
            if self.clip_grad > 0:
                clip_grad_norm_(flat_grads, self.clip_grad, norm=grad_norm)
            opt_state = self.optimizer.update(
                flat_grads, state.opt_state, state.flat_master, lr=lr,
                compute_out=self._flat_params)
            self._write_params(state.flat_master)
        if self.dynamic:
            scale = update_loss_scale(
                state.scale, overflow, scale_window=self.scale_window,
                min_scale=self.min_scale, delayed_shift=self.delayed_shift)
        else:
            scale = state.scale._replace(cur_iter=state.scale.cur_iter + 1)
        return (state._replace(opt_state=opt_state, scale=scale),
                StepInfo(overflow=overflow, grad_norm=grad_norm,
                         loss_scale=state.scale.cur_scale))

    # -- checkpoint surface (reference fused_optimizer.py:391-457) ---------

    def state_dict(self, state):
        return {
            "dynamic_loss_scale": self.dynamic,
            "cur_scale": float(state.scale.cur_scale),
            "cur_iter": int(state.scale.cur_iter),
            "last_overflow_iter": int(state.scale.last_overflow_iter),
            "scale_window": self.scale_window,
            "clip_grad": self.clip_grad,
            "fp32_groups_flat": [state.flat_master.detach().cpu().numpy()],
            "optimizer_state_dict": self.optimizer.state_dict(
                state.opt_state),
        }

    def _load_scale(self, state, sd):
        return state.scale._replace(
            cur_scale=float(sd["cur_scale"]), cur_iter=int(sd["cur_iter"]),
            last_overflow_iter=int(sd["last_overflow_iter"]))

    def _load_opt(self, state, sd, load_optimizer_states):
        if not load_optimizer_states:
            return state.opt_state
        return self.optimizer.load_state_dict(sd["optimizer_state_dict"],
                                              device=state.flat_master.device)

    def load_state_dict(self, state, sd, load_optimizer_states=True):
        """The state with the checkpoint's scale, masters (copied into the
        flat buffer and the parameters in place) and, by default, base
        optimizer state."""
        flat = torch.as_tensor(np.asarray(sd["fp32_groups_flat"][0]),
                               dtype=torch.float32)
        return self._restore(state, flat, sd, load_optimizer_states)

    def _restore(self, state, flat, sd, load_optimizer_states):
        with torch.no_grad():
            state.flat_master.copy_(flat.to(state.flat_master.device))
            if self._flat_params is not None:
                self._flat_params.copy_(state.flat_master)
        self._write_params(state.flat_master)
        return state._replace(
            opt_state=self._load_opt(state, sd, load_optimizer_states),
            scale=self._load_scale(state, sd))
