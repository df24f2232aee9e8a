"""LAMB over the engine's flat partition.

The port of `deeperspeed_tpu/ops/lamb/fused_lamb.py`: Adam with a
per-tensor trust ratio ||p|| / ||update|| scaling the step (You et al.
2019), clamped to [``min_coeff``, ``max_coeff``], with the JAX class's
``bias_correction`` and ``eps_inside_sqrt`` options. The JAX optimizer
is XLA (no Pallas kernel), so plain PyTorch is the port: the elementwise
update runs over the whole flat buffer at once, and the two norms of
the trust ratio are taken over each parameter's span of it
(``segments``, the engine's `param_slices`), which is the JAX leaf.

API shape follows the JAX class and the port's `FusedAdam`:
hyperparameters live in ``param_groups[0]``; `init_state` / `update`
take and return a `LambState`, and `update` writes the masters and
moments in place.
"""

from typing import NamedTuple

import torch

from ..hopper.adam import bias_corrections


class LambState(NamedTuple):
    step: int                    # optimizer steps taken
    exp_avg: torch.Tensor        # [n] fp32
    exp_avg_sq: torch.Tensor     # [n] fp32
    segments: tuple = ()         # (lo, hi) of each parameter in [0, n)


class FusedLamb:
    """LAMB with the JAX class's options; the moments rest in fp32."""

    def __init__(self, params=None, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0,
                 min_coeff=0.01, amsgrad=False):
        if amsgrad:
            raise ValueError("FusedLamb does not support amsgrad")
        self.param_groups = [{
            "lr": lr,
            "betas": tuple(betas),
            "eps": eps,
            "weight_decay": weight_decay,
            "bias_correction": bias_correction,
            "max_coeff": max_coeff,
            "min_coeff": min_coeff,
        }]
        self.eps_inside_sqrt = eps_inside_sqrt
        self.defaults = dict(self.param_groups[0])
        # the last step's trust ratios, one 0-d tensor a parameter (the
        # JAX class's introspection hook)
        self.lamb_coeffs = []

    def init_state(self, master, segments=None):
        """Zero fp32 moments shaped like the flat ``master``; ``segments``
        ((lo, hi) of each parameter) default to one tensor over all of
        it."""
        n = master.numel()
        segs = tuple((int(lo), int(hi)) for lo, hi in
                     (segments if segments is not None else [(0, n)]))
        bounds = [0] + [hi for _, hi in segs]
        if [lo for lo, _ in segs] != bounds[:-1] or bounds[-1] != n:
            raise ValueError(f"FusedLamb segments must tile [0, {n}) in "
                             f"order, got {list(segs)[:4]}...")
        return LambState(
            step=0,
            exp_avg=torch.zeros_like(master, dtype=torch.float32),
            exp_avg_sq=torch.zeros_like(master, dtype=torch.float32),
            segments=segs)

    def update(self, grads, state, master, lr=None, compute_out=None,
               use_kernel=True):
        """One LAMB step: ``master`` (flat, any float dtype; the math runs
        in fp32) and the moments of ``state`` are updated in place from
        the flat ``grads``; the new masters are also written into
        ``compute_out`` when given. ``use_kernel`` is accepted for the
        engine's call and has no effect: there is no kernel. Returns the
        state with the step advanced."""
        group = self.param_groups[0]
        beta1, beta2 = group["betas"]
        eps = group["eps"]
        weight_decay = group["weight_decay"]
        lr = group["lr"] if lr is None else lr
        step = state.step + 1
        c1, c2 = (torch.tensor(c, dtype=torch.float32, device=master.device)
                  for c in bias_corrections(beta1, beta2, step,
                                            group["bias_correction"]))
        g = grads.float()
        p = master.float()
        m = state.exp_avg.mul_(beta1).add_((1 - beta1) * g)
        v = state.exp_avg_sq.mul_(beta2).add_((1 - beta2) * torch.square(g))
        if self.eps_inside_sqrt:
            denom = torch.sqrt(v / c2 + eps)
        else:
            denom = torch.sqrt(v / c2) + eps
        upd = (m / c1) / denom
        if weight_decay != 0.0:
            upd = upd + weight_decay * p
        segs = state.segments or ((0, p.numel()),)
        p_norm = torch.stack([torch.linalg.vector_norm(p[lo:hi])
                              for lo, hi in segs])
        u_norm = torch.stack([torch.linalg.vector_norm(upd[lo:hi])
                              for lo, hi in segs])
        trust = torch.where(
            (p_norm > 0) & (u_norm > 0),
            torch.clamp(p_norm / u_norm, group["min_coeff"],
                        group["max_coeff"]),
            torch.ones_like(p_norm))
        self.lamb_coeffs = list(trust.unbind())
        sizes = torch.tensor([hi - lo for lo, hi in segs],
                             device=master.device)
        new_p = p - (lr * trust).repeat_interleave(sizes) * upd
        master.copy_(new_p)
        if compute_out is not None:
            compute_out.copy_(new_p)
        return state._replace(step=step)

    # -- state (de)serialization (the JAX class's surface) ----------------

    def state_dict(self, state):
        return {
            "step": int(state.step),
            # copies: `update` writes the moments in place
            "exp_avg": state.exp_avg.detach().clone(),
            "exp_avg_sq": state.exp_avg_sq.detach().clone(),
            "param_groups": [dict(g) for g in self.param_groups],
            "segments": list(state.segments),
        }

    def load_state_dict(self, sd, device=None):
        """The state of a `state_dict` (moments as tensors or numpy
        arrays, put on ``device``); the param groups are restored."""
        self.param_groups = [dict(g) for g in sd["param_groups"]]
        m, v = (torch.as_tensor(sd[k], device=device)
                for k in ("exp_avg", "exp_avg_sq"))
        return LambState(step=int(sd["step"]), exp_avg=m, exp_avg_sq=v,
                         segments=tuple(map(tuple, sd.get("segments", ()))))

    def get_lamb_coeffs(self):
        return self.lamb_coeffs
