"""Gradient helpers over the engine's flat gradient.

The port of `global_norm`, `clip_grad_norm_` and `GradientNoiseScale` of
`deeperspeed_tpu/runtime/utils.py`: the JAX versions work leaf by leaf
over a pytree; the port's gradient is one flat buffer, so the norm is
one reduction and the clip one scale, both on the device (no host
read), and the noise-scale estimator keeps its running sum on the
gradient's device. Where the gradient is partitioned across
data-parallel ranks, the norm takes the process group (the JAX
versions' ``axis_name``) and sums the squares over it.
"""

import atexit
import weakref

import torch

from ..utils.logging import logger


def register_weak_atexit(obj, method_name):
    """Register `obj.<method_name>()` to run at interpreter exit, held
    through a weakref: the atexit registry must not pin `obj` (engines,
    monitors, telemetry, checkpoint managers are made per run) for the
    process lifetime. Returns the registered hook for
    `atexit.unregister`."""
    obj_ref = weakref.ref(obj)

    def hook():  # pragma: no cover - interpreter teardown
        target = obj_ref()
        if target is not None:
            getattr(target, method_name)()

    atexit.register(hook)
    return hook


def global_norm(flat, group=None):
    """L2 norm of a flat tensor, as a 0-d fp32 tensor. With a process
    ``group`` of more than one rank, ``flat`` is this rank's partition
    and the squares are summed over the ranks (the JAX `global_norm`'s
    ``axis_name``)."""
    norm = torch.linalg.vector_norm(flat.float())
    if group is None:
        return norm
    import torch.distributed as dist
    if dist.get_world_size(group) == 1:
        return norm
    sq = norm.square()
    dist.all_reduce(sq, group=group)
    return sq.sqrt()


def clip_grad_norm_(flat, max_norm, norm=None, group=None):
    """Scale ``flat`` in place so its L2 norm (over the ranks of
    ``group`` where given) is at most ``max_norm``. A non-finite norm
    leaves it unscaled (the fp16 overflow skip handles those steps).
    Returns the norm before clipping."""
    total = global_norm(flat, group) if norm is None else norm
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    coef = torch.where(torch.isfinite(total), coef, torch.ones_like(coef))
    flat.mul_(coef.to(flat.dtype))
    return total


class GradientNoiseScale:
    """Estimate the gradient noise scale B_noise = tr(Σ)/|G|² from
    gradients at two effective batch sizes (McCandlish et al. 2018),
    with EMA smoothing: a copy of the JAX class (fork addition,
    reference `utils.py:618-674`). `update(grads)` takes the current
    micro-batch's unscaled gradient, a flat tensor (the engine's) or a
    tree of tensors; every `n_batches` calls it compares the averaged
    gradients against the freshest one. The running sum and the two
    means are computed on the gradient's device in fp32; the estimates
    are Python floats, as in the JAX class."""

    def __init__(self, batch_size_small, n_batches, beta=0.99, model=None):
        self.batch_size_small = batch_size_small
        self.batch_size_large = batch_size_small * n_batches
        self.n_batches = n_batches
        self.beta = beta
        self.model = model
        self.buffer = []
        self.ema_scale = None
        self.ema_noise = None
        self.scale = None
        self.noise = None
        self.noise_scale = None
        self.n_updates = 0
        self.skipped_nonfinite = 0

    def _ema(self, avg, value, i):
        avg = (avg or 0) * self.beta + (1 - self.beta) * value
        return avg, avg / (1 - self.beta ** (i + 1))

    @staticmethod
    def _flatten(grads):
        if isinstance(grads, torch.Tensor):
            return grads.float().reshape(-1)
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                for key in sorted(node):
                    walk(node[key])
            elif isinstance(node, (list, tuple)):
                for item in node:
                    walk(item)
            else:
                leaves.append(torch.as_tensor(node).float().reshape(-1))
        walk(grads)
        return torch.cat(leaves)

    def _get_scale(self, g_small, g_big):
        return (g_small - g_big) / ((1 / self.batch_size_small) -
                                    (1 / self.batch_size_large))

    def _get_noise(self, g_small, g_big):
        return (self.batch_size_large * g_big -
                self.batch_size_small * g_small) / \
            (self.batch_size_large - self.batch_size_small)

    def update(self, grads):
        curr = self._flatten(grads)
        if not bool(torch.isfinite(curr).all()):
            # One NaN/Inf micro-batch would poison the running sum AND
            # both EMAs permanently (every later estimate stays NaN).
            # Drop it: the step itself is handled by the loss-scaler
            # skip; the estimator just sees one fewer sample.
            self.skipped_nonfinite += 1
            if self.skipped_nonfinite == 1:
                logger.warning(
                    "GradientNoiseScale: skipping a non-finite "
                    "micro-batch gradient (would permanently poison the "
                    "EMA estimates)")
            return
        # running sum, not a buffer of n_batches full gradient copies
        self.buffer = [curr.clone()] if not self.buffer else \
            [self.buffer[0].add_(curr)]
        if self.n_updates % self.n_batches == self.n_batches - 1:
            past = self.buffer[0] / self.n_batches
            self.buffer = []
            g_big = float(torch.mean(past ** 2))
            g_small = float(torch.mean(curr ** 2))

            noise = self._get_noise(g_small, g_big)
            scale = self._get_scale(g_small, g_big)

            self.ema_scale, scale = self._ema(self.ema_scale, scale,
                                              self.n_updates)
            self.ema_noise, noise = self._ema(self.ema_noise, noise,
                                              self.n_updates)
            self.scale = float(scale)
            self.noise = float(noise)
            self.noise_scale = self.scale / self.noise if self.noise else None
        self.n_updates += 1
