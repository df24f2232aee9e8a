"""Loss scaling for fp16 training.

The port of `deeperspeed_tpu/runtime/fp16/loss_scaler.py`. The JAX
package runs the dynamic-scale state machine inside its compiled step as
branchless arithmetic; the port's engine reads the overflow flag on the
host each fp16 step (the JAX engine does too, `_after_step`), so the
state is plain Python numbers and `update_loss_scale` is the same
transition written with branches. bf16 and fp32 runs keep a static scale
of 1 and never check for overflow. Across data-parallel ranks the
overflow flag is agreed over the process group (`grads_finite`), as the
JAX step agrees it over the data axis. `ScaleFloorWatch` watches a
dynamic scale pinned at its floor (``fp16.min_scale_patience``).
"""

from typing import NamedTuple

import torch

from ...utils.logging import logger


class LossScaleState(NamedTuple):
    """Loss-scale state between steps."""
    cur_scale: float
    cur_iter: int
    last_overflow_iter: int
    cur_hysteresis: int


def init_loss_scale_state(init_scale=2 ** 32, delayed_shift=1,
                          static=False):
    """`static=True` yields a state whose window never hits (the JAX
    package's sentinel), for a scale that never moves."""
    return LossScaleState(cur_scale=float(init_scale), cur_iter=0,
                          last_overflow_iter=-1 if not static else -2 ** 30,
                          cur_hysteresis=int(delayed_shift))


def grads_finite(flat_grads, group=None):
    """0-d bool tensor: every element of the flat gradient is finite.
    With a process ``group`` of more than one rank, ``flat_grads`` is
    this rank's partition and the flag is agreed over the ranks (any
    rank's overflow is every rank's), so the dynamic scale moves alike
    on all of them."""
    finite = torch.isfinite(flat_grads).all()
    if group is None:
        return finite
    import torch.distributed as dist
    if dist.get_world_size(group) == 1:
        return finite
    flag = finite.to(torch.int32).reshape(1)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return flag[0].bool()


def update_loss_scale(state, overflow, scale_factor=2.0, scale_window=1000,
                      min_scale=1.0, delayed_shift=1,
                      consecutive_hysteresis=False):
    """The JAX package's `update_loss_scale` transition: halve on
    overflow (after `delayed_shift` overflows), double after
    `scale_window` clean steps, never below `min_scale`."""
    if overflow:
        shift_now = delayed_shift == 1 or state.cur_hysteresis <= 1
        return LossScaleState(
            cur_scale=(max(state.cur_scale / scale_factor, min_scale)
                       if shift_now else state.cur_scale),
            cur_iter=state.cur_iter + 1,
            last_overflow_iter=state.cur_iter,
            cur_hysteresis=(state.cur_hysteresis if shift_now
                            else state.cur_hysteresis - 1))
    window_hit = (state.cur_iter - state.last_overflow_iter) % \
        scale_window == 0
    return LossScaleState(
        cur_scale=(state.cur_scale * scale_factor if window_hit
                   else state.cur_scale),
        cur_iter=state.cur_iter + 1,
        last_overflow_iter=state.last_overflow_iter,
        cur_hysteresis=(int(delayed_shift)
                        if consecutive_hysteresis or window_hit
                        else state.cur_hysteresis))


class LossScaler:
    """Static loss scale; overflow never fires."""

    def __init__(self, scale=1):
        self.cur_scale = scale


class DynamicLossScaler(LossScaler):
    """Dynamic scaling parameters (the state lives in `LossScaleState`)."""

    def __init__(self, init_scale=2 ** 32, scale_factor=2.0,
                 scale_window=1000, min_scale=1, delayed_shift=1,
                 consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis


class LossScaleFloorError(RuntimeError):
    """The dynamic loss scale has been pinned at `min_loss_scale` for
    `fp16.min_scale_patience` consecutive skipped steps: every step is
    being skipped, the run is burning compute without training."""


class ScaleFloorWatch:
    """Detect a loss scale stuck at its floor (host-side, O(1) per step).

    The dynamic scaler halves on overflow but floors at `min_scale`; once
    there, a run whose gradients stay non-finite skips EVERY step while
    reporting normal-looking progress. This watch warns ONCE when the
    floor is first hit on a skipped step, tracks the consecutive-skip run
    length, and after `patience` consecutive skipped steps at the floor
    raises `LossScaleFloorError` instead of silently burning steps.
    `patience=0` keeps warn-only behavior.
    """

    def __init__(self, min_scale=1.0, patience=0):
        self.min_scale = float(min_scale)
        self.patience = int(patience)
        self.consecutive = 0
        self.warned = False

    def on_skip(self, cur_scale):
        """Record an overflow-skipped step; True if the scale sits at the
        floor. Raises after `patience` consecutive floor skips."""
        if cur_scale > self.min_scale:
            self.consecutive = 0
            return False
        self.consecutive += 1
        if not self.warned:
            self.warned = True
            logger.warning(
                f"dynamic loss scale has bottomed out at min_scale="
                f"{self.min_scale} and the step was skipped; if this "
                "persists the run is not training (set "
                "fp16.min_scale_patience to fail fast)")
        if self.patience and self.consecutive >= self.patience:
            raise LossScaleFloorError(
                f"loss scale pinned at min_scale={self.min_scale} for "
                f"{self.consecutive} consecutive skipped steps "
                f"(fp16.min_scale_patience={self.patience}): every "
                "recent step overflowed and was dropped. The gradients "
                "are persistently non-finite — check for bad data, a "
                "diverged model, or enable the training_health sentinel "
                "for automatic rollback.")
        return True

    def on_step_taken(self):
        """A step actually applied: the skip run (if any) is over."""
        self.consecutive = 0


def create_loss_scaler(config):
    """The scaler a `DeepSpeedConfig`-like object asks for."""
    if not getattr(config, "loss_scaling_enabled", False):
        return LossScaler(scale=1)
    static_scale = getattr(config, "loss_scale", 0)
    if static_scale and static_scale > 0:
        return LossScaler(scale=static_scale)
    args = getattr(config, "dynamic_loss_scale_args", None) or {}
    return DynamicLossScaler(
        init_scale=2 ** args.get("initial_scale_power", 32),
        scale_window=args.get("loss_scale_window", 1000),
        min_scale=args.get("min_loss_scale", 1),
        delayed_shift=args.get("hysteresis", 1),
    )
