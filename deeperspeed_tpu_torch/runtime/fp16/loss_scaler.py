"""Loss scaling for fp16 training.

The port of `deeperspeed_tpu/runtime/fp16/loss_scaler.py`. The JAX
package runs the dynamic-scale state machine inside its compiled step as
branchless arithmetic; the port's engine reads the overflow flag on the
host each fp16 step (the JAX engine does too, `_after_step`), so the
state is plain Python numbers and `update_loss_scale` is the same
transition written with branches. bf16 and fp32 runs keep a static scale
of 1 and never check for overflow.
"""

from typing import NamedTuple

import torch


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


def grads_finite(flat_grads):
    """0-d bool tensor: every element of the flat gradient is finite."""
    return torch.isfinite(flat_grads).all()


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
