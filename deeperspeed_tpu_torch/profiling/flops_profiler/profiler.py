"""FLOPs profiler (reference:
`deepspeed/profiling/flops_profiler/profiler.py:11`).

The port of `deeperspeed_tpu/profiling/flops_profiler/profiler.py`,
with its API: `profile_fn`, `params_count`, `FlopsProfiler(engine=)`
(`profile_train_step`, `print_model_profile`, the reference's lifecycle
methods), `get_model_profile` and the ``*_to_string`` helpers.

The JAX profiler reads XLA's cost analysis of the compiled step. Eager
PyTorch has no compiled program to ask, so the port counts the products
that run: `torch.utils.flop_counter.FlopCounterMode` (2·M·N·K a matrix
product, over mm / addmm / bmm and what einsum and linear lower to).

The hand-written kernels are ctypes launches, which FlopCounterMode
cannot see. So the engine's count (`count_train_flops`) runs one
micro-step's forward and backward on the plain path (the model's
``use_kernels`` off) under `FakeTensorMode`: every tensor is a fake of
the real one's shape, dtype and device, nothing is computed and no
device memory is taken (a real plain pass at 16k tokens would hold
S×S fp32 scores a layer), and the card counts the products the CPU
does, whatever implements them on the real step. What the count holds:

- attention is the plain version's products. Dense, causal or
  segmented: QKᵀ and P·V over the full S×S square, two in the forward
  and, through autograd, four in the backward (masked scores are
  computed and then masked): the analytic 12·L·h·S a token. A call that
  goes through the ``flash_fwd`` op (which hides its body from the
  counter) counts its two forward products by the formula registered
  below, and its explicit plain backward five, so the layout-masked
  arm of sparse attention counts 14·L·h·S a token. The block-sparse
  arm's plain version computes active 128-blocks only: each query
  block against its LUT's width of key blocks (the widest row's count,
  the shorter rows padded), 2 products forward and 5 backward;
- the embedding gather and its scatter-add gradient are no product and
  count nothing, though the analytic 6N counts 6·V·h a token for them;
  elementwise work (norms, gelu, softmax, Adam) counts nothing, where
  XLA's cost analysis counts every operation;
- the MoE sort engine's grouped products count their whole expert
  buffer (every span row, live or not), as the plain version computes
  it.
"""

import time

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# imported for the flash_fwd op it defines (the formula below)
from ...ops.hopper import flash_attention  # noqa: F401
from ...utils.logging import logger


@register_flop_formula(torch.ops.deeperspeed_tpu_torch.flash_fwd)
def _flash_fwd_flop(q_shape, k_shape, v_shape, *args, out_shape=None,
                    **kwargs):
    """The flash forward op hides its body (kernel or plain version)
    from the counter: QKᵀ and P·V over the full S×S square."""
    B, S, H, D = q_shape
    return 2 * 2 * B * H * S * S * D


def count_flops(fn, *args, **kwargs):
    """(fn(*args, **kwargs), the products it ran in flops)."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, float(counter.get_total_flops())


def _sync(device=None):
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


def profile_fn(fn, *args, n_timing_iters=3, **kwargs):
    """Run ``fn(*args)`` once under the flop counter, then time
    ``n_timing_iters`` more runs between device syncs. Returns {flops,
    bytes_accessed, duration, flops_per_sec}; eager PyTorch has no cost
    model for bytes, so ``bytes_accessed`` is None. A kernel launched by
    ``fn`` counts nothing: profile its plain version."""
    _, flops = count_flops(fn, *args, **kwargs)
    _sync()
    start = time.perf_counter()
    for _ in range(n_timing_iters):
        fn(*args, **kwargs)
    _sync()
    duration = (time.perf_counter() - start) / max(n_timing_iters, 1)
    return {
        "flops": flops,
        "bytes_accessed": None,
        "duration": duration,
        "flops_per_sec": flops / duration if duration > 0 else 0.0,
    }


def params_count(params):
    """Elements of a parameter pytree (dicts, lists, tuples of tensors or
    arrays), or of a module's parameters."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(params_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_count(v) for v in params)
    if params is None:
        return 0
    return int(np.prod(params.shape))


def _micro_loss(engine, params, micro_batch, rng):
    """One micro-batch's loss at ``params`` through the engine's
    installed loss (the model's, or the "rl" block's), with the step's
    own keyword arguments."""
    kw = engine._pld_kwargs()
    if engine.quant is not None and engine._quant_step_active:
        kw["ffn_amax"] = engine.quant.amax
    loss = engine.loss_fn(params, micro_batch, rng=rng, **kw)
    return loss[0] if isinstance(loss, tuple) else loss


def _micro_grads(engine, micro_batch, rng):
    """One micro-batch's forward and the gradients of every parameter,
    through `torch.autograd.grad`: the engine's flat gradient buffer and
    counters are untouched."""
    model = engine.module
    loss = _micro_loss(engine, model.params_tree(), micro_batch, rng)
    torch.autograd.grad(loss, [p for p in model.parameters()
                               if p.requires_grad])


def count_train_flops(engine, micro_batch, rng_seed=0):
    """Flops of one micro-step of ``engine``'s model, forward and backward
    (gradients of every parameter), on the plain path (the model's
    ``use_kernels`` off for the count) and over fake tensors: the
    parameters and the micro-batch become `FakeTensorMode` fakes on
    their own devices, so the count computes nothing, touches no device
    memory and syncs nothing. Nothing of the engine's state changes; the
    jitter and dropout draw from a generator of their own, and the MoE
    routing statistics are not recorded."""
    from ...moe.layer import ROUTING_STATS
    model = engine.module
    had = hasattr(model, "use_kernels")
    prev = getattr(model, "use_kernels", None)
    if had:
        model.use_kernels = False
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                ROUTING_STATS.suspended():
            def fake(t, grad=False):
                if not isinstance(t, torch.Tensor):
                    return t
                f = mode.from_tensor(t)
                return f.requires_grad_() if grad and t.requires_grad \
                    else f
            params = pytree.tree_map(lambda t: fake(t, grad=True),
                                     model.params_tree())
            batch = pytree.tree_map(fake, micro_batch)
            leaves = [t for t in pytree.tree_leaves(params)
                      if isinstance(t, torch.Tensor) and t.requires_grad]
            rng = torch.Generator(device=engine.device).manual_seed(
                rng_seed)

            def step():
                loss = _micro_loss(engine, params, batch, rng)
                torch.autograd.grad(loss, leaves, allow_unused=True)
            _, flops = count_flops(step)
    finally:
        if had:
            model.use_kernels = prev
    return flops


class FlopsProfiler:
    """Engine-attached profiler with the reference's method surface."""

    def __init__(self, model=None, engine=None):
        self.engine = engine if engine is not None else model
        self.started = False
        self._results = {}
        self._start_time = None
        self._steps = 0

    # -- lifecycle (reference API) ----------------------------------------

    def start_profile(self, ignore_list=None):
        self.started = True
        self._steps = 0
        self._start_time = time.perf_counter()
        self._results = {}

    def stop_profile(self):
        if not self.started:
            return
        self.started = False
        self._results["duration"] = time.perf_counter() - self._start_time

    def reset_profile(self):
        self._results = {}
        self._steps = 0

    def end_profile(self):
        self.stop_profile()

    def step(self):
        if self.started:
            self._steps += 1

    # -- results -----------------------------------------------------------

    def get_total_flops(self, as_string=False):
        flops = self._results.get("flops", 0.0)
        return flops_to_string(flops) if as_string else flops

    def get_total_duration(self, as_string=False):
        duration = self._results.get("duration", 0.0)
        return duration_to_string(duration) if as_string else duration

    def get_total_params(self, as_string=False):
        n = 0
        if self.engine is not None:
            n = getattr(self.engine, "num_params", None)
            if n is None and hasattr(self.engine, "module"):
                n = params_count(self.engine.module)
        return params_to_string(n or 0) if as_string else (n or 0)

    def profile_train_step(self, batch, accum_steps=None):
        """Count and time the engine's train step body on ``batch``
        (stacked [accum, micro, ...], as `train_batch` takes it).

        ``flops``: `count_train_flops` of each micro-batch, summed (the
        update's elementwise work counts nothing). ``duration``: each
        micro-batch's forward and backward through the kernels, between
        device syncs, with `torch.autograd.grad` (the engine's gradient
        buffer and its step counters are untouched, as the JAX profiler
        runs a copy of the step that donates nothing)."""
        eng = self.engine
        gas = accum_steps if accum_steps is not None else \
            eng.gradient_accumulation_steps()
        batch = eng._device_batch(batch)
        micro = [eng._map(batch, lambda v, i=i: v[i]) for i in range(gas)]
        flops = sum(count_train_flops(eng, m) for m in micro)
        rng = torch.Generator(device=eng.device).manual_seed(0)
        from ...moe.layer import ROUTING_STATS
        _sync()
        t0 = time.perf_counter()
        with ROUTING_STATS.suspended():
            for m in micro:
                _micro_grads(eng, m, rng)
        _sync()
        duration = time.perf_counter() - t0
        results = {"flops": flops, "bytes_accessed": None,
                   "duration": duration,
                   "flops_per_sec": flops / duration if duration > 0
                   else 0.0}
        self._results.update(results)
        return results

    def print_model_profile(self, profile_step=1, module_depth=-1,
                            top_modules=3, detailed=True, output_file=None):
        lines = [
            "DeepSpeed-Torch Flops Profiler",
            f"params:            {self.get_total_params(as_string=True)}",
            f"flops per step:    {self.get_total_flops(as_string=True)}",
            f"step duration:     {self.get_total_duration(as_string=True)}",
        ]
        if self._results.get("flops_per_sec"):
            lines.append(
                f"achieved:          "
                f"{flops_to_string(self._results['flops_per_sec'])}/s")
        report = "\n".join(lines)
        if output_file:
            with open(output_file, "w") as f:
                f.write(report)
        else:
            logger.info(report)
        return report

    def print_model_aggregated_profile(self, module_depth=-1, top_modules=3):
        return self.print_model_profile(module_depth=module_depth,
                                        top_modules=top_modules)


# -- formatting helpers (reference profiler.py bottom section) -------------

def flops_to_string(flops, units=None, precision=2):
    for unit, scale in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if units == unit or (units is None and flops >= scale):
            return f"{round(flops / scale, precision)} {unit}FLOPS"
    return f"{round(flops, precision)} FLOPS"


def params_to_string(params_num, units=None, precision=2):
    for unit, scale in (("B", 1e9), ("M", 1e6), ("k", 1e3)):
        if units == unit or (units is None and params_num >= scale):
            return f"{round(params_num / scale, precision)} {unit}"
    return str(params_num)


def duration_to_string(duration, units=None, precision=2):
    if units == "ms" or (units is None and duration < 1):
        return f"{round(duration * 1000, precision)} ms"
    return f"{round(duration, precision)} s"


def get_model_profile(model, input_res=None, args=None, kwargs=None,
                      print_profile=True, detailed=True, module_depth=-1,
                      top_modules=3, warm_up=1, as_string=True,
                      output_file=None, ignore_modules=None):
    """Standalone helper (reference `profiler.py` tail): profile a
    callable ``model(*args, **kwargs)`` (`profile_fn`)."""
    args = args or []
    kwargs = kwargs or {}
    results = profile_fn(model, *args, **kwargs)
    flops = results["flops"]
    duration = results["duration"]
    if print_profile:
        logger.info(f"flops={flops_to_string(flops)} "
                    f"duration={duration_to_string(duration)}")
    if as_string:
        return flops_to_string(flops), duration_to_string(duration)
    return flops, duration
