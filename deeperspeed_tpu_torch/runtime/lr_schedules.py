"""LR schedules: a copy of `deeperspeed_tpu/runtime/lr_schedules.py`
(pure Python, so the port keeps its own copy rather than importing it).

Four schedules with the reference's exact math and stateful API
(`step`/`get_lr`/`get_last_lr`/`state_dict`/`load_state_dict`):
``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``. The
training engine reads ``param_groups[0]["lr"]`` before each step and
calls ``step()`` after each step taken; ``lr_at(iteration)``
evaluates a schedule as a function, and `make_schedule_fn` builds one
as a plain ``f(step)`` without an optimizer.
"""

import math

LR_SCHEDULE = "lr_schedule"
LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]

LR_RANGE_TEST_MIN_LR = "lr_range_test_min_lr"
LR_RANGE_TEST_STEP_RATE = "lr_range_test_step_rate"
LR_RANGE_TEST_STEP_SIZE = "lr_range_test_step_size"
LR_RANGE_TEST_STAIRCASE = "lr_range_test_staircase"

EDGE_VALUE = "edge_value"
MID_VALUE = "mid_value"

CYCLE_FIRST_STEP_SIZE = "cycle_first_step_size"
CYCLE_FIRST_STAIR_COUNT = "cycle_first_stair_count"
CYCLE_SECOND_STEP_SIZE = "cycle_second_step_size"
CYCLE_SECOND_STAIR_COUNT = "cycle_second_stair_count"
DECAY_STEP_SIZE = "decay_step_size"

CYCLE_MIN_LR = "cycle_min_lr"
CYCLE_MAX_LR = "cycle_max_lr"
DECAY_LR_RATE = "decay_lr_rate"

CYCLE_MIN_MOM = "cycle_min_mom"
CYCLE_MAX_MOM = "cycle_max_mom"
DECAY_MOM_RATE = "decay_mom_rate"
CYCLE_MOMENTUM = "cycle_momentum"

WARMUP_MIN_LR = "warmup_min_lr"
WARMUP_MAX_LR = "warmup_max_lr"
WARMUP_NUM_STEPS = "warmup_num_steps"

TOTAL_NUM_STEPS = "total_num_steps"


def _require_param_groups(optimizer):
    """Accept any optimizer wrapper exposing torch-style `param_groups`."""
    if hasattr(optimizer, "param_groups"):
        return optimizer
    inner = getattr(optimizer, "optimizer", None)
    if inner is not None and hasattr(inner, "param_groups"):
        return inner
    raise TypeError(
        f"{type(optimizer).__name__} does not expose param_groups")


def _format_param(optimizer, value, name):
    if isinstance(value, (list, tuple)):
        if len(value) != len(optimizer.param_groups):
            raise ValueError(
                f"expected {len(optimizer.param_groups)} values for {name}, "
                f"got {len(value)}")
        return list(value)
    return [value] * len(optimizer.param_groups)


class _LRScheduler:
    """Shared stepping/state plumbing; subclasses implement lr_at()."""

    def __init__(self, optimizer, last_batch_iteration=-1):
        self.optimizer = _require_param_groups(optimizer)
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, iteration):
        raise NotImplementedError

    def get_lr(self):
        return self.lr_at(self.last_batch_iteration)

    def get_last_lr(self):
        if getattr(self, "_last_lr", None) is None:
            raise RuntimeError("need to call step() first")
        return self._last_lr

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        for param_group, lr in zip(self.optimizer.param_groups,
                                   self.get_lr()):
            param_group["lr"] = lr
        self._last_lr = [g["lr"] for g in self.optimizer.param_groups]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_LRScheduler):
    """LR range test: grow lr from a base with constant frequency
    (arXiv:1803.09820); used to find the divergence boundary."""

    def __init__(self, optimizer, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = _format_param(self.optimizer, lr_range_test_min_lr,
                                    "lr_range_test_min_lr")
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        if last_batch_iteration == -1:
            for group, lr in zip(self.optimizer.param_groups, self.min_lr):
                group["lr"] = lr

    def _interval(self, iteration):
        frac = float(iteration + 1) / self.step_size
        return math.floor(frac) if self.staircase else frac

    def lr_at(self, iteration):
        increase = 1 + self.step_rate * self._interval(iteration)
        return [lr * increase for lr in self.min_lr]


class OneCycle(_LRScheduler):
    """1Cycle policy: one lr (and inverse momentum) cycle followed by decay
    (arXiv:1803.09820)."""

    def __init__(self, optimizer, cycle_min_lr, cycle_max_lr,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 cycle_momentum=True, cycle_min_mom=0.8, cycle_max_mom=0.9,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)

        first = float(cycle_first_step_size)
        second = float(cycle_second_step_size
                       if cycle_second_step_size is not None else first)
        self.total_size = first + second
        self.step_ratio = first / self.total_size
        self.first_stair_count = cycle_first_stair_count
        self.second_stair_count = (cycle_first_stair_count
                                   if cycle_second_stair_count is None else
                                   cycle_second_stair_count)
        self.decay_step_size = decay_step_size

        self.min_lrs = [cycle_min_lr] * len(self.optimizer.param_groups)
        self.max_lrs = [cycle_max_lr] * len(self.optimizer.param_groups)
        self.decay_lr_rate = decay_lr_rate
        if last_batch_iteration == -1:
            for lr, group in zip(self.min_lrs, self.optimizer.param_groups):
                group["lr"] = lr

        self.cycle_momentum = cycle_momentum
        if cycle_momentum:
            has_betas = any("betas" in g for g in self.optimizer.param_groups) \
                or "betas" in getattr(self.optimizer, "defaults", {})
            if not has_betas:
                self.cycle_momentum = False
            else:
                self.decay_mom_rate = decay_mom_rate
                n = len(self.optimizer.param_groups)
                self.min_moms = [(cycle_min_mom, 0.99)] * n
                self.max_moms = [(cycle_max_mom, 0.99)] * n
                if last_batch_iteration == -1:
                    for mom, group in zip(self.min_moms,
                                          self.optimizer.param_groups):
                        group["betas"] = mom

    def _scale_factor(self, iteration):
        batch_iteration = iteration + 1
        cycle = math.floor(1 + batch_iteration / self.total_size)
        x = 1.0 + batch_iteration / self.total_size - cycle
        if x <= self.step_ratio:
            return x / self.step_ratio
        return (x - 1) / (self.step_ratio - 1)

    def lr_at(self, iteration):
        if iteration < self.total_size:
            scale = self._scale_factor(iteration)
            return [min_lr + (max_lr - min_lr) * scale
                    for min_lr, max_lr in zip(self.min_lrs, self.max_lrs)]
        decay_iter = iteration - self.total_size + 1
        factor = 1 + self.decay_lr_rate * decay_iter / self.decay_step_size
        return [min_lr / factor for min_lr in self.min_lrs]

    def mom_at(self, iteration):
        if not self.cycle_momentum:
            return None
        if iteration < self.total_size:
            scale = self._scale_factor(iteration)
            return [(max_b[0] - (max_b[0] - min_b[0]) * scale, min_b[1])
                    for min_b, max_b in zip(self.min_moms, self.max_moms)]
        decay_iter = iteration - self.total_size + 1
        factor = 1 + self.decay_mom_rate * decay_iter / self.decay_step_size
        return [(b0 * factor, b1) for b0, b1 in self.max_moms]

    def get_mom(self):
        return self.mom_at(self.last_batch_iteration)

    def step(self, batch_iteration=None):
        super().step(batch_iteration)
        if self.cycle_momentum:
            for group, momentum in zip(self.optimizer.param_groups,
                                       self.get_mom()):
                group["betas"] = momentum


class WarmupLR(_LRScheduler):
    """Log-ramp lr from min to max over warmup_num_steps, then hold."""

    def __init__(self, optimizer, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lrs = _format_param(self.optimizer, warmup_min_lr, "min_lr")
        self.max_lrs = _format_param(self.optimizer, warmup_max_lr, "max_lr")
        self.delta_lrs = [big - small
                          for big, small in zip(self.max_lrs, self.min_lrs)]
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _gamma(self, iteration):
        if iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(iteration + 1)
        return 1.0

    def lr_at(self, iteration):
        if iteration < 0:
            return [0.0]
        gamma = self._gamma(iteration)
        return [min_lr + delta * gamma
                for min_lr, delta in zip(self.min_lrs, self.delta_lrs)]


class WarmupDecayLR(WarmupLR):
    """WarmupLR followed by linear decay to zero at total_num_steps."""

    def __init__(self, optimizer, total_num_steps, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr,
                         warmup_num_steps, last_batch_iteration)

    def _gamma(self, iteration):
        if iteration < self.warmup_num_steps:
            return self.inverse_log_warm_up * math.log(iteration + 1)
        return max(
            0.0,
            float(self.total_num_steps - iteration) /
            float(max(1.0, self.total_num_steps - self.warmup_num_steps)))


_SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_scheduler_class(name):
    if name not in _SCHEDULE_CLASSES:
        raise ValueError(
            f"unknown lr schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return _SCHEDULE_CLASSES[name]


class _DummyGroups:
    """Stand-in optimizer so schedules can be evaluated as pure functions."""
    param_groups = None

    def __init__(self):
        self.param_groups = [{"lr": 0.0, "betas": (0.9, 0.999)}]
        self.defaults = {"betas": (0.9, 0.999)}


def make_schedule_fn(name, params):
    """Return a pure ``f(step: int) -> float``, the schedule's LR at an
    optimizer step counted from 0 (the JAX package's `make_schedule_fn`,
    which its jitted programs call)."""
    sched = get_scheduler_class(name)(_DummyGroups(), **params)

    def schedule(step):
        return sched.lr_at(int(step))[0]

    return schedule


def add_tuning_arguments(parser):
    """The reference's CLI tuning flags (the JAX package's
    `add_tuning_arguments`: the same flags and defaults)."""
    group = parser.add_argument_group("Convergence Tuning",
                                      "Convergence tuning configurations")
    group.add_argument("--lr_schedule", type=str, default=None)
    group.add_argument("--lr_range_test_min_lr", type=float, default=0.001)
    group.add_argument("--lr_range_test_step_rate", type=float, default=1.0)
    group.add_argument("--lr_range_test_step_size", type=int, default=1000)
    group.add_argument("--lr_range_test_staircase", type=bool, default=False)
    group.add_argument("--cycle_first_step_size", type=int, default=1000)
    group.add_argument("--cycle_first_stair_count", type=int, default=-1)
    group.add_argument("--cycle_second_step_size", type=int, default=-1)
    group.add_argument("--cycle_second_stair_count", type=int, default=-1)
    group.add_argument("--decay_step_size", type=int, default=1000)
    group.add_argument("--cycle_min_lr", type=float, default=0.01)
    group.add_argument("--cycle_max_lr", type=float, default=0.1)
    group.add_argument("--decay_lr_rate", type=float, default=0.0)
    group.add_argument("--cycle_momentum", default=False,
                       action="store_true")
    group.add_argument("--cycle_min_mom", type=float, default=0.8)
    group.add_argument("--cycle_max_mom", type=float, default=0.9)
    group.add_argument("--decay_mom_rate", type=float, default=0.0)
    group.add_argument("--warmup_min_lr", type=float, default=0.0)
    group.add_argument("--warmup_max_lr", type=float, default=0.001)
    group.add_argument("--warmup_num_steps", type=int, default=1000)
    return parser
