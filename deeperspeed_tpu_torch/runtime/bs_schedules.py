"""Batch-size warmup scheduler (fork addition; reference:
`deepspeed/runtime/bs_schedules.py:5-69`).

A copy of `deeperspeed_tpu/runtime/bs_schedules.py`. Linearly increases
the micro batch size from ``ceil(min_batch_size_multiplier *
final_batch_size)`` to ``final_batch_size`` over ``warmup_num_steps`` in
``num_intervals`` jumps. The engine steps it once per optimizer step
taken (a quarantined or overflow-skipped step leaves it where it is),
saves its ``state_dict`` in a checkpoint and restores it on load; the
caller reads ``current_batch_size`` to size its next batch.
"""

import math


class BatchSizeScheduler:
    """Step-indexed piecewise-constant batch-size schedule."""

    def __init__(self, final_batch_size, min_batch_size_multiplier=0.01,
                 warmup_num_steps=1000, num_intervals=4,
                 last_batch_iteration=-1, deepspeed=None):
        self.final_batch_size = final_batch_size
        self.min_batch_size_multiplier = min_batch_size_multiplier
        self.warmup_num_steps = warmup_num_steps
        self.num_intervals = num_intervals
        self.last_batch_iteration = last_batch_iteration
        self.deepspeed = deepspeed
        self.schedule = self._build_schedule()
        self.current_batch_size = None

    def _build_schedule(self):
        start = math.ceil(self.min_batch_size_multiplier *
                          self.final_batch_size)
        schedule = {}
        prev_bs = None
        for i in range(self.num_intervals):
            frac = i / max(1, self.num_intervals - 1)
            step = int(round(frac * self.warmup_num_steps))
            bs = int(round(start + frac * (self.final_batch_size - start)))
            if bs != prev_bs:
                schedule[step] = bs
            prev_bs = bs
        return schedule

    def get_current_batch_size(self):
        boundaries = sorted(self.schedule.keys(), reverse=True)
        for step in boundaries:
            if self.last_batch_iteration >= step:
                return self.schedule[step]
        return self.schedule[boundaries[-1]]

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self.current_batch_size = self.get_current_batch_size()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
