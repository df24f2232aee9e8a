"""Throughput timer: the port of `ThroughputTimer` of
`deeperspeed_tpu/utils/timer.py`.

Samples per second with a warm-up skip, and tokens per second where the
caller counts them (`stop(tokens=)`). The device is fenced with
`torch.cuda.synchronize` (the JAX version drains XLA's async dispatch).
The JAX timer's ``monitor_memory`` option reads host memory through
`psutil`, which the card's machine does not have; it is not ported.
"""

import time

import torch

from .logging import logger


def _device_barrier():
    """Wait for queued device work, so the wall clock is meaningful."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class ThroughputTimer:
    """Samples/sec with configurable warmup skip (reference
    `timer.py:105`)."""

    def __init__(self, batch_size, num_workers=1, start_step=2,
                 steps_per_output=50, logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.total_tokens = 0
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or logger.info
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def _init_timer(self):
        self.initialized = True

    def start(self):
        self._init_timer()
        self.started = True
        if self.global_step_count >= self.start_step:
            _device_barrier()
            self.start_time = time.monotonic()

    def stop(self, report_speed=True, tokens=None):
        """End a step; ``tokens`` (the step's token count) is summed over
        the timed steps for `avg_tokens_per_sec`."""
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        self.global_step_count += 1
        if self.start_time > 0:
            _device_barrier()
            self.end_time = time.monotonic()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.total_tokens += tokens or 0
            if report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                avg = self.avg_samples_per_sec()
                if avg > 0:   # still in warmup: nothing meaningful yet
                    self.logging(
                        f"{self.global_step_count}/"
                        f"{self.micro_step_count}, "
                        f"SamplesPerSec={avg:.2f}")

    def avg_samples_per_sec(self):
        # 0.0 (not -inf) before warmup completes: callers feed this into
        # logs, and a -inf reads as garbage.
        if self.global_step_count > self.start_step and \
                self.total_elapsed_time > 0:
            samples = self.batch_size * self.num_workers
            total_step_offset = self.global_step_count - self.start_step
            avg_time_per_step = self.total_elapsed_time / total_step_offset
            return samples / avg_time_per_step
        return 0.0

    def avg_tokens_per_sec(self):
        """Tokens over the timed steps' seconds (0.0 before any)."""
        if self.total_elapsed_time > 0:
            return self.total_tokens / self.total_elapsed_time
        return 0.0
