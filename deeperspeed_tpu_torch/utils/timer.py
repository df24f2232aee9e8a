"""Timers (reference: `deepspeed/utils/timer.py`): the port of
`deeperspeed_tpu/utils/timer.py`.

`SynchronizedWallClockTimer` is the ``wall_clock_breakdown`` timer
group: each start and stop waits for the queued device work
(`torch.cuda.synchronize`, where the JAX version drains XLA's async
dispatch), so its phases are device time plus host time, at the price of
a sync each. `ThroughputTimer` reports samples per second with a warm-up
skip, and tokens per second where the caller counts them
(`stop(tokens=)`). The JAX timer's ``monitor_memory`` option reads host
memory through `psutil`, which the card's machine does not have; it is
not ported. `profiler_trace` is a `torch.profiler` trace of a block.
"""

import contextlib
import time

import torch

from .logging import logger


def _device_barrier():
    """Wait for queued device work, so the wall clock is meaningful."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Named timer group with device-synchronized start/stop."""

    class Timer:
        # time.monotonic, not time.time: a wall-clock jump mid-span would
        # corrupt elapsed; monotonic cannot go back
        def __init__(self, name):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = time.monotonic()

        def start(self):
            assert not self.started_, f"{self.name_} timer already started"
            _device_barrier()
            self.start_time = time.monotonic()
            self.started_ = True

        def stop(self, reset=False):
            assert self.started_, f"{self.name_} timer not started"
            _device_barrier()
            if reset:
                self.elapsed_ = time.monotonic() - self.start_time
            else:
                self.elapsed_ += time.monotonic() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started = self.started_
            if started:
                self.stop()
            elapsed = self.elapsed_
            if reset:
                self.reset()
            if started:
                self.start()
            return elapsed

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]

    @staticmethod
    def memory_usage():
        """The caching allocator's bytes in use and their peak on the
        current card (a host query, no device sync)."""
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return "device memory stats unavailable"
        alloc = torch.cuda.memory_allocated() / 2 ** 30
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        return f"device in-use: {alloc:.2f} GB, peak: {peak:.2f} GB"

    def log(self, names, normalizer=1.0, reset=True, memory_breakdown=False):
        assert normalizer > 0.0
        string = "time (ms)"
        for name in names:
            if name not in self.timers:
                continue
            elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / \
                normalizer
            string += f" | {name}: {elapsed:.2f}"
        if memory_breakdown:
            string += f" | {self.memory_usage()}"
        logger.info(string)


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


@contextlib.contextmanager
def profiler_trace(logdir, create_perfetto_trace=False):
    """`torch.profiler` trace of everything run inside the block (the
    JAX package's `jax.profiler` trace): CPU and CUDA activity, exported
    as a Chrome trace ``trace.json`` under ``logdir`` when the block
    exits. ``create_perfetto_trace`` is accepted for the JAX signature;
    the Chrome trace loads in Perfetto as it is. It takes the process's
    one profile through the telemetry's flag, as a capture window does:
    inside an open window it raises RuntimeError, and a window that
    opens inside it traces only its host spans.

    with profiler_trace("/tmp/trace"):
        engine.train_batch(batch=...)
    """
    import os

    from ..runtime.telemetry import start_trace, stop_trace

    prof = start_trace()
    if prof is None:
        raise RuntimeError("profiler_trace: this process already runs a "
                           "torch.profiler trace (a telemetry capture "
                           "window or another profiler_trace)")
    try:
        yield prof
    finally:
        stop_trace(prof, os.path.join(logdir, "trace.json"))
