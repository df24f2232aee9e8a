"""Activation checkpointing: the port of
`deeperspeed_tpu/runtime/activation_checkpointing/checkpointing.py`
(reference: `deepspeed/runtime/activation_checkpointing/checkpointing.py`).

Each concern of the reference maps to a PyTorch mechanism:

- recompute-in-backward → `torch.utils.checkpoint.checkpoint` with
  ``use_reentrant=False`` (the fused BERT layer's own checkpoint knobs use
  the same), so spans nest and the parameters' gradients land in the
  engine's flat gradient views as without remat;
- the named policies (`make_remat_policy`) → what a span keeps for the
  backward, as a ``context_fn``: selective checkpointing for ``dots``
  and ``attn_residuals``, a pair of dispatch modes that park the dots in
  pinned host memory for ``offload_dots``;
- RNG capture/restore → the port draws gate jitter and dropout seeds
  from explicit `torch.Generator`s, which ``checkpoint``'s
  ``preserve_rng_state`` does not cover (it restores the default CPU and
  CUDA generators only). `checkpoint_span(..., generators=)` snapshots
  each generator before the span, replays the snapshot in the recompute
  and leaves the advanced state after it, so the recompute draws the
  forward's numbers (the JAX package replays for free: its keys are
  values). The tracker API is kept for Megatron-style callers;
- partition_activations → a no-op on one rank (the JAX package's
  boundary constraint is None without a model axis);
- contiguous_memory_optimization / synchronize_checkpoint_boundary /
  profile → accepted no-ops, as in the JAX package.
"""

import contextlib
import dataclasses
import functools
from collections import defaultdict

import torch
from torch.utils import checkpoint as _torch_ckpt
from torch.utils._python_dispatch import TorchDispatchMode

from ...ops.hopper import flash_attention  # noqa: F401 (registers flash_fwd)
from ...utils.device import resolve_device
from ...utils.logging import logger
from .config import REMAT_POLICY_CHOICES, DeepSpeedActivationCheckpointingConfig

_config = DeepSpeedActivationCheckpointingConfig()
_mpu = None
_configured = False

# ---------------------------------------------------------------------------
# Named remat policies. The JSON `activation_checkpointing.policy` key (and
# the model families' `remat_policy=` knob) select one by name; the model
# forward hands the resolved policy to every checkpoint span.
#
# The JAX package tags the flash forward's saved output and LSE by name for
# `attn_residuals`; here the flash forward is one dispatcher op
# (`ops/hopper/flash_attention.flash_fwd`) whose two outputs are exactly
# those residuals, so the policy keeps that op's outputs.
# ---------------------------------------------------------------------------

# matmul results without batch dims (JAX's dots_with_no_batch_dims): every
# `x @ w` of a block reaches the dispatcher as mm (3-D activations are
# folded to rows) or addmm; bmm has a batch dim and is recomputed
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})

# the 'none' policy: a span that keeps everything, i.e. runs plainly (JAX's
# everything_saveable)
SAVE_EVERYTHING = "save_everything"


# what attn_residuals keeps: the flash forward's two outputs (out, lse)
ATTN_RESIDUAL_OPS = frozenset(
    {torch.ops.deeperspeed_tpu_torch.flash_fwd.default})


def _save_ops_policy(ops):
    """A selective-checkpoint policy: the outputs of ``ops`` MUST_SAVE,
    everything else recomputed."""
    save = _torch_ckpt.CheckpointPolicy.MUST_SAVE
    recompute = _torch_ckpt.CheckpointPolicy.PREFER_RECOMPUTE

    def policy(ctx, op, *args, **kwargs):
        return save if op in ops else recompute

    return functools.partial(_torch_ckpt.create_selective_checkpoint_contexts,
                             policy)


class _ParkDots(TorchDispatchMode):
    """The forward half of ``offload_dots``: each dot's result is copied
    into pinned host memory on the current stream (CPU tensors are kept
    as they are: they are already in host memory). The device result
    lives on only while the span's forward still reads it."""

    def __init__(self, parked):
        super().__init__()
        self.parked = parked

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in DOT_OPS:
            if out.device.type == "cuda":
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                self.parked[func].append((host, out.device))
            else:
                self.parked[func].append((out.detach(), None))
        return out


class _FetchDots(TorchDispatchMode):
    """The recompute half of ``offload_dots``: each dot is not recomputed
    but copied back from its host buffer on the current stream, in the
    forward's order; every other op runs again."""

    def __init__(self, parked):
        super().__init__()
        self.parked = parked
        self.taken = defaultdict(int)

    def __enter__(self):
        self.taken.clear()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in DOT_OPS:
            return func(*args, **(kwargs or {}))
        i = self.taken[func]
        self.taken[func] += 1
        host, device = self.parked[func][i]
        if device is None:
            return host
        return host.to(device, non_blocking=True)


def _offload_dots_contexts():
    parked = defaultdict(list)
    return _ParkDots(parked), _FetchDots(parked)


def make_remat_policy(name, offload_src="device", offload_dst="pinned_host"):
    """Named policy -> a ``context_fn`` for `torch.utils.checkpoint`.

    Returns `(policy, is_remat)`: `policy` is what a span keeps (None =
    keep nothing, whole-span recompute; `SAVE_EVERYTHING` = run the span
    plainly); `is_remat=False` only for 'none', which keeps everything —
    callers may skip the checkpoint wrapper entirely.

    - none:           keep every intermediate (remat disabled).
    - full:           keep nothing; recompute the whole span in backward.
    - dots:           keep matmul results without batch dims (mm, addmm;
                      the classic activations-not-weights split).
    - attn_residuals: keep only the flash forward's out and LSE, so the
                      backward never re-runs the forward kernel.
    - offload_dots:   'dots', with the kept dots in pinned host memory
                      (``offload_src`` → ``offload_dst``, the only pair;
                      honors `cpu_checkpointing`).
    """
    if name is None or name == "full":
        return None, True
    if name == "none":
        return SAVE_EVERYTHING, False
    if name == "dots":
        return _save_ops_policy(DOT_OPS), True
    if name == "attn_residuals":
        return _save_ops_policy(ATTN_RESIDUAL_OPS), True
    if name == "offload_dots":
        if (offload_src, offload_dst) != ("device", "pinned_host"):
            raise ValueError(
                f"offload_dots moves kept dots from 'device' to "
                f"'pinned_host', got {offload_src!r} -> {offload_dst!r}")
        return _offload_dots_contexts, True
    raise ValueError(
        f"unknown remat policy {name!r}; valid choices: "
        f"{', '.join(REMAT_POLICY_CHOICES)}")


def _replaying(fn, generators):
    """``fn`` whose second and later runs (the recomputes) start from the
    generators' states at the first run and leave their states as they
    found them."""
    states = [g.get_state() for g in generators]
    ran = [False]

    @functools.wraps(fn)
    def run(*args):
        if not ran[0]:
            ran[0] = True
            return fn(*args)
        after = [g.get_state() for g in generators]
        for g, state in zip(generators, states):
            g.set_state(state)
        try:
            return fn(*args)
        finally:
            for g, state in zip(generators, after):
                g.set_state(state)

    return run


def checkpoint_span(fn, *args, policy=None, generators=()):
    """Run ``fn(*args)`` as one recompute span: non-reentrant
    `torch.utils.checkpoint` keeping what ``policy`` (a
    `make_remat_policy` result; None keeps nothing, `SAVE_EVERYTHING`
    runs the span plainly) names. ``generators`` are the explicit
    `torch.Generator`s the span draws from; their draws replay in the
    recompute. Without grad mode the span just runs (nothing is kept for
    a backward that will not come)."""
    if policy is SAVE_EVERYTHING or not torch.is_grad_enabled():
        return fn(*args)
    gens = [g for g in generators if g is not None]
    if gens:
        fn = _replaying(fn, gens)
    extra = {} if policy is None else {"context_fn": policy}
    return _torch_ckpt.checkpoint(fn, *args, use_reentrant=False, **extra)


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """Configure the checkpointing subsystem (reference
    `checkpointing.py:769`)."""
    global _config, _mpu, _configured
    _mpu = mpu_
    if deepspeed_config is not None:
        if hasattr(deepspeed_config, "activation_checkpointing_config"):
            _config = deepspeed_config.activation_checkpointing_config
        else:
            _config = DeepSpeedActivationCheckpointingConfig.from_dict(
                deepspeed_config if isinstance(deepspeed_config, dict)
                else {})
    overrides = {
        "partition_activations": partition_activations,
        "contiguous_memory_optimization": contiguous_checkpointing,
        "number_checkpoints": num_checkpoints,
        "cpu_checkpointing": checkpoint_in_cpu,
        "synchronize_checkpoint_boundary": synchronize,
        "profile": profile,
    }
    updates = {k: v for k, v in overrides.items() if v is not None}
    if updates:
        _config = dataclasses.replace(_config, **updates)
    _configured = True


def is_configured():
    return _configured


def resolve_policy_name(policy, cpu_checkpointing):
    """The effective policy name for a config block: `cpu_checkpointing`
    promotes the (default/'dots') on-device policy to its host-offload
    form — the reference key spills checkpoints to CPU memory."""
    if cpu_checkpointing and policy in (None, "dots", "offload_dots"):
        return "offload_dots"
    return policy


def checkpoint(function, *args, generators=()):
    """Checkpoint a forward span: recompute it during backward (reference
    `checkpointing.py:687`) under the configured policy ('none' runs it
    plainly). Draws from ``generators`` replay in the recompute."""
    name = resolve_policy_name(getattr(_config, "policy", None),
                               _config.cpu_checkpointing)
    return checkpoint_span(function, *args,
                           policy=make_remat_policy(name)[0],
                           generators=generators)


def checkpoint_wrapper(fn):
    """Decorator form."""
    return functools.partial(checkpoint, fn)


# ---------------------------------------------------------------------------
# RNG tracker API (reference `checkpointing.py:198`-): Megatron callers
# expect named RNG states whose capture/restore makes dropout reproducible
# under recompute. Here each name holds a `torch.Generator`.
# ---------------------------------------------------------------------------

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"


class CudaRNGStatesTracker:
    """Named generator registry (name kept for API compatibility)."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states(self):
        """{name: the named generator's state}."""
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states):
        """Restore the named generators' states (names must be added)."""
        for name, state in states.items():
            if name not in self.states_:
                raise Exception(f"RNG state {name} is not added")
            self.states_[name].set_state(state)

    def add(self, name, seed, device=None):
        """A generator seeded ``seed`` on ``device`` (None: the GPU)."""
        if seed in self.seeds_:
            raise Exception(f"seed {seed} already present")
        self.seeds_.add(seed)
        if name in self.states_:
            raise Exception(f"RNG state {name} already present")
        self.states_[name] = torch.Generator(
            device=resolve_device(device, "CudaRNGStatesTracker")) \
            .manual_seed(int(seed))

    def fork(self, name=_MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Context manager yielding a generator split off the named one;
        the named generator advances, so successive forks differ."""

        @contextlib.contextmanager
        def _fork():
            if name not in self.states_:
                raise Exception(f"RNG state {name} is not added")
            g = self.states_[name]
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=g,
                                     device=g.device))
            yield torch.Generator(device=g.device).manual_seed(seed)

        return _fork()


_CUDA_RNG_STATE_TRACKER = CudaRNGStatesTracker()


def get_cuda_rng_tracker():
    return _CUDA_RNG_STATE_TRACKER


def model_parallel_cuda_manual_seed(seed, device=None):
    """Seed data-parallel and model-parallel RNG streams (reference
    `checkpointing.py:198`): MP ranks get offset seeds so dropout differs
    across tensor-parallel shards of one layer. Returns a generator
    seeded ``seed`` on ``device`` (None: the GPU)."""
    mp_rank = 0
    if _mpu is not None and hasattr(_mpu, "get_slice_parallel_rank"):
        mp_rank = _mpu.get_slice_parallel_rank()
    offset = seed + 2718
    model_parallel_seed = offset + mp_rank
    _CUDA_RNG_STATE_TRACKER.reset()
    _CUDA_RNG_STATE_TRACKER.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                                model_parallel_seed, device=device)
    return torch.Generator(
        device=resolve_device(device, "model_parallel_cuda_manual_seed")) \
        .manual_seed(int(seed))


def reset():
    """Reset between batches (reference keeps buffers; we keep nothing)."""


def partition_activations_in_checkpoint(partition_activation):
    global _config
    _config = dataclasses.replace(
        _config, partition_activations=partition_activation)
    logger.info(f"**************Partition Activations "
                f"{partition_activation}************")
