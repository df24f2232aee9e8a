"""Distributed init and the fail-fast barrier: the port of
`deeperspeed_tpu/utils/distributed.py`.

`init_distributed` joins the `torch.distributed` world from the
launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT: the names the reference launcher exports) or from MPI
(`mpi_discovery`, through mpi4py), with NCCL on the card and gloo on the
CPU. Unlike the JAX package, where one process drives every local chip
and a single-host run needs no rendezvous, the port runs one process a
card, so a process group is formed at any world size, 1 included: the
training engine's data-parallel path runs whenever one exists.

`barrier(tag, timeout)` fails fast with a typed `BarrierTimeoutError`
where the backend can bound the wait (gloo's monitored barrier), and
`inject_barrier_timeout` arms it to fail without waiting, the
single-process test seam of the JAX package.

The MoE layer's collectives are differentiable (`all_reduce_sum`,
`all_gather`: their backward sums the cotangents over the group, as
`torch.distributed.nn.functional` does; `all_to_all`: its backward is
the reverse exchange, and it can be issued asynchronously and completed
by `a2a_wait`). A CUDA tensor on a gloo group goes through an explicit
host copy (`_staged`, counted in `host_staged`); NCCL takes it as it
is.
"""

import datetime
import os
import time

import torch
import torch.distributed as dist

from .logging import logger

# the deadline (seconds) of rendezvous, collectives and barriers set by
# init_distributed(timeout=...); None: the backend's default
_collective_timeout = None

# a barrier's deadline when none is configured, as in the JAX package
DEFAULT_BARRIER_TIMEOUT_S = 900.0

# fault-injection seam: {tag_or_None: remaining_fires}; None matches any
_forced_timeouts = {}


class BarrierTimeoutError(RuntimeError):
    """A barrier blew its deadline: a peer never arrived (dead,
    preempted or wedged). Carries the tag and the elapsed wall time."""

    def __init__(self, tag, timeout_s, elapsed_s, cause=None):
        self.tag = tag
        self.timeout_s = float(timeout_s)
        self.elapsed_s = float(elapsed_s)
        super().__init__(
            f"barrier '{tag}' timed out after {elapsed_s:.1f}s "
            f"(deadline {timeout_s:.1f}s): a peer rank never arrived"
            + (f" — {cause}" if cause else ""))


def inject_barrier_timeout(tag=None, times=1):
    """Arm the next ``times`` barrier call(s) (only those with ``tag``,
    when given) to raise `BarrierTimeoutError` without waiting."""
    _forced_timeouts[tag] = _forced_timeouts.get(tag, 0) + int(times)


def _pop_forced_timeout(tag):
    for key in (tag, None):
        if _forced_timeouts.get(key, 0) > 0:
            _forced_timeouts[key] -= 1
            if not _forced_timeouts[key]:
                del _forced_timeouts[key]
            return True
    return False


def get_collective_timeout():
    """The deadline configured by ``init_distributed(timeout=...)``, in
    seconds (None: the backend's default)."""
    return _collective_timeout


def is_initialized():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None):
    import torch.distributed as dist
    return dist.get_world_size(group) if is_initialized() else 1


def get_rank(group=None):
    import torch.distributed as dist
    return dist.get_rank(group) if is_initialized() else 0


def default_backend(device=None):
    """"nccl" for a CUDA device (the default when CUDA is there), "gloo"
    for the CPU."""
    import torch
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(dist_backend=None, auto_mpi_discovery=True,
                     distributed_port=29500, verbose=True, timeout=None,
                     init_method=None):
    """Join the `torch.distributed` world (a no-op once joined).

    Rank and world come from RANK / WORLD_SIZE (MPI discovery fills them
    in when they are absent and an Open MPI launcher set
    OMPI_COMM_WORLD_SIZE); the rendezvous is ``init_method`` or
    ``tcp://MASTER_ADDR:MASTER_PORT`` (127.0.0.1 and
    ``distributed_port`` by default). ``dist_backend`` is "nccl" (one
    card a rank: LOCAL_RANK's device is made current), "gloo" (the CPU)
    or None for `default_backend`. ``timeout`` (seconds) bounds the
    rendezvous, every collective and every `barrier`."""
    import torch
    import torch.distributed as dist
    global _collective_timeout
    if timeout is not None:
        _collective_timeout = float(timeout)
    if is_initialized():
        return
    required = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
    if auto_mpi_discovery and init_method is None and \
            not all(v in os.environ for v in required) and \
            "OMPI_COMM_WORLD_SIZE" in os.environ:
        mpi_discovery(distributed_port=distributed_port, verbose=verbose)
    rank = int(os.environ.get("RANK", "0"))
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    backend = dist_backend or default_backend()
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{addr}:{port}"
    if backend == "nccl":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kwargs = {}
    if _collective_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=_collective_timeout)
    if verbose:
        logger.info(f"Initializing torch.distributed: backend={backend}, "
                    f"rank={rank}, world_size={world_size}, "
                    f"init_method={init_method}"
                    + (f", timeout={timeout}s" if timeout is not None
                       else ""))
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world_size, **kwargs)


def barrier(tag, timeout=None):
    """A barrier over the default group with a deadline: ``timeout``,
    else the configured one, else `DEFAULT_BARRIER_TIMEOUT_S`. On gloo
    a missing rank raises `BarrierTimeoutError` at the deadline (the
    monitored barrier); on NCCL the process group's own timeout bounds
    it. One process: a no-op, but an injected timeout still fires."""
    timeout = _collective_timeout if timeout is None else timeout
    if _pop_forced_timeout(tag):
        raise BarrierTimeoutError(
            tag, timeout or DEFAULT_BARRIER_TIMEOUT_S, 0.0,
            cause="injected fault (barrier_timeout)")
    if get_world_size() <= 1:
        return
    import torch.distributed as dist
    timeout = float(timeout) if timeout else DEFAULT_BARRIER_TIMEOUT_S
    if dist.get_backend() != "gloo":
        dist.barrier()
        return
    t0 = time.monotonic()
    try:
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout))
    except RuntimeError as e:
        raise BarrierTimeoutError(tag, timeout, time.monotonic() - t0,
                                  cause=e) from e


def mpi_discovery(distributed_port=29500, verbose=True):
    """Rank, world and master from MPI, exported as the launcher's
    environment variables (needs mpi4py)."""
    try:
        from mpi4py import MPI
    except ImportError as e:
        raise RuntimeError(
            "MPI discovery needs mpi4py, which is not installed: set RANK, "
            "WORLD_SIZE, MASTER_ADDR and MASTER_PORT instead (or install "
            "mpi4py)") from e
    comm = MPI.COMM_WORLD
    rank = comm.Get_rank()
    world_size = comm.Get_size()
    import socket
    master_addr = None
    if rank == 0:
        master_addr = socket.gethostbyname(socket.gethostname())
    master_addr = comm.bcast(master_addr, root=0)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ["MASTER_ADDR"] = master_addr
    os.environ["MASTER_PORT"] = str(distributed_port)
    os.environ["LOCAL_RANK"] = str(
        comm.Split_type(MPI.COMM_TYPE_SHARED).Get_rank())
    if verbose:
        logger.info(f"MPI discovery: rank={rank}, world_size={world_size}, "
                    f"master_addr={master_addr}, master_port="
                    f"{distributed_port}")


# ---------------------------------------------------------------------------
# differentiable collectives (MoE across ranks: `moe/layer.py`)
# ---------------------------------------------------------------------------

# how many collectives took the explicit host copy (a CUDA tensor on a
# gloo group, `_staged`) since the last reset; `chip_smoke.py` reports it
host_staged = 0


def _staged(t, group):
    """(the tensor the backend is given, whether it is a host copy):
    gloo's all-to-all takes CPU tensors, so a CUDA tensor on a gloo group
    goes through an explicit host copy, counted in `host_staged`. NCCL
    takes the CUDA tensor itself."""
    global host_staged
    if t.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host_staged += 1
        return t.cpu(), True
    return t, False


def _all_to_all(x, group, async_op=False):
    """``out[s] = x_of_rank_s[rank]`` along dim 0 (split in world equal
    blocks) → (out, work or None). ``x`` is made contiguous."""
    src, host = _staged(x.contiguous(), group)
    out = torch.empty_like(src)
    work = dist.all_to_all_single(out, src, group=group, async_op=async_op)
    if host:
        # the host copy back needs the data: wait here
        if work is not None:
            work.wait()
        return out.to(x.device), None
    return out, work


def _all_reduce_sum(t, group):
    src, host = _staged(t.contiguous(), group)
    out = src.clone() if not host else src
    dist.all_reduce(out, group=group)
    return out.to(t.device) if host else out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents over the
    group too (`torch.distributed.nn.functional.all_reduce`): a statistic
    every rank computes over the whole group sends each rank's gradient
    back to every contributor."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """[world, *t.shape], rank-major; the backward sums the cotangents
    over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        src, host = _staged(t.contiguous(), group)
        out = [torch.empty_like(src)
               for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, src, group=group)
        out = torch.stack(out)
        return out.to(t.device) if host else out

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group)[dist.get_rank(ctx.group)], None


class A2AHandle:
    """An all-to-all in flight (`all_to_all(..., async_op=True)`)."""
    work = None


class _AllToAll(torch.autograd.Function):
    """`_all_to_all` along dim 0; the backward is the reverse all-to-all
    (the exchange is its own transpose). With ``handle`` (an `A2AHandle`)
    the exchange is issued asynchronously and `a2a_wait` completes it."""

    @staticmethod
    def forward(ctx, x, group, handle):
        ctx.group = group
        out, work = _all_to_all(x, group, async_op=handle is not None)
        if handle is not None:
            handle.work = work
        return out

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group)[0], None, None


class _Wait(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, handle):
        if handle.work is not None:
            handle.work.wait()
            handle.work = None
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(t, group=None):
    """Differentiable sum over ``group``: the backward all-reduces the
    cotangent, so a group statistic every rank computes and every rank's
    loss reads gets the sum of their gradients (a data-parallel average
    then divides by the world)."""
    return _AllReduceSum.apply(t, group)


def all_gather(t, group=None):
    """Differentiable all-gather → [world, *t.shape] (rank-major); the
    backward sums the cotangents over the group."""
    return _AllGather.apply(t, group)


def all_to_all(x, group=None, async_op=False):
    """Differentiable all-to-all along dim 0 (``x`` [world, ...]: block s
    goes to rank s; the result's block s came from rank s), as
    `jax.lax.all_to_all(x, axis, 0, 0)`. The backward is the reverse
    exchange. With ``async_op`` the return is (out, handle): ``out`` is
    ready once `a2a_wait(out, handle)` returns it."""
    if not async_op:
        return _AllToAll.apply(x, group, None)
    handle = A2AHandle()
    return _AllToAll.apply(x, group, handle), handle


def a2a_wait(x, handle):
    """Complete the asynchronous all-to-all that made ``x``."""
    return _Wait.apply(x, handle)
