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
"""

import datetime
import os
import time

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
