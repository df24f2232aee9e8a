"""Rank-aware logging (reference: `deepspeed/utils/logging.py`)."""

import logging
import sys

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name="DeeperSpeedTorch", level=logging.INFO):
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s")
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(formatter)
        lg.addHandler(handler)
    return lg


logger = _create_logger()


def _current_rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log `message` only on the given process ranks (None or [-1] = all)."""
    my_rank = _current_rank()
    if ranks is None or ranks == [-1] or my_rank in set(ranks):
        logger.log(level, f"[Rank {my_rank}] {message}")
