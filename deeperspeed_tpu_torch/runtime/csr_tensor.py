"""Compressed-sparse-row container for sparse (embedding) gradients: the
port of `deeperspeed_tpu/runtime/csr_tensor.py`.

A row-sparse gradient is kept as (indices, values); the data-parallel
reduction all-gathers both (`csr_allreduce`) instead of reducing the
dense rows. The ranks' row counts differ, so each rank's pair is padded
to the largest count for the all-gather and cut back after; the result
is the JAX function's under `shard_map` (the ranks' rows concatenated in
rank order, the values divided by the world). The training engine takes
this path for the token embeddings where ``sparse_gradients`` is set
(`runtime/engine.py`).
"""

import torch


class CSRTensor:
    """Row-sparse view of a dense [rows, cols] gradient."""

    def __init__(self, dense_tensor=None):
        self.orig_dense_tensor = dense_tensor
        if dense_tensor is not None:
            self.dense_size = tuple(dense_tensor.shape)
            row_sums = dense_tensor.abs().sum(
                dim=tuple(range(1, dense_tensor.dim())))
            self.indices = torch.nonzero(row_sums > 0).reshape(-1)
            self.values = dense_tensor[self.indices]
        else:
            self.dense_size = None
            self.indices = None
            self.values = None

    @staticmethod
    def type():
        return "deeperspeed_tpu_torch.runtime.csr_tensor.CSRTensor"

    def to_dense(self):
        """Scatter-add the values back to dense; duplicate indices
        accumulate."""
        dense = self.values.new_zeros(self.dense_size)
        return dense.index_add_(0, self.indices, self.values)

    def sparse_size(self):
        num_sparse = self.indices.numel() * int(
            torch.Size(self.values.shape[1:]).numel())
        num_dense = int(torch.Size(self.dense_size).numel())
        return num_sparse, num_dense

    def add(self, other):
        assert self.dense_size == other.dense_size
        self.indices = torch.cat([self.indices, other.indices])
        self.values = torch.cat([self.values, other.values])
        return self

    def __str__(self):
        num_sparse, num_dense = self.sparse_size()
        return (f"CSRTensor(indices={self.indices.numel()}, "
                f"values={tuple(self.values.shape)}, "
                f"dense={self.dense_size}, "
                f"density={num_sparse / num_dense:.4f})")


def _gather_padded(t, count, most, group):
    """Every rank's first ``count`` rows of ``t`` (padded to ``most``
    rows for the all-gather), concatenated in rank order; ``count`` is
    the list of every rank's row count."""
    import torch.distributed as dist
    world = len(count)
    pad = t.new_zeros((most,) + tuple(t.shape[1:]))
    pad[:t.shape[0]] = t
    out = t.new_empty((world * most,) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(out, pad, group=group)
    return torch.cat([out[r * most:r * most + count[r]]
                      for r in range(world)])


def csr_allgather(csr, group=None):
    """Every rank's (indices, values), concatenated in rank order: a
    `CSRTensor` whose `to_dense` is the sum over the ranks."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    n = torch.tensor([csr.indices.numel()], dtype=torch.int64,
                     device=csr.values.device)
    counts = torch.empty(world, dtype=torch.int64, device=n.device)
    dist.all_gather_into_tensor(counts, n, group=group)
    count = [int(c) for c in counts.cpu()]
    most = max(count)
    out = CSRTensor()
    out.dense_size = csr.dense_size
    out.indices = _gather_padded(csr.indices.to(csr.values.device), count,
                                 most, group)
    out.values = _gather_padded(csr.values, count, most, group)
    return out


def csr_allreduce(csr, group=None):
    """All-gather indices and values across the ranks and average: the
    JAX `csr_allreduce` (reference `engine.py:1397-1448`)."""
    import torch.distributed as dist
    out = csr_allgather(csr, group)
    out.values = out.values / dist.get_world_size(group)
    return out
