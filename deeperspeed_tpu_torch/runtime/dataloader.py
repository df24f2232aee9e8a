"""Data pipeline: the port of `deeperspeed_tpu/runtime/dataloader.py`.

`DeepSpeedDataLoader` wraps any indexable dataset (torch Dataset, numpy
arrays, lists of tuples) with rank-strided sampling, batching into numpy
stacks, and optional infinite repeat. The training engine moves each
batch to its device. The replica count and the rank default to the
`torch.distributed` process group's (one rank a card; 1 and 0 without a
group), as the JAX loader's default to the process count and index;
each rank loads every ``num_replicas``-th sample from its rank on.
`state_dict` /
`load_state_dict` carry the resume position through a checkpoint with
the JAX loader's keys and errors.
"""

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart from the beginning when exhausted
    (reference `dataloader.py:10`; pipelines need unbounded iterators)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


def _stack_batch(samples):
    """Collate a list of samples (arrays or tuples/dicts of arrays)."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            _stack_batch([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_batch([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Batched, optionally-shuffled loader producing numpy pytrees.

    `data_sampler` may be any iterable of indices; by default a
    seeded-shuffle or sequential sampler over the local shard
    (process-strided for multi-host, mirroring DistributedSampler).
    """

    def __init__(self, dataset, batch_size, collate_fn=None,
                 local_rank=None, shuffle=False, seed=0, drop_last=True,
                 data_sampler=None, num_replicas=None, rank=None,
                 tput_timer=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _stack_batch
        self.tput_timer = tput_timer
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        from ..utils.distributed import get_rank, get_world_size
        self.num_replicas = num_replicas if num_replicas is not None \
            else get_world_size()
        self.rank = rank if rank is not None else get_rank()
        # One-shot iterators (generator samplers, iter(x) is x) are
        # consumed by the first traversal — `_num_batches()` below would
        # exhaust them and `__iter__` would then yield zero batches.
        # Materialize those once; re-iterable samplers (lists, torch-style
        # sampler objects) are kept as-is so a per-epoch reshuffling
        # sampler still yields a fresh order every epoch.
        if data_sampler is not None and iter(data_sampler) is data_sampler:
            data_sampler = list(data_sampler)
        self.data_sampler = data_sampler
        self.epoch = 0
        self._batches_yielded = 0   # position within the current epoch
        self._resume_offset = 0     # batches to skip on the next __iter__
        self.len = self._num_batches()

    def _local_indices(self):
        n = len(self.dataset)
        if self.data_sampler is not None:
            return list(self.data_sampler)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # Process-strided split (each host loads 1/num_replicas of data).
        return order[self.rank::self.num_replicas].tolist()

    def _num_batches(self):
        n = len(self._local_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.len = self._num_batches()

    def __len__(self):
        return self.len

    def position(self):
        """Current stream position as `{"epoch", "offset"}` (offset in
        batches within the epoch): the provenance the training-health
        sentinel records for quarantined windows and rollbacks."""
        return {"epoch": self.epoch, "offset": self._batches_yielded}

    def state_dict(self):
        """Resume position for full-state checkpointing: epoch + batch
        offset. The built-in sampler's shuffle order is derived from
        (seed, epoch), so these two plus the seed restore the exact
        sample stream; a materialized custom `data_sampler` is static
        across epochs and needs only the offset."""
        return {"epoch": self.epoch,
                "batches_yielded": self._batches_yielded,
                "seed": self.seed,
                "shuffle": self.shuffle,
                "batch_size": self.batch_size,
                "num_replicas": self.num_replicas,
                "rank": self.rank}

    def load_state_dict(self, sd):
        self.epoch = int(sd["epoch"])
        self.seed = sd.get("seed", self.seed)
        if sd.get("batch_size") not in (None, self.batch_size):
            # a different batch size re-chunks the index stream; an
            # offset in old-batch units would resume mid-batch silently
            raise ValueError(
                f"dataloader resume: checkpoint was cut at batch_size="
                f"{sd['batch_size']} but this loader uses "
                f"{self.batch_size}; restart the epoch or match sizes")
        if "shuffle" in sd and bool(sd["shuffle"]) != bool(self.shuffle):
            # the offset skip only lands on the right samples if the
            # index order matches
            raise ValueError(
                f"dataloader resume: checkpoint was cut with shuffle="
                f"{sd['shuffle']} but this loader uses "
                f"shuffle={self.shuffle}")
        saved_topo = (sd.get("num_replicas", self.num_replicas),
                      sd.get("rank", self.rank))
        if saved_topo != (self.num_replicas, self.rank):
            # rank-strided index streams: another replica count or rank
            # re-deals the samples, so the offset would skip or replay
            # the wrong ones (the engine reconciles instead)
            raise ValueError(
                f"dataloader resume: checkpoint was cut at (num_replicas,"
                f" rank)={saved_topo} but this loader runs "
                f"{(self.num_replicas, self.rank)}")
        self._resume_offset = int(sd.get("batches_yielded", 0))
        self._batches_yielded = self._resume_offset
        self.len = self._num_batches()

    def reconcile_state_dict(self, sd):
        """Fallback when `load_state_dict` rejects the exact position
        (replica count / batch size / shuffle changed): keep the epoch
        and the shuffle seed, reset the batch offset. At most one partial
        epoch is replayed; nothing is skipped. Returns the fields kept."""
        self.epoch = int(sd.get("epoch", self.epoch))
        self.seed = sd.get("seed", self.seed)
        self._resume_offset = 0
        self._batches_yielded = 0
        self.len = self._num_batches()
        return {"epoch": self.epoch, "seed": self.seed, "offset": 0}

    def __iter__(self):
        if self.tput_timer:
            self.tput_timer.start()
        indices = self._local_indices()
        skip, self._resume_offset = self._resume_offset, 0
        self._batches_yielded = skip
        for batch_idx, start in enumerate(
                range(0, len(indices), self.batch_size)):
            chunk = indices[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if batch_idx < skip:   # checkpoint resume: mid-epoch seek
                continue
            batch = self.collate_fn([self.dataset[i] for i in chunk])
            self._batches_yielded = batch_idx + 1
            yield batch
        self.epoch += 1
        self._batches_yielded = 0
