"""Document packing for ragged training corpora: the port of
`deeperspeed_tpu/runtime/packing.py`, the same functions on numpy
arrays or torch tensors (where the JAX module takes numpy or jnp). The
numpy results are the JAX module's bit for bit, and the same seed gives
the same document mixture.

Real corpora are document mixtures, not fixed-length sequences: padding
every document to the attention window burns flash-kernel flops on pad
tokens and on cross-document attention that contributes nothing to the
loss (BENCH_r05's longseq rows pay full n² work regardless of content).
This module packs documents into fixed [S]-token rows and emits the
metadata the segment-aware attention stack consumes:

- ``tokens [S]`` — documents laid back to back, zero-padded at the tail;
- ``segment_ids [S]`` — 1-based per-document ids, ``0`` = pad. Ids are
  non-decreasing within a row (the kernels' block-skip test relies on
  per-block min/max, which contiguous segments make exact);
- positions are NOT materialized: the models derive intra-segment
  positions from the segment ids (`segment_relative_positions`), so
  rotary/learned-position codes see each document as if it started at
  position 0 — exactly what the same document padded alone would see.

Packing strategy is greedy first-fit-decreasing over the document
lengths: deterministic, O(n·bins) with a tail-bin shortcut, and within a
few percent of optimal occupancy on lognormal web-corpus mixtures.
Documents longer than the window are split into window-sized pieces
(each piece becomes its own segment, matching the usual LM chunking).

The loss must then ignore exactly two kinds of targets (and nothing
else): pad positions and the first token of every document (its
predictor is the previous document's last token). `mask_cross_document_labels`
applies both via `ignore_index`; `count_effective_targets` counts what
survives — the "effective tokens" the telemetry layer reports next to
the raw scalars so packing wins are measured, not claimed.
"""

import numpy as np
import torch

# pad positions carry segment id 0 — shared convention across the
# dataloader, the kernels' masks and the telemetry accounting
PAD_SEGMENT_ID = 0


def pack_documents(docs, seq_len, pad_id=0, drop_tail=False):
    """Greedy first-fit-decreasing packing of token documents into
    fixed-length rows.

    docs: iterable of 1-D int token arrays (any dtype castable to
    int32). seq_len: row length. Documents longer than seq_len are
    split into seq_len-sized pieces first. Returns
    ``(tokens [N, S] int32, segment_ids [N, S] int32)`` with
    segment ids 1-based per row and 0 on pads.

    drop_tail: drop rows whose occupancy is below 50% (bench hygiene —
    a final nearly-empty row would skew tokens/s comparisons).
    """
    pieces = []
    for d in docs:
        d = np.asarray(d, np.int32).reshape(-1)
        if d.size == 0:
            continue
        for start in range(0, d.size, seq_len):
            pieces.append(d[start:start + seq_len])
    # first-fit-decreasing: sort by length, place each piece into the
    # first row with room; lengths index a stable order so equal-length
    # docs keep their corpus order
    order = sorted(range(len(pieces)), key=lambda i: -pieces[i].size)
    bins = []        # list of lists of piece indices
    room = []        # remaining tokens per bin
    for i in order:
        n = pieces[i].size
        placed = False
        for b, r in enumerate(room):
            if n <= r:
                bins[b].append(i)
                room[b] -= n
                placed = True
                break
        if not placed:
            bins.append([i])
            room.append(seq_len - n)

    rows_tok, rows_seg = [], []
    for b, members in enumerate(bins):
        tok = np.full((seq_len,), pad_id, np.int32)
        seg = np.full((seq_len,), PAD_SEGMENT_ID, np.int32)
        cur = 0
        # corpus order within the row keeps the stream readable/debuggable
        for s_idx, i in enumerate(sorted(members), start=1):
            p = pieces[i]
            tok[cur:cur + p.size] = p
            seg[cur:cur + p.size] = s_idx
            cur += p.size
        if drop_tail and cur * 2 < seq_len:
            continue
        rows_tok.append(tok)
        rows_seg.append(seg)
    if not rows_tok:
        return (np.zeros((0, seq_len), np.int32),
                np.zeros((0, seq_len), np.int32))
    return np.stack(rows_tok), np.stack(rows_seg)


class PackedDataset:
    """Indexable dataset of packed rows for `DeepSpeedDataLoader`.

    Each item is the 3-tuple ``(tokens, labels, segment_ids)`` the
    segment-aware model loss consumes (labels == tokens; the loss shifts
    internally and `mask_cross_document_labels` handles pad/cross-doc
    targets from the segment ids — the raw label stream stays intact for
    models that want their own masking)."""

    def __init__(self, docs, seq_len, pad_id=0, drop_tail=False):
        self.tokens, self.segment_ids = pack_documents(
            docs, seq_len, pad_id=pad_id, drop_tail=drop_tail)
        self.seq_len = seq_len

    def __len__(self):
        return self.tokens.shape[0]

    def __getitem__(self, i):
        return (self.tokens[i], self.tokens[i], self.segment_ids[i])

    def occupancy(self):
        """Fraction of non-pad positions — the packing-efficiency scalar
        the bench row records."""
        if self.segment_ids.size == 0:
            return 0.0
        return float((self.segment_ids != PAD_SEGMENT_ID).mean())


def mask_cross_document_labels(labels, segment_ids, ignore_index=-100):
    """Set `ignore_index` on every label whose next-token prediction
    would cross a document boundary or land on padding.

    The LM losses predict labels[t] from position t-1, so label position
    t is valid iff segment_ids[t] == segment_ids[t-1] and
    segment_ids[t] != PAD_SEGMENT_ID. Position 0 is never a target
    (the shift drops it) but is masked too for tidiness. Works on torch
    tensors or numpy arrays [B, S] (returns the same family)."""
    if isinstance(labels, np.ndarray):
        valid = np.concatenate(
            [np.zeros_like(segment_ids[:, :1], dtype=bool),
             (segment_ids[:, 1:] == segment_ids[:, :-1])
             & (segment_ids[:, 1:] != PAD_SEGMENT_ID)], axis=1)
        return np.where(valid, labels, ignore_index)
    valid = torch.cat(
        [torch.zeros_like(segment_ids[:, :1], dtype=torch.bool),
         (segment_ids[:, 1:] == segment_ids[:, :-1])
         & (segment_ids[:, 1:] != PAD_SEGMENT_ID)], dim=1)
    return torch.where(valid, labels,
                       torch.full_like(labels, ignore_index))


def count_effective_targets(segment_ids):
    """Number of loss-bearing target positions in a packed batch — the
    complement of `mask_cross_document_labels` (non-pad, non-cross-doc).
    numpy-only (the engine calls this host-side on the raw batch, before
    upload). segment_ids: [..., S]."""
    seg = np.asarray(segment_ids)
    valid = (seg[..., 1:] == seg[..., :-1]) & \
        (seg[..., 1:] != PAD_SEGMENT_ID)
    return int(valid.sum())


def packed_batch_token_stats(batch):
    """(effective_targets, total_targets) for a packed engine batch —
    the triple (tokens, labels, segment_ids) with any leading dims over
    the trailing [.., S] — or None when the batch carries no segment
    ids. `total` counts every possible LM target (S-1 per row);
    `effective` counts the non-pad, non-cross-document survivors. The
    telemetry layer divides both by step wall time so packing wins show
    up as measured effective-tokens/s, not just claimed occupancy.
    Host-side numpy (called on the raw batch before device upload)."""
    if not isinstance(batch, (tuple, list)) or len(batch) != 3:
        return None
    seg = np.asarray(batch[2])
    if seg.ndim < 2 or seg.shape[-1] < 2:
        return None
    rows = int(np.prod(seg.shape[:-1], dtype=np.int64))
    total = rows * (seg.shape[-1] - 1)
    return count_effective_targets(seg), total


def segment_relative_positions(segment_ids):
    """Intra-segment positions [B, S] int32: position i's offset from
    the start of its own segment — the index packed rotary/learned
    position codes must use so a packed document sees the same position
    stream as the same document padded alone.

    Computed as i - (last index where the segment id changed), via a
    cumulative maximum over change-point indices (`torch.cummax` on a
    tensor, on its device: no host sync)."""
    B, S = segment_ids.shape
    if isinstance(segment_ids, np.ndarray):
        idx = np.arange(S, dtype=np.int32)[None, :]
        change = np.concatenate(
            [np.ones_like(segment_ids[:, :1], dtype=bool),
             segment_ids[:, 1:] != segment_ids[:, :-1]], axis=1)
        starts = np.maximum.accumulate(np.where(change, idx, 0), axis=1)
        return (idx - starts).astype(np.int32)
    idx = torch.arange(S, dtype=torch.int32,
                       device=segment_ids.device)[None, :]
    change = torch.cat(
        [torch.ones_like(segment_ids[:, :1], dtype=torch.bool),
         segment_ids[:, 1:] != segment_ids[:, :-1]], dim=1)
    starts = torch.cummax(torch.where(change, idx, 0), dim=1).values
    return (idx - starts).to(torch.int32)


def synthetic_doc_mixture(seed, n_docs, vocab_size, mean_len=600.0,
                          sigma=1.0, max_len=None):
    """Deterministic lognormal document-length mixture (the shape of web
    corpora: many short documents, a heavy long tail). Shared by the
    packed bench row and the tests so rounds are comparable — same seed,
    same mixture. Returns a list of int32 token arrays."""
    rng = np.random.default_rng(seed)
    # lognormal with the requested mean: mean = exp(mu + sigma^2/2)
    mu = np.log(mean_len) - 0.5 * sigma * sigma
    lens = np.maximum(rng.lognormal(mu, sigma, n_docs).astype(np.int64), 8)
    if max_len is not None:
        lens = np.minimum(lens, max_len)
    return [rng.integers(0, vocab_size, int(n), dtype=np.int32)
            for n in lens]
