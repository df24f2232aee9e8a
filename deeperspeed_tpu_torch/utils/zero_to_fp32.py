#!/usr/bin/env python
"""Offline checkpoint → consolidated fp32 state dict.

The port's copy of `deeperspeed_tpu/utils/zero_to_fp32.py`, shipped
inside every checkpoint directory the port writes: a user can, at any
later time and without either framework installed (numpy and torch
only), turn a checkpoint into one fp32 state dict.

Layout read (written by either package's `checkpoint/checkpointing`):

    {ckpt_dir}/mp_rank_{mp:02d}_model_states.pt        # params + counters
    {ckpt_dir}/zero_pp_rank_{dp}_mp_rank_{mp:02d}_optim_states.pt

The zero files carry per-dp-rank slices of the fp32 masters and a
``fp32_master_dims`` map saying which dim each leaf was sliced along
(ceil-chunked, the last shard may be short; "flat" for a raveled leaf),
so the merge is a concatenate. Without zero files (fp32 training
without ZeRO) the module's leaves are the fp32 weights. bf16 leaves
written by the JAX package (`ml_dtypes.bfloat16` arrays) are read as
their 16-bit words and widened by a shift, without `ml_dtypes`. The JAX
package's streamed-NVMe and host-offload checkpoints are the JAX
script's to read.

Usage::

    python zero_to_fp32.py <checkpoint_dir> <output_file>

The output is a ``{param_path: np.float32 ndarray}`` dict saved with
torch.
"""

import os
import sys

if __package__ in (None, ""):
    # Run as a standalone script: python puts THIS directory first on
    # sys.path, where sibling modules (logging.py, timer.py) shadow the
    # stdlib and break third-party imports. The script is
    # self-contained, so drop the dir.
    _here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.getcwd()) != _here]

import argparse
import glob
import pickle
import re
import types

import numpy as np
import torch


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes" and name == "bfloat16":
            return np.uint16          # a bf16 leaf arrives as its words
        return super().find_class(module, name)


_PICKLE = types.ModuleType("zero_to_fp32_pickle")
_PICKLE.Unpickler = _Unpickler
_PICKLE.load = lambda f, **kw: _Unpickler(f, **kw).load()
_PICKLE.UnpicklingError = pickle.UnpicklingError


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PICKLE)


def _fp32(arr):
    arr = np.asarray(arr)
    if arr.dtype == np.uint16:    # bf16 words
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return np.asarray(arr, np.float32)


def get_model_state_file(checkpoint_dir, mp_rank=0):
    path = os.path.join(checkpoint_dir,
                        f"mp_rank_{mp_rank:02d}_model_states.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"can't find {path}")
    return path


def get_zero_files(checkpoint_dir, mp_rank=0):
    """Zero shard files ordered by dp rank (numeric, not lexicographic)."""
    pattern = os.path.join(
        checkpoint_dir, f"zero_pp_rank_*_mp_rank_{mp_rank:02d}_optim_states.pt")

    def dp_rank(path):
        m = re.search(r"zero_pp_rank_(\d+)_", os.path.basename(path))
        return int(m.group(1)) if m else 0

    return sorted(glob.glob(pattern), key=dp_rank)


def _merge_sliced(per_rank, dims, saved_dp, flat_shapes=None):
    merged = {}
    for key in per_rank[0]:
        dim = dims.get(key) if dims else None
        if dim is None or saved_dp == 1:
            merged[key] = np.asarray(per_rank[0][key])
        elif dim == "flat":
            flat = np.concatenate(
                [np.asarray(r[key]).ravel() for r in per_rank])
            merged[key] = flat.reshape((flat_shapes or {})[key])
        else:
            merged[key] = np.concatenate(
                [np.asarray(r[key]) for r in per_rank], axis=dim)
    return merged


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, mp_rank=0):
    """{param_path: fp32 ndarray}: the fp32 masters of the zero files,
    or the module's leaves widened to fp32 when there are none."""
    zero_files = get_zero_files(checkpoint_dir, mp_rank)
    if zero_files:
        shards = [_load(f) for f in zero_files]
        saved_dp = shards[0].get("partition_count", len(shards))
        if saved_dp != len(shards):
            raise RuntimeError(
                f"incomplete checkpoint: found {len(shards)} zero shard "
                f"files but the checkpoint was saved with "
                f"partition_count={saved_dp}")
        if shards[0].get("fp32_master") is not None:
            merged = _merge_sliced(
                [s["fp32_master"] for s in shards],
                shards[0].get("fp32_master_dims", {}) or {}, saved_dp,
                shards[0].get("fp32_master_flat_shapes"))
            return {k: _fp32(v) for k, v in merged.items()}
    model_state = _load(get_model_state_file(checkpoint_dir, mp_rank))
    return {k: _fp32(v) for k, v in model_state["module"]["arrays"].items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file,
                                               mp_rank=0):
    state_dict = get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir, mp_rank)
    print(f"Saving fp32 state dict ({len(state_dict)} tensors, "
          f"{sum(v.size for v in state_dict.values()):,} elements) "
          f"to {output_file}")
    torch.save(state_dict, output_file, pickle_protocol=4)
    return state_dict


# the reference's spelling
convert_zero_chkpt_to_fp32_consolid_state_dict = \
    convert_zero_checkpoint_to_fp32_state_dict


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract a consolidated fp32 state dict from a "
                    "DeeperSpeed checkpoint directory")
    parser.add_argument("checkpoint_dir",
                        help="checkpoint directory, e.g. global_step100")
    parser.add_argument("output_file",
                        help="where to save the consolidated fp32 state "
                             "dict, e.g. model_fp32.bin")
    parser.add_argument("--mp_rank", type=int, default=0,
                        help="model-parallel rank to extract (default 0)")
    args = parser.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, args.mp_rank)


if __name__ == "__main__":
    main()
