"""Checkpoint serialization in the JAX package's layout.

The port of `deeperspeed_tpu/checkpoint/serialization.py`. Files are
torch containers (`torch.save`) of dicts of numpy arrays, keyed by the
JAX package's tree paths: ``"blocks/0/attn/qkv_w"`` for a parameter,
``"exp_avg/blocks/0/attn/qkv_w"`` for a field of the Adam state. Those
are the port's dotted parameter names (`named_parameters`,
`models/convert._flatten`) with ``/`` for ``.``.

A JAX state dict also holds a ``"treedef"`` entry, a pickled JAX tree
structure. The port writes ``None`` there and never reads it: every
JAX load matches leaves by key against a template
(`state_dict_to_tree(like=...)`), and so does the port's.

bf16 without `ml_dtypes`. The JAX package writes bf16 leaves as numpy
arrays of `ml_dtypes.bfloat16`. `load_obj` reads every file through an
unpickler that maps that type to ``uint16``, so such a leaf arrives as
its raw 16-bit words and `to_tensor` views them as ``torch.bfloat16``
(exact); the port never imports `ml_dtypes`. The port itself writes
compute-dtype leaves as fp32 arrays (exact for bf16; the JAX package
casts them back on load), never as 16-bit words, which JAX would read
as integers.
"""

import pickle
import types

import numpy as np
import torch

# the dtype a JAX bf16 leaf arrives as: its raw words
BF16_WORDS = np.uint16


class _Unpickler(pickle.Unpickler):
    """Maps `ml_dtypes.bfloat16` (the scalar type numpy pickles a bf16
    array's dtype by) to ``uint16``, so no `ml_dtypes` is needed."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes" and name == "bfloat16":
            return BF16_WORDS
        return super().find_class(module, name)


# the module-like object `torch.load(pickle_module=...)` takes
_PICKLE = types.ModuleType("deeperspeed_checkpoint_pickle")
_PICKLE.Unpickler = _Unpickler
_PICKLE.load = lambda f, **kw: _Unpickler(f, **kw).load()
_PICKLE.UnpicklingError = pickle.UnpicklingError


# torch.save's default pickle protocol (2) stores a bytes object, and so
# every numpy array's data, as a latin-1 string re-encoded to UTF-8:
# random fp32 words grow by about a third and take a text codec each way.
# Protocol 4 stores them as raw bytes; every reader (torch.load, the JAX
# package's included) reads either.
PICKLE_PROTOCOL = 4


def save_obj(obj, path):
    torch.save(obj, path, pickle_protocol=PICKLE_PROTOCOL)


def load_obj(path):
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PICKLE)


def path_key(name):
    """The port's dotted parameter name → the JAX tree path key."""
    return name.replace(".", "/")


def to_tensor(arr):
    """A leaf read from a checkpoint → a CPU tensor (bf16 words from a
    JAX file → ``torch.bfloat16``)."""
    arr = np.asarray(arr)
    if arr.dtype == BF16_WORDS:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a writable copy


def state_dict(arrays):
    """``{path key: numpy array}`` → the JAX state-dict form (no
    treedef)."""
    return {"arrays": arrays, "treedef": None}


def shard_slice(array, num_parts, rank, dim):
    """GSPMD-convention shard: ceil-chunk along `dim` (last shard may be
    short)."""
    n = array.shape[dim]
    chunk = -(-n // num_parts)
    start = min(rank * chunk, n)
    stop = min(start + chunk, n)
    index = [slice(None)] * array.ndim
    index[dim] = slice(start, stop)
    return array[tuple(index)]


def unshard_concat(shards, dim):
    return np.concatenate(shards, axis=dim)
