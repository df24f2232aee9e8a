"""Weights carried across from the JAX package.

`state_dict_from_jax` takes the JAX package's natural params pytree
(nested dicts and the ``blocks`` list, with numpy arrays as leaves) and
returns the port's ``state_dict``, keyed by the dotted pytree paths. The
port keeps the JAX ``[in, out]`` weight layout, so no leaf is
transposed. Nothing here imports JAX: the caller converts device arrays
to numpy (``jax.device_get``) on its side.
"""

import numpy as np
import torch


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}{key}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _flatten(value, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def state_dict_from_jax(params):
    """JAX natural params pytree (numpy leaves) → ``{dotted name:
    torch.Tensor}``. Leaves keep their shape; a dtype numpy cannot
    hand to torch (bfloat16 from ml_dtypes) goes through float32."""
    flat = _flatten(params, "", {})
    out = {}
    for name, leaf in flat.items():
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(
                arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(arr))   # a writable copy
    return out
