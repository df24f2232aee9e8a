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
    torch.Tensor}``. Leaves keep their shape and dtype (fp16 leaves stay
    fp16, the fp16 training and serving paths' weights); a dtype numpy
    cannot hand to torch (bfloat16 from ml_dtypes) goes through float32
    to bfloat16. A
    leaf that is already a tensor (a tree made by the port, as
    `gpt2.init_params` makes one) is taken as it is, on its device."""
    flat = _flatten(params, "", {})
    out = {}
    for name, leaf in flat.items():
        if isinstance(leaf, torch.Tensor):
            out[name] = leaf
            continue
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(
                arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(arr))   # a writable copy
    return out


def flat_from_jax(tree, names):
    """A JAX pytree (numpy leaves) shaped like the params → one flat fp32
    tensor, leaves in the order of ``names`` (the engine's flat layout,
    `named_parameters` order)."""
    sd = state_dict_from_jax(tree)
    if set(sd) != set(names):
        raise ValueError(f"pytree leaves {sorted(set(sd) ^ set(names))} do "
                         f"not match the parameter names")
    return torch.cat([sd[n].reshape(-1).float() for n in names])


def adam_state_from_jax(state, names):
    """The JAX `AdamState` (numpy leaves: call ``jax.device_get`` first)
    → the port's flat `AdamState` (step, exp_avg, exp_avg_sq) in the
    layout of ``names``."""
    from ..ops.adam.fused_adam import AdamState
    return AdamState(step=int(np.asarray(state.step)),
                     exp_avg=flat_from_jax(state.exp_avg, names),
                     exp_avg_sq=flat_from_jax(state.exp_avg_sq, names))


def tiled_linear_from_jax(layer, params):
    """The JAX `TiledLinear`'s params ``{"weight": (in_splits, out_splits,
    in_tile, out_tile), "bias": (out_features,)}`` (numpy leaves) into the
    port's `runtime.zero.TiledLinear` ``layer``, in place: both stack the
    tiles alike, so no leaf is transposed. Returns ``layer``."""
    sd = state_dict_from_jax(params)
    own = layer.state_dict()
    if set(sd) != set(own):
        raise ValueError(f"JAX TiledLinear params {sorted(sd)} do not match "
                         f"the layer's {sorted(own)}")
    for name, leaf in sd.items():
        if tuple(leaf.shape) != tuple(own[name].shape):
            raise ValueError(f"JAX TiledLinear {name} is "
                             f"{tuple(leaf.shape)}, the layer's "
                             f"{tuple(own[name].shape)} (in/out splits "
                             f"differ?)")
    layer.load_state_dict({k: v.to(own[k].dtype) for k, v in sd.items()})
    return layer
