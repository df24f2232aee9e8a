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


def _map_experts(tree, fn, path=()):
    """``tree`` with ``fn(leaf)`` in place of every expert leaf (an MoE
    block's ``mlp.{w_in,b_in,w_out,b_out}``, dim 0 the experts)."""
    from .gpt_neox import is_expert_leaf
    if isinstance(tree, dict):
        return {k: _map_experts(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_experts(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(tree) if is_expert_leaf(".".join(path)) else tree


def expert_slice(tree, rank, ep):
    """A rank's share of a whole GPT-NeoX params tree (numpy or tensor
    leaves, the JAX natural tree) on an "expert" mesh of ``ep`` ranks:
    rows [rank·E/ep, (rank + 1)·E/ep) of every expert leaf, every other
    leaf (the gate too) whole."""
    def cut(leaf):
        n = leaf.shape[0] // ep
        return leaf[rank * n:(rank + 1) * n]
    return _map_experts(tree, cut)


def merge_expert_slices(trees):
    """The whole tree back from every rank's `expert_slice` (rank order):
    the expert leaves concatenated along the experts, every other leaf
    rank 0's."""
    leaves = [_flatten(t, "", {}) for t in trees]

    def whole(path_leaf):
        name, leaf = path_leaf
        parts = [lv[name] for lv in leaves]
        if isinstance(leaf, torch.Tensor):
            return torch.cat(parts)
        return np.concatenate([np.asarray(p) for p in parts])

    from .gpt_neox import is_expert_leaf

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}.") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}.")
                              for i, v in enumerate(tree))
        name = prefix[:-1]
        return whole((name, tree)) if is_expert_leaf(name) else tree
    return rebuild(trees[0], "")
