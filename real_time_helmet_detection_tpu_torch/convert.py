"""Weight bridge: flax `{"params", "batch_stats"}` trees -> torch state dict.

The JAX package keeps its weights as flax variable trees in orbax
checkpoints (ref train.py:86 `init_variables`, models/hourglass.py:877);
the port's model names its submodules after the flax auto-names, so a
flax module path maps one to one onto a torch state-dict key:

    params/PreLayer_0/Convolution_0/Conv_0/kernel  (HWIO)
        -> PreLayer_0.Convolution_0.Conv_0.weight  (OIHW)
    params/.../BatchNorm_0/{scale, bias}  -> .../BatchNorm_0.{weight, bias}
    batch_stats/.../BatchNorm_0/{mean, var}
        -> .../BatchNorm_0.{running_mean, running_var}
    params/.../Activation_0/PReLU_0/negative_slope  (shape ())
        -> .../Activation_0.PReLU_0.negative_slope  (a 0-d tensor)

Grouped kernels take the same transpose: the depthwise HWIO (k, k, 1, C)
becomes OIHW (C, 1, k, k).

The int8 twin (`models/hourglass.py` `QuantConv`, JAX's `fold_bn=True,
quant_mode=...` model) maps the same way: a folded params tree (the
output of either package's `fold_batchnorm`: each `Conv_0` a kernel and
a bias, no BatchNorm) fills its `Conv_0.weight`/`bias`, and the `quant`
collection of calibrated clip ranges fills its buffers:

    quant/.../Conv_0/act_scale  (shape ())  -> .../Conv_0.act_scale

Flax keeps the biased batch variance; eval uses it as is.
`state_dict_to_flax` is the inverse, so a port checkpoint also writes
the flax-shaped npz that `--model-load` reads.

The port's `--model-load` format is an `.npz` of the flattened tree
(`save_npz`/`load_npz`, keys like `params/PreLayer_0/.../kernel`): an
orbax checkpoint cannot be read without jax, so
`scripts/orbax_to_npz.py` converts one with the JAX package on a machine
that has it.
"""

from __future__ import annotations

import io
from typing import Dict, Mapping

import numpy as np
import torch

from .utils import atomic_write_bytes

_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("params", "negative_slope"): "negative_slope",
    ("quant", "act_scale"): "act_scale",
}
COLLECTIONS = ("params", "batch_stats", "quant")


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/c": array}."""
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = "%s/%s" % (prefix, key) if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """{"a/b/c": array} -> nested dicts."""
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ..., "quant": ...} nested numpy
    dicts (any of them) -> a torch state dict (float32 tensors) for the
    port's `StackedHourglass` or its twins."""
    state: Dict[str, torch.Tensor] = {}
    for collection in COLLECTIONS:
        for path, value in flatten_tree(variables.get(collection, {})).items():
            *modules, leaf = path.split("/")
            name = _LEAF.get((collection, leaf))
            if name is None:
                raise KeyError("no torch counterpart for flax leaf %s/%s"
                               % (collection, path))
            arr = np.array(value, np.float32)  # a writable copy
            if leaf == "kernel":
                if arr.ndim != 4:
                    raise ValueError("conv kernel %s must be 4-D HWIO, got %s"
                                     % (path, arr.shape))
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            key = ".".join(modules + [name])
            if key in state:
                raise KeyError("two flax leaves map to %s" % key)
            # (np.ascontiguousarray would make a 0-d slope 1-d)
            state[key] = torch.from_numpy(arr.copy(order="C"))
    return state


def state_dict_to_flax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse bridge: a state dict of the port's `StackedHourglass`
    -> {"params": ..., "batch_stats": ...} nested float32 numpy dicts
    under the flax module paths (OIHW -> HWIO), the tree `save_npz`
    writes and `flax_to_state_dict` reads back; a twin's clip ranges go
    to "quant"."""
    inverse = {name: key for key, name in _LEAF.items()}
    flat: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        *modules, name = key.split(".")
        # a checkpoint's conversion: one copy per tensor is the work
        arr = value.detach().float().cpu().numpy()  # graftlint: off=device-get-in-loop
        if name == "weight":
            leaf = ("params", "kernel") if arr.ndim == 4 else \
                ("params", "scale")
        elif name in ("bias", "running_mean", "running_var",
                      "negative_slope", "act_scale"):
            leaf = inverse[name]
        else:
            raise KeyError("no flax counterpart for state-dict entry %s"
                           % key)
        if leaf[1] == "kernel":
            arr = arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        flat["/".join([leaf[0]] + modules + [leaf[1]])] = \
            arr.copy(order="C")
    return unflatten_tree(flat)


def save_npz(path: str, variables: Mapping) -> None:
    """Write a flax variable tree as an npz of its flattened leaves."""
    buf = io.BytesIO()
    np.savez(buf, **flatten_tree(variables))
    atomic_write_bytes(path, buf.getvalue())


def load_npz(path: str) -> Dict:
    """Read `save_npz` output back into a nested variable tree."""
    with np.load(path, allow_pickle=False) as f:
        return unflatten_tree({k: f[k] for k in f.files})


def load_into(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Fill every parameter and buffer of `model` from a flax tree;
    `strict=True` refuses a missing or extra leaf."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model
