"""flax variables -> torch ``state_dict``, and the weight files.

Inverse of ``vision_semantic_segmentation_tpu/models/convert.py::
torch_state_dict_to_flax``.  :func:`load_weights` reads a reference
``.pth`` checkpoint or the JAX package's flat ``.npz`` archive of flax
variables (keys ``params/backbone/conv1/kernel``, ...) into a state dict.
The port's modules use the reference torch
names, so a reference ``.pth`` loads with ``load_state_dict(strict=True)``
and a flax tree from the JAX package crosses over exactly.  Leaves may be
numpy or any array type ``np.asarray`` accepts.

Mapping rules (flax -> torch):
  * params/.../kernel (4-D, HWIO) -> ....weight (OIHW); grouped
    ``(kh, kw, in/g, out)`` and depthwise ``(3, 3, 1, C)`` included
  * params/.../kernel (2-D)       -> ....weight (transposed)
  * params/.../scale / bias       -> ....weight / bias (BatchNorm)
  * batch_stats/.../mean / var    -> ....running_mean / running_var, plus
    ``num_batches_tracked`` = 0 (torch keeps it; flax has none)
  * a trailing ``_<int>`` on a path component is a torch ModuleList /
    Sequential index: ``layer1_0`` -> ``layer1.0``,
    ``module_pyramid_2`` -> ``module_pyramid.2``
"""
from __future__ import annotations

import re
from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_INDEXED = re.compile(r"^(.*?)((?:_\d+)+)$")


def _split_indices(parts: Tuple[str, ...]) -> Tuple[str, ...]:
    """Undo ``_fuse_indices``: ``('layer1_0', 'conv1')`` -> ``('layer1', '0', 'conv1')``."""
    out = []
    for p in parts:
        m = _INDEXED.match(p)
        if m and m.group(1):
            out.append(m.group(1))
            out.extend(m.group(2)[1:].split("_"))
        else:
            out.append(p)
    return tuple(out)


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert ``{'params': ..., 'batch_stats': ...}`` into a torch state dict."""
    sd: Dict[str, torch.Tensor] = OrderedDict()

    def put(path: Tuple[str, ...], leaf: str, value: np.ndarray) -> None:
        # np.ascontiguousarray would turn a 0-d array into shape (1,)
        sd[".".join(_split_indices(path) + (leaf,))] = torch.from_numpy(
            np.array(value, order="C", copy=True)
        )

    for path, value in _leaves(variables.get("params", {})):
        value = np.asarray(value)
        *mod, leaf = path
        mod = tuple(mod)
        if leaf == "kernel":
            if value.ndim == 4:
                put(mod, "weight", value.transpose(3, 2, 0, 1))  # HWIO -> OIHW
            elif value.ndim == 2:
                put(mod, "weight", value.transpose(1, 0))
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        elif leaf == "scale":
            put(mod, "weight", value)
        elif leaf == "bias":
            put(mod, "bias", value)
        else:
            raise ValueError(f"Unrecognized flax parameter leaf: {'/'.join(path)}")
    for path, value in _leaves(variables.get("batch_stats", {})):
        value = np.asarray(value)
        *mod, leaf = path
        mod = tuple(mod)
        if leaf == "mean":
            put(mod, "running_mean", value)
            put(mod, "num_batches_tracked", np.zeros((), np.int64))
        elif leaf == "var":
            put(mod, "running_var", value)
        else:
            raise ValueError(f"Unrecognized flax batch_stats leaf: {'/'.join(path)}")
    return sd


def load_npz_variables(path: str) -> Dict[str, Any]:
    """A flat ``.npz`` of flax variables (``save_npz``'s format) as a nested dict."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """``cfg.MODEL.WEIGHT`` -> state dict: a ``.pth`` checkpoint or a ``.npz``.

    A reference checkpoint stores the model under ``"model"`` (ref
    semantic_segmentation.py:31-32); a bare state dict loads as it is.
    """
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(ckpt, Mapping) and "model" in ckpt:
            ckpt = ckpt["model"]
        return dict(ckpt)
    return flax_to_state_dict(load_npz_variables(path))
