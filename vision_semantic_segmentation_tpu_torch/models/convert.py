"""Weights between the port's torch ``state_dict`` and the JAX package's
flax variables, and the weight files.

Port of ``vision_semantic_segmentation_tpu/models/convert.py`` in both
directions.  The port's modules use the reference torch names, so a
reference ``.pth`` loads with ``load_state_dict(strict=True)``.
:func:`load_weights` reads a ``.pth`` checkpoint or the JAX package's flat
``.npz`` archive of flax variables (keys ``params/backbone/conv1/kernel``,
...); :func:`convert_pth_to_npz` writes that archive from a reference
``.pth``, a bare state dict or a training directory of the port's
``train/checkpoint.py`` (its ``last_checkpoint`` pointer followed), the
same keys, dtypes and bytes as the JAX package's ``convert`` writes.
Leaves may be numpy or any array type ``np.asarray`` accepts.

Mapping rules (torch -> flax, ``torch_state_dict_to_flax``; the JAX
package's rules, copied):
  * drop the DataParallel ``module.`` prefix
  * ``layer1.0.conv1.weight``    -> params/layer1_0/conv1/kernel (OIHW->HWIO)
  * ``...bn.weight / bias``      -> params/.../bn/scale, bias
  * ``...bn.running_mean / var`` -> batch_stats/.../bn/mean, var
  * ``num_batches_tracked``      -> dropped
  * integer path components are fused into their parent with '_'

Mapping rules (flax -> torch, ``flax_to_state_dict``):
  * params/.../kernel (4-D, HWIO) -> ....weight (OIHW); grouped
    ``(kh, kw, in/g, out)`` and depthwise ``(3, 3, 1, C)`` included
  * params/.../kernel (2-D)       -> ....weight (transposed)
  * params/.../scale / bias       -> ....weight / bias (BatchNorm)
  * batch_stats/.../mean / var    -> ....running_mean / running_var, plus
    ``num_batches_tracked`` = 0 (torch keeps it; flax has none)
  * a trailing ``_<int>`` on a path component is a torch ModuleList /
    Sequential index: ``layer1_0`` -> ``layer1.0``,
    ``module_pyramid_2`` -> ``module_pyramid.2``
  * Xception65's modules take the reference torch names (the inverse of
    ``tests/test_xception_parity.py::_remap_keys``): ``entry_conv{1,2}`` ->
    ``entry_flow_modules.{0,1}``, ``entry_block{n}`` ->
    ``entry_flow_modules.{n+1}``, ``middle_block{n}`` ->
    ``middle_flow_modules.{n}``, ``exit_block`` -> ``exit_flow_modules.0``,
    ``exit_conv{n}`` -> ``exit_flow_modules.{n+1}``; in a block of k
    separable convs ``residual_{j}`` -> ``residual_group1.{2j}`` for j < k-1
    and the last -> ``residual_group2.1`` in an entry block (after its zero
    pad), ``residual_group2.0`` elsewhere
"""
from __future__ import annotations

import re
from collections import OrderedDict
import os.path as osp
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

_INDEXED = re.compile(r"^(.*?)((?:_\d+)+)$")
_XCEPTION = re.compile(r"^(entry_conv|entry_block|middle_block|exit_block|exit_conv)(\d*)$")
_RESIDUAL = re.compile(r"^residual_(\d+)$")
_XCEPTION_FLOW = {  # flax name -> (torch ModuleList, index offset)
    "entry_conv": ("entry_flow_modules", -1),
    "entry_block": ("entry_flow_modules", 1),
    "middle_block": ("middle_flow_modules", 0),
    "exit_block": ("exit_flow_modules", 0),
    "exit_conv": ("exit_flow_modules", 1),
}


def _xception_block_sizes(paths) -> Dict[Tuple[str, ...], int]:
    """Separable convs per Xception block, keyed by the block's flax path."""
    sizes: Dict[Tuple[str, ...], int] = {}
    for path in paths:
        for i in range(1, len(path)):
            m = _RESIDUAL.match(path[i])
            if m and _XCEPTION.match(path[i - 1]):
                sizes[path[:i]] = max(sizes.get(path[:i], 0), int(m.group(1)) + 1)
    return sizes


def _xception_torch_path(path: Tuple[str, ...], sizes) -> Tuple[str, ...]:
    """A flax module path with Xception65's names as the reference's."""
    out = []
    for i, part in enumerate(path):
        top = _XCEPTION.match(part)
        res = _RESIDUAL.match(part) if i and _XCEPTION.match(path[i - 1]) else None
        if top:
            flow, offset = _XCEPTION_FLOW[top.group(1)]
            out += [flow, str(int(top.group(2) or 0) + offset)]
        elif res:
            j, k = int(res.group(1)), sizes[path[:i]]
            padded = path[i - 1].startswith("entry_block")
            out += (["residual_group1", str(2 * j)] if j < k - 1
                    else ["residual_group2", "1" if padded else "0"])
        else:
            out.append(part)
    return tuple(out)


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
    sizes = _xception_block_sizes(path for path, _ in _leaves(variables.get("params", {})))

    def put(path: Tuple[str, ...], leaf: str, value: np.ndarray) -> None:
        path = _split_indices(_xception_torch_path(path, sizes))
        # np.ascontiguousarray would turn a 0-d array into shape (1,)
        sd[".".join(path + (leaf,))] = torch.from_numpy(
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


def _to_numpy(tensor) -> np.ndarray:
    """A leaf as numpy; a bfloat16 tensor (numpy has no such type) as
    float32, which holds each bf16 value exactly.  The JAX package's
    converter refuses bf16; serving saves the port's bf16 networks so."""
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu()
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.float()
        return tensor.numpy()
    return np.asarray(tensor)


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _fuse_indices(parts: Tuple[str, ...]) -> Tuple[str, ...]:
    """Fuse numeric path components into the preceding name:
    ``('layer1', '0', 'conv1')`` -> ``('layer1_0', 'conv1')``."""
    fused = []
    for p in parts:
        if p.isdigit() and fused:
            fused[-1] = f"{fused[-1]}_{p}"
        else:
            fused.append(p)
    return tuple(fused)


def torch_state_dict_to_flax(state_dict: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A torch state dict as ``{'params': ..., 'batch_stats': ...}`` of numpy leaves."""
    params: Dict[str, Any] = {}
    batch_stats: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        path = _fuse_indices(tuple(parts[:-1]))
        value = _to_numpy(tensor)
        if leaf == "weight":
            if value.ndim == 4:  # conv OIHW -> HWIO (grouped convs keep I = in/groups)
                _set_path(params, path + ("kernel",), value.transpose(2, 3, 1, 0))
            elif value.ndim == 2:
                _set_path(params, path + ("kernel",), value.transpose(1, 0))
            else:
                _set_path(params, path + ("scale",), value)  # BatchNorm gamma
        elif leaf == "bias":
            _set_path(params, path + ("bias",), value)
        elif leaf == "running_mean":
            _set_path(batch_stats, path + ("mean",), value)
        elif leaf == "running_var":
            _set_path(batch_stats, path + ("var",), value)
        else:
            raise ValueError(f"Unrecognized torch parameter leaf: {key}")
    return {"params": params, "batch_stats": batch_stats}


def _read_state_dict(path: str, model_key: str = "model") -> Mapping[str, Any]:
    """The model's state dict of a ``.pth``: ``ckpt[model_key]`` of a
    reference or port training checkpoint (ref semantic_segmentation.py:31-32,
    checkpoint.py:36-64), or the file itself when it is a bare state dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, Mapping) and model_key in ckpt:
        return ckpt[model_key]
    return ckpt


def load_torch_checkpoint(path: str, model_key: str = "model") -> Dict[str, Any]:
    """A ``.pth`` checkpoint's model weights as flax variables."""
    return torch_state_dict_to_flax(_read_state_dict(path, model_key))


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def save_npz(variables: Mapping[str, Any], path: str) -> None:
    """A flax variable tree as a flat ``.npz`` archive (keys ``params/...``)."""
    np.savez(path, **_flatten(variables))


def load_npz(path: str) -> Dict[str, Any]:
    """The flax variable tree of a flat ``.npz`` written by :func:`save_npz`."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            _set_path(tree, tuple(key.split("/")), data[key])
    return tree


def resolve_last_checkpoint(path: str) -> str:
    """A checkpoint location as a ``.pth`` file.

    A training output directory (the reference's trainer or the port's
    ``train/checkpoint.py``) holds ``<name>.pth`` files and a
    ``last_checkpoint`` pointer naming one (ref core/utils/checkpoint.py:
    102-129); the pointer is followed.  A file path is returned unchanged.
    """
    if osp.isdir(path):
        pointer = osp.join(path, "last_checkpoint")
        if not osp.exists(pointer):
            raise FileNotFoundError(f"{path} is a directory without a last_checkpoint pointer")
        with open(pointer) as f:
            named = f.read().strip()
        if not osp.isabs(named):
            named = osp.join(path, named)
        return named
    return path


def convert_pth_to_npz(pth_path: str, npz_path: Optional[str] = None) -> str:
    """Write a ``.pth`` checkpoint (or a training directory's last one) as
    the JAX package's ``.npz``; returns its path (default: beside the
    ``.pth``, ``.npz`` for ``.pth``)."""
    pth_path = resolve_last_checkpoint(pth_path)
    if npz_path is None:
        npz_path = osp.splitext(pth_path)[0] + ".npz"
    save_npz(load_torch_checkpoint(pth_path), npz_path)
    return npz_path


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """``cfg.MODEL.WEIGHT`` -> state dict: a ``.pth`` checkpoint or a ``.npz``.

    A reference checkpoint stores the model under ``"model"`` (ref
    semantic_segmentation.py:31-32); a bare state dict loads as it is.
    """
    if path.endswith(".pth"):
        return dict(_read_state_dict(path))
    return flax_to_state_dict(load_npz(path))
