"""Read (and write) the reference's hickle ``.hkl`` recorded-input dumps.

The port's own copy of ``vision_semantic_segmentation_tpu/runtime/
hickle_io.py`` (pure numpy and h5py), so that the port imports nothing of
the JAX package.  Files written by either copy read identically in the
other.

The reference persists every mapping input frame to ``input_list.hkl`` via
``hickle.dump`` (ref mapping.py:323-326) and replays it with ``hickle.load``
(ref mapping_replay.py:146-159).  hickle is an HDF5 serialization convention
on top of h5py: python containers become HDF5 groups, leaves become datasets,
and the python type is recorded in node attributes.  hickle itself is not
installed in this image, but h5py is — so this module implements the hickle
*schema*, tolerantly, over h5py:

* :func:`load_hickle` reads hickle v3 (``CLASS=b'hickle'``/``VERSION``; the
  vintage the reference targets), v4 and v5 (``HICKLE_VERSION``) layouts.
* :func:`dump_hickle` writes a fixed hickle-4-flavoured layout, used for test
  fixtures and as a migration tool for reference users who want to carry
  their recorded bags over.

The reference's frames hold a pickled ``geometry_msgs/Pose`` (hickle's
fallback for types it has no loader for).  genpy message objects pickle as a
bare list of ``__slots__`` values, so they cannot be unpickled generically
without the class definition; :class:`_RosUnpickler` maps the well-known ROS
message classes onto slot-compatible local stubs so reference dumps load
without a ROS installation.
"""
from __future__ import annotations

import ast
import io as _io
import pickle
import re
from typing import Any, Dict, List

import numpy as np

__all__ = ["load_hickle", "dump_hickle"]

_TRAILING_INT = re.compile(r"(\d+)$")


# ---------------------------------------------------------------------------
# ROS message stand-ins (for pickled payloads inside reference dumps)
# ---------------------------------------------------------------------------

class RosMessageStub:
    """Slot-compatible stand-in for a genpy message class.

    genpy ``Message.__getstate__`` returns ``[getattr(self, s) for s in
    __slots__]`` — reconstructing it requires a class with the same slot
    order, which these stubs provide.
    """

    __slots__ = ()

    def __init__(self, *args, **kwargs):
        for name, value in zip(self.__slots__, args):
            setattr(self, name, value)
        for name in self.__slots__[len(args):]:
            setattr(self, name, kwargs.get(name))

    def __getstate__(self):
        return [getattr(self, s, None) for s in self.__slots__]

    def __setstate__(self, state):
        if isinstance(state, dict):
            for k, v in state.items():
                setattr(self, k, v)
        elif (
            isinstance(state, tuple)
            and len(state) == 2
            and isinstance(state[1], dict)
        ):
            # Default __slots__ pickling: (dict_state, slot_dict).
            if isinstance(state[0], dict):
                for k, v in state[0].items():
                    setattr(self, k, v)
            for k, v in state[1].items():
                setattr(self, k, v)
        else:
            for name, value in zip(self.__slots__, state):
                setattr(self, name, value)

    def __repr__(self):
        fields = ", ".join(
            f"{s}={getattr(self, s, None)!r}" for s in self.__slots__
        )
        return f"{type(self).__name__}({fields})"


class Point(RosMessageStub):
    __slots__ = ("x", "y", "z")


class Quaternion(RosMessageStub):
    __slots__ = ("x", "y", "z", "w")


class Pose(RosMessageStub):
    __slots__ = ("position", "orientation")


class Header(RosMessageStub):
    __slots__ = ("seq", "stamp", "frame_id")


class PoseStamped(RosMessageStub):
    __slots__ = ("header", "pose")


class PoseWithCovariance(RosMessageStub):
    __slots__ = ("pose", "covariance")


class Time(RosMessageStub):
    __slots__ = ("secs", "nsecs")


class Duration(RosMessageStub):
    __slots__ = ("secs", "nsecs")


#: (module, qualname) → stub.  Covers both the private generated-module path
#: (geometry_msgs.msg._Pose.Pose) and the re-exported one (geometry_msgs.msg).
_ROS_CLASS_MAP: Dict[tuple, type] = {}
for _mod_leaf, _cls in [
    ("_Point", Point),
    ("_Quaternion", Quaternion),
    ("_Pose", Pose),
    ("_PoseStamped", PoseStamped),
    ("_PoseWithCovariance", PoseWithCovariance),
]:
    _name = _cls.__name__
    _ROS_CLASS_MAP[(f"geometry_msgs.msg.{_mod_leaf}", _name)] = _cls
    _ROS_CLASS_MAP[("geometry_msgs.msg", _name)] = _cls
_ROS_CLASS_MAP[("std_msgs.msg._Header", "Header")] = Header
_ROS_CLASS_MAP[("std_msgs.msg", "Header")] = Header
for _name, _cls in [("Time", Time), ("Duration", Duration)]:
    _ROS_CLASS_MAP[("genpy.rostime", _name)] = _cls
    _ROS_CLASS_MAP[("genpy", _name)] = _cls
    _ROS_CLASS_MAP[("rospy.rostime", _name)] = _cls
    _ROS_CLASS_MAP[("rospy", _name)] = _cls


def _make_generic_stub(module: str, name: str) -> type:
    """A last-resort stub for unknown classes in pickled payloads.

    Attribute names are preserved only for dict-style states; genpy's bare
    list state is kept as ``_state`` (better than failing the whole load).
    """

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (
            isinstance(state, tuple)
            and len(state) == 2
            and isinstance(state[1], dict)
        ):
            if isinstance(state[0], dict):
                self.__dict__.update(state[0])
            self.__dict__.update(state[1])
        else:
            self._state = state

    return type(name, (), {
        "__module__": module,
        "__setstate__": __setstate__,
        "_hickle_stub_for": f"{module}.{name}",
    })


# Modules whose classes may be resolved for real during unpickling.  A
# reference hickle dump only ever embeds numpy payloads and ROS message
# objects (stubbed above); resolving arbitrary globals would let a
# malicious .hkl execute code on load, so anything else gets an inert
# attribute-bag stub instead.
_SAFE_MODULE_ROOTS = ("numpy", "collections")
_SAFE_EXACT = {
    ("copyreg", "_reconstructor"),  # legacy new-style class reconstruction
    ("builtins", "set"),
    ("builtins", "frozenset"),
    ("builtins", "bytearray"),
    ("builtins", "complex"),
}


class _RosUnpickler(pickle.Unpickler):
    """Unpickler that substitutes local stubs for non-allowlisted classes.

    ROS message types map to slot-compatible local stubs; numpy (and a few
    harmless builtins) resolve for real; every other global — including
    importable ones — becomes an inert generic stub, so loading an
    untrusted file cannot reach arbitrary callables.
    """

    def find_class(self, module, name):
        stub = _ROS_CLASS_MAP.get((module, name))
        if stub is not None:
            return stub
        if module.split(".", 1)[0] in _SAFE_MODULE_ROOTS or (module, name) in _SAFE_EXACT:
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                pass
        return _make_generic_stub(module, name)


def _loads(data: bytes) -> Any:
    return _RosUnpickler(_io.BytesIO(data)).load()


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _attr_token(attrs, *names) -> str:
    """Normalize a hickle type attribute to a lowercase token.

    Handles the representations used across hickle versions: plain bytes
    (b'list'), length-1 byte arrays ([b'list']), str, and the v2-era
    ``"<type 'list'>"`` / ``"<class 'list'>"`` reprs.
    """
    for name in names:
        if name not in attrs:
            continue
        raw = attrs[name]
        if isinstance(raw, (list, tuple, np.ndarray)) and len(raw) >= 1:
            raw = raw[0]
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8", "replace")
        raw = str(raw)
        m = re.search(r"'([^']+)'", raw)
        if m:
            raw = m.group(1)
        return raw.rsplit(".", 1)[-1].lower()
    return ""


def _decode_key(name: str, attrs) -> Any:
    """Recover a dict key from a child node name."""
    name = name.replace("\\x2f", "/")  # writer-escaped '/' (see _write_node)
    token = _attr_token(attrs, "key_base_type", "key_type")
    if token in ("str", "unicode", "bytes") or token.startswith("string"):
        if len(name) >= 2 and name[0] == name[-1] and name[0] in "'\"":
            return name[1:-1]
        return name
    if token == "int":
        return int(name.strip("'\""))
    if token == "float":
        return float(name.strip("'\""))
    if token == "bool":
        return name.strip("'\"") == "True"
    if token in ("tuple", "nonetype"):
        try:
            return ast.literal_eval(name)
        except (ValueError, SyntaxError):
            return name
    # No key-type attr (hickle 3.x stores plain str(key) names) or unknown:
    # try a literal parse, fall back to the raw name.
    try:
        return ast.literal_eval(name)
    except (ValueError, SyntaxError):
        return name


def _sorted_items(group) -> List[tuple]:
    """Children of a list-like group in element order (data_0, data1, '0'…)."""

    def order(name: str):
        m = _TRAILING_INT.search(name)
        return (0, int(m.group(1))) if m else (1, name)

    return [(n, group[n]) for n in sorted(group.keys(), key=order)]


def _read_dataset(node) -> Any:
    token = _attr_token(node.attrs, "base_type", "type")
    value = node[()]

    if token == "pickle" or (token == "" and isinstance(value, np.void)):
        if isinstance(value, np.void):
            data = value.tobytes()
        elif isinstance(value, np.ndarray):
            data = value.tobytes()
        else:
            data = bytes(value)
        return _loads(data)

    if token in ("str", "unicode"):
        if isinstance(value, bytes):
            return value.decode("utf-8")
        if isinstance(value, np.ndarray) and value.dtype.kind in ("S", "O"):
            item = value.item() if value.shape == () else value[0]
            return item.decode("utf-8") if isinstance(item, bytes) else str(item)
        return str(value)
    if token == "bytes":
        return bytes(value) if not isinstance(value, bytes) else value
    if token == "int":
        return int(np.asarray(value).item())
    if token == "float":
        return float(np.asarray(value).item())
    if token == "bool":
        return bool(np.asarray(value).item())
    if token == "complex":
        return complex(np.asarray(value).item())
    if token == "nonetype":
        return None
    if token in ("list", "tuple", "set"):
        # Homogeneous primitive sequences are stored as one dataset.
        seq = np.asarray(value).tolist()
        if token == "tuple":
            return tuple(seq)
        if token == "set":
            return set(seq)
        return seq

    # ndarray (and np_dtype / np scalar variants) or untyped payloads.
    if isinstance(value, bytes):
        return value
    arr = np.asarray(value)
    if token in ("np_dtype", "np_scalar") and arr.shape == ():
        return arr[()]
    return arr


def _read_node(node) -> Any:
    import h5py

    if isinstance(node, h5py.Dataset):
        return _read_dataset(node)

    token = _attr_token(node.attrs, "base_type", "type")
    if token == "dict":
        out = {}
        for name, child in node.items():
            out[_decode_key(name, child.attrs)] = _read_node(child)
        return out
    if token in ("list", "tuple", "set"):
        seq = [_read_node(child) for _, child in _sorted_items(node)]
        if token == "tuple":
            return tuple(seq)
        if token == "set":
            return set(seq)
        return seq

    # Untyped group: list-like if every child name carries an index,
    # dict-like otherwise.
    names = list(node.keys())
    if names and all(_TRAILING_INT.search(n) for n in names):
        return [_read_node(child) for _, child in _sorted_items(node)]
    return {
        _decode_key(name, child.attrs): _read_node(child)
        for name, child in node.items()
    }


def load_hickle(path: str) -> Any:
    """Load a hickle ``.hkl`` file (schema v3/v4/v5) without hickle.

    Ref contract: ``hickle.load`` of the recorded ``input_list``
    (mapping_replay.py:146-159).
    """
    import h5py

    with h5py.File(path, "r") as f:
        # The payload root: hickle 4/5 use 'data', 3.x uses 'data_0'.
        for candidate in ("data", "data_0"):
            if candidate in f:
                return _read_node(f[candidate])
        children = list(f.keys())
        if len(children) == 1:
            return _read_node(f[children[0]])
        raise ValueError(
            f"{path}: not a recognizable hickle file (root children: "
            f"{children})"
        )


# ---------------------------------------------------------------------------
# Writing (fixture / migration writer, hickle-4-flavoured layout)
# ---------------------------------------------------------------------------

def _write_node(parent, name: str, obj: Any) -> None:
    if isinstance(obj, np.ndarray):
        ds = parent.create_dataset(name, data=obj)
        ds.attrs["base_type"] = b"ndarray"
        ds.attrs["type"] = np.void(pickle.dumps(np.ndarray))
    elif isinstance(obj, str):
        ds = parent.create_dataset(name, data=np.bytes_(obj.encode("utf-8")))
        ds.attrs["base_type"] = b"str"
    elif isinstance(obj, bytes):
        ds = parent.create_dataset(name, data=np.void(obj))
        ds.attrs["base_type"] = b"bytes"
    elif isinstance(obj, bool):
        ds = parent.create_dataset(name, data=obj)
        ds.attrs["base_type"] = b"bool"
    elif isinstance(obj, int):
        ds = parent.create_dataset(name, data=obj)
        ds.attrs["base_type"] = b"int"
    elif isinstance(obj, float):
        ds = parent.create_dataset(name, data=obj)
        ds.attrs["base_type"] = b"float"
    elif obj is None:
        ds = parent.create_dataset(name, data=np.bytes_(b"None"))
        ds.attrs["base_type"] = b"NoneType"
    elif isinstance(obj, dict):
        grp = parent.create_group(name)
        grp.attrs["base_type"] = b"dict"
        for key, value in obj.items():
            if not isinstance(key, (str, int, float, bool, tuple)):
                raise TypeError(f"unsupported dict key type: {type(key)}")
            child = repr(key) if not isinstance(key, str) else f"'{key}'"
            # '/' would create nested HDF5 groups and corrupt the key
            # (e.g. ROS-topic-named keys); escape it reversibly
            child = child.replace("/", "\\x2f")
            _write_node(grp, child, value)
            kt = type(key).__name__.encode()
            grp[child].attrs["key_base_type"] = kt
    elif isinstance(obj, (list, tuple)):
        grp = parent.create_group(name)
        grp.attrs["base_type"] = b"tuple" if isinstance(obj, tuple) else b"list"
        for i, item in enumerate(obj):
            _write_node(grp, f"data_{i}", item)
    else:
        ds = parent.create_dataset(name, data=np.void(pickle.dumps(obj)))
        ds.attrs["base_type"] = b"pickle"


def dump_hickle(obj: Any, path: str) -> None:
    """Write ``obj`` as a hickle-4-layout ``.hkl`` readable by hickle≥4."""
    import h5py

    with h5py.File(path, "w") as f:
        f.attrs["CLASS"] = b"hickle"
        f.attrs["HICKLE_VERSION"] = "4.0.0"
        f.attrs["VERSION"] = 4
        _write_node(f, "data", obj)
