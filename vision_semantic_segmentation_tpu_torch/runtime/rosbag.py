"""Pure-python ROS bag (format v2.0) reader + minimal writer.

The port's own copy of ``vision_semantic_segmentation_tpu/runtime/
rosbag.py``, so that the port imports nothing of the JAX package.  Bags
written by either copy read identically in the other.  PointCloud2 payloads
unpack through numpy views (the JAX package may route them through its
native decoder; the values are the same).

The reference consumes recorded drives through roslaunch + rosbag play
(ref scripts/launch/camera1_mapping.launch:6-15,
README.md:190-196).  No ROS is available here, so this module parses the
bag container directly:

    #ROSBAG V2.0 header line, then length-prefixed records
    (op=0x03 bag header, 0x05 chunk, 0x07 connection, 0x02 message data,
    0x04 index, 0x06 chunk info)

and deserializes the message types the pipeline consumes:
sensor_msgs/{Image,CompressedImage,PointCloud2}, geometry_msgs/PoseStamped,
tf2_msgs/TFMessage (and the legacy tf/tfMessage).

The reader streams chunks sequentially (bz2 or uncompressed) and does not
require index records, so partial/unindexed bags also load.  The writer
emits a spec-conformant single-chunk bag for tests and for exporting
sequences back into the ROS ecosystem.
"""
from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["RosbagReader", "write_bag", "BagMessage"]

_U32 = struct.Struct("<I")

# record op codes (rosbag format 2.0 spec)
OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# Low-level record parsing
# ---------------------------------------------------------------------------

def _parse_header(blob: bytes) -> Dict[bytes, bytes]:
    """A record header is a sequence of u32-length 'name=value' fields."""
    fields = {}
    off = 0
    while off < len(blob):
        (n,) = _U32.unpack_from(blob, off)
        off += 4
        field = blob[off : off + n]
        off += n
        eq = field.index(b"=")
        fields[field[:eq]] = field[eq + 1 :]
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for k, v in fields.items():
        field = k + b"=" + v
        out += _U32.pack(len(field)) + field
    return out


def _read_record(buf: bytes, off: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = _U32.unpack_from(buf, off)
    off += 4
    header = _parse_header(buf[off : off + hlen])
    off += hlen
    (dlen,) = _U32.unpack_from(buf, off)
    off += 4
    data = buf[off : off + dlen]
    return header, data, off + dlen


# ---------------------------------------------------------------------------
# Message deserialization (little-endian ROS serialization)
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = _U32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode("utf-8", "replace")

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b


@dataclasses.dataclass
class Header:
    seq: int
    stamp: float
    frame_id: str


@dataclasses.dataclass
class ImageMsg:
    header: Header
    height: int
    width: int
    encoding: str
    data: np.ndarray  # (H, W, 3) RGB or (H, W) mono

    def rgb(self) -> np.ndarray:
        return self.data


@dataclasses.dataclass
class CompressedImageMsg:
    header: Header
    format: str
    data: bytes

    def rgb(self) -> np.ndarray:
        import cv2

        bgr = cv2.imdecode(np.frombuffer(self.data, np.uint8), cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"cannot decode compressed image ({self.format})")
        return bgr[:, :, ::-1]


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


@dataclasses.dataclass
class PointCloud2Msg:
    header: Header
    height: int
    width: int
    fields: List[PointField]
    point_step: int
    data: bytes

    def xyzi(self) -> np.ndarray:
        """(4, N) float32 x, y, z, intensity (0 when absent).

        Equivalent of the reference's per-point ``pc2.read_points`` loop
        (ref mapping.py:172-183).  With all four fields present as float32
        the C++ decoder (``runtime/native_io.py``) reads them in one pass,
        as in the JAX package; otherwise one strided numpy view per field.
        NaN returns survive here and are rejected by the projection masks.
        """
        n = self.height * self.width
        if len(self.data) < n * self.point_step:
            raise ValueError(
                f"PointCloud2 payload truncated: {len(self.data)} bytes for "
                f"{n} points of {self.point_step}"
            )
        by_name = {f.name: f for f in self.fields}
        needed = [by_name.get(name) for name in ("x", "y", "z", "intensity")]
        for f in needed:
            if f is not None and f.offset + 4 > self.point_step:
                raise ValueError(
                    f"PointCloud2 field {f.name!r} offset {f.offset} exceeds "
                    f"point_step {self.point_step}"
                )
        if all(f is not None and f.datatype == 7 for f in needed):
            from .native_io import decode_pointcloud2

            return decode_pointcloud2(self.data, n, self.point_step,
                                      offsets=[f.offset for f in needed],
                                      datatypes=[7] * 4, skip_nans=False)
        raw = np.frombuffer(self.data, np.uint8)[: n * self.point_step]
        raw = raw.reshape(n, self.point_step)
        cols = []
        for f in needed:
            if f is None:
                cols.append(np.zeros(n, np.float32))
                continue
            if f.datatype != 7:  # FLOAT32
                raise ValueError(f"unsupported PointCloud2 dtype {f.datatype}")
            cols.append(
                raw[:, f.offset : f.offset + 4].copy().view(np.float32).ravel()
            )
        return np.stack(cols)


@dataclasses.dataclass
class PoseStampedMsg:
    header: Header
    position: np.ndarray    # (3,)
    quaternion: np.ndarray  # (4,) x y z w


@dataclasses.dataclass
class TransformStampedMsg:
    header: Header
    child_frame_id: str
    translation: np.ndarray  # (3,)
    rotation: np.ndarray     # (4,) x y z w


@dataclasses.dataclass
class TFMessageMsg:
    transforms: List[TransformStampedMsg]


@dataclasses.dataclass
class BagMessage:
    topic: str
    type: str
    stamp: float       # receive time (bag record time)
    message: Any


def _read_ros_header(c: _Cursor) -> Header:
    seq = c.u32()
    secs, nsecs = c.u32(), c.u32()
    frame_id = c.string()
    return Header(seq, secs + nsecs * 1e-9, frame_id)


def _deser_image(data: bytes) -> ImageMsg:
    c = _Cursor(data)
    header = _read_ros_header(c)
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()          # is_bigendian
    step = c.u32()
    n = c.u32()
    raw = np.frombuffer(c.raw(n), np.uint8)
    if encoding in ("rgb8", "bgr8"):
        img = raw.reshape(height, step // 1)[:, : width * 3].reshape(height, width, 3)
        if encoding == "bgr8":
            img = img[:, :, ::-1]
    elif encoding == "mono8":
        img = raw.reshape(height, step)[:, :width]
    else:
        raise ValueError(f"unsupported image encoding {encoding!r}")
    return ImageMsg(header, height, width, encoding, np.ascontiguousarray(img))


def _deser_compressed_image(data: bytes) -> CompressedImageMsg:
    c = _Cursor(data)
    header = _read_ros_header(c)
    fmt = c.string()
    n = c.u32()
    return CompressedImageMsg(header, fmt, c.raw(n))


def _deser_pointcloud2(data: bytes) -> PointCloud2Msg:
    c = _Cursor(data)
    header = _read_ros_header(c)
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        fields.append(PointField(name, c.u32(), c.u8(), c.u32()))
    c.u8()                    # is_bigendian
    point_step = c.u32()
    c.u32()                   # row_step
    n = c.u32()
    raw = c.raw(n)
    c.u8()                    # is_dense
    return PointCloud2Msg(header, height, width, fields, point_step, raw)


def _deser_pose_stamped(data: bytes) -> PoseStampedMsg:
    c = _Cursor(data)
    header = _read_ros_header(c)
    position = np.array([c.f64(), c.f64(), c.f64()])
    quaternion = np.array([c.f64(), c.f64(), c.f64(), c.f64()])
    return PoseStampedMsg(header, position, quaternion)


def _deser_tf(data: bytes) -> TFMessageMsg:
    c = _Cursor(data)
    n = c.u32()
    transforms = []
    for _ in range(n):
        header = _read_ros_header(c)
        child = c.string()
        translation = np.array([c.f64(), c.f64(), c.f64()])
        rotation = np.array([c.f64(), c.f64(), c.f64(), c.f64()])
        transforms.append(TransformStampedMsg(header, child, translation, rotation))
    return TFMessageMsg(transforms)


_DESERIALIZERS = {
    "sensor_msgs/Image": _deser_image,
    "sensor_msgs/CompressedImage": _deser_compressed_image,
    "sensor_msgs/PointCloud2": _deser_pointcloud2,
    "geometry_msgs/PoseStamped": _deser_pose_stamped,
    "tf2_msgs/TFMessage": _deser_tf,
    "tf/tfMessage": _deser_tf,
}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

class RosbagReader:
    """Sequential rosbag v2.0 reader (no ROS, no index required)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"{path}: not a ROS bag v2.0 file ({magic!r})")
        self._start = len(magic)

    def read_messages(
        self, topics: Optional[Sequence[str]] = None, raw: bool = False
    ) -> Iterator[BagMessage]:
        """Yield messages in file order (== chunk/time order as recorded).

        Args:
            topics: optional topic filter.
            raw: yield undeserialized payload bytes for unknown types
                instead of skipping them.
        """
        want = set(topics) if topics else None
        connections: Dict[int, Dict[bytes, bytes]] = {}

        with open(self.path, "rb") as f:
            f.seek(self._start)
            yield from self._scan(f, connections, want, raw)

    def _scan(self, f, connections, want, raw) -> Iterator[BagMessage]:
        """Stream top-level records from the file handle — one record (and
        one decompressed chunk) in memory at a time, so multi-GB bags read
        in bounded memory."""
        while True:
            hlen_b = f.read(4)
            if len(hlen_b) < 4:
                return
            (hlen,) = _U32.unpack(hlen_b)
            header = _parse_header(f.read(hlen))
            (dlen,) = _U32.unpack(f.read(4))
            op = header.get(b"op", b"\x00")[0]
            if op not in (OP_CONNECTION, OP_CHUNK, OP_MESSAGE_DATA):
                f.seek(dlen, 1)  # skip index/chunk-info/bag-header payloads
                continue
            data = f.read(dlen)
            if op == OP_CONNECTION:
                conn = int.from_bytes(header[b"conn"], "little")
                fields = _parse_header(data)
                fields[b"topic"] = header.get(b"topic", fields.get(b"topic", b""))
                connections[conn] = fields
            elif op == OP_CHUNK:
                compression = header.get(b"compression", b"none").decode()
                if compression == "bz2":
                    chunk = bz2.decompress(data)
                elif compression == "none":
                    chunk = data
                else:
                    raise ValueError(
                        f"unsupported chunk compression {compression!r} "
                        "(none/bz2 supported)"
                    )
                coff = 0
                while coff < len(chunk):
                    chdr, cdata, coff = _read_record(chunk, coff)
                    cop = chdr.get(b"op", b"\x00")[0]
                    if cop == OP_CONNECTION:
                        conn = int.from_bytes(chdr[b"conn"], "little")
                        fields = _parse_header(cdata)
                        fields[b"topic"] = chdr.get(
                            b"topic", fields.get(b"topic", b"")
                        )
                        connections[conn] = fields
                    elif cop == OP_MESSAGE_DATA:
                        msg = self._emit(chdr, cdata, connections, want, raw)
                        if msg is not None:
                            yield msg
            elif op == OP_MESSAGE_DATA:  # unchunked (rare but legal)
                msg = self._emit(header, data, connections, want, raw)
                if msg is not None:
                    yield msg

    @staticmethod
    def _emit(header, data, connections, want, raw) -> Optional[BagMessage]:
        conn = int.from_bytes(header[b"conn"], "little")
        t_raw = int.from_bytes(header[b"time"], "little")
        stamp = (t_raw & 0xFFFFFFFF) + (t_raw >> 32) * 1e-9
        info = connections.get(conn, {})
        topic = info.get(b"topic", b"").decode()
        mtype = info.get(b"type", b"").decode()
        if want is not None and topic not in want:
            return None
        deser = _DESERIALIZERS.get(mtype)
        if deser is None:
            if not raw:
                return None
            return BagMessage(topic, mtype, stamp, data)
        return BagMessage(topic, mtype, stamp, deser(data))


# ---------------------------------------------------------------------------
# Writer (tests / export)
# ---------------------------------------------------------------------------

def _ser_ros_header(h: Header) -> bytes:
    secs = int(h.stamp)
    nsecs = int(round((h.stamp - secs) * 1e9))
    fid = h.frame_id.encode()
    return (
        _U32.pack(h.seq)
        + _U32.pack(secs)
        + _U32.pack(nsecs)
        + _U32.pack(len(fid))
        + fid
    )


def _ser_string(s: str) -> bytes:
    b = s.encode()
    return _U32.pack(len(b)) + b


def serialize_message(msg: Any) -> Tuple[str, bytes]:
    """Serialize a message dataclass -> (ros type, payload bytes)."""
    if isinstance(msg, ImageMsg):
        img = np.ascontiguousarray(msg.data)
        if img.ndim == 3:
            enc, step = "rgb8", img.shape[1] * 3
        else:
            enc, step = "mono8", img.shape[1]
        payload = (
            _ser_ros_header(msg.header)
            + _U32.pack(img.shape[0])
            + _U32.pack(img.shape[1])
            + _ser_string(enc)
            + b"\x00"
            + _U32.pack(step)
            + _U32.pack(img.nbytes)
            + img.tobytes()
        )
        return "sensor_msgs/Image", payload
    if isinstance(msg, CompressedImageMsg):
        payload = (
            _ser_ros_header(msg.header)
            + _ser_string(msg.format)
            + _U32.pack(len(msg.data))
            + msg.data
        )
        return "sensor_msgs/CompressedImage", payload
    if isinstance(msg, PointCloud2Msg):
        body = _ser_ros_header(msg.header)
        body += _U32.pack(msg.height) + _U32.pack(msg.width)
        body += _U32.pack(len(msg.fields))
        for f in msg.fields:
            body += (
                _ser_string(f.name)
                + _U32.pack(f.offset)
                + bytes([f.datatype])
                + _U32.pack(f.count)
            )
        body += b"\x00" + _U32.pack(msg.point_step)
        body += _U32.pack(msg.point_step * msg.width)
        body += _U32.pack(len(msg.data)) + msg.data + b"\x01"
        return "sensor_msgs/PointCloud2", body
    if isinstance(msg, PoseStampedMsg):
        body = _ser_ros_header(msg.header)
        body += struct.pack("<3d", *np.asarray(msg.position, np.float64))
        body += struct.pack("<4d", *np.asarray(msg.quaternion, np.float64))
        return "geometry_msgs/PoseStamped", body
    if isinstance(msg, TFMessageMsg):
        body = _U32.pack(len(msg.transforms))
        for tr in msg.transforms:
            body += _ser_ros_header(tr.header)
            body += _ser_string(tr.child_frame_id)
            body += struct.pack("<3d", *np.asarray(tr.translation, np.float64))
            body += struct.pack("<4d", *np.asarray(tr.rotation, np.float64))
        return "tf2_msgs/TFMessage", body
    raise TypeError(f"cannot serialize {type(msg)}")


def write_bag(path: str, messages: Sequence[Tuple[str, Any, float]]) -> None:
    """Write (topic, message, stamp) triples as a single-chunk v2.0 bag."""

    def record(header: Dict[bytes, bytes], data: bytes) -> bytes:
        h = _encode_header(header)
        return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data

    def time_bytes(stamp: float) -> bytes:
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        return struct.pack("<II", secs, nsecs)

    conn_ids: Dict[str, int] = {}
    chunk = b""
    for topic, msg, stamp in messages:
        mtype, payload = serialize_message(msg)
        if topic not in conn_ids:
            conn = len(conn_ids)
            conn_ids[topic] = conn
            conn_fields = _encode_header(
                {
                    b"topic": topic.encode(),
                    b"type": mtype.encode(),
                    b"md5sum": b"*",
                    b"message_definition": b"",
                }
            )
            chunk += record(
                {
                    b"op": bytes([OP_CONNECTION]),
                    b"conn": _U32.pack(conn),
                    b"topic": topic.encode(),
                },
                conn_fields,
            )
        chunk += record(
            {
                b"op": bytes([OP_MESSAGE_DATA]),
                b"conn": _U32.pack(conn_ids[topic]),
                b"time": time_bytes(stamp),
            },
            payload,
        )

    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        # bag header record, padded with spaces to 4096 bytes of data (spec)
        bag_header = {
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", 0),
            b"conn_count": _U32.pack(len(conn_ids)),
            b"chunk_count": _U32.pack(1),
        }
        h = _encode_header(bag_header)
        pad = 4096 - len(h)
        f.write(_U32.pack(len(h)) + h + _U32.pack(pad) + b" " * pad)
        f.write(
            record(
                {
                    b"op": bytes([OP_CHUNK]),
                    b"compression": b"none",
                    b"size": _U32.pack(len(chunk)),
                },
                chunk,
            )
        )
