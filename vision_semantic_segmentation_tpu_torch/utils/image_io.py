"""Image files without OpenCV: one reader, and a PNG writer.

The machine with the card may have neither Pillow nor OpenCV, so the port
reads images through :func:`read_image`: Pillow when it is importable
(``np.asarray(PIL.Image.open(path))``, whatever the format), otherwise its
own PNG decoder (zlib, 8-bit greyscale, grey + alpha, RGB and RGBA, palette
images of 1, 2, 4 or 8 bits, every row filter, no interlacing).  Like ``PIL.Image.open`` it
decides by the file's magic bytes, not its name: a ``.jpg`` path holding
PNG data reads as PNG.  JPEG data with no Pillow raises.  A palette image
reads as its indices, as Pillow gives them.

:func:`encode_png` writes 8-bit greyscale, RGB or RGBA arrays with no row
filter (the layout ``runtime/replay.py::write_png`` has always written).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


def read_image(path: str) -> np.ndarray:
    """An image file as a uint8 array: (H, W) or (H, W, channels)."""
    try:
        import PIL.Image
    except ImportError:
        pass
    else:
        with PIL.Image.open(path) as image:
            return np.asarray(image)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_MAGIC):
        return decode_png(data)
    if data.startswith(JPEG_MAGIC):
        raise RuntimeError(f"{path}: JPEG data, and no JPEG decoder (Pillow) is installed")
    raise ValueError(f"{path}: not a PNG or JPEG file")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) or (H, W, channels) uint8."""
    if not data.startswith(PNG_MAGIC):
        raise ValueError("not PNG data")
    off, idat, header = 8, [], None
    while off < len(data):
        n, kind = struct.unpack(">I4s", data[off : off + 8])
        body = data[off + 8 : off + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        off += 12 + n
    if header is None:
        raise ValueError("PNG data without IHDR")
    w, h, depth, color, _, _, interlace = header
    packed = color == 3 and depth in (1, 2, 4)  # palette indices packed in bytes
    if not (depth == 8 or packed) or color not in _CHANNELS or interlace:
        raise ValueError(f"PNG bit depth {depth}, colour type {color}, interlace {interlace}: "
                         "only 8-bit (or packed palette) non-interlaced images are decoded")
    bpp = _CHANNELS[color]
    stride = -(-w * depth // 8) if packed else w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        kind, line = raw[r, 0], raw[r, 1:]
        if kind == 0:
            row = line
        elif kind == 1:  # Sub: a running sum along the row, per channel
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: a recurrence along the row
            row = np.frombuffer(_unfilter_recurrent(kind, line.tobytes(), prev.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[r] = row
        prev = out[r]
    if packed:
        bits = np.unpackbits(out, axis=1)[:, : w * depth].reshape(h, w, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (bits * weights).sum(-1, dtype=np.uint8)
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


def _unfilter_recurrent(kind: int, line: bytes, prev: bytes, bpp: int) -> bytearray:
    row = bytearray(line)
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    return row


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """(H, W) greyscale, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes."""
    img = np.ascontiguousarray(np.asarray(image, dtype=np.uint8))
    color = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if color is None:
        raise ValueError(f"cannot write an array of shape {img.shape} as PNG")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)  # filter byte 0 leads each row
    rows[:, 1:] = img.reshape(h, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write :func:`encode_png`'s bytes to ``path`` (whatever its extension)."""
    with open(path, "wb") as f:
        f.write(encode_png(image, level))
