"""Offline point-cloud-map -> BEV intensity image.

Port of ``vision_semantic_segmentation_tpu/utils/pcd_bev.py`` (ref
src/utils/generate_pointcloud_bev.py) without python-pcl, host numpy as
there: a small native .pcd reader (ASCII and uncompressed binary) and
a vectorized intensity rasterizer producing a colored BEV jpg.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

_PCD_DTYPES = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 4): "<i4", ("U", 4): "<u4",
               ("I", 1): "<i1", ("U", 1): "<u1", ("I", 2): "<i2", ("U", 2): "<u2"}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Parse a .pcd file into named field arrays (ascii / binary formats)."""
    with open(path, "rb") as f:
        header: Dict[str, list] = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n_points = int(header["POINTS"][0])
        data_format = header["DATA"][0].lower()

        dtype = np.dtype(
            [
                (name, _PCD_DTYPES[(t, s)], (c,)) if c > 1 else (name, _PCD_DTYPES[(t, s)])
                for name, t, s, c in zip(fields, types, sizes, counts)
            ]
        )
        if data_format == "ascii":
            raw = np.loadtxt(f, max_rows=n_points)
            out = {}
            col = 0
            for name, c in zip(fields, counts):
                out[name] = raw[:, col] if c == 1 else raw[:, col : col + c]
                col += c
            return out
        elif data_format == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * n_points), dtype=dtype)
            return {name: np.asarray(raw[name]) for name in fields}
        raise NotImplementedError(f"Unsupported .pcd DATA format {data_format!r}")


def pointcloud_to_bev(
    points_xyz: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    resolution: float = 0.1,
    bounds: Optional[Tuple[Tuple[float, float], Tuple[float, float]]] = None,
) -> np.ndarray:
    """Rasterize points into a colored (H, W, 3) BEV intensity image.

    Max-intensity per cell, viridis-ish colorization; empty cells black.
    """
    xyz = np.asarray(points_xyz, dtype=np.float64)
    if intensity is None:
        intensity = np.ones(xyz.shape[0])
    intensity = np.asarray(intensity, dtype=np.float64)

    if bounds is None:
        bounds = (
            (xyz[:, 0].min(), xyz[:, 0].max()),
            (xyz[:, 1].min(), xyz[:, 1].max()),
        )
    (xmin, xmax), (ymin, ymax) = bounds
    h = max(int((xmax - xmin) / resolution), 1)
    w = max(int((ymax - ymin) / resolution), 1)

    ix = ((xyz[:, 0] - xmin) / resolution).astype(np.int64)
    iy = ((xyz[:, 1] - ymin) / resolution).astype(np.int64)
    ok = (ix >= 0) & (ix < h) & (iy >= 0) & (iy < w)

    grid = np.zeros((h, w))
    np.maximum.at(grid, (ix[ok], iy[ok]), intensity[ok])

    vmax = grid.max() or 1.0
    norm = grid / vmax
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = (norm * 255).astype(np.uint8)           # blue ramp
    img[..., 1] = (np.sqrt(norm) * 255).astype(np.uint8)  # green ramp
    img[..., 2] = ((norm > 0) * 64 + norm * 191).astype(np.uint8)
    img[grid == 0] = 0
    return img


def generate_pointcloud_bev(pcd_path: str, out_path: str, resolution: float = 0.1) -> str:
    """File-level entry: .pcd -> colored BEV .jpg (ref generate_pointcloud_bev.py)."""
    import cv2

    data = read_pcd(pcd_path)
    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1)
    img = pointcloud_to_bev(xyz, data.get("intensity"), resolution)
    cv2.imwrite(out_path, img)
    return out_path
