"""Homography estimation and perspective warping.

Port of ``vision_semantic_segmentation_tpu/geometry/homography.py``, which
replaces the reference's OpenCV pair (ref homography.py:22-76,
``cv2.findHomography`` + ``cv2.warpPerspective``): a normalized DLT solver
(host numpy f64, a 9x9 SVD) and an inverse-map gather warp on the image's
device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .transforms import mm, to_int32


def find_homography(pts_src: np.ndarray, pts_dst: np.ndarray) -> np.ndarray:
    """Estimate the 3x3 homography H with dst ~ H @ src via normalized DLT.

    Least squares over all correspondences, the behaviour of
    ``cv2.findHomography(method=0)`` (ref homography.py:39).  Host numpy f64.

    Args:
        pts_src, pts_dst: (N, 2) arrays, N >= 4.
    """
    pts_src = np.asarray(pts_src, dtype=np.float64).reshape(-1, 2)
    pts_dst = np.asarray(pts_dst, dtype=np.float64).reshape(-1, 2)
    n = pts_src.shape[0]
    if n < 4 or pts_dst.shape[0] != n:
        raise ValueError(f"a homography needs N >= 4 correspondences, got {n} and "
                         f"{pts_dst.shape[0]}")

    def normalize(pts):
        mean = pts.mean(axis=0)
        centered = pts - mean
        scale = np.sqrt(2.0) / max(np.mean(np.linalg.norm(centered, axis=1)), 1e-12)
        T = np.array([[scale, 0, -scale * mean[0]], [0, scale, -scale * mean[1]], [0, 0, 1]])
        return (T @ np.vstack([pts.T, np.ones(n)]))[:2].T, T

    src_n, T_src = normalize(pts_src)
    dst_n, T_dst = normalize(pts_dst)

    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = src_n[i]
        u, v = dst_n[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]

    _, _, VT = np.linalg.svd(A)
    Hn = VT[-1].reshape(3, 3)
    H = np.linalg.inv(T_dst) @ Hn @ T_src
    return H / H[2, 2]


def _inv_f32(H) -> np.ndarray:
    """The f32 inverse of ``H`` by LU with partial pivoting (LAPACK
    ``sgetrf`` + ``sgetrs``), bit for bit the JAX package's
    ``jnp.linalg.inv`` on the CPU: a last-bit difference in ``H^-1`` moves a
    nearest-warp pixel that lies on a rounding edge."""
    from scipy.linalg import lu_factor, lu_solve

    H32 = np.asarray(H, dtype=np.float32).reshape(3, 3)
    return lu_solve(lu_factor(H32), np.eye(3, dtype=np.float32)).astype(np.float32)


def warp_perspective(
    image: torch.Tensor,
    H,
    out_size: Tuple[int, int],
    mode: str = "bilinear",
    fill_value: float = 0.0,
) -> torch.Tensor:
    """Warp ``image`` by homography ``H`` into an (out_h, out_w) canvas.

    The equivalent of ``cv2.warpPerspective`` (ref homography.py:52-55): each
    output pixel samples the source at ``H^-1 (x, y, 1)``.  ``H`` is cast to
    f32 and inverted on the host (``_inv_f32``), as the JAX package does;
    the map and the gather run on the image's device, the map as an f32
    product (exact f32 while TF32 is off, which ``device.resolve_device``
    sets).

    Args:
        image: (H, W) or (H, W, C) tensor.
        H: 3x3 homography mapping src pixel -> dst pixel.
        out_size: (width, height) of the output, cv2 argument order.
        mode: 'bilinear' (cv2 default INTER_LINEAR) or 'nearest'.
    """
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"Unknown mode {mode}")
    image = torch.as_tensor(image)
    dev = image.device
    out_w, out_h = out_size
    H_inv = torch.from_numpy(_inv_f32(H)).to(dev)

    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)
    dst = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    src = mm(H_inv, dst)
    sx = src[0] / src[2]
    sy = src[1] / src[2]

    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    h, w, c = image.shape
    flat = image.reshape(-1, c).float()

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
        return torch.where(inside[:, None], flat[idx], fill_value)

    if mode == "nearest":
        # cv2 INTER_NEAREST rounds half down via floor(x + 0.5) on the
        # positive domain; outside pixels get the border constant
        out = tap(to_int32(torch.floor(sx + 0.5)), to_int32(torch.floor(sy + 0.5)))
    else:
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        fx = (sx - x0)[:, None]
        fy = (sy - y0)[:, None]
        x0i, y0i = to_int32(x0), to_int32(y0)
        out = (tap(x0i, y0i) * (1 - fx) * (1 - fy) + tap(x0i + 1, y0i) * fx * (1 - fy)
               + tap(x0i, y0i + 1) * (1 - fx) * fy + tap(x0i + 1, y0i + 1) * fx * fy)

    out = out.reshape(out_h, out_w, c)
    if not image.dtype.is_floating_point:
        out = torch.round(out).to(image.dtype)
    if squeeze:
        out = out[..., 0]
    return out


def generate_homography(
    im_src,
    pts_src: np.ndarray,
    pts_dst: np.ndarray,
    out_size: Optional[Sequence[int]] = None,
    mode: str = "bilinear",
    return_h: bool = False,
):
    """Estimate H from correspondences and warp (ref homography.py:22-76).

    Args:
        out_size: [width, height]; defaults to the source image size.
    """
    H = find_homography(pts_src, pts_dst)
    im_src = torch.as_tensor(im_src)
    if out_size is None:
        out_size = (im_src.shape[1], im_src.shape[0])
    im_dst = warp_perspective(im_src, H, (out_size[0], out_size[1]), mode=mode)
    return (im_dst, H) if return_h else im_dst
