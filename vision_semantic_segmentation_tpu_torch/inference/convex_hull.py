"""Convex-hull extraction from a class mask, without OpenCV.

Port of ``vision_semantic_segmentation_tpu/inference/convex_hull.py`` (ref
semantic_convex_hull.py:17-91): binarize the target class, 3x3 erode, label
8-connected components (scipy.ndimage), keep the ``top_number`` largest
above ``area_threshold``, and return each one's closed convex-hull vertex
loop.  Host numpy; the node publishes the loops as ground-plane markers.

The JAX package calls ``cv2.erode`` and ``cv2.convexHull``.  Here the
erosion is ``ndimage.binary_erosion`` with a border of ones (cv2's default
border leaves edge pixels as they are), and :func:`cv_convex_hull` is
OpenCV's own algorithm (imgproc/src/convhull.cpp: Sklansky's scan over the
points sorted by x then y, and its final cyclic shift), so the loops have
cv2's vertices, order and start vertex.
"""
from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np


def _sign(v: int) -> int:
    return (v > 0) - (v < 0)


def _sklansky(p: List[List[int]], start: int, end: int, nsign: int, sign2: int) -> List[int]:
    """One monotone chain of OpenCV's ``Sklansky_`` over the sorted points
    ``p`` from ``start`` to ``end`` inclusive; returns the chain's indices."""
    if start == end or p[start] == p[end]:
        return [start]
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    stack = [pprev, pcur, pnext]
    end += incr  # one past the end
    while pnext != end:
        # check the angle pprev, pcur, pnext
        by = p[pnext][1] - p[pcur][1]
        if _sign(by) != nsign:
            ax = p[pcur][0] - p[pprev][0]
            bx = p[pnext][0] - p[pcur][0]
            ay = p[pcur][1] - p[pprev][1]
            convexity = ay * bx - ax * by  # > 0: a convex angle
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack.append(pnext)
            elif pprev == start:
                pcur = pnext
                pnext += incr
                stack[1:3] = [pcur, pnext]
            else:
                stack[-2] = pnext
                pcur = pprev
                pprev = stack[-4]
                stack.pop()
        else:
            pnext += incr
            stack[-1] = pnext
    return stack[:-1]


def cv_convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points)`` for integer (N, 2) points (x, y), with
    its defaults (counter-clockwise in cv2's sense, points returned): the
    (K, 2) hull vertices in cv2's order, from cv2's start vertex."""
    data = np.asarray(points, dtype=np.int64).reshape(-1, 2)
    total = len(data)
    if total == 0:
        return data
    order = np.lexsort((data[:, 1], data[:, 0]))  # by x, then y
    sorted_pts = data[order]
    miny_ind = int(np.argmin(sorted_pts[:, 1]))  # the first of equals in sorted order
    maxy_ind = int(np.argmax(sorted_pts[:, 1]))
    p = sorted_pts.tolist()
    if p[0] == p[-1]:
        hull = [int(order[0])]
    else:
        # upper half; counter-clockwise takes the right chain first
        tl = _sklansky(p, 0, maxy_ind, -1, 1)
        tr = _sklansky(p, total - 1, maxy_ind, -1, -1)
        tl, tr = tr, tl
        chain = tl[:-1] + tr[:0:-1]
        stop_idx = tr[1] if len(tr) > 2 else tl[-2] if len(tl) > 2 else -1
        # lower half
        bl = _sklansky(p, 0, miny_ind, 1, -1)
        br = _sklansky(p, total - 1, miny_ind, 1, 1)
        if stop_idx >= 0:
            check_idx = (bl[1] if len(bl) > 2 else
                         br[2 - len(bl)] if len(bl) + len(br) > 2 else -1)
            if check_idx == stop_idx or (check_idx >= 0 and p[check_idx] == p[stop_idx]):
                # all points on one line: the lower half mirrors the upper
                bl, br = bl[:2], br[:2]
        chain += bl[:-1] + br[:0:-1]
        hull = [int(order[i]) for i in chain]
        hull = _cyclic_shift(hull)
    return data[hull]


def _cyclic_shift(hull: List[int]) -> List[int]:
    """OpenCV's last step: rotate the loop so that the input indices of its
    vertices ascend (or descend), where a rotation can make them do so."""
    nout = len(hull)
    if nout < 3:
        return hull
    min_idx = max_idx = lt = 0
    i = 1
    while i < nout:
        idx = hull[i]
        lt += hull[i - 1] < idx
        if 1 < lt <= i - 2:
            break
        if idx < hull[min_idx]:
            min_idx = i
        if idx > hull[max_idx]:
            max_idx = i
        i += 1
    mmdist = abs(max_idx - min_idx)
    if (mmdist == 1 or mmdist == i - 1) and (lt <= 1 or lt >= i - 2):
        ascending = (max_idx + 1) % nout == min_idx
        i0 = min_idx if ascending else max_idx
        if i0 > 0:
            shifted = hull[i0:] + hull[:i0]
            if all(ascending == (a < b) for a, b in zip(shifted, shifted[1:])):
                return shifted
    return hull


def _row_extremes(ij: np.ndarray) -> np.ndarray:
    """The leftmost and rightmost pixel of each row of a row-major (N, 2)
    (row, col) pixel list, in the list's order.  Every hull vertex is one of
    them, so the hull (and its input order, which sets cv2's start vertex)
    is the same over these few points as over all N."""
    rows = ij[:, 0]
    first = np.r_[True, rows[1:] != rows[:-1]]
    last = np.r_[rows[1:] != rows[:-1], True]
    return ij[first | last]


def generate_convex_hull(
    img_src: np.ndarray,
    index_care_about: int = 1,
    top_number: int = 1,
    area_threshold: int = 30,
) -> List[np.ndarray]:
    """Extract convex hulls of the largest blobs of one class.

    Args:
        img_src: (H, W) integer label image.
        index_care_about: class id to extract (must be nonzero, ref :33-35).
        top_number: how many largest components to keep.
        area_threshold: minimum component area in pixels.

    Returns:
        List of (2, K) int32 closed vertex loops in (x, y) image coordinates
        (first vertex repeated at the end, ref :74-76).
    """
    from scipy import ndimage

    if index_care_about == 0:
        raise ValueError("index_care_about cannot be zero")

    binary = np.asarray(img_src) == index_care_about
    eroded = ndimage.binary_erosion(binary, structure=np.ones((3, 3)), border_value=1)

    # 8-connected labeling (the reference's skimage connectivity=ndim)
    labeled, num = ndimage.label(eroded, structure=np.ones((3, 3)))
    if num == 0:
        return []

    counts = Counter(labeled[labeled != 0].ravel()).most_common(top_number)
    selected = [idx for idx, cnt in counts if cnt > area_threshold]

    vertices: List[np.ndarray] = []
    for select_index in selected:
        ij = _row_extremes(np.argwhere(labeled == select_index))  # (N, 2) row, col
        hull = cv_convex_hull(np.fliplr(ij)).astype(np.int32)  # (K, 2) x, y
        vertices.append(np.concatenate([hull, hull[:1]], axis=0).T)
    return vertices
