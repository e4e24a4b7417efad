"""Joint image + label transforms for segmentation training.

Port of ``vision_semantic_segmentation_tpu/train/transforms.py`` (ref
data/transforms.py:16-424), on numpy and PyTorch instead of PIL images: a
sample is ``{"image": (H, W, 3) uint8, "label": (H, W) uint8}`` until
``ToTensor``.  Randomness is Python's ``random`` module, as in the JAX
package, so one seed draws the same scales, crops and flips in both.

Resampling follows Pillow's, which the JAX package uses:

  * images BILINEAR through ``F.interpolate(uint8, antialias=True)``,
    PyTorch's CPU port of Pillow's filter: at most one grey level from
    Pillow, on a fraction of a percent of pixels;
  * labels NEAREST with Pillow's source index exactly: the pixel centre
    ``0.5 * s + i * s`` (s = source / target size) accumulated in double
    precision, then truncated, as Pillow's affine nearest scaler does;
  * crops, flips and border padding as array slices and ``np.pad``
    (Pillow's ``ImageOps.expand``: image black, label ``ignore_index``).

``RandomRotate`` samples with ``grid_sample`` (bilinear image, nearest
label, zero fill) about the image centre; it agrees with Pillow's rotate to
interpolation rounding, not bit for bit.  ``ToTensor`` gives NHWC float32
(image (H, W, 3), label (H, W)) as the JAX package does; the trainer makes
NCHW tensors of them.
"""
from __future__ import annotations

import math
import numbers
import random
import warnings
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Sample = Dict[str, np.ndarray]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample

    def __repr__(self):
        inner = "\n".join(f"    {t}" for t in self.transforms)
        return f"{type(self).__name__}(\n{inner}\n)"


def _pair(size) -> Tuple[int, int]:
    return (int(size), int(size)) if isinstance(size, numbers.Number) else tuple(size)


def _wh(a: np.ndarray) -> Tuple[int, int]:
    """(width, height), Pillow's ``Image.size``."""
    return a.shape[1], a.shape[0]


def resize_bilinear(image: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) uint8 -> Pillow-style antialiased bilinear resize to (w, h)."""
    w, h = size_wh
    if _wh(image) == (w, h):
        return image
    image = np.ascontiguousarray(image)
    if not image.flags.writeable:  # Pillow's arrays are read-only
        image = image.copy()
    t = torch.from_numpy(image)
    t = (t[..., None] if t.ndim == 2 else t).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    out = out[0].permute(1, 2, 0).numpy()
    return out[..., 0] if image.ndim == 2 else np.ascontiguousarray(out)


def nearest_index(src: int, dst: int) -> np.ndarray:
    """Pillow's NEAREST source index for each of ``dst`` target pixels."""
    scale = src / dst
    centres = np.cumsum(np.concatenate([[0.5 * scale], np.full(dst - 1, scale)]))
    return np.clip(centres.astype(np.int64), 0, src - 1)


def resize_nearest(label: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    w, h = size_wh
    if _wh(label) == (w, h):
        return label
    return label[np.ix_(nearest_index(label.shape[0], h), nearest_index(label.shape[1], w))]


def _crop(a: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> np.ndarray:
    """Pillow's ``crop``: a box reaching outside the array reads zeros there."""
    h, w = a.shape[:2]
    if x1 < 0 or y1 < 0 or x2 > w or y2 > h:
        a = _expand(a, max(0, -x1), max(0, -y1), max(0, x2 - w), max(0, y2 - h), 0)
        x1, x2, y1, y2 = x1 + max(0, -x1), x2 + max(0, -x1), y1 + max(0, -y1), y2 + max(0, -y1)
    return np.ascontiguousarray(a[y1:y2, x1:x2])


def _expand(a: np.ndarray, left: int, top: int, right: int, bottom: int, fill: int) -> np.ndarray:
    pad = [(top, bottom), (left, right)] + [(0, 0)] * (a.ndim - 2)
    return np.pad(a, pad, constant_values=fill)


class ToTensor:
    """uint8 pair -> numpy float32: image (H, W, 3), label (H, W)."""

    def __call__(self, sample: Sample) -> Sample:
        return {"image": np.asarray(sample["image"], dtype=np.float32),
                "label": np.asarray(sample["label"], dtype=np.float32)}


class Normalize:
    """Scale to [0,1] then standardize with the given stats (ref :56-78)."""

    def __init__(self, mean, std, inplace: bool = False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, sample: Sample) -> Sample:
        image = np.asarray(sample["image"], dtype=np.float32)
        return {"image": (image / 255.0 - self.mean) / self.std, "label": sample["label"]}


class Resize:
    def __init__(self, size):
        self.size = _pair(size)  # (w, h), as Pillow reads it

    def __call__(self, sample: Sample) -> Sample:
        image, label = sample["image"], sample["label"]
        if _wh(image) != _wh(label):
            raise ValueError("image and label sizes differ")
        return {"image": resize_bilinear(image, self.size),
                "label": resize_nearest(label, self.size)}


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.prob = p

    def __call__(self, sample: Sample) -> Sample:
        if random.random() < self.prob:
            return {"image": np.ascontiguousarray(sample["image"][:, ::-1]),
                    "label": np.ascontiguousarray(sample["label"][:, ::-1])}
        return sample


def _rotate(a: np.ndarray, angle: float, mode: str) -> np.ndarray:
    """Rotate counter-clockwise by ``angle`` degrees about the centre, same size, zero fill."""
    h, w = a.shape[:2]
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    t = (t[..., None] if t.ndim == 2 else t).permute(2, 0, 1)[None]
    rad = math.radians(angle)
    c, s = math.cos(rad), math.sin(rad)
    # output pixel (x, y) samples the source at R(-angle) about the centre,
    # in normalised coordinates (x right, y down; aspect kept)
    theta = torch.tensor([[[c, -s * h / w, 0.0], [s * w / h, c, 0.0]]], dtype=torch.float32)
    grid = F.affine_grid(theta, list(t.shape), align_corners=False)
    out = F.grid_sample(t, grid, mode=mode, padding_mode="zeros", align_corners=False)
    out = out[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()
    return out[..., 0] if a.ndim == 2 else np.ascontiguousarray(out)


class RandomRotate:
    def __init__(self, degrees):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be positive")
            self.degrees = (-degrees, degrees)
        else:
            if len(degrees) != 2:
                raise ValueError("degrees must have length 2")
            self.degrees = tuple(degrees)

    def __call__(self, sample: Sample) -> Sample:
        angle = random.uniform(*self.degrees)
        return {"image": _rotate(sample["image"], angle, "bilinear"),
                "label": _rotate(sample["label"], angle, "nearest")}


class RandomCrop:
    """Random crop; pads (or shrinks, with nopad) when the image is smaller.

    (ref :158-242 including the centroid-covering option)
    """

    def __init__(self, size, ignore_index: int = 0, nopad: bool = True):
        self.size = _pair(size)
        self.ignore_index = ignore_index
        self.nopad = nopad

    def __call__(self, sample: Sample, centroid=None) -> Sample:
        image, label = sample["image"], sample["label"]
        if _wh(image) != _wh(label):
            raise ValueError("image and label sizes differ")
        w, h = _wh(image)
        th, tw = self.size
        if w == tw and h == th:
            return sample

        if self.nopad:
            if th > h or tw > w:
                shorter = min(w, h)
                th, tw = shorter, shorter
        else:
            pad_h = (th - h) // 2 + 1 if th > h else 0
            pad_w = (tw - w) // 2 + 1 if tw > w else 0
            if pad_h or pad_w:
                image = _expand(image, pad_w, pad_h, pad_w, pad_h, 0)
                label = _expand(label, pad_w, pad_h, pad_w, pad_h, self.ignore_index)
                w, h = _wh(image)

        if centroid is not None:
            c_x, c_y = centroid
            x1 = min(w - tw, max(0, random.randint(c_x - tw, c_x)))
            y1 = min(h - th, max(0, random.randint(c_y - th, c_y)))
        else:
            x1 = 0 if w == tw else random.randint(0, w - tw)
            y1 = 0 if h == th else random.randint(0, h - th)
        return {"image": _crop(image, x1, y1, x1 + tw, y1 + th),
                "label": _crop(label, x1, y1, x1 + tw, y1 + th)}


class RandomSizeAndCrop:
    """Random scale then random crop (ref :245-298)."""

    def __init__(self, size, scale=(0.5, 2), ignore_index=0, crop_nopad=False, pre_size=None):
        self.size = _pair(size)
        if scale[0] > scale[1]:
            warnings.warn("scale range should be (min, max)")
        self.crop = RandomCrop(self.size, ignore_index=ignore_index, nopad=crop_nopad)
        self.scale = scale
        self.pre_size = pre_size

    def __call__(self, sample: Sample, centroid=None) -> Sample:
        image, label = sample["image"], sample["label"]
        if _wh(image) != _wh(label):
            raise ValueError("image and label sizes differ")
        scale_amt = 1.0 if self.pre_size is None else self.pre_size / min(_wh(image))
        scale_amt *= random.uniform(*self.scale)
        w, h = [int(i * scale_amt) for i in _wh(image)]
        if centroid is not None:
            centroid = [int(c * scale_amt) for c in centroid]
        sample = {"image": resize_bilinear(image, (w, h)), "label": resize_nearest(label, (w, h))}
        return self.crop(sample, centroid)


class FixScaleCenterCrop:
    """Scale preserving aspect ratio so the crop fits, then center crop (ref :301-352)."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, sample: Sample) -> Sample:
        image, label = sample["image"], sample["label"]
        width, height = _wh(image)
        c_height, c_width = self.size
        ratio = max(c_width / width, c_height / height)
        s_width, s_height = int(width * ratio), int(height * ratio)
        image = resize_bilinear(image, (s_width, s_height))
        label = resize_nearest(label, (s_width, s_height))
        x1 = (s_width - c_width) // 2
        y1 = (s_height - c_height) // 2
        return {"image": _crop(image, x1, y1, x1 + c_width, y1 + c_height),
                "label": _crop(label, x1, y1, x1 + c_width, y1 + c_height)}


class CenterCropWithPad:
    """Center crop, padding when the image is smaller (ref :355-400)."""

    def __init__(self, size, ignore_index: int = 255):
        self.size = _pair(size)
        self.ignore_index = ignore_index

    def __call__(self, sample: Sample) -> Sample:
        image, label = sample["image"], sample["label"]
        if _wh(image) != _wh(label):
            raise ValueError("image and label sizes differ")
        w, h = _wh(image)
        tw, th = self.size
        pad_x = tw - w if w < tw else 0
        pad_y = th - h if h < th else 0
        if pad_x or pad_y:
            image = _expand(image, pad_x, pad_y, pad_x, pad_y, 0)
            label = _expand(label, pad_x, pad_y, pad_x, pad_y, self.ignore_index)
            w, h = _wh(image)
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return {"image": _crop(image, x1, y1, x1 + tw, y1 + th),
                "label": _crop(label, x1, y1, x1 + tw, y1 + th)}


class MaxSizeCenterCrop:
    """Center crop only when larger than a max size (ref :403-424)."""

    def __init__(self, size, ignore_index: int = 255):
        self.size = _pair(size)
        self.center_crop = CenterCropWithPad(size, ignore_index)

    def __call__(self, sample: Sample) -> Sample:
        w, h = _wh(sample["image"])
        tw, th = self.size
        if w > tw or h > th:
            return self.center_crop(sample)
        return sample
