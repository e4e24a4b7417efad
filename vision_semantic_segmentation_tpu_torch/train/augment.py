"""Batched training augmentation on the card (``TRAIN.DEVICE_AUGMENT``).

Port of ``vision_semantic_segmentation_tpu/train/augment.py``: the host
supplies raw fixed-shape uint8 batches, and the random scale -> pad -> crop
-> horizontal flip -> ImageNet normalize chain of ``RandomSizeAndCrop(size,
scale, ignore_index, crop_nopad=False)`` + ``RandomHorizontalFlip(p)`` +
``ToTensor`` + ``Normalize`` runs on the tensors' device as one gather per
batch, with the JAX package's coordinates (truncated scaled size
``int(side * s)``, pad ``(target - side)//2 + 1`` when the scaled image is
smaller, inclusive crop-origin range, image padding black / label padding
``ignore_index``), its classic 4-tap bilinear image resampling (not
Pillow's antialiased one, as in the JAX package) and its
``floor((i + 0.5) * src/dst)`` label index.

The parameters are drawn from a ``torch.Generator`` (the JAX package splits
a PRNG key; the two give different numbers from one seed, so the tests hand
both the same parameters).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..inference.predictor import IMAGENET_MEAN, IMAGENET_STD


def sample_augment_params(
    generator: torch.Generator,
    batch: int,
    image_hw: Tuple[int, int],
    size: Tuple[int, int],
    scale: Tuple[float, float] = (0.5, 2.0),
    flip_p: float = 0.5,
    pre_size: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Each sample's augmentation parameters, (batch,) tensors on the
    generator's device: scale amount (uniform), crop origin (inclusive
    randint over the padded extent), flip (bernoulli)."""
    dev = generator.device
    h0, w0 = image_hw
    th, tw = size
    u = torch.rand((4, batch), generator=generator, device=dev)
    base = 1.0 if not pre_size else float(pre_size) / float(min(h0, w0))
    s = base * (float(scale[0]) + (float(scale[1]) - float(scale[0])) * u[0])
    h = torch.clamp(torch.floor(h0 * s), min=1.0).long()
    w = torch.clamp(torch.floor(w0 * s), min=1.0).long()
    pad_h = torch.where(h < th, (th - h) // 2 + 1, torch.zeros_like(h))
    pad_w = torch.where(w < tw, (tw - w) // 2 + 1, torch.zeros_like(w))
    span_y = h + 2 * pad_h - th + 1
    span_x = w + 2 * pad_w - tw + 1
    y1 = torch.minimum(torch.floor(u[1] * span_y).long(), span_y - 1)
    x1 = torch.minimum(torch.floor(u[2] * span_x).long(), span_x - 1)
    return {"h": h, "w": w, "pad_h": pad_h, "pad_w": pad_w, "y1": y1, "x1": x1,
            "flip": u[3] < float(flip_p)}


def apply_augment(
    image_u8: torch.Tensor,
    label: torch.Tensor,
    params: Dict[str, torch.Tensor],
    size: Tuple[int, int],
    ignore_index: int = 255,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale/pad/crop/flip/normalize a batch as one gather.

    Args:
        image_u8: (B, H0, W0, 3) uint8.
        label: (B, H0, W0) integer class ids.
        params: from :func:`sample_augment_params`, (B,) each.
    Returns:
        (B, th, tw, 3) float32 normalized image, (B, th, tw) int64 label
        (padding = ignore_index).
    """
    b, h0, w0 = image_u8.shape[:3]
    th, tw = size
    dev = image_u8.device

    def col(key):  # (B,) -> (B, 1, 1) for broadcasting over the crop
        return params[key].to(dev).view(b, 1, 1)

    ty = torch.arange(th, device=dev).view(1, th, 1)
    tx = torch.arange(tw, device=dev).view(1, 1, tw)
    # flip mirrors the final crop's columns (RandomHorizontalFlip after the crop)
    tx = torch.where(col("flip"), tw - 1 - tx, tx)
    xs = tx + col("x1") - col("pad_w")  # target pixel -> scaled-image coords
    ys = ty + col("y1") - col("pad_h")
    h, w = col("h"), col("w")
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)

    # scaled-image pixel -> source coords, pixel-centre convention, f32
    sx = w0 / w.float()
    sy = h0 / h.float()
    fx = (xs.float() + 0.5) * sx - 0.5
    fy = (ys.float() + 0.5) * sy - 0.5
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0i = x0.long().clamp(0, w0 - 1)
    x1i = (x0.long() + 1).clamp(0, w0 - 1)
    y0i = y0.long().clamp(0, h0 - 1)
    y1i = (y0.long() + 1).clamp(0, h0 - 1)
    flat = image_u8.reshape(b, h0 * w0, 3).float()

    def take(yi, xi):
        idx = (yi * w0 + xi).reshape(b, -1, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(b, th, tw, 3)

    top = take(y0i, x0i) * (1.0 - wx) + take(y0i, x1i) * wx
    bot = take(y1i, x0i) * (1.0 - wx) + take(y1i, x1i) * wx
    bilin = top * (1.0 - wy) + bot * wy
    img01 = torch.where(inside[..., None], bilin / 255.0, torch.zeros_like(bilin))
    mean_t = torch.as_tensor(mean, dtype=torch.float32, device=dev)
    std_t = torch.as_tensor(std, dtype=torch.float32, device=dev)
    out_img = (img01 - mean_t) / std_t

    lx = torch.floor((xs.float() + 0.5) * sx).clamp(0, w0 - 1).long()
    ly = torch.floor((ys.float() + 0.5) * sy).clamp(0, h0 - 1).long()
    lab = torch.gather(label.reshape(b, h0 * w0).long(), 1, (ly * w0 + lx).reshape(b, -1))
    out_lab = torch.where(inside, lab.reshape(b, th, tw), torch.full_like(lab.reshape(b, th, tw),
                                                                          ignore_index))
    return out_img, out_lab


def make_device_augment(
    size,
    scale: Tuple[float, float] = (0.5, 2.0),
    flip_p: float = 0.5,
    ignore_index: int = 255,
    pre_size: Optional[int] = None,
    mean: Sequence[float] = IMAGENET_MEAN,
    std: Sequence[float] = IMAGENET_STD,
) -> Callable[[torch.Generator, Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Build ``augment(generator, batch) -> batch`` for ``make_train_step``.

    Input batch: ``image`` (B, H0, W0, 3) uint8, ``label`` (B, H0, W0)
    integer.  Output: ``image`` (B, th, tw, 3) float32 normalized,
    ``label`` (B, th, tw) int64.  Any extra batch keys pass through.
    """
    if isinstance(size, int):
        size = (size, size)
    size = (int(size[0]), int(size[1]))

    def augment(generator: torch.Generator, batch: Dict[str, torch.Tensor]):
        image, label = batch["image"], batch["label"]
        if image.dtype != torch.uint8:
            raise TypeError(
                "device augment expects RAW uint8 image batches (the host transform "
                f"should only Resize) - got {image.dtype}; disable "
                "TRAIN.DEVICE_AUGMENT.ENABLED or drop ToTensor/Normalize from "
                "TRAIN.AUGMENTATION")
        params = sample_augment_params(generator, image.shape[0], tuple(image.shape[1:3]), size,
                                       scale=scale, flip_p=flip_p, pre_size=pre_size)
        out = dict(batch)
        out["image"], out["label"] = apply_augment(image, label, params, size,
                                                   ignore_index=ignore_index, mean=mean, std=std)
        return out

    return augment


def device_augment_from_cfg(cfg) -> Optional[Callable]:
    """TRAIN.DEVICE_AUGMENT config node -> augment fn (None when disabled)."""
    node = getattr(cfg.TRAIN, "DEVICE_AUGMENT", None)
    if node is None or not node.ENABLED:
        return None
    return make_device_augment(size=node.SIZE, scale=tuple(node.SCALE), flip_p=node.FLIP_P,
                               ignore_index=node.IGNORE_INDEX, pre_size=node.PRE_SIZE or None)
