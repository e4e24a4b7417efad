"""The one generator of the benchmark's inputs, driven by a traffic file.

Every array is drawn on the device from a ``torch.Generator`` seeded by the
run's seed, in a few large calls; a replay's frames and clouds are then
copied to host memory, where a decoded log holds them, and training
batches stay on the device.  The sizes do not depend on the
seed beyond what the traffic file draws (a cloud's valid share), so every
seed brings the same amount of work in another order.

Parameters of a replay (a traffic file's ``frames`` object):
    pool: distinct raw uint8 frames made, then cycled
    speed_mps, rate_hz: the vehicle's speed along the grid's diagonal and the
      frame rate (poses advance speed / rate a frame)
    start_m: where along the diagonal the first pose lies
    valid_share: [lo, hi] of a cloud's 2**k slots that hold points
    z_range, intensity_range: ground height and LiDAR intensity of the points

Parameters of training (a traffic file's ``batches`` object):
    pool: distinct batches made on the device, then cycled
    blob_px: the side of a label blob, in pixels
    normalize: the mean and standard deviation images are normalised by
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from ..reference.mapping import ORIGIN_OFFSET

# Mapillary's colours of the 19 classes the network is trained on
MAPILLARY_19 = [[128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156], [190, 153, 153],
                [153, 153, 153], [250, 170, 30], [220, 220, 0], [107, 142, 35], [152, 251, 152],
                [70, 130, 180], [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70],
                [0, 60, 100], [0, 80, 100], [0, 0, 230], [119, 11, 32]]


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of a run, from the run's seed."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 64)
    x ^= x >> 31
    return x % (1 << 63)


def poses(n: int, map_cfg: dict, p: dict) -> Dict[str, np.ndarray]:
    """Poses along the grid's diagonal, heading along it, in the origin frame."""
    (bx0, _), (by0, _) = map_cfg["boundary"]
    step = float(p["speed_mps"]) / float(p["rate_hz"])
    s = float(p["start_m"]) + step * np.arange(n)
    pos = np.zeros((n, 3), np.float64)
    pos[:, 0] = bx0 + s / math.sqrt(2.0) - ORIGIN_OFFSET[0]
    pos[:, 1] = by0 + s / math.sqrt(2.0) - ORIGIN_OFFSET[1]
    yaw = math.pi / 4
    quat = np.tile([0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2)], (n, 1))
    return {"position": pos.astype(np.float32), "quaternion": quat.astype(np.float32)}


def clouds(n: int, map_cfg: dict, p: dict, position: np.ndarray, gen: torch.Generator,
           device) -> List[np.ndarray]:
    """(4, m) clouds of m = valid_share x bucket points, around each pose:
    range 1 m to RANGE_MAX (denser near), every bearing."""
    bucket = int(map_cfg["point_bucket"])
    lo, hi = p["valid_share"]
    share = lo + (hi - lo) * torch.rand(n, generator=gen, device=device)
    counts = (share * bucket).long().tolist()
    rmax = float(map_cfg["range_max"])
    u = torch.rand((n, 4, bucket), generator=gen, device=device)
    r = 1.0 + (rmax - 1.0) * u[:, 0] ** 2
    theta = 2.0 * math.pi * u[:, 1]
    z0, z1 = p["z_range"]
    i0, i1 = p["intensity_range"]
    pos = torch.as_tensor(position, device=device)
    pts = torch.stack([pos[:, :1] + r * torch.cos(theta), pos[:, 1:2] + r * torch.sin(theta),
                       z0 + (z1 - z0) * u[:, 2], i0 + (i1 - i0) * u[:, 3]], dim=1)
    host = pts.cpu().numpy()
    return [np.ascontiguousarray(host[i, :, :counts[i]]) for i in range(n)]


def camera_frames(n: int, hw, gen: torch.Generator, device) -> np.ndarray:
    """(n, H, W, 3) uint8 raw frames."""
    return torch.randint(0, 256, (n, hw[0], hw[1], 3), generator=gen, device=device,
                         dtype=torch.uint8).cpu().numpy()


def blob_classes(n: int, hw, blob: int, classes: int, gen: torch.Generator, device) -> torch.Tensor:
    """(n, H, W) int64 class ids in 0..classes-1, constant over blob x blob squares."""
    gh, gw = -(-hw[0] // blob), -(-hw[1] // blob)
    low = torch.randint(0, classes, (n, gh, gw), generator=gen, device=device)
    return low.repeat_interleave(blob, 1).repeat_interleave(blob, 2)[:, :hw[0], :hw[1]]


def frame_pool(seed: int, map_cfg: dict, image_hw, p: dict, device) -> Dict[str, list]:
    """The pool a replay cycles: raw frames, clouds and poses."""
    n = int(p["pool"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    pose = poses(n, map_cfg, p)
    images = camera_frames(n, image_hw, gen, device)
    pcd = clouds(n, map_cfg, p, pose["position"], gen, device)
    return {"image": list(images), "pcd": pcd, "position": list(pose["position"]),
            "quaternion": list(pose["quaternion"])}


def train_batches(seed: int, p: dict, batch: int, crop: int, classes: int,
                  device) -> Dict[str, torch.Tensor]:
    """The pool of training batches, already on the device as a loader's
    prefetcher hands them: ``image`` (pool, batch, crop, crop, 3) float32,
    normalised as ``p["normalize"]`` says (ToTensor's /255, then the mean
    and standard deviation); ``label`` (pool, batch, crop, crop) int32.
    Labels are blobs of the network's classes and of the ignore label 255;
    each image pixel is its label's colour in ``MAPILLARY_19`` (black for
    ignore) shaded by a ramp across the row, rounded as a decoded uint8
    image holds it."""
    pool = int(p["pool"])
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    ids = blob_classes(pool * batch, (crop, crop), int(p["blob_px"]), classes + 1, gen, device)
    pal = torch.tensor(MAPILLARY_19[:classes] + [[0, 0, 0]], dtype=torch.float32, device=device)
    mean = torch.tensor(p["normalize"]["mean"], device=device)
    std = torch.tensor(p["normalize"]["std"], device=device)
    ramp = torch.linspace(0.6, 1.0, crop, device=device)[None, None, :, None]
    image = ((pal[ids] * ramp).round() / 255.0 - mean) / std
    label = torch.where(ids == classes, 255, ids).to(torch.int32)
    return {"image": image.view(pool, batch, crop, crop, 3),
            "label": label.view(pool, batch, crop, crop)}

