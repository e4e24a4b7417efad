"""Port parity: geometry and point projection against the JAX package.

Transforms agree to f32 rounding; projected pixels and grid cells go
through int32 truncation and must be identical.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vision_semantic_segmentation_tpu.geometry import camera as jcamera
from vision_semantic_segmentation_tpu.geometry import transforms as jtransforms
from vision_semantic_segmentation_tpu.mapping import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu_torch.geometry import camera, transforms
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine

from test_mapping import make_frame, small_cfg
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.fixture
def rng():
    """A fixed seed for each test, whatever else ran before it in the worker."""
    return np.random.default_rng(0)


def _quat(rng):
    q = rng.standard_normal(4).astype(np.float32)
    return q / np.linalg.norm(q)


class TestTransforms:
    def test_pose_and_inverse(self, rng):
        for _ in range(5):
            q = _quat(rng)
            p = rng.standard_normal(3).astype(np.float32) * 100
            ref = np.asarray(jtransforms.pose_to_matrix(jnp.asarray(p), jnp.asarray(q)))
            ours = transforms.pose_to_matrix(torch.from_numpy(p), torch.from_numpy(q))
            np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
            np.testing.assert_allclose(
                transforms.se3_inverse(ours).numpy(),
                np.asarray(jtransforms.se3_inverse(jnp.asarray(ref))), atol=1e-4,
            )

    def test_euler_and_homogenize(self, rng):
        np.testing.assert_array_equal(
            transforms.euler_matrix(0.1, 0.14, -0.3), jtransforms.euler_matrix(0.1, 0.14, -0.3)
        )
        x = rng.standard_normal((3, 7)).astype(np.float32)
        np.testing.assert_array_equal(
            transforms.homogenize(torch.from_numpy(x)).numpy(),
            np.asarray(jtransforms.homogenize(jnp.asarray(x))),
        )


class TestCamera:
    @pytest.mark.parametrize("setup", ["camera_setup_1", "camera_setup_6"])
    def test_matrices_and_distortion(self, rng, setup):
        ours, ref = getattr(camera, setup)(), getattr(jcamera, setup)()
        np.testing.assert_array_equal(ours.P, ref.P)
        np.testing.assert_array_equal(ours.P_norm, ref.P_norm)
        xy = rng.uniform(-0.8, 0.8, (2, 500)).astype(np.float32)
        np.testing.assert_allclose(
            ours.distort_normalized(torch.from_numpy(xy)).numpy(),
            np.asarray(ref.distort_normalized(jnp.asarray(xy))), atol=1e-6,
        )


class TestProjection:
    @pytest.mark.parametrize("distorted", [False, True])
    @pytest.mark.parametrize("velodyne", [False, True])
    def test_pixels_and_cells_exact(self, rng, distorted, velodyne):
        cfg = small_cfg()
        pts, _, position, quaternion = make_frame(rng, cfg, n=4000)
        # a wider cloud too, so the masks see out-of-image / behind points
        wide = pts.copy()
        wide[:2] += rng.uniform(-60, 60, (2, wide.shape[1])).astype(np.float32)
        pcd = np.concatenate([pts, wide], axis=1)
        if velodyne:
            # ego-frame cloud: the pose is identity-rotation, so subtracting
            # the position puts the points ahead of (and around) the sensor
            pcd[:3] -= np.asarray(position, np.float32)[:, None]
        valid = np.ones(pcd.shape[1], bool)
        full_hw, img_hw = (1440, 1920), (356, 476)
        # each label pixel holds its own index, so equal labels == equal pixels
        image = np.arange(img_hw[0] * img_hw[1], dtype=np.int32).reshape(img_hw)

        kw = dict(image_is_class_id=True, image_full_hw=full_hw, distorted_image=distorted)
        j_pw = JaxEngine(cfg)._build_pointwise("camera1", velodyne, **kw)
        t_pw = SemanticMappingEngine(cfg, device="cpu")._build_pointwise("camera1", velodyne, **kw)
        ref = j_pw(jnp.asarray(pcd), jnp.asarray(valid), jnp.asarray(image),
                   jnp.asarray(position, jnp.float32), jnp.asarray(quaternion, jnp.float32))
        ours = t_pw(torch.from_numpy(pcd), torch.from_numpy(valid), torch.from_numpy(image),
                    torch.tensor(position, dtype=torch.float32),
                    torch.tensor(quaternion, dtype=torch.float32))
        names = ("cell", "cls", "vis", "upd")
        for name, a, b in zip(names, ours, ref[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        vis = ours[2].numpy()
        assert 100 < vis.sum() < vis.size  # some points in view, some not
        assert ours[0].dtype == torch.int32 and ours[1].dtype == torch.int32
