"""Port parity: the planar path (geometry, homography, the planar update and
the planar mapping node) against the JAX package.

The same numpy inputs, made from a seed, go through the JAX package and the
port on the CPU.  Tolerances, each with its reason:
  * host numpy code (``parameterize_rotation``, ``right_null``, the
    calibration properties, the plane constructors, the DLT fit, the
    anchors) equal exactly: it is the same numpy arithmetic;
  * f32 tensor math (transforms, projection, rays, plane queries) to 1e-5,
    relative where the values are pixels: the two packages may order a sum
    or a norm differently;
  * the warp and the engine's planar grid equal exactly: the port inverts
    ``H`` with the LU that ``jnp.linalg.inv`` runs on the CPU (LAPACK, bit
    for bit) and forms the map with the same f32 product, so no pixel moves
    across a rounding edge;
  * the planar node's grid equal but for at most 1e-4 of the cells, each
    off by one count: the JAX node builds the pose's matrix in f32 (its
    ``pose_to_matrix`` runs with x64 off), the port in f64 on the host, so
    the fitted homography differs in its last bits and a warped pixel that
    lies on a rounding edge lands one cell over.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from vision_semantic_segmentation_tpu.config import get_cfg_defaults as j_cfg_defaults
from vision_semantic_segmentation_tpu.geometry import bounding_box as j_bbox
from vision_semantic_segmentation_tpu.geometry import camera as j_camera
from vision_semantic_segmentation_tpu.geometry import homography as j_homography
from vision_semantic_segmentation_tpu.geometry import plane as j_plane
from vision_semantic_segmentation_tpu.geometry import transforms as j_transforms
from vision_semantic_segmentation_tpu.mapping.engine import SemanticMappingEngine as JaxEngine
from vision_semantic_segmentation_tpu.runtime.bus import TopicBus as JaxBus
from vision_semantic_segmentation_tpu.runtime.node import (
    FusedOnlineNode as JaxFusedNode,
    MappingNode as JaxMappingNode,
)
from vision_semantic_segmentation_tpu.utils.ros_compat import TransformTree as JaxTree
from vision_semantic_segmentation_tpu_torch import geometry
from vision_semantic_segmentation_tpu_torch.config import get_cfg_defaults
from vision_semantic_segmentation_tpu_torch.geometry import bounding_box, camera, homography, plane
from vision_semantic_segmentation_tpu_torch.geometry import transforms
from vision_semantic_segmentation_tpu_torch.mapping import SemanticMappingEngine
from vision_semantic_segmentation_tpu_torch.runtime import FusedOnlineNode, MappingNode, TopicBus
from vision_semantic_segmentation_tpu_torch.utils.ros_compat import TransformTree

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CAMERAS = ("camera1", "camera6")


@pytest.fixture
def rng():
    """A fixed seed for each test, whatever else ran before it in the worker."""
    return np.random.default_rng(0)


def _both(name, *args, module_pair=(j_transforms, transforms)):
    """``name`` of the JAX module on jnp arrays and of the port's on tensors."""
    jmod, mod = module_pair
    ref = getattr(jmod, name)(*[jnp.asarray(a) for a in args])
    ours = getattr(mod, name)(*[torch.as_tensor(a) for a in args])
    return np.asarray(ref), ours.numpy()


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# -- transforms ------------------------------------------------------------------
TENSOR_CASES = {
    "dehomogenize": lambda rng: (np.vstack([_f32(rng, 3, 10), rng.uniform(0.5, 2, (1, 10))])
                                 .astype(np.float32),),
    "skew": lambda rng: (_f32(rng, 3),),
    "de_skew": lambda rng: (np.array(j_transforms.skew(jnp.asarray(_f32(rng, 3)))),),
    "sinc": lambda rng: (np.float32([-3.0, -1e-3, 0.0, 0.5, 2.0, 7.0]),),
    "deparameterize_rotation": lambda rng: (_f32(rng, 3),),
    "rotation_2d": lambda rng: (np.float32(rng.uniform(-np.pi, np.pi)),),
    "differentiate_sinc": lambda rng: (np.float32([-2.0, -1e-2, 0.0, 0.3, 4.0]),),
    "jacobian_vector_norm": lambda rng: (_f32(rng, 3, 1),),
    "transform_points": lambda rng: (
        np.array(j_transforms.pose_to_matrix(jnp.asarray(_f32(rng, 3)),
                                               jnp.asarray(Rotation.random(random_state=1)
                                                           .as_quat().astype(np.float32)))),
        _f32(rng, 3, 20) * 10),
}


@pytest.mark.parametrize("name", list(TENSOR_CASES))
def test_tensor_transforms_match(name, rng):
    ref, ours = _both(name, *TENSOR_CASES[name](rng))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-5)


def test_small_rotation_takes_the_taylor_branch():
    ref, ours = _both("deparameterize_rotation", np.float32([1e-9, -2e-9, 5e-10]))
    np.testing.assert_allclose(ours, ref, atol=1e-12, rtol=0)
    np.testing.assert_allclose(ours, np.eye(3), atol=1e-8)


@pytest.mark.parametrize("angle", [1e-9, 0.3, 2.0, np.pi - 1e-4, np.pi])
def test_parameterize_rotation_matches(angle, rng):
    axis = rng.standard_normal(3)
    R = Rotation.from_rotvec(axis / np.linalg.norm(axis) * angle).as_matrix()
    w_ref, theta_ref = j_transforms.parameterize_rotation(R)
    w, theta = transforms.parameterize_rotation(R)
    np.testing.assert_array_equal(w, w_ref)
    assert theta == theta_ref


@pytest.mark.parametrize("norm", [0.5, np.pi + 0.1, 5.0, 20.0])
def test_singularity_normalization_matches(norm, rng):
    w = rng.standard_normal(3)
    w *= norm / np.linalg.norm(w)
    ours = transforms.singularity_normalization(w)
    np.testing.assert_array_equal(ours, j_transforms.singularity_normalization(w))
    assert np.linalg.norm(ours) <= np.pi + 1e-12


def test_right_null_matches(rng):
    A = rng.standard_normal((4, 3))
    np.testing.assert_array_equal(transforms.right_null(A), j_transforms.right_null(A))
    assert transforms.right_null(A) is None
    A[:, 2] = A[:, 0] - 2 * A[:, 1]  # rank 2: a right null vector exists
    np.testing.assert_array_equal(transforms.right_null(A), j_transforms.right_null(A))
    assert np.abs(A @ transforms.right_null(A)).max() < 1e-10


def test_jacobian_vector_norm_wants_a_column(rng):
    with pytest.raises(ValueError, match="column vector"):
        transforms.jacobian_vector_norm(torch.ones(3))


def test_geometry_exports_match():
    import vision_semantic_segmentation_tpu.geometry as j_geometry

    assert set(j_geometry.__all__) <= set(geometry.__all__)


# -- camera ------------------------------------------------------------------------
@pytest.mark.parametrize("cam", CAMERAS)
def test_camera_matrices_match(cam):
    ours, ref = camera.get_camera(cam), j_camera.get_camera(cam)
    for prop in ("T", "K_inv", "C_world", "P", "P_norm"):
        np.testing.assert_array_equal(getattr(ours, prop), getattr(ref, prop))


@pytest.mark.parametrize("cam", CAMERAS)
def test_project_matches(cam, rng):
    calib = j_camera.get_camera(cam)
    in_view = rng.uniform([[-8.0], [-5.0], [5.0]], [[8.0], [5.0], [40.0]], (3, 50))
    pts = (calib.R.T @ (in_view - calib.t)).astype(np.float32)  # camera -> world
    ref = np.asarray(j_camera.get_camera(cam).project(jnp.asarray(pts)))
    ours = camera.get_camera(cam).project(torch.from_numpy(pts)).numpy()
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("world", [True, False], ids=["world", "camera"])
@pytest.mark.parametrize("cam", CAMERAS)
def test_pixel_to_ray_matches(cam, world, rng):
    pix = rng.uniform([[0.0], [0.0]], [[1920.0], [1440.0]], (2, 40)).astype(np.float32)
    d_ref, c_ref = j_camera.get_camera(cam).pixel_to_ray(jnp.asarray(pix), world=world)
    d, c = camera.get_camera(cam).pixel_to_ray(torch.from_numpy(pix), world=world)
    assert d.dtype == c.dtype == torch.float32
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=0), 1.0, atol=1e-6)


@pytest.mark.parametrize("cam", CAMERAS)
def test_bounding_box_to_ray_matches(cam):
    box, j_box = (m.BoundingBox(400.0, 700.0, 120.0, 80.0, "car", 0.9)
                  for m in (bounding_box, j_bbox))
    assert box == bounding_box.BoundingBox(**j_box.__dict__)
    assert (box.right, box.bottom, box.bottom_point(), box.center()) == (
        j_box.right, j_box.bottom, j_box.bottom_point(), j_box.center())
    d_ref, c_ref = j_camera.get_camera(cam).bounding_box_to_ray(j_box)
    d, c = camera.get_camera(cam).bounding_box_to_ray(box)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5, rtol=1e-6)


# -- plane -------------------------------------------------------------------------
def _planes(rng):
    coef = rng.standard_normal(4)
    coef[2] = -abs(coef[2])  # c < 0: the normalisation flips the sign
    return plane.Plane3D(*coef), j_plane.Plane3D(*coef)


def test_plane_constructors_match(rng):
    ours, ref = _planes(rng)
    assert dataclasses_equal(ours, ref) and ours.c > 0
    np.testing.assert_array_equal(ours.normal, ref.normal)
    np.testing.assert_array_equal(ours.param, ref.param)
    assert dataclasses_equal(plane.Plane3D.from_list([1, 2, -3, 4]),
                             j_plane.Plane3D.from_list([1, 2, -3, 4]))
    pts = rng.standard_normal((3, 3))
    assert dataclasses_equal(plane.Plane3D.fit_minimal(pts), j_plane.Plane3D.fit_minimal(pts))
    v1, v2, p1 = rng.standard_normal((3, 3))
    assert dataclasses_equal(plane.Plane3D.from_vectors_and_point(v1, v2, p1),
                             j_plane.Plane3D.from_vectors_and_point(v1, v2, p1))
    assert dataclasses_equal(ours.rotated_around_y(0.3), ref.rotated_around_y(0.3))
    assert dataclasses_equal(plane.ground_plane(), j_plane.ground_plane())
    for mod in (plane, j_plane):
        with pytest.raises(ValueError, match="Degenerate"):
            mod.Plane3D(0.0, 0.0, 0.0, 1.0)
        with pytest.raises(ValueError, match="Collinear"):
            mod.Plane3D.fit_minimal(np.array([[0, 0, 0], [1, 1, 1], [2, 2, 2.0]]))


def dataclasses_equal(a, b) -> bool:
    return (a.a, a.b, a.c, a.d) == (b.a, b.b, b.c, b.d)


def test_plane_queries_match(rng):
    ours, ref = _planes(rng)
    pts = (_f32(rng, 30, 3) * 10)
    for q in ("distance", "distance_signed"):
        np.testing.assert_allclose(getattr(ours, q)(torch.from_numpy(pts)).numpy(),
                                   np.asarray(getattr(ref, q)(jnp.asarray(pts))),
                                   atol=1e-5, rtol=1e-5)
    v = _f32(rng, 3)
    np.testing.assert_allclose(ours.normal_angle_to_vector(torch.from_numpy(v)).numpy(),
                               np.asarray(ref.normal_angle_to_vector(jnp.asarray(v))), atol=1e-5)


@pytest.mark.parametrize("cam", CAMERAS)
def test_ray_intersection_matches(cam, rng):
    ground = (plane.Plane3D(0.0, 0.0, 1.0, 2.0), j_plane.Plane3D(0.0, 0.0, 1.0, 2.0))
    pix = rng.uniform([[0.0], [800.0]], [[1920.0], [1440.0]], (2, 30)).astype(np.float32)
    d, c = camera.get_camera(cam).pixel_to_ray(torch.from_numpy(pix))
    d_ref, c_ref = j_camera.get_camera(cam).pixel_to_ray(jnp.asarray(pix))
    ours = ground[0].ray_intersection(d, c).numpy()
    ref = np.asarray(ground[1].ray_intersection(d_ref, c_ref))
    np.testing.assert_allclose(ours, ref, atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(ours[2], -2.0, atol=1e-4)  # on the plane


def test_clip_pcd_by_distance_plane_matches(rng):
    pts = _f32(rng, 200, 4) * 3
    v1, v2, p1 = np.eye(3)[0], np.eye(3)[1], np.zeros(3)
    ours = plane.clip_pcd_by_distance_plane(torch.from_numpy(pts), v1, v2, p1, (1.0, -0.5))
    ref = j_plane.clip_pcd_by_distance_plane(jnp.asarray(pts), v1, v2, p1, (1.0, -0.5))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert len(ours[0]) and len(ours[1]) and len(ours[0]) + len(ours[1]) == 200


# -- homography --------------------------------------------------------------------
@pytest.mark.parametrize("n", [4, 9])
def test_find_homography_matches(n, rng):
    src = rng.uniform(0, 1000, (n, 2))
    H_true = np.array([[1.1, 0.05, 20.0], [-0.03, 0.9, 5.0], [1e-4, -2e-4, 1.0]])
    dst_h = H_true @ np.vstack([src.T, np.ones(n)])
    dst = (dst_h[:2] / dst_h[2]).T + rng.normal(0, 0.5, (n, 2)) * (n > 4)
    ours = homography.find_homography(src, dst)
    np.testing.assert_array_equal(ours, j_homography.find_homography(src, dst))
    if n == 4:
        np.testing.assert_allclose(ours, H_true, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="N >= 4"):
        homography.find_homography(src[:3], dst[:3])


def _homography(rng):
    """A ground-plane-like homography: a perspective warp of a 120x160 image."""
    src = np.array([[10.0, 100.0], [150.0, 100.0], [100.0, 40.0], [60.0, 40.0]])
    dst = src + rng.uniform(-15, 15, (4, 2))
    return j_homography.find_homography(src, dst)


IMAGES = {
    "rgb_u8": lambda rng: rng.integers(0, 256, (120, 160, 3), dtype=np.uint8),
    "gray_f32": lambda rng: rng.standard_normal((120, 160)).astype(np.float32),
}


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("image", list(IMAGES))
def test_warp_perspective_matches(image, mode, rng):
    img, H = IMAGES[image](rng), _homography(rng)
    for out_size in ((160, 120), (97, 131)):
        ref = np.asarray(j_homography.warp_perspective(jnp.asarray(img), H, out_size, mode=mode))
        ours = homography.warp_perspective(torch.from_numpy(img), H, out_size, mode=mode)
        assert ours.dtype == torch.as_tensor(np.array(ref)).dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert (ref != 0).mean() > 0.3
    with pytest.raises(ValueError, match="Unknown mode"):
        homography.warp_perspective(torch.from_numpy(img), H, (10, 10), mode="cubic")


def test_generate_homography_matches(rng):
    img = IMAGES["rgb_u8"](rng)
    src = np.array([[10.0, 100.0], [150.0, 100.0], [100.0, 40.0], [60.0, 40.0]])
    dst = src + rng.uniform(-15, 15, (4, 2))
    ours, H = homography.generate_homography(torch.from_numpy(img), src, dst, return_h=True)
    ref, j_H = j_homography.generate_homography(img, src, dst, return_h=True)
    np.testing.assert_array_equal(H, j_H)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    ours = homography.generate_homography(img, src, dst, out_size=[50, 70], mode="nearest")
    ref = j_homography.generate_homography(img, src, dst, out_size=[50, 70], mode="nearest")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# -- the planar update -------------------------------------------------------------
def _planar_cfgs(tmp_path, resolution=0.2):
    """Both packages' defaults in planar mode over an ego-local 40x40 m
    grid in front of the vehicle (200x200 cells at 0.2 m)."""
    cfgs = []
    for make, sub in ((j_cfg_defaults, "jax"), (get_cfg_defaults, "port")):
        cfg = make()
        cfg.MAPPING.DEPTH_METHOD = "planar"
        cfg.MAPPING.BOUNDARY = [[0, 40], [-20, 20]]
        cfg.MAPPING.RESOLUTION = resolution
        cfg.TEST_END_TIME = 1e12
        cfg.OUTPUT_DIR = str(tmp_path / sub)
        cfgs.append(cfg)
    return cfgs


def _semantic_images(cfg, rng):
    """Two semantic images: label-colour stripes (a constant image would be
    invariant to the warp and hide a wrong transform) and random palette
    colours with some unmapped pixels."""
    colors = np.array(cfg.LABEL_COLORS, np.uint8)
    stripes = np.zeros((1440, 1920, 3), np.uint8)
    stripes[:] = colors[0]
    stripes[:, ::3] = colors[1]
    stripes[::5] = colors[3]
    noisy = colors[rng.integers(0, len(colors), (90, 120))].repeat(16, 0).repeat(16, 1)
    noisy[rng.random((1440, 1920)) < 0.1] = 17
    return stripes, noisy


def _poses(n):
    return [(np.array([1.0 * i, 0.5 * i, 0.0]), Rotation.from_euler("z", 0.2 * i).as_quat())
            for i in range(n)]


def _T_local_to_base(position, quaternion):
    T = np.asarray(j_transforms.pose_to_matrix(jnp.asarray(position), jnp.asarray(quaternion)),
                   np.float64)
    return np.linalg.inv(T)


def test_planar_anchors_match(tmp_path):
    jcfg, cfg = _planar_cfgs(tmp_path)
    ours, ref = SemanticMappingEngine(cfg, device="cpu"), JaxEngine(jcfg)
    np.testing.assert_array_equal(ours.anchor_points_2(), ref.anchor_points_2())
    np.testing.assert_array_equal(ours.discretize_matrix_inv(), ref.discretize_matrix_inv())


@pytest.mark.parametrize("cam", CAMERAS)
def test_update_map_planar_matches(cam, tmp_path, rng):
    jcfg, cfg = _planar_cfgs(tmp_path)
    engine, j_engine = SemanticMappingEngine(cfg, device="cpu"), JaxEngine(jcfg)
    grid, j_grid = engine.init_grid(), j_engine.init_grid()
    grid -= 0.5  # max(grid, 0) clears what the frames do not add to
    j_grid = j_grid - 0.5
    for (position, quaternion), image in zip(_poses(3), _semantic_images(cfg, rng) * 2):
        T = _T_local_to_base(position, quaternion)
        out = engine.update_map_planar(grid, torch.from_numpy(image), T, camera=cam)
        assert out is grid  # in place
        j_grid = j_engine.update_map_planar(j_grid, image, T, camera=cam)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(j_grid))
    assert (grid > 0).sum() > 1000 and (grid >= 0).all()
    sep = int(8 / 0.2)  # the cells closer than 8 m take nothing
    assert (grid[:, :, :sep] == 0).all()


# -- the planar mapping node -------------------------------------------------------
def _run_planar_node(cfg, node_cls, bus, poses, images, tf_tree=None, **kw):
    node = node_cls(cfg, bus, tf_tree=tf_tree, **kw)
    for i, ((position, quaternion), image) in enumerate(zip(poses, images)):
        cam = CAMERAS[i % 2]
        bus.publish("/current_pose", (position, quaternion), stamp=float(i))
        bus.publish(f"/{cam}/semantic", image, stamp=float(i) + 0.01, frame_id=cam)
    return node


def _assert_planar_nodes_match(node, j_node):
    assert node.grid is not None and (node.grid > 0).sum() > 1000
    diff = np.abs(node.grid.numpy() - np.asarray(j_node.grid))
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-4, (
        f"{(diff > 0).mean():.2e} of cells differ, by up to {diff.max()}")
    # the JAX planar branch counts no fused frame, and neither does the port
    assert node.fused_frames == j_node.fused_frames == 0
    assert node.dropped_frames == j_node.dropped_frames == 0
    assert node.pcd_topic is j_node.pcd_topic is None


def test_planar_node_moving_poses_matches(tmp_path, rng):
    jcfg, cfg = _planar_cfgs(tmp_path)
    images = _semantic_images(cfg, rng) * 2
    poses = _poses(4)
    bus = TopicBus()
    node = _run_planar_node(cfg, MappingNode, bus, poses,
                            [torch.from_numpy(im) for im in images], device="cpu")
    j_node = _run_planar_node(jcfg, JaxMappingNode, JaxBus(), poses, images)
    _assert_planar_nodes_match(node, j_node)
    assert "/reduced_map" not in bus._subscribers and "/points_raw" not in bus._subscribers
    # the node's grid is the engine's, frame by frame, with the pose's transform
    engine = SemanticMappingEngine(cfg, device="cpu")
    grid = engine.init_grid()
    for i, ((position, quaternion), image) in enumerate(zip(poses, images)):
        engine.update_map_planar(grid, torch.from_numpy(image),
                                 node._planar_transform(position, quaternion),
                                 camera=CAMERAS[i % 2])
    torch.testing.assert_close(node.grid, grid, rtol=0, atol=0)
    # a moving pose changes the warp against the identity wiring
    still = engine.update_map_planar(engine.init_grid(), torch.from_numpy(images[1]), np.eye(4))
    moved = engine.update_map_planar(engine.init_grid(), torch.from_numpy(images[1]),
                                     node._planar_transform(*poses[1]))
    assert not torch.equal(still, moved)


def test_planar_node_local_map_from_tf_tree(tmp_path, rng):
    jcfg, cfg = _planar_cfgs(tmp_path)
    images = _semantic_images(cfg, rng)
    poses = [(np.array([1.0, 2.0, 0.0]), np.array([0.0, 0.0, 0.0, 1.0]))] * 2
    T_local = np.eye(4)
    T_local[:3, 3] = [3.0, -2.0, 0.0]
    trees = TransformTree(), JaxTree()
    for tree in trees:
        tree.set_transform("world", "local_map", T_local)
    node = _run_planar_node(cfg, MappingNode, TopicBus(), poses,
                            [torch.from_numpy(im) for im in images], tf_tree=trees[0],
                            device="cpu")
    j_node = _run_planar_node(jcfg, JaxMappingNode, JaxBus(), poses, images, tf_tree=trees[1])
    _assert_planar_nodes_match(node, j_node)
    want = np.linalg.inv(transforms.pose_to_matrix(
        torch.tensor(poses[0][0]), torch.tensor(poses[0][1])).numpy()) @ T_local
    np.testing.assert_allclose(node._planar_transform(*poses[0]), want, atol=1e-12)
    plain = _run_planar_node(cfg, MappingNode, TopicBus(), poses,
                             [torch.from_numpy(im) for im in images], device="cpu")
    assert not torch.equal(plain.grid, node.grid)


def test_fused_online_node_refuses_planar(tmp_path):
    jcfg, cfg = _planar_cfgs(tmp_path)
    with pytest.raises(ValueError) as j_err:
        JaxFusedNode(jcfg, JaxBus(), pipeline=_PipelineDouble(JaxEngine(jcfg)))
    with pytest.raises(ValueError) as err:
        FusedOnlineNode(cfg, TopicBus(), state_dict={}, device="cpu")
    assert str(err.value) == str(j_err.value)
    assert "planar" in str(err.value)


class _PipelineDouble:
    """What the JAX FusedOnlineNode reads of an injected pipeline."""

    def __init__(self, engine):
        self.engine = engine
