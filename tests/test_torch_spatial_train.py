"""Port parity: the spatially sharded train and eval steps and the trainer
(``TRAIN.SPATIAL_SHARDS``).

Counterparts of ``tests/test_spatial_train.py`` (each test there has one
here, same name, at its tolerance).  The JAX package's single-device steps
are the reference, from the JAX test's thin DeepLab (resnet18 OS8, 64x32
images: one OS8 row a band at 8 bands) and the same initial variables,
crossed through ``flax_to_state_dict``; the port steps on logical shards of
the CPU (``["cpu"] * 8``) with SGD at 0.05, momentum 0.9.  ASPP's dropout is
0 on both sides (the two libraries draw different masks); the port's
banded dropout is held against its own unbanded step below.

``_assert_matches`` is the JAX test's: loss 2e-4 absolute, the confusion's
totals equal and every cell within 1 % of the pixels, the updated running
statistics 5e-3, the parameters 0.05 of their scale; in f32 train-mode
BatchNorm at batch 2 makes the parameters conditioning noise, as that
test's docstring measures.  The eval-mode gradients hold the backward's
halos at 1e-3 relative per leaf; the eval confusion is exact.

Each JAX program compiles once per module (module-scoped fixture): the
plain step (also run twice for the two-step dispatch), the eval-mode
gradient and the eval step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vision_semantic_segmentation_tpu.config import get_train_cfg_defaults as j_train_cfg
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.models.loss import cross_entropy_loss as j_ce
from vision_semantic_segmentation_tpu.parallel import (
    TrainState as JState,
    create_mesh as j_create_mesh,
    jit_eval_step,
    jit_train_step,
    make_eval_step as j_make_eval_step,
    make_train_step as j_make_train_step,
)
from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import build_train_model, flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.parallel import (
    Bands,
    SpatialModel,
    TrainState,
    create_mesh,
    make_eval_step,
    make_spatial_eval_step,
    make_spatial_train_step,
    make_train_step,
)
from vision_semantic_segmentation_tpu_torch.parallel.train_step import spatial_loss
from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CLASSES = 5


def _tiny(cfg, dropout=0.0):
    cfg.MODEL.TYPE = "DeepLabv3+"
    cfg.MODEL.BACKBONE = "resnet18"
    cfg.MODEL.OUTPUT_STRIDE = 8  # os map: H=64 -> 8 rows = 1 per shard
    cfg.MODEL.ASPP.OUT_CHANNELS = 16
    cfg.MODEL.ASPP.ATROUS_CHANNELS = [16, 16, 16, 16]
    cfg.MODEL.ASPP.DROPOUT = dropout
    cfg.MODEL.DECODER.LOW_LEVEL_OUT_CHANNELS = 8
    cfg.MODEL.DECODER.REFINE_CHANNELS = [16, 16]
    cfg.DATASET.NUM_CLASSES = CLASSES
    return cfg


def _make_batch(rng, b=2, h=64, w=32):
    return {
        "image": rng.standard_normal((b, h, w, 3)).astype(np.float32),
        "label": rng.integers(0, CLASSES, (b, h, w)).astype(np.int32),
    }


def _flat(tree) -> dict:
    """A JAX state (or a gradient tree) as the port's state-dict names."""
    params = jax.tree.map(np.asarray, tree.params if hasattr(tree, "params") else tree)
    stats = jax.tree.map(np.asarray, tree.batch_stats) if hasattr(tree, "batch_stats") else {}
    out = flax_to_state_dict({"params": params, "batch_stats": stats})
    return {k: v.numpy() for k, v in out.items() if not k.endswith("num_batches_tracked")}


class Ref:
    """The JAX side: model, initial variables, batches and the reference
    results, computed once."""

    def __init__(self):
        self.jmodel, *_ = j_build_model(_tiny(j_train_cfg()))
        variables = self.jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                     train=False)
        self.variables = jax.tree.map(np.asarray, dict(variables))
        rng = np.random.default_rng(10)
        self.batches = [_make_batch(rng), _make_batch(rng)]
        mesh1 = j_create_mesh(axis_names=("data",), devices=jax.devices()[:1])
        step = jit_train_step(j_make_train_step(num_classes=CLASSES), mesh1)
        state = self.jax_state()
        self.steps = []
        for batch in self.batches:  # the plain step twice: the two-step dispatch
            state, metrics = step(state, batch)
            self.steps.append((_flat(state), {k: np.asarray(v) for k, v in metrics.items()}))
        state = self.jax_state()
        stats = state.batch_stats
        image, label = self.batches[0]["image"], self.batches[0]["label"]

        def loss_fn(params):
            logits = self.jmodel.apply({"params": params, "batch_stats": stats}, image,
                                       train=False, upsample_pred=True)
            return j_ce(logits, label)

        self.eval_grads = _flat(jax.jit(jax.grad(loss_fn))(state.params))
        ev = jit_eval_step(j_make_eval_step(num_classes=CLASSES), mesh1)(state, self.batches[0])
        self.eval_confusion = np.asarray(ev["confusion"])

    def jax_state(self):
        return JState.create(self.jmodel, self.variables, optax.sgd(0.05, momentum=0.9),
                             jax.random.PRNGKey(1))

    def port_state(self, dropout=0.0, dtype=torch.float32) -> TrainState:
        model, *_ = build_train_model(_tiny(get_train_cfg_defaults(), dropout), device="cpu")
        model.load_state_dict(flax_to_state_dict(self.variables), strict=True)
        model.to(dtype)
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0),
                          torch.Generator().manual_seed(0))

    def port_batch(self, i=0, dtype=torch.float32):
        b = self.batches[i]
        return {"image": torch.from_numpy(b["image"]).to(dtype),
                "label": torch.from_numpy(b["label"]).long()}


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _mesh(sizes=None, names=("spatial",), devices=None):
    return create_mesh(sizes, names, devices=devices or ["cpu"] * 8)


def _assert_matches(want, state: TrainState, metrics, loss_atol=2e-4, stats_atol=5e-3,
                    param_tol=0.05):
    """The JAX test's ``_assert_matches`` (its docstring gives the envelope)."""
    want_state, want_metrics = want
    np.testing.assert_allclose(metrics["loss"].numpy(), want_metrics["loss"], rtol=0,
                               atol=loss_atol)
    ref_conf, got_conf = want_metrics["confusion"], metrics["confusion"].numpy()
    assert ref_conf.sum() == got_conf.sum()
    assert np.max(np.abs(ref_conf - got_conf)) <= 0.01 * ref_conf.sum()
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    params = {k for k, _ in state.model.named_parameters()}
    for k, a in want_state.items():
        b = got[k]
        if k in params:
            assert np.max(np.abs(a - b)) <= param_tol * max(1.0, np.max(np.abs(a))), k
        elif stats_atol is not None:
            np.testing.assert_allclose(b, a, rtol=0, atol=stats_atol, err_msg=k)


class TestSpatialTrainStep:
    def test_pure_spatial_matches_single_device(self, ref):
        """1-D ('spatial',) mesh: the batch whole, rows banded over 8 shards."""
        state = ref.port_state()
        step = make_spatial_train_step(CLASSES, _mesh(), data_axis=None)
        _assert_matches(ref.steps[0], state, step(state, ref.port_batch()))

    def test_data_x_spatial_matches_single_device(self, ref):
        """2-D (2, 4) ('data', 'spatial') mesh, the trainer's layout."""
        state = ref.port_state()
        step = make_spatial_train_step(CLASSES, _mesh((2, 4), ("data", "spatial")))
        _assert_matches(ref.steps[0], state, step(state, ref.port_batch()))

    def test_multi_step_spatial(self, ref):
        """K = 2 steps over a (2, B, H, W, ...) stack: step 1 tight, step 2
        at the JAX test's envelope (step-1 conditioning noise amplified)."""
        state = ref.port_state()
        step = make_spatial_train_step(CLASSES, _mesh((2, 4), ("data", "spatial")), steps=2)
        batches = {k: torch.stack([ref.port_batch(0)[k], ref.port_batch(1)[k]])
                   for k in ("image", "label")}
        got = step(state, batches)
        want_loss = np.array([m["loss"] for _, m in ref.steps])
        np.testing.assert_allclose(float(got["loss"][0]), want_loss[0], rtol=0, atol=2e-3)
        np.testing.assert_allclose(float(got["loss"][1]), want_loss[1], rtol=0, atol=0.1)
        # the JAX test's call: the (K, C, C) confusions stacked, 1 % of both steps' pixels
        want_m = {"loss": want_loss, "confusion": np.stack([m["confusion"] for _, m in ref.steps])}
        _assert_matches((ref.steps[1][0], want_m), state, got, loss_atol=0.1, stats_atol=None,
                        param_tol=0.4)

    def test_remat_composes(self, ref):
        """remat x SPATIAL_SHARDS: the banded forward (its halo fetches too)
        recomputed in the backward."""
        state = ref.port_state()
        step = make_spatial_train_step(CLASSES, _mesh((2, 4), ("data", "spatial")), remat=True)
        _assert_matches(ref.steps[0], state, step(state, ref.port_batch()))

    def test_backward_halos_eval_mode_grads(self, ref):
        """Eval-mode (running-statistics) gradients through the banded
        forward against JAX's, 1e-3 relative per leaf: a broken cotangent
        halo is O(1) wrong on the early convs."""
        model = ref.port_state().model.eval()
        engine = SpatialModel(model, _mesh(), spatial_axis="spatial")
        batch = ref.port_batch()
        logits = engine(engine.split(batch["image"].permute(0, 3, 1, 2)), upsample_pred=True)
        labels = Bands.split(batch["label"], engine.groups, 1)
        loss, _ = spatial_loss(logits, labels, CLASSES, 255, engine.home)
        loss.backward()
        grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
        assert set(grads) == set(ref.eval_grads)
        for k, a in ref.eval_grads.items():
            scale = np.max(np.abs(a)) + 1e-12
            assert np.max(np.abs(a - grads[k])) <= 1e-3 * scale, k

    def test_eval_step_spatial(self, ref):
        """The spatial eval step's confusion equals the single-device one's."""
        state = ref.port_state()
        got = make_spatial_eval_step(CLASSES, _mesh((2, 4), ("data", "spatial")))(
            state, ref.port_batch())
        np.testing.assert_array_equal(got["confusion"].numpy(), ref.eval_confusion)
        want = make_eval_step(CLASSES)(state, ref.port_batch())
        np.testing.assert_array_equal(got["confusion"].numpy(), want["confusion"].numpy())
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)


# -- port-only: the banded step against the port's own unbanded step ---------------
@pytest.mark.parametrize("devices,sizes,names,kw", [
    (["cpu"] * 8, (2, 4), ("data", "spatial"), {}),
    (["cpu", "cpu:0", "cpu"], None, ("spatial",), dict(accum_steps=2, max_grad_norm=0.5)),
    (["cpu", "cpu:0"] * 2, (2, 2), ("data", "spatial"), dict(freeze_bn_stats=True)),
], ids=["dropout_2x4", "replicas_accum_clip", "replicas_2x2_frozen"])
def test_banded_step_matches_unbanded(ref, devices, sizes, names, kw):
    """With ASPP's dropout on, the banded step draws the unbanded step's
    mask (one seed): in f64 (the loss and resizes round to f32 as shipped),
    loss within 1e-6, confusion equal, every state leaf within 1e-3.  With ``cpu`` and ``cpu:0`` (distinct devices to the mesh)
    the second device steps its own copy, and the copies' gradients add
    onto the model's; accumulation, clipping and frozen statistics compose."""
    plain, banded = ref.port_state(0.5, torch.float64), ref.port_state(0.5, torch.float64)
    batch = ref.port_batch(0, torch.float64)
    torch.manual_seed(11)
    want = make_train_step(CLASSES, **kw)(plain, batch)
    data_axis = "data" if "data" in names else None
    step = make_spatial_train_step(CLASSES, _mesh(sizes, names, devices), data_axis=data_axis,
                                   **kw)
    torch.manual_seed(11)
    got = step(banded, batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)
    np.testing.assert_array_equal(got["confusion"].numpy(), want["confusion"].numpy())
    for (k, a), b in zip(plain.model.state_dict().items(), banded.model.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-3, rtol=0, err_msg=k)


def test_eval_step_pads_to_the_data_axis(ref):
    """A batch of 3 over 2 data shards: padded with an ignored copy, the
    loss and confusion of the 3 images."""
    state = ref.port_state()
    batch = {k: torch.cat([v, v[:1]]) for k, v in ref.port_batch().items()}
    got = make_spatial_eval_step(CLASSES, _mesh((2, 4), ("data", "spatial")))(state, batch)
    want = make_eval_step(CLASSES)(state, batch)
    np.testing.assert_array_equal(got["confusion"].numpy(), want["confusion"].numpy())
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-6)


class TestTrainerSpatial:
    def _cfg(self, spatial):
        cfg = _tiny(get_train_cfg_defaults())
        cfg.MODEL.SYNC_BN = True
        cfg.OPTIMIZER.TYPE = "SGD"
        cfg.OPTIMIZER.BASE_LR = 0.05
        cfg.OPTIMIZER.SGD.momentum = 0.9
        cfg.SCHEDULER.TYPE = "PolyLRDecay"
        cfg.SCHEDULER.PolyLRDecay.max_iter = 100
        cfg.SCHEDULER.MAX_EPOCH = 1
        cfg.TRAIN.BATCH_SIZE = 2
        cfg.TRAIN.SPATIAL_SHARDS = spatial
        return cfg

    def test_trainer_builds_2d_mesh_and_steps(self):
        trainer = Trainer(self._cfg(4), device="cpu", devices=["cpu"] * 8)
        assert trainer.mesh.shape == {"data": 2, "spatial": 4}
        batch = _make_batch(np.random.default_rng(16))
        metrics = trainer._train_step(trainer.state, trainer._on_device(batch, False))
        assert np.isfinite(float(metrics["loss"])) and trainer.state.step == 1

    def test_trainer_rejects_per_device_bn(self):
        cfg = self._cfg(4)
        cfg.MODEL.SYNC_BN = False
        with pytest.raises(NotImplementedError, match="SPATIAL_SHARDS"):
            Trainer(cfg, device="cpu", devices=["cpu"] * 8)

    def test_trainer_rejects_device_augment(self):
        cfg = self._cfg(4)
        cfg.TRAIN.DEVICE_AUGMENT.ENABLED = True
        with pytest.raises(NotImplementedError, match="DEVICE_AUGMENT"):
            Trainer(cfg, device="cpu", devices=["cpu"] * 8)

    def test_trainer_rejects_indivisible_device_count(self):
        with pytest.raises(ValueError, match="SPATIAL_SHARDS"):
            Trainer(self._cfg(3), device="cpu", devices=["cpu"] * 8)

    def test_trainer_rejects_below_min_rows_per_shard(self):
        """The JAX trainer's guard, kept: H < OUTPUT_STRIDE x shards raises."""
        trainer = Trainer(self._cfg(4), device="cpu", devices=["cpu"] * 8)
        small = _make_batch(np.random.default_rng(17), h=16)
        with pytest.raises(ValueError, match="OUTPUT_STRIDE"):
            trainer._on_device(small, False)

    def test_trainer_rejects_bands_across_ranks(self):
        """``distributed=True`` with bands (bands across ranks) is not ported."""
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(self._cfg(2), device="cpu", distributed=True)
