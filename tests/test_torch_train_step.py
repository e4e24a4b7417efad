"""Port parity: the single-device train step against ``make_train_step``.

The same numpy-seeded batch goes through the JAX package's jitted
``make_train_step`` and the port's, from the same weights (flax variables
with BatchNorm drawn at random, crossed through ``flax_to_state_dict``) and
the same optimizer config (SGD, momentum 0.9, weight decay 1e-4, poly LR).
The port's ASPP depthwise convs run ``DepthwiseBranches`` on K4's plain
version, with its own backward (the flipped-tap dgrad and the wgrad), as
on the card.

Tolerances: the loss within 1e-5 relative, the confusion exactly, and
every parameter and BatchNorm running statistic, leaf by leaf, within
1e-5 absolute after one and three updates.  The Dummy model runs in f32,
three steps in a row.

DeepLabV3+ runs in f64 on both sides (``jax.enable_x64`` and
``model.double()``).  In f32 it is ill-conditioned in training mode at
batch 2: ASPP's pooled branch normalises 2 values a channel, and
BatchNorm's backward there turns rounding noise, summed in another order,
into gradient differences of several per cent.  Both packages also round
to f32 on purpose in the align-corners resizes and in the loss, and the
two libraries' f32 einsums and log-softmaxes differ in the last bit.  A
last-bit difference at the first step moves the parameters by about 1e-8,
and at the second step a ReLU whose input lies within that of zero flips
(one in the decoder does here), which moves every gradient by about
0.3 %.  So for these tests both packages resize and take the loss in f64
and round their results to the shipped type: both then see the same
bits, and what is left is f64 noise, far below 1e-5.  The shipped f32
resize and loss are held against the JAX package by the Dummy model's
steps below and by their own tests.

DeepLabV3+'s three steps each start from JAX's state before them (its
weights, BatchNorm statistics and SGD momentum), and the momentum after
each step is held too, leaf by leaf within 1e-5.  Training from these
random weights is chaotic: JAX's own run, with its initial weights moved
by 1e-9 relative, ends 1e-3 away after two steps and 5e-2 after three, so
a free run of three steps would compare that chaos, not the port.

Each JAX program compiles once per module (module-scoped fixtures):
DeepLabV3+ resnet18 OS16 at 65x65, batch 2, plain, and with gradient
accumulation (2 micro-batches), global-norm clipping and frozen BatchNorm
statistics in one program; the Dummy model with each of those alone.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vision_semantic_segmentation_tpu.config import get_train_cfg_defaults as j_train_cfg
from vision_semantic_segmentation_tpu.models import aspp as j_aspp
from vision_semantic_segmentation_tpu.models import decoder as j_decoder
from vision_semantic_segmentation_tpu.models import deeplab as j_deeplab
from vision_semantic_segmentation_tpu.models.build import build_model as j_build_model
from vision_semantic_segmentation_tpu.ops import resize as j_resize
from vision_semantic_segmentation_tpu.parallel import train_step as j_train_step
from vision_semantic_segmentation_tpu.parallel.train_step import TrainState as JState
from vision_semantic_segmentation_tpu.parallel.train_step import make_train_step as j_make_step
from vision_semantic_segmentation_tpu.train.optim import build_optimizer as j_build_optimizer
from vision_semantic_segmentation_tpu.train.optim import build_schedule as j_build_schedule
from vision_semantic_segmentation_tpu_torch.config import get_train_cfg_defaults
from vision_semantic_segmentation_tpu_torch.models import build_train_model, flax_to_state_dict
from vision_semantic_segmentation_tpu_torch.models import resize as p_model_resize
from vision_semantic_segmentation_tpu_torch.ops import resize as p_resize
from vision_semantic_segmentation_tpu_torch.models.layers import BatchNorm2d
from vision_semantic_segmentation_tpu_torch.parallel import TrainState, make_eval_step, make_train_step
from vision_semantic_segmentation_tpu_torch.parallel import train_step as p_train_step
from vision_semantic_segmentation_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    build_scheduler,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)

CLASSES = 6
HW = 65
OVERRIDES = [
    "DATASET.NUM_CLASSES", CLASSES, "MODEL.BACKBONE", "resnet18", "MODEL.OUTPUT_STRIDE", 16,
    "MODEL.ASPP.DROPOUT", 0.0, "OPTIMIZER.TYPE", "SGD", "OPTIMIZER.BASE_LR", 0.01,
    "OPTIMIZER.WEIGHT_DECAY", 1e-4, "OPTIMIZER.SGD.momentum", 0.9,
    "SCHEDULER.TYPE", "PolyLRDecay", "SCHEDULER.PolyLRDecay.max_iter", 10,
]


def _cfgs(model_type: str):
    out = []
    for make in (j_train_cfg, get_train_cfg_defaults):
        cfg = make()
        cfg.merge_from_list([str(v) if not isinstance(v, str) else v for v in OVERRIDES])
        cfg.MODEL.TYPE = model_type
        out.append(cfg)
    return out


def _randomize_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _randomize_bn(v, rng)
            continue
        v = np.asarray(v, dtype=np.float32)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        out[k] = v
    return out


def _batch(rng, n=2):
    image = rng.standard_normal((n, HW, HW, 3)).astype(np.float32)
    label = rng.integers(0, CLASSES, (n, HW, HW)).astype(np.int32)
    label[:, :5, :7] = 255  # ignored pixels
    return image, label


class Setup:
    """One model on both sides from the same variables, and a batch."""

    def __init__(self, model_type: str, seed: int):
        rng = np.random.default_rng(seed)
        jcfg, cfg = _cfgs(model_type)
        self.jmodel, *_ = j_build_model(jcfg)
        variables = jax.jit(lambda k, x: self.jmodel.init(k, x, train=False))(
            jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 3)))
        self.variables = _randomize_bn(jax.tree.map(np.asarray, dict(variables)), rng)
        self.jtx = j_build_optimizer(jcfg, j_build_schedule(jcfg))
        self.cfg = cfg
        self.batches = [_batch(rng) for _ in range(3)]

    def jax_state(self, dtype=np.float32):
        variables = jax.tree.map(lambda v: np.asarray(v, dtype), self.variables)
        return JState.create(self.jmodel, variables, self.jtx, jax.random.PRNGKey(0))

    def port_state(self, dtype=torch.float32) -> TrainState:
        model, *_ = build_train_model(self.cfg, device="cpu")
        model.load_state_dict(flax_to_state_dict(self.variables), strict=True)
        model.to(dtype)
        opt = build_optimizer(self.cfg, model.parameters())
        return TrainState(model, opt, build_scheduler(opt, build_schedule(self.cfg)),
                          torch.Generator().manual_seed(0))

    def port_batch(self, i, dtype=torch.float32):
        image, label = self.batches[i]
        return {"image": torch.from_numpy(image).to(dtype), "label": torch.from_numpy(label).long()}

    def jax_batch(self, i, dtype=np.float32):
        image, label = self.batches[i]
        return {"image": jnp.asarray(image.astype(dtype)), "label": jnp.asarray(label)}


def _flat(jstate):
    """The JAX state as the port's state dict (numpy leaves)."""
    out = flax_to_state_dict({"params": jax.tree.map(np.asarray, jstate.params),
                              "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    return {k: v.numpy() for k, v in out.items() if not k.endswith("num_batches_tracked")}


def _momentum(jstate):
    """The SGD momentum (optax's trace) as the port's parameter names."""
    (trace,) = [st.trace for st in jstate.opt_state if hasattr(st, "trace")]
    out = flax_to_state_dict({"params": jax.tree.map(np.asarray, trace), "batch_stats": {}})
    return {k: v.numpy() for k, v in out.items()}


def _metrics(jm):
    return {"loss": float(jm["loss"]), "confusion": np.asarray(jm["confusion"])}


def _compare(want_state, want_m, state: TrainState, m, want_momentum=None) -> None:
    """The tolerances of the module docstring, leaf by leaf."""
    np.testing.assert_allclose(float(m["loss"]), want_m["loss"], rtol=1e-5)
    np.testing.assert_array_equal(m["confusion"].numpy(), want_m["confusion"])
    got = state.model.state_dict()
    for k, v in want_state.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, rtol=0, err_msg=k)
    if want_momentum is not None:
        params = dict(state.model.named_parameters())
        for k, v in want_momentum.items():
            buf = state.optimizer.state[params[k]]["momentum_buffer"]
            np.testing.assert_allclose(buf.numpy(), v, atol=1e-5, rtol=0, err_msg=k)


def _load(state: TrainState, flat, momentum) -> None:
    """Put JAX's weights, BatchNorm statistics and momentum into ``state``."""
    model = state.model
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if k in flat:
                t.copy_(torch.from_numpy(flat[k]))
    for k, p in model.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = torch.from_numpy(momentum[k]).clone()


def _jax_resize_f64(x, out_hw):
    """The JAX package's align-corners resize summed in f64, in x's type."""
    (h, w), (oh, ow) = x.shape[-3:-1], out_hw
    if (h, w) == (oh, ow):
        return x
    y = j_resize._separable_resize(x.astype(jnp.float64), j_resize._align_corners_matrix(h, oh),
                                   j_resize._align_corners_matrix(w, ow))
    return y.astype(x.dtype)


def _port_resize_f64(x, out_hw):
    """The port's align-corners resize summed in f64, in x's type."""
    (h, w), (oh, ow) = x.shape[-3:-1], out_hw
    if (h, w) == (oh, ow):
        return x
    mh, mw = (torch.from_numpy(p_resize._align_corners_matrix(i, o)).double()
              for i, o in ((h, oh), (w, ow)))
    y = torch.einsum("oh,...hwc->...owc", mh, x.double())
    return torch.einsum("ow,...hwc->...hoc", mw, y).to(x.dtype)


def _jax_loss_f64(logits, labels, ignore_index=255):
    """The JAX package's cross entropy in f64 (its value as f32)."""
    valid = labels != ignore_index
    safe = jnp.where(valid, labels, 0).astype(jnp.int32)
    log_probs = jax.nn.log_softmax(logits.astype(jnp.float64), axis=-1)
    nll = -jnp.take_along_axis(log_probs, safe[..., None], axis=-1)[..., 0]
    w = valid.astype(jnp.float64)
    return (jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1e-12)).astype(jnp.float32)


def _port_loss_f64(logits, labels, ignore_index=255):
    """The port's cross entropy in f64 (its value as f32)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    nll = -F.log_softmax(logits.double(), dim=1).gather(1, safe.unsqueeze(1)).squeeze(1)
    w = valid.double()
    return ((nll * w).sum() / w.sum().clamp_min(1e-12)).float()


@pytest.fixture
def f64_rounding(monkeypatch):
    """The port's resizes and loss in f64, as the module docstring says."""
    monkeypatch.setattr(p_model_resize, "resize_align_corners", _port_resize_f64)
    monkeypatch.setattr(p_train_step, "cross_entropy_loss", _port_loss_f64)


@contextlib.contextmanager
def _jax_f64():
    """x64 on, and the JAX package's resizes and loss in f64 (see the
    module docstring)."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for module in (j_aspp, j_decoder, j_deeplab):
            mp.setattr(module, "resize_align_corners", _jax_resize_f64)
        mp.setattr(j_train_step, "cross_entropy_loss", _jax_loss_f64)
        yield


@pytest.fixture(scope="module")
def deeplab():
    """The JAX side's results in f64: the state, momentum and metrics after
    each of three plain steps."""
    s = Setup("DeepLabv3+", seed=0)
    with _jax_f64():
        plain = jax.jit(j_make_step(CLASSES))
        jstate = s.jax_state(np.float64)
        s.want = {}
        for i in range(3):
            jstate, jm = plain(jstate, s.jax_batch(i, np.float64))
            s.want[i + 1] = (_flat(jstate), _metrics(jm), _momentum(jstate))
    return s


@pytest.fixture(scope="module")
def deeplab_combined(deeplab):
    """One step of the accumulated, clipped, frozen-statistics program in
    f64 (its own fixture, so that its compile is not added to another
    test's)."""
    with _jax_f64():
        combined = jax.jit(j_make_step(CLASSES, accum_steps=2, max_grad_norm=0.5,
                                       freeze_bn_stats=True))
        jstate, jm = combined(deeplab.jax_state(np.float64), deeplab.jax_batch(0, np.float64))
        return _flat(jstate), _metrics(jm), _momentum(jstate)


@pytest.fixture(scope="module")
def dummy():
    s = Setup("Dummy", seed=1)
    s.steps = {
        "plain": {},
        "accum": dict(accum_steps=2),
        "clip": dict(max_grad_norm=0.05),
    }
    s.jsteps = {k: jax.jit(j_make_step(CLASSES, **kw)) for k, kw in s.steps.items()}
    return s


class TestDeepLabStep:
    @pytest.mark.parametrize("steps", [1, 3])
    def test_matches_jax(self, deeplab, f64_rounding, steps):
        """``steps`` steps in a row, each from JAX's state before it."""
        state = deeplab.port_state(torch.float64)
        step = make_train_step(CLASSES)
        for i in range(steps):
            if i:
                want_state, _, want_momentum = deeplab.want[i]
                _load(state, want_state, want_momentum)
            m = step(state, deeplab.port_batch(i, torch.float64))
            want_state, want_m, want_momentum = deeplab.want[i + 1]
            _compare(want_state, want_m, state, m, want_momentum)
        assert state.step == steps

    def test_accum_clip_frozen_stats_match_jax(self, deeplab, deeplab_combined, f64_rounding):
        state = deeplab.port_state(torch.float64)
        before = {k: v.clone() for k, v in state.model.state_dict().items() if "running" in k}
        m = make_train_step(CLASSES, accum_steps=2, max_grad_norm=0.5,
                            freeze_bn_stats=True)(state, deeplab.port_batch(0, torch.float64))
        want_state, want_m, want_momentum = deeplab_combined
        _compare(want_state, want_m, state, m, want_momentum)
        for k, v in before.items():
            assert torch.equal(state.model.state_dict()[k], v), k

    def test_running_variance_is_biased(self, deeplab):
        """ASPP's pooled branch sees one value a channel and frame: with
        batch 2 the biased variance is half PyTorch's unbiased one."""
        state = deeplab.port_state()
        bn = state.model.aspp.global_avg_pool[1].bn
        assert isinstance(bn, BatchNorm2d)
        seen = {}
        bn.register_forward_hook(lambda mod, inp, out: seen.setdefault("x", inp[0].detach()))
        old = bn.running_var.clone()
        make_train_step(CLASSES)(state, deeplab.port_batch(0))
        var = seen["x"].var(dim=(0, 2, 3), unbiased=False)
        np.testing.assert_allclose(bn.running_var.numpy(), (0.9 * old + 0.1 * var).numpy(),
                                   rtol=1e-6, atol=1e-7)

    def test_remat_bit_identical(self, deeplab):
        a, b = deeplab.port_state(), deeplab.port_state()
        ma = make_train_step(CLASSES)(a, deeplab.port_batch(1))
        mb = make_train_step(CLASSES, remat=True)(b, deeplab.port_batch(1))
        assert torch.equal(ma["loss"], mb["loss"])
        assert torch.equal(ma["confusion"], mb["confusion"])
        for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
            assert torch.equal(va, vb), k

    def test_eval_step_uses_running_stats(self, deeplab):
        state = deeplab.port_state()
        jvars = deeplab.variables
        image, label = deeplab.batches[2]
        m = make_eval_step(CLASSES)(state, deeplab.port_batch(2))
        logits = deeplab.jmodel.apply(jvars, jnp.asarray(image), train=False)
        from vision_semantic_segmentation_tpu.models.loss import cross_entropy_loss
        np.testing.assert_allclose(float(m["loss"]),
                                   float(cross_entropy_loss(logits, jnp.asarray(label))),
                                   rtol=1e-5)
        assert state.model.training  # the eval step restores the mode


class TestDummyStep:
    @pytest.mark.parametrize("kind", ["plain", "accum", "clip"])
    def test_matches_jax(self, dummy, kind):
        jstate, state = dummy.jax_state(), dummy.port_state()
        step = make_train_step(CLASSES, **dummy.steps[kind])
        for i in range(3):
            jstate, jm = dummy.jsteps[kind](jstate, dummy.jax_batch(i))
            m = step(state, dummy.port_batch(i))
        _compare(_flat(jstate), _metrics(jm), state, m)


def test_dropout_statistics():
    """ASPP's dropout at rate 0.5 in training: about half the activations
    zeroed, the rest doubled (the JAX package's inverted dropout; the two
    draw different masks)."""
    drop = torch.nn.Dropout(0.5).train()
    torch.manual_seed(0)
    x = torch.ones(200_000)
    y = drop(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.01
    assert torch.all((y == 0) | (y == 2.0))
    jy = jax.random.bernoulli(jax.random.PRNGKey(0), 0.5, (200_000,))
    assert abs(float(jy.mean()) - kept) < 0.01
