"""Training steps through the Trainer, fed batches already on the card.

The loader is bypassed: set-up makes a pool of batches of crops on the card
from the seed (``core/traffic.py::train_batches``), and the feed hands them
to the Trainer in turn, each as a staged window on the device
(``runtime/replay.py::StagedWindow``), as the Trainer's prefetcher hands a
staged batch.  The window so measures the training step (forward, loss,
backward and SGD on the card) and the Trainer's loop around it, and not the
host's decode and augmentation.

Set-up builds one ``Trainer`` over the configuration, loads the weights
made from the seed and drives it with the window's own call
(``Trainer.train_one_epoch``) and feed: the first ``check_steps`` steps one
call a step (the first step's predictions, the optimizer's first gradient
and the parameters after them are kept for the check), then
``warmup_steps`` in one call.  The window runs epoch after epoch (an epoch
is a pass over the pool) on that same object until ``--seconds`` have
passed: a timer asks the Trainer to stop (``request_preempt``), which it
does at the next step boundary.  Validation and checkpoints stay out.

End to end: ``images_per_s``, every image stepped over the window's time.
Checked against the plain reference on the same batches and dropout masks:

- the set-up's steps, which the reference takes from the same weights:
  each step's loss, the first step's predictions, the first gradient as the
  optimizer took it (by the worst leaf) and the parameters' change after
  the steps (by the median leaf);
- one step of the window, drawn from the seed among ``probe_units``: the
  program's parameters and momentum buffers are copied on the card before
  it and after it, and the reference takes the same step from the state
  before: its loss, its gradient as the optimizer took it (the momentum
  buffer's increment) and the parameters' change, by the worst leaf.
"""
from __future__ import annotations

import math
import random
import threading
import time

import torch
import torch.nn.functional as F

from ..core.checks import leaf_gap, reference_network
from ..core.portcfg import train_cfg
from ..core.traffic import sub_seed, train_batches
from ..core.weights import make_state_dict
from ..reference.deeplab import fp8_grad_quant, fp8_quant
from ..reference.train import confusion, sgd_steps
from .replay import launches

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Driver:
    def __init__(self, run):
        self.run = run

    def sync(self) -> None:
        if self.run.device == "cuda":
            torch.cuda.synchronize()

    def rng(self) -> torch.Tensor:
        """Where the device's default generator, which dropout draws from, stands."""
        return torch.cuda.get_rng_state() if self.run.device == "cuda" else torch.get_rng_state()

    def setup(self) -> None:
        from vision_semantic_segmentation_tpu_torch.runtime.replay import StagedWindow
        from vision_semantic_segmentation_tpu_torch.train.trainer import Trainer

        run, conf = self.run, self.run.config
        train = conf["train"]
        marks = [("start", time.perf_counter())]
        if run.device == "cuda":
            from vision_semantic_segmentation_tpu_torch.ops import kernels as K

            K.build_all()
        marks.append(("kernels", time.perf_counter()))
        self.staged = StagedWindow
        self.pool = train_batches(run.seed, run.traffic["batches"], int(train["batch_size"]),
                                  int(train["crop"]), int(conf["network"]["num_classes"]),
                                  run.device)
        cfg = train_cfg(conf, "", "", sub_seed(run.seed, 4) % (1 << 31))
        marks.append(("batches", time.perf_counter()))
        self.trainer = Trainer(cfg, device=run.device)
        marks.append(("trainer", time.perf_counter()))
        self.state_dict = make_state_dict(run.reference, conf["network"], sub_seed(run.seed, 0),
                                          run.device, torch.float32,
                                          conf["weights"]["residual_bn_weight"])
        self.trainer.model.load_state_dict(self.state_dict, strict=True)
        marks.append(("weights", time.perf_counter()))
        self.params = dict(self.trainer.model.named_parameters())
        self.next = 0  # the step whose batch the feed hands next
        self.check_batches, self.probe = [], {}
        self.probe_unit = random.Random(sub_seed(run.seed, 3)).randrange(
            *run.traffic["probe_units"])

        # where the default generator stands when the first step draws its
        # dropout mask
        self.rng_state = self.rng()
        for k in range(int(run.traffic["check_steps"])):
            self.trainer.train_one_epoch(self.feed(1, keep=True), 0)
            if k == 0:
                # the first step's predictions, as its confusion matrix (the
                # Trainer's training metric holds that step's alone)
                self.confusion = torch.as_tensor(self.trainer.train_metric.confusion_matrix.copy())
                self.first_grad = self.buffers()
        self.change = {n: (p.detach() - self.state_dict[n]).clone()
                       for n, p in self.params.items()}
        self.losses = [h["loss"] for h in self.trainer.history]
        marks.append(("check steps", time.perf_counter()))
        self.trainer.train_one_epoch(self.feed(int(run.traffic["warmup_steps"])), 0)
        self.sync()
        marks.append(("warm-up steps", time.perf_counter()))
        self.setup_note = "set-up: " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:]))

    def batch(self, step: int):
        i = step % self.pool["image"].shape[0]
        return self.staged({"image": self.pool["image"][i], "label": self.pool["label"][i]})

    def feed(self, steps: int, keep: bool = False):
        """The pool's next ``steps`` batches, in turn."""
        for _ in range(steps):
            b = self.batch(self.next)
            if keep:
                self.check_batches.append(b)
            self.next += 1
            yield b

    def buffers(self):
        """Copies of the optimizer's momentum buffers (zeros where it keeps none)."""
        state = self.trainer.state.optimizer.state
        return {n: (state[p]["momentum_buffer"].detach().clone()
                    if "momentum_buffer" in state.get(p, {}) else torch.zeros_like(p))
                for n, p in self.params.items()}

    def snapshot(self):
        return {"params": {n: p.detach().clone() for n, p in self.params.items()},
                "bufs": self.buffers()}

    def _ticked(self, counter):
        """One epoch of the feed: each step a unit of the traced part, and
        the state copied before and after the probe's step."""
        for _ in range(self.pool["image"].shape[0]):
            unit = counter[0]
            if unit == self.probe_unit + 1:
                self.probe["after"] = self.snapshot()
            self.run.trace_tick(unit, launches())
            if unit == self.probe_unit:
                self.probe.update(before=self.snapshot(), batch=self.batch(self.next),
                                  step=self.next, rng=self.rng())
            counter[0] += 1
            yield from self.feed(1)

    def window(self) -> dict:
        run, trainer = self.run, self.trainer
        self.sync()
        n0 = len(trainer.history)
        timer = threading.Timer(run.seconds, trainer.request_preempt)
        counter = [0]
        t0 = time.perf_counter()
        timer.start()
        epoch = 1
        while not trainer._preempted:
            trainer.train_one_epoch(self._ticked(counter), epoch)
            epoch += 1
        self.sync()
        elapsed = time.perf_counter() - t0
        timer.cancel()
        run.finish_trace(launches())
        steps = trainer.history[n0:]
        if "before" in self.probe:
            # the Trainer stopped before asking for the batch after the probe's
            self.probe.setdefault("after", self.snapshot())
            # the history counts steps taken: the probe's is its step + 1
            self.probe["loss"] = next((h["loss"] for h in steps
                                       if h["step"] == self.probe["step"] + 1), None)
        batch = int(run.config["train"]["batch_size"])
        images = batch * len(steps)
        return {"end_to_end": {"images_per_s": images / elapsed},
                "attempted": len(steps), "failed": 0, "seconds": elapsed, "unit_work": batch,
                "notes": [self.setup_note,
                          f"window: {len(steps)} steps, {images} images in {elapsed:.3f} s, "
                          f"epochs 1-{epoch - 1}; probe: unit {self.probe_unit}, step "
                          f"{self.probe.get('step')}"]}

    def release(self) -> None:
        self.sync()
        del self.trainer, self.params
        keep = lambda b: {k: v.clone() for k, v in b.items()}  # noqa: E731
        self.check_batches = [keep(b) for b in self.check_batches]
        if "batch" in self.probe:
            self.probe["batch"] = keep(self.probe["batch"])
        del self.pool
        if self.run.device == "cuda":
            torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------
    def masks(self, state: torch.Tensor):
        """The dropout masks the program's steps drew, drawn again: the
        device's default generator put back to ``state``, one dropout of
        ones a step in the configuration's compute type and memory layout."""
        dev = torch.device(self.run.device)
        if dev.type == "cuda":
            torch.cuda.set_rng_state(state)
        else:
            torch.set_rng_state(state)
        dtype = DTYPES[self.run.config["train"]["compute_dtype"]]
        p = float(self.run.config["network"]["aspp_dropout"])

        def mask(shape):
            ones = torch.ones(shape, dtype=dtype, device=dev).contiguous(
                memory_format=torch.channels_last)
            return F.dropout(ones, p, True) != 0

        return mask

    def reference(self, state_dict, rng, quant: bool):
        run = self.run
        model = reference_network(run.reference, run.config["network"], state_dict, run.device,
                                  training=True)
        if quant:
            model.set_quant(fp8_quant, fp8_grad_quant)
        model.aspp.mask = self.masks(rng)
        return model

    @staticmethod
    def compared(raw):
        """The leaves compared: all but those whose reference gradient lies
        under a thousandth of the median leaf's (nought to rounding)."""
        norms = {n: float(g.double().norm()) for n, g in raw.items()}
        med = sorted(norms.values())[len(norms) // 2]
        return [n for n, v in norms.items() if v >= 1e-3 * med]

    @staticmethod
    def as_nchw(b):
        return b["image"].permute(0, 3, 1, 2).float(), b["label"].long()

    def check(self):
        run, conf = self.run, self.run.config
        train, classes = conf["train"], int(conf["network"]["num_classes"])
        batches = [self.as_nchw(b) for b in self.check_batches]

        def steps(quant):
            model = self.reference(self.state_dict, self.rng_state, quant)
            losses, first, raw, preds = sgd_steps(model, train, batches)
            change = {n: p.detach() - self.state_dict[n] for n, p in model.named_parameters()}
            return losses, first, raw, change, confusion(preds, batches[0][1], classes).double().cpu()

        losses, first, raw, ref_change, ref_conf = steps(False)
        if run.control:
            prog_losses, prog_first, _, prog_change, prog_conf = steps(True)
        else:
            prog_losses, prog_first, prog_change = self.losses, self.first_grad, self.change
            prog_conf = self.confusion
        keep = self.compared(raw)
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(prog_losses, losses)]
        grad_gap, grad_leaf, grad_median = leaf_gap(prog_first, first, keep)
        # the change after the set-up's steps by its median leaf: the worst
        # leaf's reads a tenth on sound runs (printed for the record)
        change_worst, change_leaf, change_gap = leaf_gap(prog_change, ref_change, keep)
        # pixels of the first batch predicted otherwise, at least
        pred_diff = float((prog_conf - ref_conf).abs().sum() / (2 * ref_conf.sum()))
        print(f"train check: losses {prog_losses} against {losses}; {len(keep)} of "
              f"{len(raw)} leaves compared; gradient: worst leaf {grad_leaf} {grad_gap}, "
              f"median leaf {grad_median}; change: worst leaf {change_leaf} {change_worst}, "
              f"median leaf {change_gap}", flush=True)
        del raw, first, ref_change, prog_first, prog_change
        step_loss, step_grad, step_change = self.probe_readings(run.control)
        lim = conf["limits"]
        return [("pred_diff", pred_diff, lim["pred_diff"]),
                ("loss_gap", max(loss_gaps), lim["loss_gap"]),
                ("grad_gap", grad_gap, lim["grad_gap"]),
                ("change_gap", change_gap, lim["change_gap"]),
                ("step_loss_gap", step_loss, lim["step_loss_gap"]),
                ("step_grad_gap", step_grad, lim["step_grad_gap"]),
                ("step_change_gap", step_change, lim["step_change_gap"])]

    def probe_readings(self, control: bool):
        """The window's probed step against the reference's step from the
        program's state before it: the loss gap, and the worst leaf of the
        gradient as the optimizer took it and of the change.  A probe the
        window never reached reads infinite: its answer never came."""
        probe, conf = self.probe, self.run.config
        if probe.get("loss") is None:
            print(f"probe: unit {self.probe_unit} was not stepped in the window", flush=True)
            return math.inf, math.inf, math.inf
        before, after, train = probe["before"], probe["after"], conf["train"]
        state_dict = dict(self.state_dict, **before["params"])
        batch = [self.as_nchw(probe["batch"])]

        def step(quant):
            model = self.reference(state_dict, probe["rng"], quant)
            losses, taken, raw, _ = sgd_steps(model, train, batch, start=probe["step"],
                                              bufs=before["bufs"])
            change = {n: p.detach() - before["params"][n] for n, p in model.named_parameters()}
            return losses[0], taken, raw, change

        ref_loss, ref_taken, raw, ref_change = step(False)
        if control:
            loss, taken, _, change = step(True)
        else:
            m = float(train["momentum"])
            loss = probe["loss"]
            taken = {n: after["bufs"][n] - m * before["bufs"][n] for n in ref_taken}
            change = {n: after["params"][n] - before["params"][n] for n in ref_change}
        keep = self.compared(raw)
        loss_gap = abs(loss - ref_loss) / abs(ref_loss)
        grad_gap, grad_leaf, grad_median = leaf_gap(taken, ref_taken, keep)
        change_gap, change_leaf, change_median = leaf_gap(change, ref_change, keep)
        print(f"probe: step {probe['step']} loss {loss} against {ref_loss}; {len(keep)} of "
              f"{len(raw)} leaves compared; gradient: worst leaf {grad_leaf} {grad_gap}, "
              f"median leaf {grad_median}; change: worst leaf {change_leaf} {change_gap}, "
              f"median leaf {change_median}", flush=True)
        return loss_gap, grad_gap, change_gap
