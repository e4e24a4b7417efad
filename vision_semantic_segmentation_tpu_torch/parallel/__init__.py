"""Training steps of the port (one device; the data-parallel, per-device
BatchNorm and spatial steps wait, ROADMAP queue 1 item 6)."""
from .train_step import TrainState, make_eval_step, make_train_step

__all__ = ["TrainState", "make_eval_step", "make_train_step"]
