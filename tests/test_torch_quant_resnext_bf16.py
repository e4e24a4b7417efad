"""Port parity: int8 serving of the full-width DeepLabV3+ ResNeXt50-32x4d OS8
in bf16, against the JAX package on the same seeded weights and frames.

The network, the frames and the reasons for each tolerance are in
``test_torch_quant_resnext.py``, which holds the f32 side; this file holds
the bf16 int8 side, so that each file runs in about half a minute:

* the port's int8 logits on the JAX-written qpack lie no further from the
  JAX package's eager int8 logits than the JAX package's jitted int8 logits
  do, within a factor 1.5 of relative RMS;
* the int8-vs-float label agreement within 0.1 of the JAX package's.

Run with ``-s`` to print the readings.
"""
import numpy as np

from test_torch_quant_resnext import HW, _rel, int8_agreement_like_jax
from test_torch_quant_resnext import readings, seeded  # noqa: F401  (fixtures)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one intra-op thread)


def test_resnext50_bf16_int8_within_jax_spread(readings):  # noqa: F811
    r = readings("bfloat16")
    port, jax_jit = _rel(r["p_on_jax"], r["j_eager"]), _rel(r["j_int8"], r["j_eager"])
    first = "layer1_0/conv1"
    level = np.abs(r["p_sites"][first].astype(np.int32) - r["j_sites"][first])
    print(f"\nResNeXt50 OS8 bf16 at {HW[0]}x{HW[1]}, int8 logits against the JAX package's eager "
          f"ones, relative RMS: port on the JAX qpack {port:.4f}, JAX jitted {jax_jit:.4f}; "
          f"{first} int8 equal on {(level == 0).mean():.4f}, at most {level.max()} levels apart")
    assert port <= 1.5 * jax_jit


def test_resnext50_bf16_int8_agreement_like_jax(readings):  # noqa: F811
    int8_agreement_like_jax(readings("bfloat16"), "bfloat16")

