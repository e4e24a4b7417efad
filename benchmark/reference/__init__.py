"""The benchmark's plain references: the network, the map update, SGD.

A configuration names its reference network in ``network.reference``: the
module ``benchmark/reference/<name>.py``, which the harness loads from the
run's root (``run.py::load_reference``) and hands to everything it derives
from the network: the seeded weights and the classifier's centring
(``core/weights.py``), the logit and training checks (``core/checks.py``,
``drivers/``) and the FLOP count (``counts/flops.py::forward_flops``).  A
network of another family so joins the benchmark as a configuration file and
a reference module, with no other file edited.

A reference module provides:

- ``network(net) -> nn.Module``: the network that the configuration's
  ``network`` object describes, built on the current device (``meta``
  included: the weights' shapes and the FLOP count come from a network built
  there).  The module has
  - ``forward(x, upsample=False)``: (N, 3, H, W) float32 images to logits at
    the network's own output resolution, or at (H, W) with ``upsample``;
  - ``set_quant(quant, grad_quant=None)``: the control's hook, a function
    applied to every convolution's input and weight before it runs, and one
    to the gradient of its output;
  - for a training configuration, ``aspp.mask``, the dropout mask of a
    training forward as a function of its shape, which
    ``reference/train.py::sgd_steps``' caller sets.
  Its state dict is the program's: the same keys, shapes and meaning.
  Every convolution is an ``nn.Conv2d`` (the FLOP count hooks them).
- ``classifier_bias(net) -> str``: the state-dict key of the classifier's
  bias, which ``center_classifier`` re-centres.
- ``residual_bn_weights(net, keys) -> set``: of the state-dict ``keys``, the
  weights of each residual branch's last BatchNorm, which ``make_state_dict``
  sets to the configuration's ``weights.residual_bn_weight``.

A reference imports nothing of the measured program, only ``torch``,
``numpy``, the standard library's ``math`` and ``typing``, and
``benchmark.reference``: ``deeplab.py``'s ``DeepLabV3Plus`` takes a backbone
module, and its ``ASPP``, ``Decoder``, ``ConvBNReLU``, ``SeparableConv``,
``fp8_quant``, ``fp8_grad_quant`` and ``normalize`` serve every DeepLabV3+.
"""
