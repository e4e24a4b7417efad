"""PyTorch/CUDA port of ``vision_semantic_segmentation_tpu`` for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its layout
(``config/``, ``ops/``, ``geometry/``, ``mapping/``, ``models/``,
``runtime/``, ``evaluation/``) and imports nothing of it.  Each Pallas
kernel on the main path is a hand-written CUDA kernel in ``csrc/`` with a
wrapper in ``ops/kernels/``.  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
