"""PyTorch/CUDA port of dt4image_restoration_tpu for one NVIDIA H100.

Same layout and public names as the JAX package beside it, which stays the
reference it is tested against; this package imports none of it. The three
Pallas TPU kernels of the evaluation path are hand-written CUDA C++ kernels
here (``csrc/``, wrapped in ``ops/kernels/``). Entry points run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
