"""cosmos_predict2_tpu_torch — the PyTorch / CUDA port of cosmos_predict2_tpu.

The JAX package beside it is the reference: every module here mirrors the
module of the same path there and is held against it numerically by the
``tests/test_torch_*.py`` suite. Plain tensor code is PyTorch; every Pallas
kernel of the reference on the ported path is a CUDA C++ kernel written by
hand for Hopper (``csrc/``), built with ``nvcc`` at first use
(``_build.py``) and bound with ``ctypes``.

Layouts at public functions follow the reference: BSHD for attention,
channels-last NDHWC for the VAE and its convs, (B, C, T, H, W) latents.
This package never imports ``jax``.
"""

__version__ = "0.1.0"
