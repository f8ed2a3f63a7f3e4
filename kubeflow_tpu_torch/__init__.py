"""PyTorch/CUDA port of `kubeflow_tpu`, for one NVIDIA H100.

The JAX package beside this one is the reference: module names follow
it (`ops/flash.py`, `models/transformer.py`, `serving/server.py`, ...)
so each counterpart is easy to find, and the tests hold every module
here against its JAX original on the same weights and inputs.

Nothing here imports JAX or the JAX package. Entry points run on CUDA
unless the caller passes ``device="cpu"`` (`_device.resolve_device`);
every Pallas TPU kernel on a ported path is a hand-written Hopper kernel
under ``ops/csrc/``, built with ``nvcc`` at first use
(`ops/_kernels.py`), with a plain PyTorch version beside it that the
CPU path and the tests run.
"""
