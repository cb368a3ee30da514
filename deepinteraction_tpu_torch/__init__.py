"""PyTorch + CUDA port of ``deepinteraction_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside it is the reference; each module here mirrors the
JAX module of the same path and is checked against it on the CPU
(``tests/test_torch_port_*.py``). The port imports ``torch``, ``numpy`` and
``deepinteraction_tpu.configs`` (plain dataclasses), never JAX.
"""
