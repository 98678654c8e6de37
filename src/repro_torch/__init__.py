"""PyTorch/CUDA port of the geo-distributed feature store.

Sits beside the JAX package (``repro``), which stays the reference: every
ported module is held against its JAX counterpart by ``tests/test_torch_*.py``.
The package imports ``torch``, ``numpy`` and the standard library only.
Entry points run on ``device="cuda"`` unless the caller asks for the CPU.
"""
