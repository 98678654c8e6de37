"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``) and their
plain PyTorch versions."""
