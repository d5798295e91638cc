"""Hand-written CUDA kernels (sources in csrc/), each with its plain PyTorch version."""
