"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, and the brute-force oracles (``ref``). Importing this package
builds nothing: a kernel is compiled on its first launch."""
