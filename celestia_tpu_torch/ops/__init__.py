"""The port's compute path: RS extension, SHA-256 and NMT trees, with the
CUDA kernels K1-K3 (csrc/) behind the wrappers in rs_cuda and sha256_cuda."""
