"""Device + host math: GF(2^8), bit-matrices, CRC32C, the plain PyTorch
transforms (ec_kernels) and the CUDA kernel wrappers (cuda_ec)."""
