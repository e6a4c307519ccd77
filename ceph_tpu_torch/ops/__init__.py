"""Device + host math: GF(2^8), bit-matrices, CRC32C, the plain PyTorch
transforms (ec_kernels), the CUDA kernel wrappers (cuda_ec), the EC
dispatch pipeline (pipeline) and the HBM stripe cache (hbm_cache)."""
