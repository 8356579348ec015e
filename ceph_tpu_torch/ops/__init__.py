"""Device kernels and their wrappers: GF(2^8) bit-matrix apply (rs_codec,
K1) and block crc32c (crc32c, K2). CUDA sources are in csrc/, built by
_build."""
