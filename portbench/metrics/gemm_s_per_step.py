"""Device seconds of the cuBLAS GEMM kernels (by name) per TDVP step."""

from harness.readers import gemm_s


def read(probe):
    return gemm_s(probe)
