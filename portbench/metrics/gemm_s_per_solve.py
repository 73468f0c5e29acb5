"""Device seconds of the cuBLAS GEMM kernels (by name) per solve."""

from harness.readers import gemm_s


def read(probe):
    return gemm_s(probe)
