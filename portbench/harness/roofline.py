"""Published peaks of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense
rates) and the least time of the Gram eigenproblems the truncation solves."""

FP32_FLOPS = 67e12   # FP32 outside the tensor cores
FP64_FLOPS = 34e12   # FP64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def jacobi_bound_ms(batch, n, itemsize=4):
    """Least milliseconds of ``batch`` symmetric n x n eigendecompositions
    with eigenvectors, and what sets it: ~9 n^3 operations per matrix
    (symmetric QR with eigenvectors, Golub & Van Loan 8.3) over the peak
    rate of the element type, against each input byte read once and each
    output (V and w) written once over the HBM rate.  The work is counted
    from the shape, whatever solver runs."""
    flops = 9.0 * n ** 3 * batch
    nbytes = itemsize * batch * (2 * n * n + n)
    peak = FP32_FLOPS if itemsize <= 4 else FP64_FLOPS
    ms_ops, ms_bytes = 1e3 * flops / peak, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ms_ops, "operations") if ms_ops >= ms_bytes else (ms_bytes, "bytes")
