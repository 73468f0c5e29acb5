"""Readings that several per-layer metrics share."""


def gemm_s(probe):
    """Device seconds of GEMM kernels (names with "gemm") per unit."""
    seconds = probe.trace.seconds_where(lambda name: "gemm" in name.lower())
    return seconds / probe.units if seconds else None


def idle_pct(probe):
    """Share of the window without a device operation, in percent."""
    busy = probe.trace.busy_s()
    return 100.0 * (1.0 - busy / probe.window_s) if busy else None
