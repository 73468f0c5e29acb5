"""The Gram eigensolver's share of its roofline: for every Gram that the
truncation solves (a wrapper on ``trunc_device.jacobi_eigh``), the least time
``jacobi_bound_ms`` of its (batch, n) shape, summed, over the device time
between CUDA events recorded around each call, summed.  The work is counted
from the shape, so another solver of the same Grams reads against the same
work."""

from harness.roofline import jacobi_bound_ms


def install(probe):
    import torch

    from renormalizer_tpu_torch.mps import trunc_device

    calls = probe.state["jacobi"] = []
    solve = trunc_device.jacobi_eigh

    def timed(g, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = solve(g, *args, **kwargs)
        end.record()
        batch = g.shape[0] if g.ndim == 3 else 1
        calls.append((batch, g.shape[-1], g.element_size(), start, end))
        return out

    probe.patch(trunc_device, "jacobi_eigh", timed)


def read(probe):
    import torch

    calls = probe.state["jacobi"]
    if not calls:
        return None
    torch.cuda.synchronize()
    bound = sum(jacobi_bound_ms(b, n, size)[0] for b, n, size, _, _ in calls)
    took = sum(start.elapsed_time(end) for _, _, _, start, end in calls)
    return 100.0 * bound / took
