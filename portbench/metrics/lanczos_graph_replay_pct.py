"""Share of the Lanczos exponentials of the traced TDVP steps that replayed
a captured CUDA graph, in percent: the growth of the program's
``lanczos.graph.replays`` over that of ``lanczos.calls``.  A program that
counts no ``lanczos.graph.*`` reads as None."""

from harness.spans import counter_delta, install  # noqa: F401


def read(probe):
    counts = counter_delta(probe)
    if not counts or not counts["lanczos.calls"]:
        return None
    if not any(k.startswith("lanczos.graph.") for k in counts):
        return None
    return 100.0 * counts["lanczos.graph.replays"] / counts["lanczos.calls"]
