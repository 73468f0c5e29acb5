"""Host waits on the device per TDVP step while the innermost open program
span is ``lanczos``: the growth of the program's ``waits.lanczos``
counter."""

from harness.spans import counter_delta, install  # noqa: F401


def read(probe):
    counts = counter_delta(probe)
    if not counts or not counts["tdvp.visits.fused"] + counts["tdvp.visits.unfused"]:
        return None
    return counts["waits.lanczos"] / probe.units
