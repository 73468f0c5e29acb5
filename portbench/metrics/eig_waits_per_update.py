"""Host waits on the device per site update while the innermost open
program span is ``eig``: the growth of the program's ``waits.eig``
counter over that of ``dmrg.updates``."""

from harness.spans import counter_delta, install  # noqa: F401


def read(probe):
    counts = counter_delta(probe)
    if not counts or not counts["dmrg.updates"]:
        return None
    return counts["waits.eig"] / counts["dmrg.updates"]
