"""Device-idle seconds per TDVP step while the innermost open program span
is ``lanczos`` (``_lanczos_expm``)."""

from harness.spans import idle_per_unit, install  # noqa: F401


def read(probe):
    return idle_per_unit(probe, "tdvp.step", names=("lanczos",))
