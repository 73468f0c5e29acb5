"""Device-idle seconds per solve while the innermost open program span is
``env``: the environment updates (``Environ.GetLR`` with
``method="System"``, ``TTNEnviron.update_2site``)."""

from harness.spans import idle_per_unit, install  # noqa: F401


def read(probe):
    return idle_per_unit(probe, "dmrg.solve", names=("env",))
