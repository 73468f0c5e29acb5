"""Device-idle seconds per solve while the innermost open program span is
``trunc`` (``Mps._update_mps``, ``TTNS.update_2site``) or ``trunc.jacobi``
(the Gram eigh kernel's wrapper)."""

from harness.spans import idle_per_unit, install  # noqa: F401


def read(probe):
    return idle_per_unit(probe, "dmrg.solve", names=("trunc", "trunc.jacobi"))
