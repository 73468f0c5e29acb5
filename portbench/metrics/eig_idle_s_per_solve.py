"""Device-idle seconds per solve while the innermost open program span is
``eig``: the local eigensolvers (``eigh_direct``/``eigh_iterative`` of the
MPS path, ``optimize_2site`` of the tree's), Davidson among them."""

from harness.spans import idle_per_unit, install  # noqa: F401


def read(probe):
    return idle_per_unit(probe, "dmrg.solve", names=("eig",))
