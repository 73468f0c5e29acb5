"""Device-idle seconds per solve inside ``dmrg.solve`` outside the
eigensolver, truncation and environment spans: the self time of
``dmrg.solve``, ``dmrg.sweep`` and ``dmrg.update``.  With
``eig_idle_s_per_solve``, ``trunc_idle_s_per_solve`` and
``env_idle_s_per_solve`` it adds up to the idle inside ``dmrg.solve``."""

from harness.spans import idle_per_unit, install  # noqa: F401


def read(probe):
    return idle_per_unit(probe, "dmrg.solve",
                         exclude=("eig", "trunc", "trunc.jacobi", "env"))
