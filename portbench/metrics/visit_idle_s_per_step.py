"""Device-idle seconds per TDVP step inside ``tdvp.step`` outside the
``lanczos`` spans: the site visits' own host work (QR splits, environment
updates, the step's set-up).  With ``lanczos_idle_s_per_step`` it adds up
to the idle inside ``tdvp.step``."""

from harness.spans import idle_per_unit, install  # noqa: F401


def read(probe):
    return idle_per_unit(probe, "tdvp.step", exclude=("lanczos",))
