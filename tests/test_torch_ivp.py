"""The port's adaptive RKF45 ``solve_ivp`` against the JAX package's, fp64 on
the CPU: the same seeded linear ODE, the same controller decisions (accepted
and attempted steps, right-hand-side evaluations) and the same final state;
both against ``scipy.linalg.expm``."""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp
from renormalizer_tpu.lib import solvers as jsolvers
from renormalizer_tpu_torch.lib import solvers

torch.set_num_threads(2)


def _hamiltonian(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    h = (a + a.conj().T) / 2
    y0 = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return h, y0 / np.linalg.norm(y0)


@pytest.mark.parametrize("rtol,atol", [(1e-5, 1e-8), (1e-8, 1e-11)])
def test_solve_ivp_matches_jax(rtol, atol):
    """Complex y' = -iHy, n = 40, to t = 2."""
    h, y0 = _hamiltonian(40)
    ht = torch.as_tensor(h)
    hj = jnp.asarray(h)
    ours = solvers.solve_ivp(lambda t, y: -1j * (ht @ y), (0.0, 2.0),
                             torch.as_tensor(y0), rtol=rtol, atol=atol)
    theirs = jsolvers.solve_ivp(lambda t, y: -1j * (hj @ y), (0.0, 2.0),
                                jnp.asarray(y0), rtol=rtol, atol=atol)
    assert (ours.nsteps, ours.nfev) == (theirs.nsteps, theirs.nfev)
    assert ours.t == pytest.approx(theirs.t, abs=1e-14)
    y, yj = ours.y.numpy(), np.asarray(theirs.y)
    assert np.abs(y - yj).max() < 1e-12
    exact = scipy.linalg.expm(-2j * h) @ y0
    bound = 1e-6 if rtol < 1e-6 else 1e-3
    assert np.abs(y - exact).max() < bound
    assert np.abs(yj - exact).max() < bound


def test_solve_ivp_max_step_and_zero_span():
    """``max_step`` bounds the accepted steps; a zero span returns the start
    state without evaluating."""
    ours = solvers.solve_ivp(lambda t, y: -5.0 * y, (0.0, 1.0),
                             torch.ones(3, dtype=torch.float64),
                             rtol=1e-6, atol=1e-9, max_step=0.05)
    theirs = jsolvers.solve_ivp(lambda t, y: -5.0 * y, (0.0, 1.0),
                                jnp.ones(3), rtol=1e-6, atol=1e-9, max_step=0.05)
    assert (ours.nsteps, ours.nfev) == (theirs.nsteps, theirs.nfev)
    assert ours.nsteps >= 20
    assert np.abs(ours.y.numpy() - np.asarray(theirs.y)).max() < 1e-14
    np.testing.assert_allclose(ours.y.numpy(), np.exp(-5.0), rtol=1e-5)
    same = solvers.solve_ivp(lambda t, y: y, (1.0, 1.0), torch.ones(2))
    assert (same.nfev, same.nsteps) == (0, 0)


def test_solve_ivp_non_finite_rhs_shrinks_then_raises():
    """A right-hand side that returns NaN counts attempted steps, shrinks
    the step tenfold each time and gives up below span 1e-14."""
    calls = []

    def nan_rhs(t, y):
        calls.append(t)
        return y * float("nan")

    with pytest.raises(FloatingPointError, match="non-finite"):
        solvers.solve_ivp(nan_rhs, (0.0, 1.0), torch.ones(2, dtype=torch.float64),
                          first_step=0.5)
    # 0.5 -> 5e-15 takes 14 shrinks, six evaluations each
    assert len(calls) == 6 * 14
