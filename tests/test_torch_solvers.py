"""The port's two-layer hop, Davidson solvers, workspace budget, LOBPCG, CG
and ``eigh_qn`` against the JAX package's, fp64 on the CPU.

Each case feeds one numpy-seeded input to both packages: environments and
MPO tensors of the (H - w)^2 hop (1e-12), a symmetric operator for the
Davidson family (eigenvalues 1e-10), a qn-blocked density matrix for
``eigh_qn``; the budget and spill cases are those of
``tests/test_davidson_budget.py``."""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax.numpy as jnp
from renormalizer_tpu.lib import solvers as jsolvers
from renormalizer_tpu.mps import svd_qn as jsvd_qn
from renormalizer_tpu.ops import contract as jcontract
from renormalizer_tpu_torch.lib import solvers
from renormalizer_tpu_torch.mps import svd_qn
from renormalizer_tpu_torch.ops import contract

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _two_layer_operands(nsite, rng):
    m, w, d = 3, 2, 2
    lt = rng.standard_normal((m, w, w, m))
    rt = rng.standard_normal((m, w, w, m))
    cmo = [rng.standard_normal((w, d, d, w)) for _ in range(nsite)]
    cshape = (m,) + (d,) * nsite + (m,)
    return lt, rt, cmo, cshape


@pytest.mark.parametrize("nsite", [1, 2])
def test_two_layer_hop_matches_jax(nsite):
    rng = np.random.default_rng(11 + nsite)
    lt, rt, cmo, cshape = _two_layer_operands(nsite, rng)
    c = rng.standard_normal(cshape)
    jf, jops = jcontract.hop_spec(lt, rt, cmo, cshape, twolayer=True)
    tf, tops = contract.hop_spec(_t(lt), _t(rt), [_t(m) for m in cmo], cshape,
                                 twolayer=True)
    assert tf == jf
    ref = np.asarray(jcontract.einsum(jf, *jops, jnp.asarray(c)))
    out = contract.einsum(tf, *tops, _t(c)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    expr = contract.hop_expr(_t(lt), _t(rt), [_t(m) for m in cmo], cshape, True)
    np.testing.assert_allclose(expr(_t(c)).numpy(), ref, rtol=0, atol=1e-12)
    for fn in ("hop_diag", "hop_dense"):
        ref = np.asarray(getattr(jcontract, fn)(lt, rt, cmo, twolayer=True))
        out = getattr(contract, fn)(_t(lt), _t(rt), [_t(m) for m in cmo],
                                    twolayer=True).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12, err_msg=fn)
    # the dense operator (input legs first) applied to c is the hop
    dim = int(np.prod(cshape))
    np.testing.assert_allclose(
        (c.ravel() @ out.reshape(dim, dim)).reshape(cshape),
        expr(_t(c)).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("domain", ["L", "R"])
def test_stacked_environment_matches_jax(domain):
    rng = np.random.default_rng(3)
    env = rng.standard_normal((3, 2, 2, 3))
    ms = rng.standard_normal((3, 2, 3))
    mo = rng.standard_normal((2, 2, 2, 2))
    ref = np.asarray(jcontract.contract_one_site_multi_mpo(env, ms, [mo, mo], domain))
    out = contract.contract_one_site_multi_mpo(_t(env), _t(ms), [_t(mo)] * 2, domain)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)


N = 60


@pytest.fixture(scope="module")
def operator():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((N, N))
    h = (a + a.T) / 2 + np.diag(np.arange(N) * 0.5)
    x0 = [rng.standard_normal(N) for _ in range(3)]
    return h, np.linalg.eigvalsh(h), x0


def test_davidson_matches_jax(operator):
    h, w, x0 = operator
    je, _, _ = jsolvers.davidson(lambda v: jnp.asarray(h) @ v, jnp.asarray(x0[0]),
                                 jnp.asarray(np.diag(h)), tol=1e-10, max_cycle=200)
    te, tx, _ = solvers.davidson(lambda v: _t(h) @ v, _t(x0[0]), _t(np.diag(h)),
                                 tol=1e-10, max_cycle=200)
    assert abs(float(te) - float(je)) < 1e-10
    assert abs(float(te) - w[0]) < 1e-10
    np.testing.assert_allclose(abs(tx.numpy() @ h @ tx.numpy()), abs(w[0]), rtol=0, atol=1e-10)


def test_davidson_multiroot_matches_jax(operator):
    h, w, x0 = operator
    jt, _, _ = jsolvers.davidson_multiroot(
        lambda v: jnp.asarray(h) @ v, [jnp.asarray(x) for x in x0],
        jnp.asarray(np.diag(h)), 3, tol=1e-9, max_cycle=200)
    tt, tx, _ = solvers.davidson_multiroot(
        lambda rows: rows @ _t(h), [_t(x) for x in x0], _t(np.diag(h)), 3,
        tol=1e-9, max_cycle=200)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), w[:3], rtol=0, atol=1e-10)
    np.testing.assert_allclose(tx.numpy() @ tx.numpy().T, np.eye(3), rtol=0, atol=1e-10)
    # a workspace below two blocks solves densely
    tt2, _, it = solvers.davidson_multiroot(
        lambda rows: rows @ _t(h[:5, :5]), [_t(x[:5]) for x in x0],
        _t(np.diag(h)[:5]), 3)
    assert it == 0
    np.testing.assert_allclose(tt2.numpy(), np.linalg.eigvalsh(h[:5, :5])[:3],
                               rtol=0, atol=1e-12)


def test_davidson_multiroot_keeps_out_of_sector_directions_out():
    """A repeated guess and a root converged from the start leave nothing
    new to add; a QR completes such a row with an arbitrary unit vector,
    here in the first flat indices, which lie outside the sector, where the
    masked matvec gives 0.  The port's block Davidson must report the two
    lowest in-sector eigenvalues (all above 0.5), not a spurious 0 (1e-10)."""
    rng = np.random.default_rng(21)
    n, out = 40, 10
    a = rng.standard_normal((n - out, n - out))
    h_in = (a + a.T) / 2
    h_in += (0.5 - np.linalg.eigvalsh(h_in)[0]) * np.eye(n - out)
    h = np.zeros((n, n))
    h[out:, out:] = h_in
    mask = _t(np.arange(n) >= out)
    hop = lambda rows: torch.where(mask, torch.where(mask, rows, 0) @ _t(h), 0)
    hdiag = torch.where(mask, _t(np.diag(h)), 1e10)
    w, v = np.linalg.eigh(h_in)
    ground = np.concatenate([np.zeros(out), v[:, 0]])
    for x0 in ([ground, ground], [ground, np.zeros(n)]):
        tt, tx, _ = solvers.davidson_multiroot(hop, [_t(x) for x in x0], hdiag, 2,
                                               tol=1e-9, max_cycle=200)
        np.testing.assert_allclose(tt.numpy(), w[:2], rtol=0, atol=1e-10)
        assert np.abs(tx.numpy()[:, :out]).max() < 1e-12


def test_davidson_host_matches_jax(operator):
    h, w, x0 = operator
    d = np.diag(h)

    def precond(r, e):
        return r / (d - e + 1e-4)

    for nroots, strict in ((1, False), (3, False), (1, True), (3, True)):
        je, _ = jsolvers.davidson_host(lambda v: h @ v, x0[:nroots], precond,
                                       nroots=nroots, tol=1e-10,
                                       strict_residual=strict)
        te, tc = solvers.davidson_host(lambda v: h @ v, x0[:nroots], precond,
                                       nroots=nroots, tol=1e-10,
                                       strict_residual=strict)
        np.testing.assert_allclose(np.atleast_1d(te), np.atleast_1d(je),
                                   rtol=0, atol=1e-10)
        if strict:
            # the default also stops once the ritz values stagnate
            np.testing.assert_allclose(np.atleast_1d(te), w[:nroots], rtol=0,
                                       atol=1e-10)


def test_lobpcg_matches_jax(operator):
    from jax.experimental.sparse.linalg import lobpcg_standard as jlobpcg

    h, w, x0 = operator
    x = np.stack(x0[:2], axis=1)
    jt, _, _ = jlobpcg(jnp.asarray(h), jnp.asarray(x), m=100)
    tt, tu, _ = solvers.lobpcg_standard(lambda v: _t(h) @ v, _t(x), m=100)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tt.numpy(), w[::-1][:2], rtol=0, atol=1e-10)


def test_cg_matches_jax_stopping_rule(operator):
    """Same iterations as ``jax.scipy.sparse.linalg.cg`` with a diagonal
    preconditioner: it stops on the unpreconditioned residual."""
    import jax

    h, _, x0 = operator
    a = h @ h + 0.05 ** 2 * np.eye(N)
    b, d = x0[1], np.diag(a)
    tx, niter = solvers.cg(lambda v: _t(a) @ v, _t(b), torch.zeros(N, dtype=torch.float64),
                           tol=1e-5, precond=lambda v: v / _t(d), maxiter=100)

    def jcg(maxiter):
        return np.asarray(jax.scipy.sparse.linalg.cg(
            lambda v: jnp.asarray(a) @ v, jnp.asarray(b), x0=jnp.zeros(N), tol=1e-5,
            M=lambda v: v / jnp.asarray(d), maxiter=maxiter)[0])

    assert 0 < niter < 100
    ref = jcg(100)
    assert np.abs(tx.numpy() - ref).max() < 1e-8 * np.abs(ref).max()
    np.testing.assert_array_equal(jcg(niter), jcg(100))
    assert np.abs(jcg(niter - 1) - jcg(100)).max() > 1e-12


def test_eigh_qn_matches_jax():
    rng = np.random.default_rng(9)
    qn_l = np.array([0, 1, 0, 1, 1, 2, 0, 1])
    qn_r = np.array([1, 0, 1, 0, 2])
    c = rng.standard_normal((8, 5)) * ((qn_l[:, None] + qn_r[None, :]) == 2)
    qnbigl, qnbigr = qn_l.reshape(8, 1), qn_r.reshape(5, 1)
    for system, dm in (("L", c @ c.T), ("R", c.T @ c)):
        ju, js, jq = jsvd_qn.eigh_qn(dm, qnbigl, qnbigr, np.array([2]), system)
        tu, ts, tq = svd_qn.eigh_qn(_t(dm), qnbigl, qnbigr, np.array([2]), system)
        assert [tuple(q) for q in tq] == [tuple(q) for q in jq]
        # the eigenvalues; the square roots of rounding-level ones differ
        np.testing.assert_allclose(ts ** 2, np.asarray(js) ** 2, rtol=0, atol=1e-12)
        tu = tu.numpy()
        np.testing.assert_allclose(tu.T @ tu, np.eye(tu.shape[1]), rtol=0, atol=1e-12)
        np.testing.assert_allclose((tu * ts ** 2) @ tu.T, dm, rtol=0, atol=1e-12)


# --- the workspace budget (``tests/test_davidson_budget.py``) ---------------

FORMULA = "abc,bdef,fghj,ljk,cehk->adgl"
BM, BW, BD = 6, 4, 2
BN = BM * BD * BD * BM


@pytest.fixture
def budget_problem():
    rng = np.random.default_rng(7)
    lt = rng.standard_normal((BM, BW, BM))
    lt = (lt + lt.transpose(2, 1, 0)) / 2
    wc = rng.standard_normal((BW, BD, BD, BW))
    wc = (wc + wc.transpose(0, 2, 1, 3)) / 2
    rt = rng.standard_normal((BM, BW, BM))
    rt = (rt + rt.transpose(2, 1, 0)) / 2
    operands = [_t(x) for x in (lt, wc, wc, rt)]
    h = np.stack([contract.einsum(FORMULA, *operands,
                                  _t(np.eye(BN)[i]).reshape(BM, BD, BD, BM)).numpy().ravel()
                  for i in range(BN)], axis=1)
    x0 = _t(np.random.default_rng(1).standard_normal(BN)).reshape(BM, BD, BD, BM)
    return operands, np.linalg.eigvalsh((h + h.T) / 2)[0], x0


@pytest.mark.parametrize("case", ["shrink", "spill", "unbudgeted"])
def test_davidson_budget(budget_problem, monkeypatch, case):
    operands, e_exact, x0 = budget_problem
    itemsize = 8
    mask = torch.ones(BN, dtype=torch.bool)
    if case == "shrink":
        # room for exactly 2*5 rows -> max_space capped at 5
        monkeypatch.setenv("RENO_DAVIDSON_WS_BYTES", str(2 * 5 * BN * itemsize))
        assert solvers._budgeted_max_space(12, BN, itemsize) == 5
    elif case == "spill":
        monkeypatch.setenv("RENO_DAVIDSON_WS_BYTES", str(BN))  # < 2*4 rows
        assert solvers._budgeted_max_space(12, BN, itemsize) == 0
    else:
        monkeypatch.delenv("RENO_DAVIDSON_WS_BYTES", raising=False)
        assert solvers._budgeted_max_space(12, BN, itemsize) == 12
    e, c, niter = solvers.davidson_fused(FORMULA, operands, (BM, BD, BD, BM), x0,
                                         mask, tol=1e-10, max_cycle=400)
    assert (niter == -1) == (case == "spill")
    assert abs(float(e) - e_exact) < 1e-8
    assert c.shape == (BM, BD, BD, BM)
    hx = contract.einsum(FORMULA, *operands, c).reshape(-1)
    assert float(torch.linalg.norm(hx - e * c.reshape(-1))) < 1e-6
