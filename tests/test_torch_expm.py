"""The port's Lanczos expm and fused TDVP-PS site visit against the JAX
package's and against dense ``scipy.linalg.expm``, fp64 on the CPU.

Environments, MPO cores and states are seeded complex numpy arrays,
symmetrized so that the effective Hamiltonian is Hermitian; the qn-structured
case takes them from a canonical state of the 3-molecule Holstein model."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import exact_model
import renormalizer_tpu as rj
from renormalizer_tpu.lib import solvers as jsolvers
from renormalizer_tpu.mps.lib import Environ as JaxEnviron
from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib import solvers
from renormalizer_tpu_torch.ops.contract import _HOP_FORMULAS, hop_dense

torch.set_num_threads(2)

F1 = _HOP_FORMULAS[(1, False, False)][0]
F0 = _HOP_FORMULAS[(0, False, False)][0]


def _crandn(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def hermitian_operands(seed, dl, d, dr, w=3):
    """(L, W, R) whose one-site and zero-site effective Hamiltonians are
    Hermitian: L[a,b,c] = conj(L[c,b,a]), W[b,d,e,f] = conj(W[b,e,d,f]),
    R[l,f,k] = conj(R[k,f,l])."""
    rng = np.random.default_rng(seed)
    lt = _crandn(rng, dl, w, dl)
    lt = (lt + lt.transpose(2, 1, 0).conj()) / 2
    wt = _crandn(rng, w, d, d, w)
    wt = (wt + wt.transpose(0, 2, 1, 3).conj()) / 2
    rt = _crandn(rng, dr, w, dr)
    rt = (rt + rt.transpose(2, 1, 0).conj()) / 2
    scale = np.linalg.norm(np.einsum("abc,bdef,lfk->adlcek", lt, wt, rt)
                           .reshape(dl * d * dr, -1), 2)
    return lt / np.sqrt(scale), wt, rt / np.sqrt(scale)


def _t(x):
    return backend.tensor(np.asarray(x))


@pytest.mark.parametrize("dl,d,dr", [(3, 2, 3), (6, 4, 6)], ids=["N18", "N144"])
@pytest.mark.parametrize("dt", [-0.3j, 0.3j, -0.2], ids=["fwd", "bwd", "imag"])
def test_expm_one_site(dl, d, dr, dt):
    """One-site hop: port == JAX to 1e-10, and == dense expm where the
    Krylov space is the whole space (N = 18 <= 30)."""
    lt, wt, rt = hermitian_operands(1, dl, d, dr)
    c = _crandn(np.random.default_rng(2), dl, d, dr)
    got = solvers.expm_krylov_fused(F1, (_t(lt), _t(wt), _t(rt)), dt, _t(c)).numpy()
    ref = np.asarray(jsolvers.expm_krylov_fused(
        F1, (jnp.asarray(lt), jnp.asarray(wt), jnp.asarray(rt)), dt, jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    h = hop_dense(_t(lt), _t(rt), [_t(wt)]).numpy().reshape(c.size, c.size)
    assert np.allclose(h, h.conj().T, atol=1e-13)
    dense = (scipy.linalg.expm(dt * h) @ c.ravel()).reshape(c.shape)
    np.testing.assert_allclose(got, dense, atol=1e-10, rtol=0)


@pytest.mark.parametrize("dl,dr", [(4, 5), (12, 9)], ids=["N20", "N108"])
def test_expm_zero_site(dl, dr):
    """Zero-site (bond) hop, the backward step of TDVP-PS."""
    lt, _, rt = hermitian_operands(3, dl, 2, dr)
    c = _crandn(np.random.default_rng(4), dl, dr)
    dt = 0.25j
    got = solvers.expm_krylov_fused(F0, (_t(lt), _t(rt)), dt, _t(c)).numpy()
    ref = np.asarray(jsolvers.expm_krylov_fused(
        F0, (jnp.asarray(lt), jnp.asarray(rt)), dt, jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, atol=1e-10, rtol=0)
    h = np.einsum("abc,lbk->alck", lt, rt).reshape(c.size, c.size)
    dense = (scipy.linalg.expm(dt * h) @ c.ravel()).reshape(c.shape)
    np.testing.assert_allclose(got, dense, atol=1e-10, rtol=0)


def test_expm_dtypes_and_breakdown():
    """Real state + real dt stays real; real state + complex dt comes out
    complex; a start vector that is an eigenvector (Lanczos breaks down at
    the first step) gives the exact phase, with no NaN from the masked
    division."""
    lt, wt, rt = (np.real(x) for x in hermitian_operands(5, 3, 2, 3))
    c = np.random.default_rng(6).standard_normal((3, 2, 3))
    ops = (_t(lt), _t(wt), _t(rt))
    assert solvers.expm_krylov_fused(F1, ops, -0.1 + 0j, _t(c)).dtype == torch.float64
    assert solvers.expm_krylov_fused(F1, ops, -0.1j, _t(c)).dtype == torch.complex128
    h = hop_dense(*[_t(x) for x in (lt, rt)], [_t(wt)]).numpy().reshape(18, 18)
    evals, evecs = np.linalg.eigh(h)
    out = solvers.expm_krylov_fused(F1, ops, -0.7j, _t(evecs[:, 3].reshape(3, 2, 3)))
    assert torch.isfinite(torch.view_as_real(out)).all()
    np.testing.assert_allclose(out.numpy().ravel(),
                               np.exp(-0.7j * evals[3]) * evecs[:, 3], atol=1e-12)
    w, m_used = solvers.expm_krylov(
        lambda v: _t(h.astype(complex)) @ v, -0.7j, _t(evecs[:, 3]), max_m=30)
    assert m_used == 18
    np.testing.assert_allclose(w.numpy(), np.exp(-0.7j * evals[3]) * evecs[:, 3],
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
def test_breakdown_is_caught_at_the_working_precision(dtype):
    """A start vector inside a 3-dimensional invariant subspace of a
    40-dimensional operator: after 3 steps what is left of A v is rounding
    error, which must be masked (the later basis vectors are exactly zero)
    rather than normalized into the basis — in single precision too, where
    that remainder is ~1e-7, far above an absolute 1e-14."""
    rng = np.random.default_rng(9)
    blocks = [rng.standard_normal((3, 3)), 0.2 * rng.standard_normal((37, 37))]
    h = scipy.linalg.block_diag(*[(b + b.T) / 2 for b in blocks])
    mix, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    h = mix @ h @ mix.T              # hide the block structure from rounding
    v0 = mix[:, :3] @ np.array([0.5, -1.0, 0.25])
    seen = []

    def hop(v):
        seen.append(v.clone())
        return _t(h).to(dtype) @ v

    w, m_used = solvers.expm_krylov(hop, -0.4j, _t(v0).to(dtype), max_m=30)
    assert m_used == 30 and len(seen) == 30
    assert all(float(v.abs().max()) > 0 for v in seen[:3])
    assert all(float(v.abs().max()) == 0.0 for v in seen[3:])
    ref = scipy.linalg.expm(-0.4j * h) @ v0
    tol = 1e-5 if dtype == torch.complex64 else 1e-13
    np.testing.assert_allclose(w.numpy(), ref, atol=tol, rtol=0)


def _lanczos_error(h, v0, dt, dtype, breakdown_eps):
    """Largest deviation of ``_lanczos_expm`` (30 steps) from the dense
    ``scipy.linalg.expm``, and how many of the 30 basis vectors were live."""
    ht, live = torch.tensor(h).to(dtype), []

    def hop(v):
        live.append(float(v.abs().max()) > 0)
        return ht @ v

    w, _ = solvers._lanczos_expm(hop, dt, torch.tensor(v0).to(dtype), 30,
                                 breakdown_eps=breakdown_eps)
    ref = scipy.linalg.expm(dt * h) @ v0
    return float(np.abs(w.numpy() - ref).max()), sum(live)


@pytest.mark.parametrize("norm", [5.0, 50.0], ids=["norm5", "norm50"])
def test_absolute_breakdown_rule_fails_in_single_precision(norm):
    """A start vector inside a 6-dimensional block of a block-diagonal
    48-dimensional operator, all other components exactly zero: the sector
    sparsity of a state padded by ``expand_bond_dimension``.  After 6 steps
    the basis spans all the operator can reach.  In complex64 the absolute
    1e-14 rule (``breakdown_eps=0``) normalizes the rounding remainder into
    the basis and the couplings grow until the result is useless; the
    relative rule stops at 6 vectors and meets the dense oracle.  In
    complex128 both rules stop at 6."""
    rng = np.random.default_rng(11)
    a = _crandn(rng, 6, 6)
    a = (a + a.conj().T) / 2
    b = rng.standard_normal((42, 42))
    h = scipy.linalg.block_diag(a * norm / np.linalg.norm(a, 2), (b + b.T) / 2)
    v0 = np.zeros(48, dtype=complex)
    v0[:6] = _crandn(rng, 6)
    v0 /= np.linalg.norm(v0)
    err_abs, live_abs = _lanczos_error(h, v0, -0.1j, torch.complex64, 0.0)
    assert live_abs > 6 and not err_abs < 1e-3      # NaN counts as failed
    err, live = _lanczos_error(h, v0, -0.1j, torch.complex64, 64.0)
    assert live == 6 and err < 2e-6
    for eps in (0.0, 64.0):
        err, live = _lanczos_error(h, v0, -0.1j, torch.complex128, eps)
        assert live == 6 and err < 1e-13


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128],
                         ids=["c64", "c128"])
@pytest.mark.parametrize("kind", ["large_norm", "offset"])
def test_breakdown_threshold_keeps_a_live_krylov_space(kind, dtype):
    """The relative threshold must not cut a space that is still growing:
    an operator of norm 1e3 with no offset (``|dt| |A| = 5``), and a spectrum
    of width 1 on an offset of 1e3, where ``|A v|`` is a thousand times the
    spread.  All 30 vectors stay live, the result is bit for bit that of the
    absolute rule, and it meets the dense oracle as closely as the
    precision's rounding of ``|dt| |A|`` allows."""
    rng = np.random.default_rng(12)
    s = rng.standard_normal((200, 200))
    s = (s + s.T) / 2
    s /= np.linalg.norm(s, 2)
    h, dt = (1e3 * s, -5e-3j) if kind == "large_norm" else (s + 1e3 * np.eye(200), -1j)
    v0 = rng.standard_normal(200).astype(complex)
    v0 /= np.linalg.norm(v0)
    err, live = _lanczos_error(h, v0, dt, dtype, 64.0)
    err_abs, live_abs = _lanczos_error(h, v0, dt, dtype, 0.0)
    assert live == live_abs == 30
    assert err == err_abs
    tol = {("large_norm", torch.complex64): 2e-6, ("offset", torch.complex64): 5e-4,
           ("large_norm", torch.complex128): 1e-13, ("offset", torch.complex128): 1e-11}
    assert err < tol[kind, dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64, torch.float64,
                                   torch.complex128], ids=["f32", "c64", "f64", "c128"])
@pytest.mark.parametrize("dt", [-0.3j, 0.3j, -0.2], ids=["fwd", "bwd", "imag"])
def test_dt_as_a_tensor_gives_the_scalar_result(dt, dtype):
    """``dt`` as the 0-d tensor that a CUDA graph reads (``_dt_tensor``)
    gives the python scalar's result bit for bit, in its dtype, at real and
    complex dt."""
    lt, wt, rt = hermitian_operands(1, 6, 4, 6)
    h = _t(hop_dense(_t(lt), _t(rt), [_t(wt)]).numpy().reshape(144, 144))
    v = _crandn(np.random.default_rng(2), 144)
    if not dtype.is_complex:
        h, v = h.real, v.real
    h, v0 = h.to(dtype), _t(v).to(dtype)
    a, _ = solvers._lanczos_expm(lambda x: h @ x, dt, v0, 30)
    b, _ = solvers._lanczos_expm(lambda x: h @ x, solvers._dt_tensor(dt, v0.real.dtype, "cpu"),
                                 v0, 30)
    assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["fused", "opaque_hop"])
def test_cpu_calls_run_eagerly(kind):
    """On the CPU neither form of the operator is captured, at any sighting:
    each call counts ``lanczos.graph.eager.cpu``, none captures or replays,
    and the second call of a key gives the first one's result bit for bit."""
    from renormalizer_tpu_torch.utils import profiling

    lt, wt, rt = hermitian_operands(1, 3, 2, 3)
    ops = (_t(lt), _t(wt), _t(rt))
    c = _t(_crandn(np.random.default_rng(2), 3, 2, 3))
    h = hop_dense(*ops[::2], [ops[1]]).reshape(18, 18)
    if kind == "fused":
        call = lambda: solvers.expm_krylov_fused(F1, ops, -0.3j, c)  # noqa: E731
    else:
        call = lambda: solvers.expm_krylov(lambda v: h @ v, -0.3j, c.reshape(-1))[0]  # noqa: E731
    before = profiling.snapshot()
    first, second = call(), call()
    counts = profiling.delta(before)
    assert torch.equal(first, second)
    assert counts["lanczos.graph.eager.cpu"] == counts["lanczos.calls"] == 2
    assert {k for k in counts if k.startswith("lanczos.graph.")} == {"lanczos.graph.eager.cpu"}
    assert counts["lanczos.jacobi_launches"] == 0


def test_graph_keys_expire_after_two_steps_unmet(monkeypatch):
    """The graph cache's bookkeeping, with no capture (the budget refuses
    it): a key's second sighting tries a capture while the key was met in
    one of the last two steps (``end_graph_step``); after two steps unmet
    it is forgotten, and a graph it held is dropped with its bytes; with
    the last graph gone the cache takes a new memory pool."""
    from renormalizer_tpu_torch.utils import profiling

    graphs = object.__new__(solvers._DeviceGraphs)
    graphs.graphs, graphs.met, graphs.step, graphs.nbytes = {}, {}, 0, 0
    monkeypatch.setattr(solvers, "_DEVICE_GRAPHS", {"card": graphs})
    monkeypatch.setattr(solvers._DeviceGraphs, "admits", lambda self, need: False)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "new pool")
    lt, wt, rt = hermitian_operands(1, 3, 2, 3)
    ops, c = (_t(lt), _t(wt), _t(rt)), _t(_crandn(np.random.default_rng(2), 3, 2, 3))
    before = profiling.snapshot()

    def sighting():
        assert graphs.get(F1, ops, -0.3j, c, torch.complex128, 18) is None
        counts = profiling.delta(before)
        return counts["lanczos.graph.eager.first_sighting"], counts["lanczos.graph.eager.budget"]

    assert sighting() == (1, 0)
    for _ in range(2):
        solvers.end_graph_step()
    assert sighting() == (1, 1)
    (key,) = graphs.met
    graphs.graphs[key] = types.SimpleNamespace(nbytes=64)
    graphs.nbytes = 64
    for _ in range(2):
        solvers.end_graph_step()
    assert key in graphs.graphs and profiling.delta(before)["lanczos.graph.dropped"] == 0
    solvers.end_graph_step()
    assert graphs.graphs == {} and graphs.met == {} and graphs.nbytes == 0
    assert profiling.delta(before)["lanczos.graph.dropped"] == 1
    assert graphs.pool == "new pool"  # no graph holds the old one
    assert sighting() == (2, 1)


def _dense_site_visit(dt, c, lt, wt, rt, nbr, to_right):
    """The site visit in numpy/scipy; returns the gauge-free
    ``site . new_neighbor`` and the evolved site tensor."""
    h1 = np.einsum("abc,bdef,lfk->adlcek", lt, wt, rt).reshape(c.size, c.size)
    w1 = (scipy.linalg.expm(dt * h1) @ c.ravel()).reshape(c.shape)
    if to_right:
        q, r = np.linalg.qr(w1.reshape(-1, c.shape[-1]))
        site = q.reshape(c.shape[:-1] + (-1,))
        env = np.einsum("abc,adf,bdeg,ceh->fgh", lt, site.conj(), wt, site)
        h0 = np.einsum("abc,lbk->alck", env, rt).reshape(r.size, r.size)
        bond = (scipy.linalg.expm(-dt * h0) @ r.ravel()).reshape(r.shape)
        return np.tensordot(site, np.tensordot(bond, nbr, 1), 1), w1
    q, r = np.linalg.qr(w1.reshape(c.shape[0], -1).T)
    site = q.T.reshape((-1,) + c.shape[1:])
    env = np.einsum("abc,fda,gdeb,hec->fgh", rt, site.conj(), wt, site)
    bond = r.T
    h0 = np.einsum("abc,lbk->alck", lt, env).reshape(bond.size, bond.size)
    bond = (scipy.linalg.expm(-dt * h0) @ bond.ravel()).reshape(bond.shape)
    return np.tensordot(np.tensordot(nbr, bond, 1), site, 1), w1


@pytest.mark.parametrize("to_right", [True, False], ids=["to_right", "to_left"])
def test_site_visit_trivial_sector(to_right):
    """Fused visit without qn structure: port == JAX == dense on the
    gauge-free product of the new site and the rotated neighbor; the site
    is an isometry that spans the forward-evolved tensor."""
    dl, d, dr = (2, 2, 3) if to_right else (3, 2, 2)
    lt, wt, rt = hermitian_operands(7, dl, d, dr)
    rng = np.random.default_rng(8)
    c = _crandn(rng, dl, d, dr)
    nbr = _crandn(rng, dr, 2, 4) if to_right else _crandn(rng, 4, 2, dl)
    m, n = (dl * d, dr) if to_right else (dl, d * dr)
    dt = -0.15j
    site, env, new_nbr = solvers.tdvp_ps_site_fused(
        dt, _t(c), _t(lt), _t(wt), _t(rt), _t(nbr), c.shape, m, n, to_right)
    jsite, jenv, jnbr = jsolvers.tdvp_ps_site_fused(
        dt, *[jnp.asarray(x) for x in (c, lt, wt, rt, nbr)], c.shape, m, n,
        to_right, True)
    dense, w1 = _dense_site_visit(dt, c, lt, wt, rt, nbr, to_right)
    if to_right:
        prod = torch.tensordot(site, new_nbr, dims=1).numpy()
        jprod = np.tensordot(np.asarray(jsite), np.asarray(jnbr), 1)
        smat = site.reshape(-1, site.shape[-1]).numpy()
        gram = smat.conj().T @ smat
        spanned = (smat @ (smat.conj().T @ w1.reshape(m, n))).reshape(c.shape)
    else:
        prod = torch.tensordot(new_nbr, site, dims=1).numpy()
        jprod = np.tensordot(np.asarray(jnbr), np.asarray(jsite), 1)
        smat = site.reshape(site.shape[0], -1).numpy()
        gram = smat @ smat.conj().T
        spanned = ((w1.reshape(m, n) @ smat.conj().T) @ smat).reshape(c.shape)
    np.testing.assert_allclose(prod, jprod, atol=1e-10, rtol=0)
    np.testing.assert_allclose(prod, dense, atol=1e-10, rtol=0)
    np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-12, rtol=0)
    # site . bond before the backward step is the forward-evolved tensor
    np.testing.assert_allclose(spanned, w1, atol=1e-10, rtol=0)
    # the environments differ by the bond gauge only: same spectrum
    assert env.shape == tuple(jenv.shape)


def _qn_case(to_right):
    """A complex canonical state of the Holstein model with its center on an
    interior site, from the JAX package: the site, its neighbor, the
    environments, the MPO core and the quantum numbers of the split."""
    model = exact_model()
    mpo = rj.Mpo(model)
    mps = rj.Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ rj.Mps.ground_state(model, False)
    mps = mps.expand_bond_dimension(hint_mpo=mpo)
    mps.evolve_config = rj.EvolveConfig(rj.EvolveMethod.tdvp_ps)
    mps = mps.evolve(mpo, 0.3)  # genuinely complex tensors
    if to_right:
        mps.ensure_right_canonical()
        mps.canonicalise(stop_idx=2)
    else:
        mps.ensure_left_canonical()
        mps.canonicalise(stop_idx=3)
    imps = mps.qnidx
    assert mps.to_right == to_right and 0 < imps < len(mps) - 1
    cmpo = mpo.to_complex()
    environ = JaxEnviron(mps, cmpo)
    nbr = imps + 1 if to_right else imps - 1
    qnbigl, qnbigr, _ = mps._get_big_qn([imps])
    arrays = [np.asarray(x) for x in (
        mps[imps], environ.read("L", imps - 1), cmpo[imps],
        environ.read("R", imps + 1), mps[nbr])]
    return arrays, qnbigl, qnbigr, np.asarray(mps.qntot)


@pytest.mark.parametrize("to_right", [True, False], ids=["to_right", "to_left"])
def test_site_visit_qn_structured(to_right):
    """Fused visit with per-sector QR: port == JAX on the gauge-free
    product; the site is an isometry whose columns are sector pure."""
    (c, lt, wt, rt, nbr), qnbigl, qnbigr, qntot = _qn_case(to_right)
    m = int(np.prod(qnbigl.shape[:-1]))
    n = int(np.prod(qnbigr.shape[:-1]))
    dt = -0.1j
    kwargs = dict(qnbigl=qnbigl, qnbigr=qnbigr, qntot=qntot)
    out = solvers.tdvp_ps_site_fused(
        dt, _t(c), _t(lt), _t(wt), _t(rt), _t(nbr), c.shape, m, n, to_right,
        **kwargs)
    jout = jsolvers.tdvp_ps_site_fused(
        dt, *[jnp.asarray(x) for x in (c, lt, wt, rt, nbr)], c.shape, m, n,
        to_right, True, **kwargs)
    assert out is not None and jout is not None
    site, _, new_nbr = out
    jsite, _, jnbr = (np.asarray(x) for x in jout)
    ql = qnbigl.reshape(m, -1)
    qr_left = qntot[None, :] - qnbigr.reshape(n, -1)
    if to_right:
        prod = torch.tensordot(site, new_nbr, dims=1).numpy()
        jprod = np.tensordot(jsite, jnbr, 1)
        q = site.reshape(m, -1).numpy()
        gram, row_qn, col_qn = q.conj().T @ q, ql, qr_left
    else:
        prod = torch.tensordot(new_nbr, site, dims=1).numpy()
        jprod = np.tensordot(jnbr, jsite, 1)
        q = site.reshape(-1, n).numpy().T
        gram, row_qn, col_qn = q.conj().T @ q, qr_left, ql
    np.testing.assert_allclose(prod, jprod, atol=1e-10, rtol=0)
    np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-12, rtol=0)
    # sector purity: column j lives on the rows that carry its quantum number
    off_sector = (row_qn[:, None, :] != col_qn[None, :, :]).any(-1)
    assert np.abs(q[off_sector]).max() == 0.0
    assert off_sector.any() and (~off_sector).any()


def test_site_visit_declines_infeasible_split():
    """A bond sector wider than its free-leg support cannot be split per
    sector: the visit returns None and the caller takes the unfused path."""
    qnbigl = np.array([[0], [0], [1]])          # rows: two states of qn 0
    qnbigr = np.array([[1], [1], [1]])          # columns: three of qn 0
    c = _t(np.zeros((3, 1, 3), dtype=complex))
    one = _t(np.ones((1, 1, 1), dtype=complex))
    w = _t(np.ones((1, 1, 1, 1), dtype=complex))
    assert solvers.tdvp_ps_site_fused(
        -0.1j, c, one, w, one, c, (3, 1, 3), 3, 3, True,
        qnbigl=qnbigl, qnbigr=qnbigr, qntot=np.array([1])) is None
