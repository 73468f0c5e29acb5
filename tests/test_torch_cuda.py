"""Tests of the port that need an NVIDIA GPU (marked ``cuda``).

They skip without a card.  On a machine with one, where jax is not
installed, run them without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections

import numpy as np
import pytest
import torch

from renormalizer_tpu_torch.ops import jacobi
from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh, jacobi_eigh_reference
from renormalizer_tpu_torch.utils.profiling import COUNTERS

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _symmetric_stack(seed, batch, n):
    a = np.random.default_rng(seed).standard_normal((batch, n, n))
    return (a + np.swapaxes(a, -1, -2)) / 2


# the main path's steady-sweep batch, its widest growth-sweep Gram, and f64;
# tolerances relative to ||A||_F: eigenvalues within 1e-5 (f32) / 1e-11
# (f64) of the exact ones for either version, so within twice that of each
# other; |V^T V - I| as chip_smoke.py holds it
@pytest.mark.cuda
@pytest.mark.parametrize("batch, n, dtype, eig, orth", [
    (2, 288, torch.float32, 1e-5, 1e-4),
    (1, 544, torch.float32, 1e-5, 1e-4),
    (2, 96, torch.float64, 1e-11, 1e-12),
])
def test_jacobi_kernel_matches_plain(cuda, batch, n, dtype, eig, orth):
    """The CUDA kernel against its plain version, one counted launch, both
    stopping before the sweep cap."""
    a = torch.tensor(_symmetric_stack(2019, batch, n), dtype=dtype, device=cuda)
    before = COUNTERS["jacobi.launches"]
    w, v, _, nsweeps = jacobi_eigh(a, return_resid=True, return_sweeps=True)
    w_p, _, _, nsweeps_p = jacobi_eigh_reference(a, return_resid=True,
                                                 return_sweeps=True)
    assert COUNTERS["jacobi.launches"] == before + 1
    cap = jacobi.default_sweeps(dtype) + jacobi.MAX_EXTRA_SWEEPS
    assert int(nsweeps.max()) < cap and int(nsweeps_p.max()) < cap
    norm = float(torch.linalg.matrix_norm(a).min())
    assert float((w - w_p).abs().max()) < 2 * eig * norm
    eye = torch.eye(n, dtype=dtype, device=cuda)
    assert float((v.mT @ v - eye).abs().max()) < orth


@pytest.mark.cuda
def test_thermal_prop_reaches_the_kernel(cuda, monkeypatch):
    """ThermalProp of chip_smoke.py's phase 8(a) (3 molecules, one 3-level
    phonon each, 1500 K, beta/2 in 20 TDVP-PS steps) on the card and on the
    CPU, both in fp32: the same occupations.  The compresses of the
    expansion and of every step's bond entropies factor their real sector
    blocks by cuSOLVER's SVD on the card (counted in
    ``trunc.svd_blocks``), no longer by Gram matrices through the
    Jacobi kernel, which this path therefore does not launch."""
    from renormalizer_tpu_torch import (
        EvolveConfig, EvolveMethod, HolsteinModel, MpDm, Mol, Phonon, Quantity,
        ThermalProp)
    from renormalizer_tpu_torch.backend import backend

    def occupations():
        ph = Phonon.simple_phonon(Quantity(1.0), Quantity(0.6), 3)
        model = HolsteinModel([Mol(Quantity(0.0), [ph], 1.0)] * 3, Quantity(0.1))
        tp = ThermalProp(MpDm.max_entangled_ex(model),
                         evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
        tp.evolve(None, 20, Quantity(1500.0, "K").to_beta() / 2j)
        assert tp.latest_mps[0].device.type == backend.device.type
        return tp.e_occupations_array[-1]

    assert backend.device.type == "cuda" and backend.is_32bits
    before, blocks = COUNTERS["jacobi.launches"], COUNTERS["trunc.svd_blocks"]
    on_card = occupations()
    launches = COUNTERS["jacobi.launches"] - before
    svd_blocks = COUNTERS["trunc.svd_blocks"] - blocks
    monkeypatch.setattr(backend, "device", torch.device("cpu"))
    on_cpu = occupations()
    assert svd_blocks > 0 and launches == 0
    # both fp32; the CPU run is 4.6e-7 off the dense populations
    np.testing.assert_allclose(on_card, on_cpu, atol=1e-5)


@pytest.mark.cuda
def test_kernel_on_state_averaged_density_matrix_blocks(cuda, monkeypatch):
    """The sector blocks of the averaged density matrix that state-averaged
    DMRG (2 roots, ``tests/test_mps.py::test_dmrg_nroots``'s model and
    procedure) hands ``svd_qn.eigh_qn`` on the card: each block again
    through the kernel and through its plain version, eigenvalues within
    2e-5 ||A||_F of each other (twice phase 3's f32 tolerance), neither at
    the sweep cap."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
    from renormalizer_tpu_torch.mps import svd_qn, trunc_device
    from renormalizer_tpu_torch.mps.gs import construct_mps_mpo, optimize_mps

    blocks, inside = [], []
    gram_eigh, eigh_qn = trunc_device.gram_eigh, svd_qn.eigh_qn

    def keep(g):
        if inside:
            blocks.append(g.clone())
        return gram_eigh(g)

    def averaged(*args, **kwargs):
        inside.append(True)
        try:
            return eigh_qn(*args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(trunc_device, "gram_eigh", keep)
    monkeypatch.setattr(svd_qn, "eigh_qn", averaged)
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    mps, mpo = construct_mps_mpo(model, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0]]
    mps.optimize_config.nroots = 2
    optimize_mps(mps, mpo)
    assert blocks and all(b.device.type == "cuda" for b in blocks)
    cap = jacobi.default_sweeps(torch.float32) + jacobi.MAX_EXTRA_SWEEPS
    for a in blocks:
        w, _, _, sweeps = jacobi_eigh(a, return_resid=True, return_sweeps=True)
        w_p, _, _, sweeps_p = jacobi_eigh_reference(a, return_resid=True,
                                                    return_sweeps=True)
        assert int(sweeps.max()) < cap and int(sweeps_p.max()) < cap
        norm = max(float(torch.linalg.matrix_norm(a)), 1e-30)
        assert float((w - w_p).abs().max()) < 2e-5 * norm


@pytest.mark.cuda
def test_compress_factors_svd_on_the_card(cuda):
    """``compress``'s factorization on the card: each sector block of a
    graded qn-blocked matrix (one column at 1e-10) factored by cuSOLVER's
    SVD (counted in ``trunc.svd_blocks``, no Jacobi launch), with numpy's
    singular values of the same blocks and C = u diag(s) v^T."""
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.mps.svd_qn import svd_qn

    rng = np.random.default_rng(7)
    qnl = rng.integers(0, 2, (40, 2))
    qnr = rng.integers(0, 2, (30, 2))
    qntot = np.ones(2, dtype=int)
    c = rng.standard_normal((40, 30))
    c[:, 3] *= 1e-10
    c *= np.all(qnl[:, None, :] + qnr[None, :, :] == qntot, axis=-1)
    blocks, launches = COUNTERS["trunc.svd_blocks"], COUNTERS["jacobi.launches"]
    u, s, _, v, _, _ = trunc_device.compress_factors(
        torch.tensor(c, device=cuda), qnl, qnr, qntot, "L", resolve=True)
    assert COUNTERS["trunc.svd_blocks"] > blocks
    assert COUNTERS["jacobi.launches"] == launches
    _, s_host, _, _, _, _ = svd_qn(c, qnl, qnr, qntot, system="L", full_matrices=False)
    np.testing.assert_allclose(np.sort(s), np.sort(s_host), rtol=0, atol=1e-13)
    rebuilt = (u * torch.tensor(s, device=cuda)) @ v.T
    np.testing.assert_allclose(rebuilt.cpu().numpy(), c, rtol=0, atol=1e-12)


@pytest.mark.cuda
def test_tree_dmrg_reaches_the_kernel(cuda):
    """Tree DMRG (``tests/test_tn.py::test_optimize_ttns``'s model and
    procedure on a binary tree) on the card in fp32: every 2-site update's
    truncation launches the Jacobi kernel, and the lowest energy lies within
    1e-5 of the dense sector energy (0.3361574422, ``exact_model``)."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree, optimize_ttns

    assert backend.device.type == "cuda" and backend.is_32bits
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    tree = BasisTree.binary(model.basis)
    ttns = TTNS.random(tree, 1, 16)
    before = COUNTERS["jacobi.launches"]
    energies = optimize_ttns(ttns, TTNO(tree, model.ham_terms),
                             [[16, 0.4], [16, 0.2], [16, 0], [16, 0]])
    # four sweeps of the tree's five bonds, one truncation each
    assert COUNTERS["jacobi.launches"] - before >= 4 * 5
    assert ttns.root.tensor.device.type == "cuda"
    assert abs(min(energies) - 0.3361574422) < 1e-5


@pytest.mark.cuda
def test_offload_round_trip_keeps_layout(cuda):
    """A permuted view goes to pinned host memory and back with its values
    and its layout (a contiguous copy would send the next product down
    another cuBLAS path); a TieredStore evicts and restores it."""
    from renormalizer_tpu_torch.mps import offload

    x = torch.randn(4, 5, 6, device=cuda).permute(2, 0, 1)
    host = offload.to_host(x)
    assert host.device.type == "cpu" and host.is_pinned()
    assert host.stride() == x.stride()
    back = offload.to_device(host)
    assert back.device == x.device and back.stride() == x.stride()
    assert torch.equal(back, x)
    store = offload.TieredStore(1)
    store["a"], store["b"] = x, x + 1
    assert store.n_evicted == 1 and store._data["a"].is_pinned()
    assert torch.equal(store["a"], x) and store.n_restored == 1


@pytest.mark.cuda
def test_jacobi_kernel_on_every_visible_device(cuda):
    """One launch on each visible card, made while another card is the
    current one: the kernel runs where its tensor lies and matches the plain
    version there (the one-time attribute setup is per device)."""
    a_host = _symmetric_stack(7, 2, 96)
    for k in range(torch.cuda.device_count()):
        dev = torch.device("cuda", k)
        a = torch.tensor(a_host, dtype=torch.float32, device=dev)
        before = COUNTERS["jacobi.launches"]
        with torch.cuda.device((k + 1) % torch.cuda.device_count()):
            w, v = jacobi_eigh(a)
        w_p, _ = jacobi_eigh_reference(a)
        assert COUNTERS["jacobi.launches"] == before + 1
        assert w.device == dev and v.device == dev
        norm = float(torch.linalg.matrix_norm(a).min())
        assert float((w - w_p).abs().max()) < 2e-5 * norm


@pytest.mark.cuda
def test_mesh_hop_and_sector_placement_on_the_card(cuda, monkeypatch):
    """A (1, 2, 2) mesh on the card (four cards when visible, else one named
    four times): the sharded 2-site hop equals the unsharded einsum, and the
    truncation's sectors placed over the mesh give bitwise the candidates
    of no placement."""
    from renormalizer_tpu_torch import parallel as par
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.contract import einsum

    n = torch.cuda.device_count()
    devices = [torch.device("cuda", k % n) for k in range(4)] if n >= 4 else [cuda] * 4
    mesh = par.make_mesh(i=2, j=2, devices=devices)
    rng = np.random.default_rng(0)
    formula = "abc,bdef,fghj,ljk,cehk->adgl"
    ops = [torch.tensor(rng.standard_normal(s), device=cuda) for s in
           ((64, 5, 64), (5, 3, 3, 5), (5, 3, 3, 5), (64, 5, 64))]
    x = torch.tensor(rng.standard_normal((64, 3, 3, 64)), device=cuda)
    hop = par.sharded_hop_factory(mesh, formula, tuple(o.shape for o in ops), x.shape)
    out = hop(*ops, x.reshape(-1))
    assert out.device == x.device
    ref = einsum(formula, *ops, x).reshape(-1)
    assert float((out - ref).abs().max()) < 1e-10 * float(ref.abs().max())

    monkeypatch.setattr(trunc_device, "MASK_BUDGET", 0)
    qnl = np.repeat(np.array([[0], [1], [2]]), [40, 60, 28], axis=0)
    qnr = np.repeat(np.array([[2], [1], [0]]), [32, 56, 40], axis=0)
    c = rng.standard_normal((len(qnl), len(qnr))).astype(np.float32)
    c = c * ((qnl[:, None, 0] + qnr[None, :, 0]) == 2)
    coef = torch.tensor(c, device=cuda)
    par.set_global_mesh(mesh)
    try:
        runs = []
        for flag in (False, True):
            monkeypatch.setattr(trunc_device, "PLACE_SECTORS", flag)
            runs.append(trunc_device.candidates(coef, qnl, qnr, np.array([2]), "L", 32,
                                                want_complement=False))
    finally:
        par.set_global_mesh(None)
    (p0, s0, q0), (p1, s1, q1) = runs
    assert q0 == q1 and np.array_equal(s0, s1)
    assert all(a.device == coef.device and torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.cuda
def test_host_waits_are_counted_where_they_happen(cuda, monkeypatch):
    """With tracing on, every host wait of the port's device eigensolves
    and factorizations is counted under a span: the runtime's stream and
    event syncs in a profile of each call equal the ``waits.*`` counted
    (torch's through its sync debug mode, cuSOLVER's own at the call site,
    the pending spectrum's event at its read).  A CUDA ``_lanczos_expm``
    makes none and counts none."""
    from renormalizer_tpu_torch.lib import solvers
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "TRACING", True)
    rng = np.random.default_rng(5)
    a32 = torch.tensor(_symmetric_stack(1, 1, 12)[0], dtype=torch.float32, device=cuda)
    a64 = torch.tensor(_symmetric_stack(2, 1, 200)[0], device=cuda)
    h = torch.tensor(_symmetric_stack(3, 1, 64)[0], dtype=torch.complex64, device=cuda)
    v0 = torch.tensor(rng.standard_normal(64), dtype=torch.complex64, device=cuda)
    grams = torch.tensor(_symmetric_stack(4, 5, 48), dtype=torch.complex128, device=cuda)
    block = torch.tensor(rng.standard_normal((60, 40)), device=cuda)
    lam = torch.tensor(rng.random(16), device=cuda)
    calls = {
        "eigh_wide f32": lambda: solvers.eigh_wide(a32),
        "eigh_wide f64": lambda: solvers.eigh_wide(a64),
        "lanczos": lambda: solvers._lanczos_expm(lambda v: h @ v, -0.1j, v0, 30),
        "complex grams": lambda: trunc_device.gram_eigh(grams),
        "complex gram": lambda: trunc_device.gram_eigh(grams[0]),
        "resolved range": lambda: trunc_device._resolved_range(block, None),
        "pending spectrum": lambda: trunc_device.PendingSpectrum(lam).sigma(),
    }
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        torch.cuda.synchronize()  # the profiler's first start outside the count
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        before = profiling.snapshot()
        with torch.profiler.profile(activities=activities) as prof:
            with profiling.span("probe"):
                call()
        # the port calls no device-wide sync; the profiler may
        seen = collections.Counter(e.name for e in prof.events() if "Synchronize" in e.name)
        waits = sum(n for k, n in profiling.delta(before).items() if k.startswith("waits."))
        host_waits = seen["cudaStreamSynchronize"] + seen["cudaEventSynchronize"]
        if name == "lanczos":
            # the tridiagonal goes to the Jacobi kernel, which reads nothing back
            assert host_waits == 0 and waits == 0, (name, dict(seen), waits)
        else:
            assert host_waits > 0 and waits == host_waits, (name, dict(seen), waits)
    profiling.clear()


def _holstein3():
    """The 3-molecule chain of the benchmark's Holstein molecule (two modes
    of 4 levels, J = -0.1 eV)."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity

    phs = [Phonon.simple_phonon(Quantity(w, "cm-1"), Quantity(d), 4)
           for w, d in ((106.51, 30.137), (1555.55, 8.7729))]
    return HolsteinModel([Mol(Quantity(2.67, "eV"), phs)] * 3, Quantity(-0.1, "eV"))


def _fresh_graph_cache(monkeypatch):
    from renormalizer_tpu_torch.lib import solvers

    monkeypatch.setattr(solvers, "_DEVICE_GRAPHS", {})


def _relative(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.cuda
def test_lanczos_graph_replays_match_the_eager_path(cuda, monkeypatch):
    """The Lanczos exponentials of the 3-molecule Holstein chain's fused
    TDVP-PS as CUDA graphs.  One key, taken from a real step (a middle
    site's forward exponential): its first call runs eagerly, the second
    captures, and replays with other operand values, with +dt, -dt and
    another step size each meet the eager result within 1e-5 relative (a
    stale static buffer would not); 1 capture, the rest replays.  Then
    whole steps with graphs meet whole steps without them, ending steps
    drops the graphs of keys no longer met (and the cache captures again
    after the last is gone), and the opaque hop of ``expm_krylov`` runs
    eagerly."""
    from renormalizer_tpu_torch import EvolveConfig, EvolveMethod, Mpo, Mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.lib import solvers
    from renormalizer_tpu_torch.ops import jacobi
    from renormalizer_tpu_torch.ops.contract import einsum
    from renormalizer_tpu_torch.utils import profiling

    assert backend.device.type == "cuda" and backend.is_32bits
    _fresh_graph_cache(monkeypatch)
    model = _holstein3()
    mpo = Mpo(model)
    backend._seed = 2024
    start = Mps.random(model, 1, 16, percent=1.0)
    start.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    calls, fused = [], solvers.expm_krylov_fused

    def record(formula, operands, dt, c0, max_m=30):
        calls.append((formula, [o.clone() for o in operands], dt, c0.clone()))
        return fused(formula, operands, dt, c0, max_m)

    monkeypatch.setattr(solvers, "expm_krylov_fused", record)
    start.copy().evolve(mpo, 0.2)
    monkeypatch.setattr(solvers, "expm_krylov_fused", fused)
    formula, ops, dt, c0 = max((c for c in calls if len(c[1]) == 3),
                               key=lambda c: c[3].numel())
    assert isinstance(dt, complex) and c0.is_complex()

    def eager(operands, step, c):
        shape = tuple(c.shape)
        hop = lambda v: einsum(formula, *operands, v.reshape(shape)).reshape(-1)  # noqa: E731
        w, _ = solvers._lanczos_expm(hop, step, c.reshape(-1), 30)
        return w.reshape(shape)

    # other values in the same layout: the left environment scaled (still
    # Hermitian), another state
    other = [torch.empty_like(o).copy_(1.5 * o) if i == 0 else o for i, o in enumerate(ops)]
    c1 = torch.empty_like(c0).copy_(c0.flip(-1))
    _fresh_graph_cache(monkeypatch)
    before = profiling.snapshot()
    cases = [(ops, dt, c0), (ops, dt, c0), (other, dt, c1), (ops, -dt, c0),
             (other, 0.5 * dt, c1), (ops, -dt, c1)]
    for operands, step, c in cases:
        got = solvers.expm_krylov_fused(formula, operands, step, c)
        assert _relative(got, eager(operands, step, c)) < 1e-5, step
    counts = profiling.delta(before)
    assert counts["lanczos.graph.eager.first_sighting"] == 1
    assert counts["lanczos.graph.captures"] == 1
    assert counts["lanczos.graph.replays"] == len(cases) - 1
    assert counts["lanczos.jacobi_launches"] == counts["lanczos.calls"] == 2 * len(cases)
    assert counts["jacobi.launches"] == 0
    # the last replay's tridiagonal, kept in the graph's static outputs
    (graph,) = solvers._DEVICE_GRAPHS[c0.device].graphs.values()
    t_mat, w, _, resid, nsweeps = graph.tridiagonal
    assert 0 < int(nsweeps) < jacobi.default_sweeps(torch.float32) + jacobi.MAX_EXTRA_SWEEPS
    assert float(resid) < 1e-5
    w_ref = torch.linalg.eigvalsh(t_mat.double())
    assert float((w.double() - w_ref).abs().max()) <= 1e-5 * float(torch.linalg.matrix_norm(t_mat))

    # whole steps: graphs from the second sighting on, against eager calls
    def steps(n):
        mps = start.copy()
        for _ in range(n):
            mps = mps.evolve(mpo, 0.2)
        return torch.cat([t.reshape(-1) for t in mps])

    _fresh_graph_cache(monkeypatch)
    before = profiling.snapshot()
    with_graphs = steps(3)
    counts = profiling.delta(before)
    assert counts["lanczos.graph.captures"] > 0
    assert counts["lanczos.graph.replays"] > counts["lanczos.graph.captures"]
    # each step ends one for the cache: keys met in neither of the last two
    # are dropped with their static buffers
    graphs = solvers._DEVICE_GRAPHS[c0.device]
    assert graphs.nbytes > 0 and counts["lanczos.graph.dropped"] == 0
    for _ in range(3):
        solvers.end_graph_step()
    counts = profiling.delta(before)
    assert counts["lanczos.graph.dropped"] == counts["lanczos.graph.captures"]
    assert graphs.graphs == {} and graphs.met == {} and graphs.nbytes == 0
    # and the cache captures again once every graph is gone
    assert _relative(steps(3), with_graphs) < 1e-5
    assert profiling.delta(before)["lanczos.graph.captures"] == 2 * counts["lanczos.graph.captures"]
    monkeypatch.setattr(solvers._DeviceGraphs, "get", lambda self, *args: None)
    assert _relative(with_graphs, steps(3)) < 1e-5

    before = profiling.snapshot()
    h = torch.tensor(_symmetric_stack(3, 1, 64)[0], dtype=torch.complex64, device=cuda)
    v0 = torch.ones(64, dtype=torch.complex64, device=cuda)
    for _ in range(2):
        solvers.expm_krylov(lambda v: h @ v, -0.1j, v0)
    counts = profiling.delta(before)
    assert counts["lanczos.graph.eager.opaque_hop"] == 2
    assert counts["lanczos.graph.captures"] == counts["lanczos.graph.replays"] == 0


@pytest.mark.cuda
def test_lanczos_tridiagonal_on_the_kernel_matches_linalg_eigh(cuda, monkeypatch):
    """The tridiagonals of real Lanczos runs on the card, a TDVP-PS step of
    the 3-molecule chain and a start inside a 3-dimensional invariant
    subspace (breakdown: every coupling past the third is zero), solved by
    the Jacobi kernel and by ``torch.linalg.eigh``: no solve at the sweep
    cap, eigenvalues within 1e-5 of ||T||, and the same exponential's coefficients u exp(dt w) u^T e_1
    (unique where eigenvalues are degenerate) within 1e-5."""
    from renormalizer_tpu_torch import EvolveConfig, EvolveMethod, Mpo, Mps
    from renormalizer_tpu_torch.lib import solvers
    from renormalizer_tpu_torch.ops import jacobi

    mats, solve = [], solvers._tridiag_eigh

    def keep(t):
        mats.append(t.clone())
        return solve(t)

    monkeypatch.setattr(solvers, "_tridiag_eigh", keep)
    # eager calls only: a capture would record a tridiagonal that is not computed yet
    monkeypatch.setattr(solvers._DeviceGraphs, "get", lambda self, *args: None)
    model = _holstein3()
    mps = Mps.random(model, 1, 16, percent=1.0)
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    mps.evolve(Mpo(model), 0.2)
    rng = np.random.default_rng(9)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    blocks = [rng.standard_normal((3, 3)), 0.2 * rng.standard_normal((37, 37))]
    h = q @ np.block([[(blocks[0] + blocks[0].T) / 2, np.zeros((3, 37))],
                      [np.zeros((37, 3)), (blocks[1] + blocks[1].T) / 2]]) @ q.T
    h = torch.tensor(h, dtype=torch.complex64, device=cuda)
    v0 = torch.tensor(q[:, :3] @ [0.5, -1.0, 0.25], dtype=torch.complex64, device=cuda)
    solvers.expm_krylov(lambda v: h @ v, -0.4j, v0)
    broken = mats[-1]
    assert float(broken[3:].abs().max()) == 0.0 and float(broken[:3, :3].abs().max()) > 0
    assert len(mats) > 2 and all(t.is_cuda and t.dtype == torch.float32 for t in mats)
    cap = jacobi.default_sweeps(torch.float32) + jacobi.MAX_EXTRA_SWEEPS
    for t in mats:
        w, u, _, nsweeps = solve(t)
        assert int(nsweeps) < cap
        w_ref, u_ref = torch.linalg.eigh(t.double())
        norm = float(torch.linalg.matrix_norm(t))
        assert float((w.double() - w_ref).abs().max()) <= 1e-5 * norm
        coef = (u * u[0]).to(torch.complex64) @ torch.exp(-0.1j * w)
        coef_ref = (u_ref * u_ref[0]).to(torch.complex128) @ torch.exp(-0.1j * w_ref)
        assert float((coef.to(torch.complex128) - coef_ref).abs().max()) <= 1e-5
