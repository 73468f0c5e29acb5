"""The port's mesh parallelism (``renormalizer_tpu_torch.parallel``) against
the JAX package's, fp64 on the CPU.

The port's mesh is ``make_mesh(i=2, j=2, devices=["cpu"] * 4)``: one
process, one device named four times, so every piece of the sharded path
runs (slicing, per-block einsums, the gathers, sector placement) and only
the copies between cards are skipped.  The JAX side runs on the conftest's
virtual 8-device mesh, and runs functions only, never a sweep (its sweeps
under the mesh are ``tests/test_parallel.py``).  Inputs come from
``numpy.random.default_rng``; the Davidson comparison takes a local problem
of the port's own sweep.  Tolerances: 1e-10 between the packages' hops and
spectra, 1e-12 against the port's unsharded einsum, the Davidson eigenvalue
1e-10 and vector 1e-8 (both converge to a residual of 1e-10), 1e-7 against
dense ground states (the JAX tests' bound), 1e-5 relative against the
Holstein regression energy.
"""

import contextlib

import numpy as np
import pytest
import torch

import renormalizer_tpu.parallel as jpar
from fixtures import GS_E, dense_hamiltonian
from renormalizer_tpu.lib.solvers import davidson_fused as jax_davidson_fused
from renormalizer_tpu.mps import trunc_device as jax_trunc_device
from renormalizer_tpu.parallel import hop as jhop
import renormalizer_tpu_torch.parallel as par
from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.cv import SpectraZtCV
from renormalizer_tpu_torch.cv import spectra_cv
from renormalizer_tpu_torch.model import BasisHalfSpin, Model, Op, heisenberg_ops
from renormalizer_tpu_torch.mps import Mpo, Mps, gs, trunc_device
from renormalizer_tpu_torch.ops.contract import einsum
from renormalizer_tpu_torch.parallel import hop as phop
from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree, optimize_ttns
from renormalizer_tpu_torch.utils import EvolveConfig, EvolveMethod, OptimizeConfig, constant
from renormalizer_tpu_torch.utils import profiling

torch.set_num_threads(2)

HOP = "abc,bdef,fghj,ljk,cehk->adgl"
TREE_HOP = "aeb,cfd,eghf,bhd->agc"


def port_mesh():
    return par.make_mesh(i=2, j=2, devices=["cpu"] * 4)


@pytest.fixture
def mesh():
    """The port's mesh and the JAX package's, both installed."""
    m = port_mesh()
    par.set_global_mesh(m)
    jpar.set_global_mesh(jpar.make_mesh(data=1, i=2, j=2))
    phop.reset_stats()
    yield m
    par.set_global_mesh(None)
    jpar.set_global_mesh(None)


def _hop_inputs():
    """``tests/test_parallel.py``'s 2-site hop operands (seed 0)."""
    M, w, d = 16, 5, 3
    rng = np.random.default_rng(0)
    L = rng.standard_normal((M, w, M))
    W1 = rng.standard_normal((w, d, d, w))
    W2 = rng.standard_normal((w, d, d, w))
    R = rng.standard_normal((M, w, M))
    x = rng.standard_normal((M, d, d, M))
    return [L, W1, W2, R], x


def _tree_inputs():
    """``tests/test_parallel.py``'s 3-child tree-node operands (seed 3)."""
    rng = np.random.default_rng(3)
    E1 = rng.standard_normal((8, 3, 8))
    Ep = rng.standard_normal((6, 3, 6))
    O = rng.standard_normal((3, 3, 3, 3))
    x = rng.standard_normal((8, 3, 6))
    return [E1, Ep, O], x


_CASES = {
    "mps": (HOP, _hop_inputs, par.sharded_hop_factory, jpar.sharded_hop_factory),
    "tree": (TREE_HOP, _tree_inputs, par.sharded_general_hop_factory,
             jpar.sharded_general_hop_factory),
}


def test_make_mesh_layout_and_error():
    """The JAX package's axes, layout and error: the first data*i*j
    devices as (data, i, j), a device may repeat; too few raise."""
    m = par.make_mesh(data=2, i=1, j=2, devices=["cpu"] * 5)
    assert m.axis_names == ("data", "i", "j")
    assert m.devices.shape == (2, 1, 2)
    assert m.shape == {"data": 2, "i": 1, "j": 2}
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(RuntimeError, match=r"mesh \(data=1, i=2, j=2\) needs 4 "
                                           r"devices, found 3"):
        par.make_mesh(i=2, j=2, devices=["cpu"] * 3)
    par.set_global_mesh(m)
    try:
        assert par.get_global_mesh() is m
    finally:
        par.set_global_mesh(None)
    assert par.get_global_mesh() is None


def test_one_card_spelled_two_ways_is_one_device(monkeypatch):
    """``"cuda"`` and ``"cuda:0"`` name one card: the mesh and
    ``backend.use_device`` resolve the unindexed spelling to the current
    card, so a mesh over both has one distinct device and places no sector
    unless placement is forced.  ``torch.cuda.current_device`` is patched to
    0 and no tensor is made, so no card is needed."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    m = par.make_mesh(i=2, j=2, devices=["cuda", "cuda:0", "cuda", "cuda:0"])
    assert set(m.devices.flat) == {torch.device("cuda", 0)}
    par.set_global_mesh(m)
    try:
        monkeypatch.setattr(trunc_device, "PLACE_SECTORS", None)
        assert trunc_device._sector_devices() is None
        monkeypatch.setattr(trunc_device, "PLACE_SECTORS", True)
        assert trunc_device._sector_devices() == [torch.device("cuda", 0)] * 4
    finally:
        par.set_global_mesh(None)
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        with backend.use_device("cuda"):
            assert backend.device == torch.device("cuda", 0)
    assert backend.device == torch.device("cpu")


@pytest.mark.parametrize("case", ["mps", "tree"])
def test_sharded_hop_matches_jax_and_unsharded(mesh, case):
    """(a), (b): the port's sharded hop equals the JAX package's and the
    port's own unsharded einsum."""
    formula, inputs, factory, jax_factory = _CASES[case]
    ops, x = inputs()
    shapes = tuple(o.shape for o in ops)
    hop = factory(mesh, formula, shapes, x.shape)
    jax_hop = jax_factory(jpar.get_global_mesh(), formula, shapes, x.shape)
    assert hop is not None and jax_hop is not None
    tops = [torch.as_tensor(o) for o in ops]
    out = hop(*tops, torch.as_tensor(x).reshape(-1)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_hop(*ops, x.ravel())),
                               rtol=0, atol=1e-10)
    ref = einsum(formula, *tops, torch.as_tensor(x)).reshape(-1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    # bind places once; each matvec of the bound hop is the same product
    matvec = hop.bind(*tops)
    np.testing.assert_array_equal(matvec(torch.as_tensor(x).reshape(-1)).numpy(), out)


def test_indivisible_shapes_fall_back_in_both_packages(mesh):
    """(c): bond dimensions that do not divide the mesh give ``None``."""
    shapes = ((15, 5, 15), (5, 3, 3, 5), (5, 3, 3, 5), (15, 5, 15))
    assert par.sharded_hop_factory(mesh, HOP, shapes, (15, 3, 3, 15)) is None
    assert jpar.sharded_hop_factory(jpar.get_global_mesh(), HOP, shapes,
                                    (15, 3, 3, 15)) is None
    # the factory counts its own fallback
    assert phop.STATS == {"sharded": 0, "fallback": 1}
    # a mesh of one device never shards
    one = par.make_mesh(devices=["cpu"])
    assert par.sharded_hop_factory(one, HOP, tuple(o.shape for o in _hop_inputs()[0]),
                                   (16, 3, 3, 16)) is None


@pytest.mark.parametrize("case,nbytes", [("mps", 27648), ("tree", 1728)])
def test_collective_inventory_matches_jax(mesh, case, nbytes):
    """(d): two gathers a matvec with the bytes of the gathered results,
    the JAX package's HLO inventory of the same hop."""
    formula, inputs, factory, jax_factory = _CASES[case]
    ops, x = inputs()
    shapes = tuple(o.shape for o in ops)
    hop = factory(mesh, formula, shapes, x.shape)
    inv = phop.collective_inventory(hop, *[torch.zeros(s, dtype=torch.float64)
                                           for s in shapes],
                                    torch.zeros(x.size, dtype=torch.float64))
    jax_hop = jax_factory(jpar.get_global_mesh(), formula, shapes, x.shape)
    jax_inv = jhop.collective_inventory(jax_hop, *[np.zeros(s) for s in shapes],
                                        np.zeros(x.size))
    assert inv == {"all-gather": {"count": 2, "bytes": nbytes}}
    assert inv == jax_inv
    # the run's tally is left as it was
    assert phop.GATHERS == {"count": 0, "bytes": 0, "matvecs": 0}


def test_engaged_registry_and_audit(mesh):
    """(e): the factories count the solves they shard, and the audit reads
    the gathers run, per matvec and per sweep: the JAX package's 2.0 a
    sweep for two solves of its test over two sweeps (its registry replays
    one matvec a solve)."""
    ops, x = _hop_inputs()
    shapes = tuple(o.shape for o in ops)
    cshape = x.shape
    for _ in range(2):
        hop = par.sharded_hop_factory(mesh, HOP, shapes, cshape)
        hop.bind(*[torch.as_tensor(o) for o in ops])(torch.as_tensor(x).reshape(-1))
    assert phop.STATS == {"sharded": 2, "fallback": 0}
    audit = phop.audit_engaged_collectives(n_sweeps=2)
    assert audit["matvecs"] == 2
    assert audit["per_matvec"] == {"all-gather": {"count": 2.0, "bytes": 27648.0}}
    assert audit["per_sweep"] == {"all-gather": {"count": 2.0, "bytes": 27648.0}}
    jhop.reset_stats()
    jmesh = jpar.get_global_mesh()
    assert jhop.record_engagement(jmesh, HOP, shapes, cshape)
    assert jhop.record_engagement(jmesh, HOP, shapes, cshape)
    jaudit = jhop.audit_engaged_collectives(jmesh, n_sweeps=2)
    assert (jaudit["per_sweep_lower_bound"]["all-gather"]["count"]
            == audit["per_sweep"]["all-gather"]["count"])
    # a complex128 matvec gathers twice the bytes; the tree hop its own
    phop.reset_stats()
    tops = [torch.as_tensor(o, dtype=torch.complex128) for o in ops]
    par.sharded_hop_factory(mesh, HOP, shapes, cshape).bind(*tops)(
        torch.zeros(x.size, dtype=torch.complex128))
    assert phop.audit_engaged_collectives()["per_matvec"]["all-gather"]["bytes"] == 2 * 27648
    phop.reset_stats()
    tree_ops, tx = _tree_inputs()
    par.sharded_general_hop_factory(mesh, TREE_HOP, tuple(o.shape for o in tree_ops),
                                    tx.shape)(*map(torch.as_tensor, tree_ops),
                                              torch.as_tensor(tx).reshape(-1))
    assert phop.audit_engaged_collectives()["per_sweep"] == {
        "all-gather": {"count": 2.0, "bytes": 1728.0}}


def _heisenberg(nspin):
    return Model([BasisHalfSpin(i) for i in range(nspin)], heisenberg_ops(nspin))


@pytest.fixture(scope="module")
def sharded_dmrg():
    """DMRG of the 10-spin Heisenberg chain at M=32 under the port's mesh
    (``tests/test_parallel.py``'s procedure), with the inputs of one
    engaged Davidson call and the device of every operand it got."""
    model = _heisenberg(10)
    calls = []
    orig = gs.davidson_fused

    def capture(formula, operands, cshape, x0, mask, **kwargs):
        calls.append((formula, [o.clone() for o in operands], tuple(cshape),
                      x0.clone(), mask.clone(), kwargs))
        return orig(formula, operands, cshape, x0, mask, **kwargs)

    par.set_global_mesh(port_mesh())
    phop.reset_stats()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gs, "davidson_fused", capture)
            mps = Mps.random(model, 0, 32)
            mps.optimize_config = OptimizeConfig(
                procedure=[[32, 0.4], [32, 0.2], [32, 0], [32, 0]])
            energies, opt = gs.optimize_mps(mps, Mpo(model))
        stats = dict(phop.STATS, gathers=phop.GATHERS["count"])
    finally:
        par.set_global_mesh(None)
    return dict(model=model, energies=energies, opt=opt, calls=calls, stats=stats)


def test_dmrg_under_the_mesh_reaches_the_dense_ground_state(sharded_dmrg):
    """(h), and why the port has no ``_harmonize_devices``: every site
    tensor and environment is on the home device after a sharded sweep."""
    e = min(float(np.min(np.asarray(x))) for x in sharded_dmrg["energies"])
    e_exact = np.linalg.eigvalsh(dense_hamiltonian(sharded_dmrg["model"]))[0]
    assert abs(e - e_exact) < 1e-7
    assert sharded_dmrg["stats"]["sharded"] > 0, "no site update was sharded"
    # the sharded matvec ran: two gathers a matvec
    assert sharded_dmrg["stats"]["gathers"] >= 2 * sharded_dmrg["stats"]["sharded"]
    home = backend.device
    assert all(mt.device == home for mt in sharded_dmrg["opt"])
    for _, operands, _, x0, mask, _ in sharded_dmrg["calls"]:
        assert all(o.device == home for o in operands)
        assert x0.device == home and mask.device == home


def test_davidson_under_the_mesh_matches_jax(mesh, sharded_dmrg):
    """(f): one ``davidson_fused`` call under each package's mesh on the
    same L, W, R, x0 and mask (an engaged local problem of (h)'s sweep)."""
    shardable = [c for c in sharded_dmrg["calls"]
                 if phop.sharded_hop_factory(mesh, c[0], tuple(o.shape for o in c[1]),
                                             c[2]) is not None]
    formula, operands, cshape, x0, mask, kwargs = shardable[-1]
    before = phop.STATS["sharded"]
    theta, x, _ = gs.davidson_fused(formula, operands, cshape, x0, mask, **kwargs)
    assert phop.STATS["sharded"] == before + 1
    jtheta, jx, _ = jax_davidson_fused(
        formula, [o.numpy() for o in operands], cshape, x0.numpy(), None,
        mask.numpy().ravel(), inverse=kwargs["inverse"], tol=kwargs["tol"],
        max_cycle=kwargs["max_cycle"], diag_mode="2")
    assert abs(float(theta) - float(jtheta)) < 1e-10
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-8)


def _three_sector_coefficient():
    """``tests/test_parallel.py``'s qn-conserving coefficient (seed 11):
    three sectors on each side, qntot 2."""
    rng = np.random.default_rng(11)
    qnl = np.repeat(np.array([[0], [1], [2]]), [20, 30, 14], axis=0)
    qnr = np.repeat(np.array([[2], [1], [0]]), [16, 28, 20], axis=0)
    c = rng.standard_normal((len(qnl), len(qnr)))
    c = c * ((qnl[:, None, 0] + qnr[None, :, 0]) == 2)
    return c, qnl, qnr


def test_sector_placement_is_bitwise_and_matches_jax(mesh, monkeypatch):
    """(g): the sectors placed over the mesh (forced: the test mesh names
    one device four times) give candidates and spectra bitwise equal to no
    placement (the masked batch off on both sides, as the JAX test pins its
    batch off); cap 32 covers every sector's rank, so the spectrum is exact
    and equals the JAX package's.  By default a mesh of one distinct device
    places nothing."""
    monkeypatch.setattr(trunc_device, "MASK_BUDGET", 0)
    c, qnl, qnr = _three_sector_coefficient()

    def run(flag):
        monkeypatch.setattr(trunc_device, "PLACE_SECTORS", flag)
        before = profiling.snapshot()
        parts, sigma, qn_list = trunc_device.candidates(
            c, qnl, qnr, np.array([2]), "L", 32, want_complement=False)
        placed = {k[len("trunc.sectors_placed."):]: v
                  for k, v in profiling.delta(before).items()
                  if k.startswith("trunc.sectors_placed.")}
        return [p.numpy() for p in parts], sigma, qn_list, placed

    parts0, sigma0, qn0, placed0 = run(False)
    parts1, sigma1, qn1, placed1 = run(True)
    assert placed0 == {} and placed1 == {"cpu": 3}
    assert run(None)[3] == {}
    assert qn0 == qn1
    assert np.array_equal(sigma0, sigma1)
    assert len(parts0) == len(parts1) == 3
    for a, b in zip(parts0, parts1):
        assert np.array_equal(a, b)

    monkeypatch.setenv("RENO_DEVICE_TRUNC", "1")
    monkeypatch.setenv("RENO_TRUNC_BATCH", "0")
    jax_trunc_device._IDX_CACHE.clear()
    _, jsigma, _ = jax_trunc_device.candidates(
        c, qnl, qnr, np.array([2]), "L", 32, want_complement=False)
    jsigma = np.asarray(jsigma)
    ours = np.sort(sigma1[sigma1 > 0])
    theirs = np.sort(jsigma[jsigma > 0])
    assert len(ours) == len(theirs) == 16 + 28 + 14  # the sectors' ranks
    np.testing.assert_allclose(ours, theirs, rtol=1e-10, atol=0)


def test_tree_dmrg_under_the_mesh(mesh):
    """(i): TTNS DMRG of the 8-spin binary tree at M=16 engages the
    general hop and reaches the dense ground state."""
    nspin = 8
    basis = [BasisHalfSpin(i) for i in range(nspin)]
    tree = BasisTree.binary(basis)
    ham = heisenberg_ops(nspin)
    energies = optimize_ttns(TTNS.random(tree, 0, 16), TTNO(tree, ham))
    e = min(float(np.min(np.asarray(x))) for x in energies)
    assert phop.STATS["sharded"] > 0, "the tree hop never engaged the mesh"
    assert phop.GATHERS["count"] >= 2 * phop.STATS["sharded"]
    e_exact = np.linalg.eigvalsh(dense_hamiltonian(Model(basis, ham)))[0]
    assert abs(e - e_exact) < 1e-7


def test_tdvp_ps_is_the_same_under_the_mesh():
    """(j): no sharded hop reaches TDVP-PS in either package (the JAX
    package's ``allow_fused`` gate is not carried); a run under the mesh
    gives the numbers of one without it."""
    nspin = 10
    model = _heisenberg(nspin)
    mpo = Mpo(model)

    def run():
        mps = Mps.hartree_product_state(
            model, {i: (1 if i % 2 == 0 else 0) for i in range(nspin)})
        mps = mps.expand_bond_dimension(hint_mpo=mpo)
        mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
        for _ in range(3):
            mps = mps.evolve(mpo, 0.2)
        return np.array(mps.expectations([Op("Z", i) for i in range(nspin)]))

    par.set_global_mesh(port_mesh())
    try:
        with_mesh = run()
    finally:
        par.set_global_mesh(None)
    np.testing.assert_allclose(with_mesh, run(), rtol=0, atol=1e-8)


def port_holstein_model() -> HolsteinModel:
    """``tests/fixtures.py``'s 3-molecule Holstein model in the port."""
    j_matrix = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3],
                         [-0.2, -0.3, 0.0]]) / constant.au2ev
    omegas = [Quantity(106.51, "cm^{-1}"), Quantity(1555.55, "cm^{-1}")]
    disps = [Quantity(30.1370, "a.u."), Quantity(8.7729, "a.u.")]
    ph_list = [Phonon([w, w], [Quantity(0), d], 4) for w, d in zip(omegas, disps)]
    return HolsteinModel([Mol(Quantity(2.67, "eV"), ph_list, 15.45)] * 3, j_matrix)


def test_sector_parallel_dmrg_regression(mesh, monkeypatch):
    """(k): the Holstein regression DMRG with its sectors placed over the
    mesh (forced: the test mesh names one device four times)."""
    monkeypatch.setattr(trunc_device, "PLACE_SECTORS", True)
    before = profiling.snapshot()
    model = port_holstein_model()
    mps = Mps.random(model, 1, 10, percent=1.0)
    mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0]]
    energies, _ = gs.optimize_mps(mps, Mpo(model))
    assert min(energies) == pytest.approx(GS_E, rel=1e-5)
    assert profiling.delta(before)["trunc.sectors_placed.cpu"] > 0


def test_batch_run_places_one_worker_per_device(monkeypatch):
    """(l): ``batch_run`` places worker ``w`` on ``_local_devices()[w]``,
    its solver's tensors there, and gives the serial loop's responses."""
    eta = 0.05
    procedure = [0.4, 0.2, 0.1, 0] + [0] * 10
    ph = Phonon.simple_phonon(Quantity(1.0), Quantity(0.4), 2)
    model = HolsteinModel([Mol(Quantity(1.0), [ph], 1.0)] * 2, Quantity(0.2))
    freqs = [1.0, 1.05, 1.45, 1.5]
    serial_cv = SpectraZtCV(model, "abs", m_max=16, eta=eta, procedure_cv=procedure)
    serial = [serial_cv.cv_solve(w) for w in freqs]

    devices = [torch.device("cpu"), torch.device("cpu")]
    monkeypatch.setattr(spectra_cv, "_local_devices", lambda: devices)
    placed = []
    clone = spectra_cv.SpectraCv.clone_for_batch

    def recording_clone(self, device=None):
        new = clone(self, device)
        mps = [getattr(new, attr) for attr in ("cv_mps", "b_mps", "h_mpo", "a_oper")]
        placed.append((device, {mt.device for mp in mps if mp is not None for mt in mp}))
        return new

    monkeypatch.setattr(spectra_cv.SpectraCv, "clone_for_batch", recording_clone)
    batch_cv = SpectraZtCV(model, "abs", m_max=16, eta=eta, procedure_cv=procedure)
    np.testing.assert_allclose(spectra_cv.batch_run(freqs, 2, batch_cv), serial,
                               rtol=1e-4)
    assert len(placed) == 2
    assert placed[0][0] is devices[0] and placed[1][0] is devices[1]
    assert all(devs == {devices[0]} for _, devs in placed)
