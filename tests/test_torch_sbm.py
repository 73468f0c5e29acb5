"""The port's spin-boson job (``param2mollist`` -> ``SpinBosonDynamics`` ->
TDVP-PS) against the JAX package's and a dense expm oracle, fp64 on the CPU."""

import os

import numpy as np
import pytest
import scipy.linalg
import torch

import renormalizer_tpu as rj
from renormalizer_tpu.sbm import SpinBosonDynamics as JaxSpinBosonDynamics
from renormalizer_tpu.sbm import param2mollist as jax_param2mollist
from renormalizer_tpu_torch import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
    Mpo,
    Mps,
    Quantity,
    TdMpsJob,
)
from renormalizer_tpu_torch.sbm import OhmicSDF, SpinBosonDynamics, param2mollist

torch.set_num_threads(2)

PARAMS = dict(alpha=0.05, renormalization_p=1, n_phonons=3)
DT, NSTEPS = 0.2, 10


def models():
    jmodel = jax_param2mollist(raw_delta=rj.Quantity(1), omega_c=rj.Quantity(20), **PARAMS)
    tmodel = param2mollist(raw_delta=Quantity(1), omega_c=Quantity(20), **PARAMS)
    return jmodel, tmodel


def dense_oracle(model):
    """sigma_z(t), sigma_x(t) of spin up + bath vacuum under the
    kron-assembled dense Hamiltonian (built from ``basis.op_mat``, not from
    the MPO)."""
    dims = [b.nbas for b in model.basis]

    def embed(mats):
        full = np.eye(1)
        for i, n in enumerate(dims):
            full = np.kron(full, mats.get(i, np.eye(n)))
        return full

    h = np.zeros((int(np.prod(dims)),) * 2)
    for op in model.ham_terms:
        elem_ops, factor = op.split_elementary(model.dof_to_siteidx)
        h = h + factor * embed({
            model.dof_to_siteidx[e.dofs[0]]: model.dof_to_basis[e.dofs[0]].op_mat(e)
            for e in elem_ops})
    sz = embed({0: np.diag([1.0, -1.0])})
    sx = embed({0: np.array([[0.0, 1.0], [1.0, 0.0]])})
    psi0 = np.zeros(len(h))
    psi0[0] = 1.0
    out = []
    for i in range(NSTEPS + 1):
        psi = scipy.linalg.expm(-1j * DT * i * h) @ psi0
        out.append([np.real(psi.conj() @ sz @ psi), np.real(psi.conj() @ sx @ psi)])
    return h, np.array(out)


def test_param2mollist_matches_jax():
    jmodel, tmodel = models()
    assert [b.nbas for b in tmodel.basis] == [b.nbas for b in jmodel.basis]
    for tph, jph in zip(tmodel.ph_list, jmodel.ph_list):
        np.testing.assert_allclose(tph.omega, jph.omega, rtol=1e-14)
        np.testing.assert_allclose(tph.dis, jph.dis, rtol=1e-14)
    assert tmodel.delta == pytest.approx(jmodel.delta, rel=1e-14)
    tdense, jdense = Mpo(tmodel).todense(), rj.Mpo(jmodel).todense()
    np.testing.assert_allclose(tdense, jdense, atol=1e-12, rtol=0)
    h, _ = dense_oracle(tmodel)
    np.testing.assert_allclose(tdense, h, atol=1e-12, rtol=0)
    # the discretizations themselves
    sdf = OhmicSDF(0.05, Quantity(20))
    jsdf = rj.sbm.OhmicSDF(0.05, rj.Quantity(20))
    for got, ref in zip(sdf.Wang1(5), jsdf.Wang1(5)):
        np.testing.assert_allclose(got, ref, rtol=1e-14)


@pytest.mark.parametrize("compress_config", [None, ("fixed", 8)],
                         ids=["default-threshold", "fixed-M8"])
def test_spin_boson_dynamics(compress_config):
    """sigma_z(t), sigma_x(t) over 10 steps of 0.2: port == JAX to 1e-8 and
    == dense expm to 1e-4 (the bond dimensions reach the exact ones here)."""
    jmodel, tmodel = models()
    jcc = tcc = None
    if compress_config is not None:
        jcc = rj.CompressConfig(rj.CompressCriteria.fixed, max_bonddim=compress_config[1])
        tcc = CompressConfig(CompressCriteria.fixed, max_bonddim=compress_config[1])
    jjob = JaxSpinBosonDynamics(
        jmodel, compress_config=jcc,
        evolve_config=rj.EvolveConfig(rj.EvolveMethod.tdvp_ps))
    tjob = SpinBosonDynamics(
        tmodel, compress_config=tcc,
        evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
    assert isinstance(tjob, TdMpsJob)
    assert tjob.latest_mps.bond_dims == jjob.latest_mps.bond_dims
    assert not tjob.latest_mps.is_complex
    jjob.evolve(evolve_dt=DT, nsteps=NSTEPS)
    tjob.evolve(evolve_dt=DT, nsteps=NSTEPS)
    np.testing.assert_allclose(tjob.evolve_times_array, DT * np.arange(NSTEPS + 1))
    np.testing.assert_allclose(tjob.sigma_z, jjob.sigma_z, atol=1e-8, rtol=0)
    np.testing.assert_allclose(tjob.sigma_x, jjob.sigma_x, atol=1e-8, rtol=0)
    np.testing.assert_allclose(np.array(tjob.bond_entropy), np.array(jjob.bond_entropy),
                               atol=1e-7, rtol=0)
    _, oracle = dense_oracle(tmodel)
    assert tjob.sigma_z[0] == 1.0
    assert np.abs(np.array(tjob.sigma_z) - oracle[:, 0]).mean() < 1e-4
    assert np.abs(np.array(tjob.sigma_x) - oracle[:, 1]).mean() < 1e-4
    assert tjob.latest_mps.is_complex
    assert tjob.latest_mps.mp_norm == pytest.approx(1.0, abs=1e-12)


def test_job_dumps(tmp_path):
    """The job writes its observables every step, and the state with
    ``dump_mps``; both load back."""
    _, tmodel = models()
    job = SpinBosonDynamics(
        tmodel, evolve_config=EvolveConfig(EvolveMethod.tdvp_ps),
        dump_dir=str(tmp_path), job_name="sbm", dump_mps="one")
    job.evolve(nsteps=3, evolve_time=0.6)
    data = np.load(tmp_path / "sbm.npz")
    np.testing.assert_allclose(data["sigma_z"], job.sigma_z)
    np.testing.assert_allclose(data["time series"], [0, 0.2, 0.4, 0.6])
    assert not os.path.exists(tmp_path / "sbm.npz.bak")
    back = Mps.load(tmodel, str(tmp_path / "sbm_mps.npz"))
    np.testing.assert_allclose(back.todense(), job.latest_mps.todense(), atol=0)
    with pytest.raises(ValueError):
        job.evolve()


def test_crash_dump(tmp_path):
    """A failing evolution step dumps the last good state before raising."""
    _, tmodel = models()
    job = SpinBosonDynamics(
        tmodel, evolve_config=EvolveConfig(EvolveMethod.tdvp_ps),
        dump_dir=str(tmp_path), job_name="boom")
    orig = job.evolve_single_step
    calls = [0]

    def bad(dt):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("synthetic failure")
        return orig(dt)

    job.evolve_single_step = bad
    with pytest.raises(RuntimeError):
        job.evolve(0.2, 5)
    assert os.path.exists(tmp_path / "boom_crash.npz")
    assert len(job.sigma_z) == 3  # the initial state and two good steps
    good = Mps.load(tmodel, str(tmp_path / "boom_crash.npz"))
    np.testing.assert_allclose(good.todense(), job.latest_mps.todense(), atol=0)
