"""The port's MPS/MPO algebra, compression and measurements against the JAX
package's, fp64 on the CPU, on states carried over with ``interop``.

A 3-molecule Holstein model small enough for dense checks; two random one-exciton states of different
bond dimension built in the JAX package are the inputs of every test."""

import numpy as np
import pytest
import torch

import renormalizer_tpu as rj
import renormalizer_tpu_torch as rt
from renormalizer_tpu.mps.lib import compressed_sum as jax_compressed_sum
from renormalizer_tpu_torch import (
    CompressConfig,
    CompressCriteria,
    Mpo,
    Mps,
    Op,
    compressed_sum,
    interop,
)

torch.set_num_threads(2)


def make_model(pkg):
    """The 3-molecule Holstein fixture of ``tests/fixtures.py`` with 3 and 2
    phonon levels (9 sites, 1728 states: small enough for dense checks), in
    either package."""
    q = pkg.Quantity
    j_matrix = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3],
                         [-0.2, -0.3, 0.0]]) / pkg.utils.constant.au2ev
    omegas = [q(106.51, "cm^{-1}"), q(1555.55, "cm^{-1}")]
    disps = [q(30.1370, "a.u."), q(8.7729, "a.u.")]
    ph_list = [pkg.Phonon([w, w], [q(0), d], n)
               for w, d, n in zip(omegas, disps, (3, 2))]
    return pkg.HolsteinModel([pkg.Mol(q(2.67, "eV"), ph_list, 15.45)] * 3, j_matrix)


holstein_model = make_model(rj)
MODEL = make_model(rt)
JA = rj.Mps.random(holstein_model, 1, 10, percent=1.0)
JB = rj.Mps.random(holstein_model, 1, 6, percent=0.5)


def pair():
    """Fresh copies of the two states in both packages."""
    ja, jb = JA.copy(), JB.copy()
    return ja, jb, interop.mps_from_object(MODEL, ja), interop.mps_from_object(MODEL, jb)


def assert_same_state(tmps, jmps, atol=1e-10):
    assert tmps.bond_dims == jmps.bond_dims
    assert tmps.qnidx == jmps.qnidx and tmps.to_right == jmps.to_right
    np.testing.assert_array_equal(tmps.qntot, jmps.qntot)
    np.testing.assert_allclose(np.asarray(tmps.coeff) * tmps.todense(),
                               np.asarray(jmps.coeff) * jmps.todense(),
                               atol=atol, rtol=0)


def test_add_scale_norm_distance_angle():
    ja, jb, ta, tb = pair()
    assert_same_state(ta + tb, ja + jb, atol=1e-14)
    assert_same_state(ta - tb, ja - jb, atol=1e-14)
    for q1, q2 in zip((ta + tb).qn, (ja + jb).qn):
        np.testing.assert_array_equal(q1, q2)
    val = 0.3 - 0.2j
    ts, js = ta.scale(val), ja.scale(val)
    assert ts.is_complex and not ta.is_complex
    assert_same_state(ts, js, atol=1e-14)
    assert_same_state(ta * 0.5, ja * 0.5, atol=1e-14)
    assert ta.mp_norm == pytest.approx(ja.mp_norm, abs=1e-12)
    assert ts.norm == pytest.approx(js.norm, abs=1e-12)
    assert ta.distance(tb) == pytest.approx(ja.distance(jb), abs=1e-10)
    assert ta.angle(tb) == pytest.approx(ja.angle(jb), abs=1e-12)
    assert ta.distance(ta.copy()) == pytest.approx(0.0, abs=1e-7)
    assert ta.bond_dims_mean == ja.bond_dims_mean
    assert ta.total_bytes == ja.total_bytes
    np.testing.assert_array_equal(ta.bond_dims_exact, ja.bond_dims_exact)
    assert str(ta) == str(ja)


@pytest.mark.parametrize("config", [
    dict(criteria=CompressCriteria.fixed, max_bonddim=8),
    dict(criteria=CompressCriteria.threshold, threshold=1e-2),
    dict(criteria=CompressCriteria.both, threshold=1e-3, max_bonddim=12),
], ids=["fixed", "threshold", "both"])
def test_compress(config):
    """Canonicalise + compress of a sum: dense vector and every bond's
    singular values to 1e-10."""
    ja, jb, ta, tb = pair()
    jsum, tsum = ja + jb, ta + tb
    jsum.compress_config = rj.CompressConfig(
        rj.CompressCriteria[config["criteria"].name],
        **{k: v for k, v in config.items() if k != "criteria"})
    tsum.compress_config = CompressConfig(**config)
    jsum.canonicalise()
    tsum.canonicalise()
    assert_same_state(tsum, jsum)
    jsum, js = jsum.compress(ret_s=True)
    tsum, ts = tsum.compress(ret_s=True)
    assert_same_state(tsum, jsum)
    np.testing.assert_allclose(ts, js, atol=1e-10, rtol=0)
    assert sum(tsum.bond_dims) < sum((ta + tb).bond_dims)
    assert tsum.check_left_canonical() or tsum.check_right_canonical()


def test_compress_temp_m_trunc_and_compressed_sum():
    ja, jb, ta, tb = pair()
    jc = (ja + jb).canonicalise().compress(5)
    tc = (ta + tb).canonicalise().compress(5)
    assert max(tc.bond_dims) == 5
    assert_same_state(tc, jc)
    for p in (ja, jb, ta, tb):
        p.compress_config.criteria = (
            rj.CompressCriteria.fixed if isinstance(p, rj.Mps) else CompressCriteria.fixed)
    jsum = jax_compressed_sum([ja, jb, ja.scale(0.5), jb.scale(-2.0)], batchsize=3)
    tsum = compressed_sum([ta, tb, ta.scale(0.5), tb.scale(-2.0)], batchsize=3)
    assert_same_state(tsum, jsum)
    expected = 1.5 * JA.todense() - JB.todense()
    np.testing.assert_allclose(tsum.todense(), expected, atol=1e-10, rtol=0)


def test_mpo_onsite_apply_contract():
    ja, _, ta, _ = pair()
    jop = rj.Mpo.onsite(holstein_model, r"a^\dagger a", dipole=True)
    top = Mpo.onsite(MODEL, r"a^\dagger a", dipole=True)
    np.testing.assert_allclose(top.todense(), jop.todense(), atol=1e-12, rtol=0)
    assert top.is_hermitian()
    np.testing.assert_allclose(Mpo.identity(MODEL).todense(),
                               np.eye(top.todense().shape[0]), atol=0)
    jh, th = rj.Mpo(holstein_model), Mpo(MODEL)
    # mpo @ mps, exact and with canonicalisation
    assert_same_state(th @ ta, jh @ ja, atol=1e-12)
    np.testing.assert_allclose((th @ ta).todense(), th.todense() @ ta.todense(),
                               atol=1e-12, rtol=0)
    assert_same_state(th.apply(ta, canonicalise=True), jh.apply(ja, canonicalise=True))
    # mpo @ mpo
    np.testing.assert_allclose((top @ th).todense(), top.todense() @ th.todense(),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(th.conj_trans().todense(), th.todense().conj().T,
                               atol=1e-14, rtol=0)
    # compressed application
    ja.compress_config = rj.CompressConfig(rj.CompressCriteria.fixed, max_bonddim=12)
    ta.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=12)
    assert_same_state(th.contract(ta), jh.contract(ja))
    # a creation operator changes the sector
    jup = rj.Mpo.onsite(holstein_model, r"a^\dagger", dof_set=[1]) @ rj.Mps.ground_state(holstein_model, False)
    tup = Mpo.onsite(MODEL, r"a^\dagger", dof_set=[1]) @ Mps.ground_state(MODEL, False)
    assert_same_state(tup, jup, atol=0)
    np.testing.assert_array_equal(tup.qntot, [1])


def test_expand_bond_dimension():
    """The job's way to a TDVP start state: hint-MPO expansion of a product
    state, and random expansion."""
    jh, th = rj.Mpo(holstein_model), Mpo(MODEL)
    jinit = rj.Mpo.onsite(holstein_model, r"a^\dagger", dof_set=[0]) @ rj.Mps.ground_state(holstein_model, False)
    tinit = Mpo.onsite(MODEL, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(MODEL, False)
    for p, cls, crit in ((jinit, rj.CompressConfig, rj.CompressCriteria),
                         (tinit, CompressConfig, CompressCriteria)):
        p.compress_config = cls(crit.fixed, max_bonddim=6)
    jexp = jinit.expand_bond_dimension(hint_mpo=jh, coef=1e-3)
    texp = tinit.expand_bond_dimension(hint_mpo=th, coef=1e-3)
    assert max(texp.bond_dims) == 6 and texp.bond_dims[3:7] == jexp.bond_dims[3:7]
    # the state has numerical rank 3: which zero-weight states pad a bond is
    # arbitrary (and decides how wide the next bond can get), so the two
    # packages agree on the vector, not on every padded bond dimension
    np.testing.assert_allclose(texp.coeff * texp.todense(),
                               jexp.coeff * jexp.todense(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(texp.calc_bond_singular_values()[:, :3],
                               jexp.calc_bond_singular_values()[:, :3],
                               atol=1e-10, rtol=0)
    assert texp.check_left_canonical() or texp.check_right_canonical()
    assert texp.mp_norm == pytest.approx(1.0, abs=1e-12)
    assert texp.norm == pytest.approx(jexp.norm, abs=1e-12)
    assert texp.expectation(th) == pytest.approx(jexp.expectation(jh), abs=1e-10)
    # without a hint the expander is ``Mps.random``: identical draws
    jrnd = jinit.expand_bond_dimension(coef=1e-3)
    trnd = tinit.expand_bond_dimension(coef=1e-3)
    np.testing.assert_allclose(trnd.coeff * trnd.todense(),
                               jrnd.coeff * jrnd.todense(), atol=1e-10, rtol=0)


def test_measurements():
    ja, jb, ta, tb = pair()
    ts, js = ta.scale(0.6 + 0.8j), ja.scale(0.6 + 0.8j)
    for tm, jm in ((ta, ja), (ts, js)):
        np.testing.assert_allclose(tm.e_occupations, jm.e_occupations, atol=1e-12)
        np.testing.assert_allclose(tm.ph_occupations, jm.ph_occupations, atol=1e-12)
        trdm, jrdm = tm.calc_1site_rdm(), jm.calc_1site_rdm()
        assert trdm.keys() == jrdm.keys()
        for k in trdm:
            np.testing.assert_allclose(trdm[k], jrdm[k], atol=1e-12, rtol=0)
        np.testing.assert_allclose(tm.calc_1site_rdm(idx=2)[2], jrdm[2], atol=1e-12)
        np.testing.assert_allclose(tm.calc_bond_singular_values(),
                                   jm.calc_bond_singular_values(), atol=1e-10, rtol=0)
        np.testing.assert_allclose(tm.calc_entropy("bond"), jm.calc_entropy("bond"),
                                   atol=1e-9, rtol=0)
    ops = [Op(r"a^\dagger a", 0), Op("n", (1, 0)), Op(r"a^\dagger a", [0, 1])]
    jops = [rj.Op(r"a^\dagger a", 0), rj.Op("n", (1, 0)), rj.Op(r"a^\dagger a", [0, 1])]
    got = ts.expectations([Mpo(MODEL, o) for o in ops])
    ref = js.expectations([rj.Mpo(holstein_model, o) for o in jops])
    np.testing.assert_allclose(got, ref, atol=1e-12, rtol=0)
    # transition amplitude <b|H|a>
    th, jh = Mpo(MODEL), rj.Mpo(holstein_model)
    assert ta.expectation(th, tb.conj()) == pytest.approx(
        ja.expectation(jh, jb.conj()), abs=1e-12)


def test_dump_load_round_trip(tmp_path):
    ja, _, ta, _ = pair()
    ts = ta.scale(0.6 + 0.8j)
    ts.coeff = 0.5 - 0.25j
    fname = str(tmp_path / "state.npz")
    ts.dump(fname)
    back = Mps.load(MODEL, fname)
    assert back.is_complex and back.coeff == ts.coeff
    assert_same_state(back, ts, atol=0)
    for q1, q2 in zip(back.qn, ts.qn):
        np.testing.assert_array_equal(q1, q2)
    # the two packages read each other's files
    jback = rj.Mps.load(holstein_model, fname)
    assert_same_state(ts, jback, atol=0)
    jname = str(tmp_path / "jax_state.npz")
    ja.dump(jname)
    assert_same_state(Mps.load(MODEL, jname), ja, atol=0)
    # and the way back through interop
    data = interop.mps_to_numpy(ts)
    again = interop.mps_from_numpy(MODEL, **data)
    assert_same_state(again, ts, atol=0)


def test_from_dense_and_hartree_product_state():
    ja, _, ta, _ = pair()
    tdense = Mps.from_dense(MODEL, ta.todense())
    np.testing.assert_allclose(tdense.todense(), ta.todense(), atol=1e-13, rtol=0)
    cond = {0: 1, (1, 0): 2}
    thp = Mps.hartree_product_state(MODEL, cond)
    jhp = rj.Mps.hartree_product_state(holstein_model, cond)
    assert_same_state(thp, jhp, atol=0)
    for q1, q2 in zip(thp.qn, jhp.qn):
        np.testing.assert_array_equal(q1, q2)
