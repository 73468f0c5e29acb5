"""The port's contraction layer against the JAX package's, fp64 on the CPU.

Inputs are drawn with numpy from fixed seeds and go through both; results
must agree to 1e-12 relative (both sides are fp64 sums of the same terms in
different orders)."""

import numpy as np
import pytest
import torch

from renormalizer_tpu.ops import contract as jc
from renormalizer_tpu_torch import interop
from renormalizer_tpu_torch.ops import contract as tc

torch.set_num_threads(2)

RTOL = 1e-12


def _random_operands(formula, seed):
    rng = np.random.default_rng(seed)
    terms = formula.split("->")[0].split(",")
    letters = sorted(set("".join(terms)))
    sizes = {c: int(rng.integers(2, 5)) for c in letters}
    return [rng.standard_normal([sizes[c] for c in t]) for t in terms]


def _close(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(port - ref).max() <= RTOL * scale


@pytest.mark.parametrize(
    "formula", list(tc._ENV_FORMULAS.values())
    + [f for f, _ in tc._HOP_FORMULAS.values()])
def test_formula_matches_jax(formula):
    ops = _random_operands(formula, seed=len(formula))
    assert tc._ENV_FORMULAS.keys() == jc._ENV_FORMULAS.keys()
    assert tc._HOP_FORMULAS == jc._HOP_FORMULAS
    _close(tc.einsum(formula, *[torch.tensor(o) for o in ops]),
           jc.einsum(formula, *ops))


def _hop_operands(nsite, seed):
    rng = np.random.default_rng(seed)
    ml, mr, w0, w1, w2 = 5, 4, 3, 4, 2
    pdims = [3, 2][:nsite]
    wb = [w0, w1, w2][: nsite + 1]
    lt = rng.standard_normal((ml, wb[0], ml))
    rt = rng.standard_normal((mr, wb[-1], mr))
    cmo = [rng.standard_normal((wb[i], d, d, wb[i + 1]))
           for i, d in enumerate(pdims)]
    return lt, rt, cmo, (ml, *pdims, mr)


@pytest.mark.parametrize("nsite", [1, 2])
def test_hop_diag_and_dense_match_jax(nsite):
    lt, rt, cmo, cshape = _hop_operands(nsite, seed=nsite)
    t = [torch.tensor(x) for x in (lt, rt)]
    tm = [torch.tensor(m) for m in cmo]
    _close(tc.hop_diag(t[0], t[1], tm), jc.hop_diag(lt, rt, cmo))
    dense = tc.hop_dense(t[0], t[1], tm)
    _close(dense, jc.hop_dense(lt, rt, cmo))
    # the matvec agrees with the dense operator and with the JAX closure
    c = np.random.default_rng(7).standard_normal(cshape)
    hop = tc.hop_expr(t[0], t[1], tm, cshape)
    out = hop(torch.tensor(c))
    _close(out, jc.hop_expr(lt, rt, cmo, cshape)(c))
    dim = int(np.prod(cshape))
    _close(out.reshape(-1), dense.reshape(dim, dim).numpy() @ c.ravel())
    # and its diagonal is the dense operator's diagonal
    _close(tc.hop_diag(t[0], t[1], tm).reshape(-1),
           np.diag(dense.reshape(dim, dim).numpy()))


def test_contract_one_site_and_tensordot1_match_jax():
    rng = np.random.default_rng(11)
    env = rng.standard_normal((3, 4, 3))
    ms = rng.standard_normal((3, 5, 6))
    mo = rng.standard_normal((4, 5, 5, 2))
    for domain in ("L", "R"):
        e = env if domain == "L" else rng.standard_normal((6, 2, 6))
        _close(tc.contract_one_site(torch.tensor(e), torch.tensor(ms),
                                    torch.tensor(mo), domain),
               jc.contract_one_site(e, ms, mo, domain))
    a, b = rng.standard_normal((3, 4, 5)), rng.standard_normal((5, 2))
    _close(tc.tensordot1(torch.tensor(a), torch.tensor(b)), jc.tensordot1(a, b))


def test_mpo_matches_jax():
    """The 3-molecule fixture's MPO: equal bond dims, qn and site tensors."""
    from fixtures import holstein_model
    from renormalizer_tpu.mps import Mpo as JaxMpo
    from renormalizer_tpu_torch.mps import Mpo

    from test_torch_dmrg import port_model

    jmpo = JaxMpo(holstein_model)
    tmpo = Mpo(port_model())
    assert tmpo.bond_dims == jmpo.bond_dims
    for qt, qj in zip(tmpo.qn, jmpo.qn):
        np.testing.assert_array_equal(np.asarray(qt), np.asarray(qj))
    for mt, mj in zip(tmpo, jmpo):
        _close(mt, mj)
    # the JAX MPO carried across as numpy is the same operator
    carried = interop.mpo_from_numpy(
        tmpo.model, [np.asarray(mj) for mj in jmpo], jmpo.qn, jmpo.qnidx,
        jmpo.to_right, jmpo.qntot)
    assert carried.bond_dims == tmpo.bond_dims
    for mc, mt in zip(carried, tmpo):
        assert torch.equal(mc, mt)


def test_mpo_todense_matches_jax():
    """``todense`` on the exactly solvable 3-site Holstein model (the JAX
    ``todense`` refuses the 3-molecule fixture: 32768 states)."""
    from fixtures import exact_model
    from renormalizer_tpu.mps import Mpo as JaxMpo
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity
    from renormalizer_tpu_torch.mps import Mpo

    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    jmpo = JaxMpo(exact_model())
    tmpo = Mpo(model)
    assert tmpo.bond_dims == jmpo.bond_dims
    ref = jmpo.todense()
    assert np.abs(tmpo.todense() - ref).max() <= RTOL * np.abs(ref).max()
