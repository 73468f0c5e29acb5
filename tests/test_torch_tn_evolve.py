"""Tree time evolution (``renormalizer_tpu_torch.tn``) against the JAX
package and against dense oracles, fp64 on the CPU.

The start is the port's ``expand_bond_dimension`` of a Hartree state of
``exact_model`` on a binary tree, carried to the JAX package node by node.
One step of each method must equal the JAX package's step from that state
to 1e-8; five steps of TDVP-PS, TDVP-PS2 and VMF must follow
``scipy.linalg.expm`` to the JAX tests' 1e-4 (mean occupation deviation,
``tests/test_tn.py::test_ttns_evolve``)."""

import os

import numpy as np
import pytest
import scipy.linalg
import torch

from fixtures import dense_hamiltonian, exact_model
from renormalizer_tpu.tn import BasisTree as JaxBasisTree
from renormalizer_tpu.tn import TTNO as JaxTTNO
from renormalizer_tpu.tn import TTNS as JaxTTNS
from renormalizer_tpu.tn.node import TreeNodeTensor as JaxTreeNodeTensor
from renormalizer_tpu.tn.node import copy_connection as jax_copy_connection
from renormalizer_tpu.utils import CompressConfig as JaxCompressConfig
from renormalizer_tpu.utils import EvolveConfig as JaxEvolveConfig
from renormalizer_tpu.utils import EvolveMethod as JaxEvolveMethod
from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity, interop
from renormalizer_tpu_torch.model import Model, Op
from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree, max_entangled_ex
from renormalizer_tpu_torch.tn.time_evolution import TREE_COUNTS
from renormalizer_tpu_torch.utils import (
    CompressConfig,
    CompressCriteria,
    EvolveConfig,
    EvolveMethod,
)

torch.set_num_threads(2)

METHODS = ["tdvp_ps", "tdvp_ps2", "tdvp_vmf", "prop_and_compress_tdrk4"]
DT = 0.2


def port_exact_model() -> HolsteinModel:
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


MODEL = port_exact_model()
TREE = BasisTree.binary(MODEL.basis)
TTNO_H = TTNO(TREE, MODEL.ham_terms)


@pytest.fixture(scope="module")
def start():
    """The expanded start state, built once per module (not at import:
    every test worker imports every test file)."""
    return TTNS(TREE, condition={0: 1}).expand_bond_dimension(TTNO_H)


def _configure(ttns, method, port=True):
    if port:
        ttns.evolve_config = EvolveConfig(EvolveMethod[method])
        if method == "tdvp_ps2":
            # the splitting error, not the truncation's, must dominate
            ttns.compress_config = CompressConfig(threshold=1e-7)
    else:
        ttns.evolve_config = JaxEvolveConfig(JaxEvolveMethod[method])
        if method == "tdvp_ps2":
            ttns.compress_config = JaxCompressConfig(threshold=1e-7)
    return ttns


def _to_jax(jtree, ttns) -> JaxTTNS:
    data = interop.ttns_to_numpy(ttns)
    nodes = [JaxTreeNodeTensor(a, q) for a, q in zip(data["arrays"], data["qn"])]
    out = JaxTTNS(jtree, root=jax_copy_connection(jtree.node_list, nodes))
    out.coeff = data["coeff"]
    return out


def test_carried_start_is_identical(start):
    jtree = JaxBasisTree.binary(exact_model().basis)
    jstart = _to_jax(jtree, start)
    assert jstart.bond_dims == start.bond_dims
    back = interop.ttns_from_object(TREE, jstart)
    for a, b in zip(back.node_list, start.node_list):
        np.testing.assert_array_equal(a.tensor.numpy(), b.tensor.numpy())
        np.testing.assert_array_equal(a.qn, b.qn)
    assert back.coeff == start.coeff


@pytest.mark.parametrize("method", METHODS)
def test_one_step_matches_jax(method, start):
    jmodel = exact_model()
    jtree = JaxBasisTree.binary(jmodel.basis)
    jttno = JaxTTNO(jtree, jmodel.ham_terms)
    ref = _configure(_to_jax(jtree, start), method, port=False).evolve(jttno, DT)
    steps0 = TREE_COUNTS["local_steps"]
    port = _configure(start.copy(), method).evolve(TTNO_H, DT)
    if method in ("tdvp_ps", "tdvp_ps2"):
        assert TREE_COUNTS["local_steps"] > steps0
    assert port.bond_dims == ref.bond_dims
    dense = port.todense(order=MODEL.basis)
    dense_ref = ref.todense(order=jmodel.basis)
    assert np.abs(dense - dense_ref).max() < 1e-8
    assert abs(port.coeff - ref.coeff) < 1e-8


def _occupation_deviations(start, method, nsteps=5):
    h = dense_hamiltonian(MODEL)
    ttns = _configure(start.copy(), method)
    psi0 = ttns.todense(order=MODEL.basis).ravel().astype(complex)
    occ_ops = [dense_hamiltonian(Model(MODEL.basis, [Op(r"a^\dagger a", dof)]))
               for dof in MODEL.e_dofs]
    occ_ttnos = [TTNO(TREE, [Op(r"a^\dagger a", dof)]) for dof in MODEL.e_dofs]
    devs = []
    for i in range(1, nsteps + 1):
        ttns = ttns.evolve(TTNO_H, DT)
        psit = scipy.linalg.expm(-1j * h * DT * i) @ psi0
        oracle = [np.real(psit.conj() @ o @ psit) for o in occ_ops]
        occ = [ttns.expectation(o) for o in occ_ttnos]
        devs.append(np.abs(np.array(occ) - oracle).mean())
    return devs


@pytest.mark.parametrize("method", ["tdvp_ps", "tdvp_ps2", "tdvp_vmf"])
def test_dense_oracle(method, start):
    vmf_reads0 = TREE_COUNTS["vmf_host_reads"]
    assert np.mean(_occupation_deviations(start, method)) < 1e-4
    if method == "tdvp_vmf":
        assert TREE_COUNTS["vmf_host_reads"] > vmf_reads0


def test_thermofield_evolution():
    """The infinite-temperature thermofield state: normalized, uniform
    electron occupations, energy and norm kept by TDVP-PS
    (``tests/test_tn.py::test_ttns_thermofield``'s bounds)."""
    tree2 = TREE.add_auxiliary_space()
    hot = max_entangled_ex(tree2)
    assert abs(hot.ttns_norm - 1) < 1e-12
    ttno = TTNO(tree2, MODEL.ham_terms)
    hot = hot.expand_bond_dimension(ttno)
    hot.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    e0 = hot.expectation(ttno)
    for _ in range(3):
        hot = hot.evolve(ttno, 4.0)
    assert abs(hot.expectation(ttno) - e0) < 1e-6
    assert abs(hot.ttns_norm - 1) < 1e-8


def test_imaginary_time_cools(start):
    """Imaginary-time TDVP-PS of a real state stays real and lowers the
    energy towards the sector ground state."""
    ttns = start.copy()
    ttns.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    e0 = ttns.expectation(TTNO_H)
    for _ in range(3):
        ttns = ttns.evolve(TTNO_H, -0.5j)
        assert not ttns.root.tensor.is_complex()
    assert ttns.expectation(TTNO_H) < e0


@pytest.mark.slow
def test_pyr4_ttns():
    """``tests/test_pyr4.py::test_pyr4_ttns`` in the port: the S1/S2
    populations of 4-mode pyrazine on a binary tree against the Heidelberg
    MCTDH data, 60 TDVP-PS steps of 2 fs (the fixed M=10 is set after the
    expansion, as there, so the bonds keep the expansion's 30-32)."""
    from renormalizer_tpu_torch.model.pyrazine import E_DOFS, pyrazine_model
    from renormalizer_tpu_torch.utils.constant import fs2au

    data = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "pyr4_mctdh.npy"))
    mctdh = data[::4][:61, 1:]
    model = pyrazine_model()
    tree = BasisTree.binary(model.basis)
    ttno = TTNO(tree, model.ham_terms)
    ttns = TTNS(tree, condition={"s2": 1}).expand_bond_dimension(ttno)
    ttns.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    ttns.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=10)
    occ_ttnos = [TTNO(tree, [Op(r"a^\dagger a", s)]) for s in E_DOFS]
    occ = [[float(np.real(ttns.expectation(o))) for o in occ_ttnos]]
    for _ in range(60):
        ttns = ttns.evolve(ttno, 2 * fs2au)
        occ.append([float(np.real(ttns.expectation(o))) for o in occ_ttnos])
    assert np.abs(np.array(occ) - mctdh).max() < 2e-2
