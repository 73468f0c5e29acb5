"""The port's tree engine (``renormalizer_tpu_torch.tn``) against the JAX
package's, fp64 on the CPU.

Both packages build the same trees from the same bases; states start from
the same seeded ``TTNS.random`` or travel across with ``interop``
(``ttns_from_object``, and the ``.npz`` files of ``dump``/``load``).
Tolerances: 1e-10 for exact contractions and factorizations, 1e-8 for
sweep energies (both packages solve each local problem to a residual of
1e-10), 1e-7 against dense sector energies (the JAX tests' bound)."""

import numpy as np
import pytest
import torch

from fixtures import dense_hamiltonian, exact_model
from renormalizer_tpu.model import Model as JaxModel
from renormalizer_tpu.model import BasisHalfSpin as JaxBasisHalfSpin
from renormalizer_tpu.model import heisenberg_ops as jax_heisenberg_ops
from renormalizer_tpu.ops import contract as jc
from renormalizer_tpu.tn import BasisTree as JaxBasisTree
from renormalizer_tpu.tn import TTNO as JaxTTNO
from renormalizer_tpu.tn import TTNS as JaxTTNS
from renormalizer_tpu.tn import TTNEnviron as JaxTTNEnviron
from renormalizer_tpu.tn import from_mps as jax_from_mps
from renormalizer_tpu.tn import max_entangled_ex as jax_max_entangled_ex
from renormalizer_tpu.tn import optimize_ttns as jax_optimize_ttns
from renormalizer_tpu.tn.hop_expr import hop_expr1 as jax_hop_expr1
from renormalizer_tpu.tn.hop_expr import hop_expr2 as jax_hop_expr2
from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity, interop
from renormalizer_tpu_torch.model import BasisHalfSpin, Model, Op, heisenberg_ops
from renormalizer_tpu_torch.mps import Mpo
from renormalizer_tpu_torch.ops import contract as tc
from renormalizer_tpu_torch.tn import (
    BasisTree,
    TTNEnviron,
    TTNO,
    TTNS,
    from_mps,
    max_entangled_ex,
    optimize_ttns,
)
from renormalizer_tpu_torch.tn.hop_expr import hop_expr1, hop_expr2

torch.set_num_threads(2)

# a growth sweep and a percent = 0 sweep (each further sweep costs the JAX
# package ~4 s on the CPU)
PROCEDURE = [[16, 0.4], [16, 0]]


def port_heisenberg(nspin=4) -> Model:
    return Model([BasisHalfSpin(i) for i in range(nspin)], heisenberg_ops(nspin))


def jax_heisenberg(nspin=4) -> JaxModel:
    return JaxModel([JaxBasisHalfSpin(i) for i in range(nspin)], jax_heisenberg_ops(nspin))


def port_exact_model() -> HolsteinModel:
    """``tests/fixtures.py``'s ``exact_model`` in the port."""
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    return HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sector_spectrum(model, nexciton, k):
    h = dense_hamiltonian(model)
    dims = model.pbond_list
    qn = np.array([
        sum(model.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
            for i in range(len(dims)))
        for s in range(h.shape[0])
    ])
    sector = np.nonzero(qn == nexciton)[0]
    return np.linalg.eigvalsh(h[np.ix_(sector, sector)])[:k]


# --- the contraction layer ------------------------------------------------

def _network(n_ops, seed, diagonal=False):
    """A random tensor network of ``n_ops`` operands as interleaved
    arguments with tuple labels; ``diagonal`` repeats one label inside an
    operand (the ``hdiag`` pattern)."""
    rng = np.random.default_rng(seed)
    labels = [("bond", k) for k in range(n_ops + 3)]
    terms = [[] for _ in range(n_ops)]
    for lab in labels:
        a, b = rng.choice(n_ops, 2, replace=False)
        terms[a].append(lab)
        terms[b].append(lab)
    out = []
    for k in range(3):
        lab = ("open", k)
        terms[int(rng.integers(n_ops))].append(lab)
        out.append(lab)
    if diagonal:
        # the first open label is also shared, twice, by operand 0
        terms[0] += [out[0], out[0]]
    sizes = {lab: int(rng.integers(2, 4)) for t in terms for lab in t}
    arrays = [rng.standard_normal([sizes[lab] for lab in t]) for t in terms]
    return arrays, terms, out


@pytest.mark.parametrize("n_ops,diagonal", [(3, False), (7, True), (9, False),
                                            (12, True)])
def test_einsum_interleaved(n_ops, diagonal):
    """The pairwise plan (exhaustive up to 8 operands, greedy above) against
    ``torch.einsum`` of the whole formula and, up to 7 operands, the JAX
    package's function (whose own path search stalls past that)."""
    arrays, terms, out = _network(n_ops, seed=n_ops, diagonal=diagonal)
    targs, jargs = [], []
    for a, t in zip(arrays, terms):
        targs += [torch.tensor(a), t]
        jargs += [a, t]
    port = tc.einsum_interleaved(*targs, out).numpy()
    formula, tensors = tc.interleaved_formula(*targs, out)
    whole = torch.einsum(formula, *tensors).numpy()
    scale = np.abs(whole).max()
    assert np.abs(port - whole).max() <= 1e-12 * scale
    if n_ops <= 7:
        ref = np.asarray(jc.einsum_interleaved(*jargs, out))
        assert np.abs(port - ref).max() <= 1e-12 * scale


def test_label_formula_rejects_more_than_52_labels():
    tensors = [torch.ones(1)] * 53
    args = []
    for k, t in enumerate(tensors):
        args += [t, [("label", k)]]
    with pytest.raises(ValueError, match="a-zA-Z"):
        tc.einsum_interleaved(*args, [])


# --- the basis trees -------------------------------------------------------

def _tree_signature(tree):
    order = {id(n): i for i, n in enumerate(tree.node_list)}
    return [
        (str(n.dofs), n.pbond_dims,
         None if n.parent is None else order[id(n.parent)])
        for n in tree.node_list
    ]


@pytest.mark.parametrize("factory", [
    "linear", "binary", "binary_mctdh", "ternary_mctdh", "t3ns",
    "general_mctdh_contracted", "binary_auxiliary",
])
def test_basis_tree_factories_match_jax(factory):
    def build(pkg_tree, basis):
        if factory == "general_mctdh_contracted":
            return pkg_tree.general_mctdh(basis, 2, contract_primitive=True,
                                          contract_label=[True, False, False, True, False, False])
        if factory == "binary_auxiliary":
            return pkg_tree.binary(basis).add_auxiliary_space()
        return getattr(pkg_tree, factory)(basis)

    port = build(BasisTree, port_exact_model().basis)
    ref = build(JaxBasisTree, exact_model().basis)
    assert _tree_signature(port) == _tree_signature(ref)
    assert port.qn_size == ref.qn_size
    lines = []
    port.print(print_function=lines.append)
    assert len(lines) == len(port)


@pytest.mark.parametrize("factory", ["linear", "binary", "t3ns", "binary_mctdh"])
def test_ttno_todense_matches_jax_and_mpo(factory):
    model = port_heisenberg()
    port = TTNO(getattr(BasisTree, factory)(model.basis), model.ham_terms)
    jmodel = jax_heisenberg()
    ref = JaxTTNO(getattr(JaxBasisTree, factory)(jmodel.basis), jmodel.ham_terms)
    dense = port.todense(order=model.basis)
    assert np.abs(dense - ref.todense(order=jmodel.basis)).max() < 1e-10
    assert np.abs(dense - Mpo(model).todense()).max() < 1e-10
    assert port.bond_dims == ref.bond_dims


def test_ttns_random_matches_jax():
    """One seed gives one start state in both packages, tensor for tensor."""
    port = TTNS.random(BasisTree.binary(port_exact_model().basis), 1, 8)
    ref = JaxTTNS.random(JaxBasisTree.binary(exact_model().basis), 1, 8)
    assert port.bond_dims == ref.bond_dims
    for a, b in zip(port.node_list, ref.node_list):
        np.testing.assert_array_equal(a.tensor.numpy(), np.asarray(b.tensor))
        np.testing.assert_array_equal(a.qn, b.qn)
    assert port.is_canonical()
    assert abs(port.ttns_norm - 1) < 1e-12


def test_canonicalise_compress_and_expand():
    """Moving the canonical centre, compressing and expanding keep the
    dense state; the expansion reaches the JAX package's bond dimensions and
    state."""
    model = port_heisenberg()
    tree = BasisTree.binary(model.basis)
    ttno = TTNO(tree, model.ham_terms)
    ttns = TTNS.random(tree, 0, 8)
    dense0 = ttns.todense(order=model.basis)
    ttns.push_cano_to_child(ttns.root, 0)
    assert np.abs(ttns.todense(order=model.basis) - dense0).max() < 1e-10
    ttns.push_cano_to_parent(ttns.root.children[0])
    assert np.abs(ttns.todense(order=model.basis) - dense0).max() < 1e-10
    assert ttns.is_canonical()

    h = dense_hamiltonian(model)
    applied = ttno.apply(ttns)
    target = h @ dense0.ravel()
    assert np.abs(applied.todense(order=model.basis).ravel() - target).max() < 1e-10
    applied.canonicalise()
    assert applied.is_canonical()
    applied.compress(temp_m_trunc=100)
    assert applied.is_canonical()
    assert np.abs(applied.todense(order=model.basis).ravel() - target).max() < 1e-10

    expanded = TTNS(tree, condition={0: 1}).expand_bond_dimension(ttno)
    jmodel = jax_heisenberg()
    jtree = JaxBasisTree.binary(jmodel.basis)
    jexpanded = JaxTTNS(jtree, condition={0: 1}).expand_bond_dimension(
        JaxTTNO(jtree, jmodel.ham_terms))
    assert expanded.bond_dims == jexpanded.bond_dims
    assert expanded.is_canonical()
    assert np.abs(expanded.todense(order=model.basis)
                  - jexpanded.todense(order=jmodel.basis)).max() < 1e-10
    assert abs(expanded.ttns_norm - 1) < 1e-12


def test_add_and_partial_ttno():
    model = port_heisenberg()
    tree = BasisTree.binary(model.basis)
    a = TTNS.random(tree, 0, 4)
    b = TTNS.random(tree, 0, 4).scale(0.7)
    s = a.add(b)
    assert np.abs(s.todense(order=model.basis) - a.todense(order=model.basis)
                  - b.todense(order=model.basis)).max() < 1e-10
    # a TTNO over a subset of the doubled tree's dofs equals the one built
    # on the doubled tree (the thermofield machinery)
    tree2 = tree.add_auxiliary_space()
    ttns = TTNS.random(tree2, 0, 4)
    ttno, ttno2 = TTNO(tree, model.ham_terms), TTNO(tree2, model.ham_terms)
    assert np.abs(ttno.apply(ttns).todense() - ttno2.apply(ttns).todense()).max() < 1e-10
    assert abs(ttns.expectation(ttno) - ttns.expectation(ttno2)) < 1e-10


def _carried_pair(kind="binary"):
    """A JAX random state on ``exact_model`` and the port's copy of it."""
    jmodel, model = exact_model(), port_exact_model()
    jtree, tree = getattr(JaxBasisTree, kind)(jmodel.basis), getattr(BasisTree, kind)(model.basis)
    jttns = JaxTTNS.random(jtree, 1, 8)
    return (jmodel, jtree, jttns), (model, tree, interop.ttns_from_object(tree, jttns))


def test_hop_and_hdiag_match_jax():
    """The 1- and 2-site effective Hamiltonians and the 2-site diagonal on a
    carried state and operator, node by node, against the JAX package's;
    the diagonal (a label repeated inside one operand) also against the
    dense hop's."""
    (jmodel, jtree, jttns), (model, tree, ttns) = _carried_pair()
    jttno = JaxTTNO(jtree, jmodel.ham_terms)
    ttno = interop.ttno_from_object(tree, jttno, model.ham_terms)
    for a, b in zip(ttno.node_list, jttno.node_list):
        np.testing.assert_array_equal(a.tensor.numpy(), np.asarray(b.tensor))
    jenv, env = JaxTTNEnviron(jttns, jttno), TTNEnviron(ttns, ttno)
    for i, node in enumerate(ttns.node_list):
        jnode = jttns.node_list[i]
        out = hop_expr1(node, ttns, ttno, env)(node.tensor)
        ref = jax_hop_expr1(jnode, jttns, jttno, jenv)(jnode.tensor)
        assert np.abs(_np(out) - np.asarray(ref)).max() < 1e-10
        if node.parent is None:
            continue
        c = ttns.merge_with_parent(node)
        expr, hdiag = hop_expr2(node, ttns, ttno, env)
        jexpr, jhdiag = jax_hop_expr2(jnode, jttns, jttno, jenv)
        assert np.abs(_np(expr(c)) - np.asarray(jexpr(jttns.merge_with_parent(jnode)))).max() < 1e-10
        assert np.abs(_np(hdiag) - np.asarray(jhdiag)).max() < 1e-10
        dim = c.numel()
        dense = torch.stack([expr(u.reshape(c.shape)).reshape(-1)
                             for u in torch.eye(dim, dtype=c.dtype)]).T
        assert np.abs(_np(torch.diagonal(dense)) - _np(hdiag).ravel()).max() < 1e-10


@pytest.mark.parametrize("kind", ["linear", "binary"])
def test_optimize_ttns_matches_jax(kind):
    """Tree DMRG from one start: each macro sweep's energy against the JAX
    package's, and the last against the dense sector energy."""
    jmodel, model = exact_model(), port_exact_model()
    jtree, tree = getattr(JaxBasisTree, kind)(jmodel.basis), getattr(BasisTree, kind)(model.basis)
    e_ref = jax_optimize_ttns(JaxTTNS.random(jtree, 1, 16), JaxTTNO(jtree, jmodel.ham_terms),
                              PROCEDURE)
    e_port = optimize_ttns(TTNS.random(tree, 1, 16), TTNO(tree, model.ham_terms), PROCEDURE)
    assert np.abs(np.array(e_port) - np.array(e_ref)).max() < 1e-8
    assert abs(e_port[-1] - _sector_spectrum(model, 1, 1)[0]) < 1e-7


@pytest.mark.parametrize("algo", ["arpack", "direct", "nroots"])
def test_optimize_ttns_solvers(algo):
    """The other local eigensolvers against the dense sector spectrum:
    ARPACK and the dense eigh at the JAX tests' 1e-7, two roots of the
    state-averaged sweep at 1e-6 (``tests/test_tn.py``)."""
    model = port_exact_model()
    tree = BasisTree.binary(model.basis)
    ttns = TTNS.random(tree, 1, 16)
    procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0], [16, 0]]
    if algo == "nroots":
        ttns.optimize_config.nroots = 2
    else:
        ttns.optimize_config.algo = algo
    energies = optimize_ttns(ttns, TTNO(tree, model.ham_terms), procedure)
    if algo == "nroots":
        assert np.abs(np.sort(energies[-1]) - _sector_spectrum(model, 1, 2)).max() < 1e-6
    else:
        assert abs(min(energies) - _sector_spectrum(model, 1, 1)[0]) < 1e-7


def test_max_entangled_ex_matches_jax():
    model, jmodel = port_exact_model(), exact_model()
    hot = max_entangled_ex(BasisTree.binary(model.basis).add_auxiliary_space())
    jhot = jax_max_entangled_ex(JaxBasisTree.binary(jmodel.basis).add_auxiliary_space())
    assert abs(hot.ttns_norm - 1) < 1e-12
    occ = [hot.expectation(TTNO(hot.basis, [Op(r"a^\dagger a", d)])) for d in model.e_dofs]
    assert np.abs(np.array(occ) - 1 / len(model.e_dofs)).max() < 1e-10
    assert np.abs(hot.todense() - jhot.todense()).max() < 1e-12


def test_from_mps_round_trip_matches_jax():
    """An MPS as a linear tree: the expectation of the converted Hamiltonian
    equals the MPS's, and the tree equals the JAX package's conversion of
    the same MPS."""
    from renormalizer_tpu.mps import Mps as JaxMps

    model, jmodel = port_exact_model(), exact_model()
    jmps = JaxMps.random(jmodel, 1, 8)
    mps = interop.mps_from_object(model, jmps)
    basis, ttns, ttno = from_mps(mps)
    _, jttns, jttno = jax_from_mps(jmps)
    assert abs(ttns.expectation(ttno) - mps.expectation(Mpo(model))) < 1e-10
    assert abs(ttns.expectation(ttno) - jttns.expectation(jttno)) < 1e-10
    assert np.abs(ttns.todense() - jttns.todense()).max() < 1e-10


def test_dump_load_across_packages(tmp_path):
    (jmodel, jtree, jttns), (model, tree, ttns) = _carried_pair()
    ttns.dump(str(tmp_path / "port.npz"))
    jttns.dump(str(tmp_path / "jax.npz"))
    from_jax = TTNS.load(tree, str(tmp_path / "jax.npz"))
    to_jax = JaxTTNS.load(jtree, str(tmp_path / "port.npz"))
    dense = jttns.todense(order=jmodel.basis)
    assert np.abs(from_jax.todense(order=model.basis) - dense).max() < 1e-12
    assert np.abs(to_jax.todense(order=jmodel.basis) - dense).max() < 1e-12
    for a, b in zip(from_jax.node_list, jttns.node_list):
        np.testing.assert_array_equal(a.qn, b.qn)
    # a TTNO's file holds the JAX package's TTNO tensors under its keys,
    # and loads back (the JAX package's TTNO.load raises a TypeError: it
    # calls the constructor without operator terms)
    ttno = TTNO(tree, model.ham_terms)
    ttno.dump(str(tmp_path / "ttno.npz"))
    payload = np.load(str(tmp_path / "ttno.npz"), allow_pickle=True)
    for i, node in enumerate(JaxTTNO(jtree, jmodel.ham_terms).node_list):
        np.testing.assert_array_equal(payload[f"tensor_{i}"], np.asarray(node.tensor))
        np.testing.assert_array_equal(payload[f"qn_{i}"], node.qn)
    back = TTNO.load(tree, str(tmp_path / "ttno.npz"))
    assert np.abs(back.todense(order=model.basis) - ttno.todense(order=model.basis)).max() < 1e-12


def _dense_rdm(psi, axes):
    """The reduced density matrix of the dense state ``psi`` on ``axes``:
    rho[ket..., bra...] = sum over the other axes of psi[ket] conj(psi[bra])."""
    n = psi.ndim
    ket = list(range(n))
    bra = [n + k if k in axes else k for k in range(n)]
    out = list(axes) + [n + k for k in axes]
    return np.einsum(psi, ket, psi.conj(), bra, out)


def test_rdms_and_entropies():
    """1-site and 1-DoF RDMs and bond entropies against the JAX package;
    2-site and 2-DoF RDMs and the mutual information against the dense
    state's (the JAX package's own einsum path search stalls on those
    contractions of 9 and more operands)."""
    (jmodel, jtree, jttns), (model, tree, ttns) = _carried_pair()
    for port, ref in [(ttns.calc_1site_rdm(), jttns.calc_1site_rdm()),
                      (ttns.calc_1dof_rdm(), jttns.calc_1dof_rdm())]:
        assert port.keys() == ref.keys()
        for k in port:
            assert np.abs(port[k] - np.asarray(ref[k])).max() < 1e-10
    assert np.abs(ttns.calc_bond_entropy() - jttns.calc_bond_entropy()).max() < 1e-10

    psi = ttns.todense(order=model.basis)
    axis = {i: model.basis.index(n.basis_sets[0]) for i, n in enumerate(tree.node_list)}
    pairs = [(1, 4), (0, 2), (3, 5)]
    rdm2 = ttns.calc_2site_rdm(pairs)
    for i, j in pairs:
        assert np.abs(rdm2[(i, j)] - _dense_rdm(psi, (axis[i], axis[j]))).max() < 1e-10
    e0, e2 = model.e_dofs[0], model.e_dofs[2]
    dof_axis = {d: model.basis.index(tree.dof2basis[d]) for d in tree.dof_list}
    rdm_dof = ttns.calc_2dof_rdm([(e0, e2)])[(e0, e2)]
    assert np.abs(rdm_dof - _dense_rdm(psi, (dof_axis[e0], dof_axis[e2]))).max() < 1e-10
    mutual, (s1, s2) = ttns.calc_2dof_mutual_info((e0, e2))
    from renormalizer_tpu_torch.utils import calc_vn_entropy_dm

    s_pair = calc_vn_entropy_dm(_dense_rdm(psi, (dof_axis[e0], dof_axis[e2])))
    s_single = [calc_vn_entropy_dm(_dense_rdm(psi, (dof_axis[d],))) for d in (e0, e2)]
    assert abs(mutual[(e0, e2)] - (sum(s_single) - s_pair) / 2) < 1e-10
    # a leaf's bond entropy is its 1-site entropy
    bond, site = ttns.calc_bond_entropy(), ttns.calc_1site_entropy()
    leaves = [i for i, n in enumerate(ttns.node_list) if not n.children]
    assert leaves and all(abs(bond[i] - site[i]) < 1e-8 for i in leaves)


def test_hartree_state_expectation():
    model = port_heisenberg()
    tree = BasisTree.binary(model.basis)
    ttns = TTNS(tree, condition={0: 1, 2: 1})
    state = np.zeros(2 ** 4)
    state[np.ravel_multi_index((1, 0, 1, 0), (2, 2, 2, 2))] = 1
    for op in [Op("Z", 0), Op("Z", 1), Op("Z Z", [0, 2])]:
        dense_op = dense_hamiltonian(Model(model.basis, [op]))
        assert abs(ttns.expectation(TTNO(tree, [op])) - state @ dense_op @ state) < 1e-12
