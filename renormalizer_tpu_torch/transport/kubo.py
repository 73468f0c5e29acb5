r"""Carrier mobility via the Green-Kubo formula.

.. math::
    \mu = \frac{1}{k_B T}\int_0^\infty dt\, \langle \hat j(t)\hat j(0)\rangle

The current operator is derived automatically from the Hamiltonian
(:func:`derive_current_terms` scans for inter-site electronic hops, split
into a bare Holstein part and a phonon-assisted Peierls part); the thermal
average is realized by splitting :math:`e^{-\beta H}` symmetrically and
evolving two branches in real time.  With a Peierls part present, four
correlation components :math:`\langle J_a(t) J_b(0)\rangle` are collected.
Port of ``renormalizer_tpu/transport/kubo.py`` (reference
``renormalizer/transport/kubo.py``).
"""

import logging
import os

import numpy as np

from renormalizer_tpu_torch.model import Model
from renormalizer_tpu_torch.mps import BraKetPair, MpDm, Mpo, ThermalProp, load_thermal_state
from renormalizer_tpu_torch.utils import CompressConfig, EvolveConfig, Quantity, TdMpsJob
from renormalizer_tpu_torch.utils.constant import mobility2au

logger = logging.getLogger(__name__)


def pbc_chain_distances(n: int) -> np.ndarray:
    """Signed site-distance matrix of a periodic 1D chain (the wrap bond
    contributes +-1, not +-(n-1))."""
    d = np.arange(n).reshape(-1, 1) - np.arange(n).reshape(1, -1)
    d[0, -1], d[-1, 0] = 1, -1
    return d


def _electronic_legs(model: Model, term):
    """Indices of the (up to two) electronic operators inside one
    Hamiltonian term, as [(position-in-term, e-dof index), ...]."""
    legs = []
    for pos, dof in enumerate(term.dofs):
        if model.basis[model.dof_to_siteidx[dof]].is_electron:
            legs.append((pos, model.e_dofs.index(dof)))
    if len(legs) > 2:
        raise ValueError(f"three-electron (or more complex) operator {term}")
    return legs


def derive_current_terms(model: Model, distance_matrix: np.ndarray):
    """j = -i[P, H], scanned term-by-term; the i is dropped (j taken real)
    so every hop term is just weighted by its signed distance.  Returns
    (holstein_terms, peierls_terms)."""
    bare, assisted = [], []
    for term in model.ham_terms:
        legs = _electronic_legs(model, term)
        if len(legs) != 2 or legs[0][1] == legs[1][1]:
            continue  # on-site or purely vibrational term: no current
        if len(term.dofs) not in (2, 3):
            raise NotImplementedError("Complex vibration potential not implemented")
        if len(term.dofs) == 3:
            ph_pos = 3 - legs[0][0] - legs[1][0]
            assert term.split_symbol[ph_pos] in (r"b^\dagger+b", "x")
        sym1, sym2 = (term.split_symbol[p] for p, _ in legs)
        if {sym1, sym2} != {r"a^\dagger", "a"}:
            raise ValueError(f"Unknown symbol: {sym1}, {sym2}")
        i, j = legs[0][1], legs[1][1]
        weight = distance_matrix[i][j] if sym1 == r"a^\dagger" else distance_matrix[j][i]
        (bare if len(term.dofs) == 2 else assisted).append(term * weight)
    return bare, assisted


class TransportKubo(TdMpsJob):
    def __init__(self, model: Model, temperature: Quantity,
                 distance_matrix: np.ndarray = None, insteps: int = 1,
                 ievolve_config=None, compress_config=None, evolve_config=None,
                 dump_dir: str = None, job_name: str = None,
                 thermal_dump_path: str = None, properties=None):
        if temperature == 0:
            raise ValueError("Can't set temperature to 0.")
        self.model = model
        self.temperature = temperature
        self.h_mpo = Mpo(model)
        logger.info(f"H MPO bond dimensions: {self.h_mpo.bond_dims}")
        if distance_matrix is None:
            logger.info("no distance matrix given; assuming a periodic 1D chain")
            distance_matrix = pbc_chain_distances(model.n_edofs)
        self.distance_matrix = distance_matrix
        bare, assisted = derive_current_terms(model, distance_matrix)
        self.j_oper = Mpo(model, bare)
        logger.info(f"current operator bond dims: {self.j_oper.bond_dims}")
        self.j_oper2 = Mpo(model, assisted) if assisted else None
        if self.j_oper2 is not None:
            logger.info(
                f"Peierls current operator bond dims: {self.j_oper2.bond_dims}")

        if ievolve_config is None:
            ievolve_config = EvolveConfig()
            if insteps is None:
                ievolve_config.adaptive = True
                ievolve_config.guess_dt = temperature.to_beta() / 1e5j
                insteps = 1
        self.ievolve_config = ievolve_config
        self.insteps = insteps
        self.compress_config = (
            CompressConfig() if compress_config is None else compress_config)

        if thermal_dump_path is None and dump_dir is not None and job_name is not None:
            thermal_dump_path = os.path.join(dump_dir, job_name + "_impdm.npz")
        self.thermal_dump_path = thermal_dump_path

        self.properties = properties
        self._auto_corr = []
        self._auto_corr_decomposition = []
        super().__init__(evolve_config=evolve_config, dump_dir=dump_dir,
                         job_name=job_name)

    # --- initial state -----------------------------------------------------

    def _thermal_state(self) -> MpDm:
        """e^{-beta H / 2} of the one-exciton space, disk-cached."""
        if self.thermal_dump_path is not None:
            cached = load_thermal_state(self.model, self.thermal_dump_path)
            if cached is not None:
                return cached
        rho0 = MpDm.max_entangled_ex(self.model)
        rho0.compress_config = self.compress_config
        sub_name = None if self.job_name is None else (
            self.job_name + "_thermal_prop")
        tp = ThermalProp(rho0, evolve_config=self.ievolve_config,
                         dump_dir=self.dump_dir, job_name=sub_name)
        tp.evolve(None, self.insteps, self.temperature.to_beta() / 2j)
        rho = tp.latest_mps
        if self.thermal_dump_path is not None:
            rho.dump(self.thermal_dump_path)
        return rho

    def init_mps(self):
        rho = self._thermal_state()
        rho.compress_config = self.compress_config
        self.h_mpo = Mpo(self.model, offset=Quantity(rho.expectation(self.h_mpo)))
        rho.evolve_config = self.evolve_config
        logger.debug("applying the current operator to the thermal state")
        branches = []
        for j in (self.j_oper, self.j_oper2):
            if j is None:
                continue
            ket = j.contract(rho).normalize("mps_norm_to_coeff")
            branches.append(BraKetPair(rho.copy(), ket, j))
        return branches[0] if len(branches) == 1 else tuple(branches)

    # --- propagation loop --------------------------------------------------

    def evolve_single_step(self, evolve_dt):
        pairs = (self.latest_mps,) if self.j_oper2 is None else self.latest_mps
        bra = pairs[0].bra_mps.evolve(self.h_mpo, evolve_dt)
        kets = [p.ket_mps.evolve(self.h_mpo, evolve_dt) for p in pairs]
        out = [BraKetPair(bra, k, j)
               for k, j in zip(kets, (self.j_oper, self.j_oper2))]
        return out[0] if len(out) == 1 else tuple(out)

    def process_mps(self, mps):
        # minus sign: j was taken real above, so the true current is i*j
        if self.j_oper2 is None:
            self._auto_corr.append(-mps.ft)
            if self.properties is not None:
                self.properties.calc_properties_braketpair(mps)
            return
        (bra, ket1), (_, ket2) = mps
        comps = [
            -BraKetPair(bra, k, j).ft
            for j in (self.j_oper, self.j_oper2) for k in (ket1, ket2)
        ]
        self._auto_corr.append(sum(comps))
        self._auto_corr_decomposition.append(comps)

    def stop_evolve_criteria(self):
        """Auto-stop when |C(t)| has decayed to 1e-5 of |C(0)| for 10 steps."""
        corr = self.auto_corr
        if len(corr) < 10:
            return False
        tail, head = corr[-10:], np.abs(corr[0])
        return np.abs(tail.mean()) < 1e-5 * head and tail.std() < 1e-5 * head

    # --- results -----------------------------------------------------------

    @property
    def auto_corr(self) -> np.ndarray:
        return np.array(self._auto_corr)

    @property
    def auto_corr_decomposition(self) -> np.ndarray:
        return np.array(self._auto_corr_decomposition)

    def calc_mobility(self):
        mobility_au = (
            np.trapezoid(self.auto_corr.real, self.evolve_times)
            / self.temperature.as_au()
        )
        return mobility_au, mobility_au / mobility2au

    def get_dump_dict(self):
        out = {
            "mol list": self.model.to_dict(),
            "temperature": self.temperature.as_au(),
            "time series": self.evolve_times,
            "auto correlation": self.auto_corr,
            "auto correlation decomposition": self.auto_corr_decomposition,
            "mobility": self.calc_mobility()[1],
        }
        if self.properties is not None:
            out.update(self.properties.prop_res)
        return out
