"""The workload runners, one per traffic ``kind``.  A traffic file names its
kind and parameters; the configuration file gives the model, the ansatz, the
bond dimension and the quantum number.

* ``ground_state``: whole ground-state solves (MPS: ``optimize_mps``,
  2-site; tree: ``optimize_ttns``), each from a random start that is drawn
  at its first use, outside the solve's time (MPS: ``Mps.random``; tree: a
  random state on ``BasisTree.binary``).  The starts come from a pool of
  ``pool.size`` seeds fixed by the traffic file, taken in order, and the
  window holds whole rounds of the pool: every run solves the same starts.
  (How many sweeps the package's convergence rule takes depends on the
  start, so starts drawn from the run's seed would spread the runs.)  The
  run's seed picks the solves that the reference checks.
* ``tdvp_ps``: back-to-back real-time TDVP-PS steps (``Mps.evolve``) from a
  random start drawn from the run's seed in set-up.  The reference checks
  the first warm-up step, from that start, and the steps the seed picks.

A runner sets up (model, operator, warm-up), runs one unit of work at a
time, keeps the outputs of the units that the seed picks for the check, and
hands them to the reference once the window has closed.
"""

import numpy as np

from reference import judge

STREAM_UNIT, STREAM_WARMUP, STREAM_CHECK, STREAM_START = 0, 1, 2, 3


def derive(seed, stream, index):
    """A 32-bit seed for ``(stream, index)`` of the run's ``seed``."""
    seq = np.random.SeedSequence([int(seed) % 2 ** 64, stream, index])
    return int(seq.generate_state(1, np.uint32)[0])


def holstein_model(spec):
    """The configuration's Holstein chain through the port's constructors."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity

    if spec["model"] != "holstein_chain" or spec.get("periodic", False):
        raise ValueError(f"unknown model {spec['model']!r}")
    phonons = [Phonon.simple_phonon(Quantity(m["omega_cm"], "cm-1"),
                                    Quantity(m["displacement_au"]), int(m["levels"]))
               for m in spec["modes"]]
    mol = Mol(Quantity(spec["elocalex_ev"], "eV"), phonons)
    return HolsteinModel([mol] * int(spec["n_mol"]), Quantity(spec["j_ev"], "eV"))


def chain_state(mps):
    """A returned MPS as the reference's network (the chain, root last)."""
    nodes = []
    for i, basis in enumerate(mps.model.basis):
        t = mps[i]
        nodes.append({"tensor": t.reshape(t.shape[1:]) if i == 0 else t,
                      "children": [i - 1] if i else [], "label": basis.dof})
    return {"kind": "chain", "nodes": nodes, "root": len(nodes) - 1}


def tree_state(ttns):
    """A returned TTNS as the reference's network."""
    nodes = []
    for node, bnode in zip(ttns.node_list, ttns.basis.node_list):
        if len(bnode.dofs) != 1 or len(bnode.dofs[0]) != 1:
            raise ValueError("the reference takes one site per tree node")
        nodes.append({"tensor": node.tensor,
                      "children": [ttns.node_idx[c] for c in node.children],
                      "label": bnode.dofs[0][0]})
    return {"kind": "tree", "nodes": nodes, "root": ttns.node_idx[ttns.root]}


def random_ttns(basis, qntot, m_max, rng):
    """A random TTNS with conserved quantum number: ``TTNS.random``'s
    construction (postorder, each node a selection of orthonormal sector
    columns), with each sector's columns drawn as ``Mps.random`` draws them,
    a thin QR of a Gaussian block of at most ``m_max + 8`` columns, in place
    of a full Haar matrix of the sector's size."""
    from renormalizer_tpu_torch.mps.lib import select_basis
    from renormalizer_tpu_torch.tn import TTNS

    ttns = TTNS(basis)
    qntot = np.atleast_1d(np.array(qntot))
    qn_size = len(qntot)
    for node in ttns.postorder_list()[:-1]:
        qnbigl, _, _ = ttns.get_qnmat(node, include_parent=False)
        shape = qnbigl.shape
        qnbigl = qnbigl.reshape(-1, qn_size)
        u_list, s_list, qn_list = [], [], []
        for sector in sorted(set(tuple(t) for t in qnbigl)):
            if np.all(qntot < np.array(sector)):
                continue
            indices = np.flatnonzero((qnbigl == np.array(sector)).all(axis=1))
            ncols = min(len(indices), int(m_max) + 8)
            u, _ = np.linalg.qr(rng.standard_normal((len(indices), ncols)))
            full = np.zeros((len(qnbigl), ncols))
            full[indices, :] = u
            u_list.append(full)
            s_list.append(rng.random(ncols))
            qn_list += [sector] * ncols
        u = np.concatenate(u_list, axis=1)
        mt, dim, qn, _ = select_basis(u, np.concatenate(s_list), qn_list, u,
                                      m_max, percent=1.0)
        node.tensor = np.asarray(mt).reshape(list(shape)[:-1] + [dim])
        node.qn = qn
    ttns.root.qn = np.ones((1, qn_size), dtype=int) * qntot
    mask = ttns.get_qnmask(ttns.root, include_parent=False)
    tensor = rng.random(mask.shape) - 0.5
    tensor[~mask] = 0
    ttns.root.tensor = tensor / np.linalg.norm(tensor.ravel())
    ttns.check_shape()
    return ttns


class Runner:
    """Shared parts: the seed, the units picked for the check, the kept
    outputs."""

    whole = 1  # the window holds a multiple of this many units

    def __init__(self, config, traffic, seed, planned):
        self.config, self.traffic, self.seed = config, traffic, seed
        check = traffic["check"]
        first = min(int(check["within_first"]), planned)
        rng = np.random.default_rng(derive(seed, STREAM_CHECK, 0))
        self.picked = set(rng.choice(first, size=min(int(check["count"]), first),
                                     replace=False).tolist())
        self.kept = {}

    def before(self, i):
        pass

    def release(self):
        """Drop everything of the program but the kept outputs."""
        import torch

        for name in ("model", "operator", "state", "start", "pool", "tree"):
            self.__dict__.pop(name, None)
        torch.cuda.empty_cache()


class GroundState(Runner):
    def __init__(self, config, traffic, seed, planned):
        super().__init__(config, traffic, seed, planned)
        pool = traffic["pool"]
        self.whole = int(pool["size"])
        self.starts = [derive(pool["seed"], STREAM_UNIT, j) for j in range(self.whole)]
        self.warmup_starts = [derive(pool["seed"], STREAM_WARMUP, j)
                              for j in range(int(traffic["warmup_units"]))]
        self.pool, self.start = {}, None

    def setup(self):
        from renormalizer_tpu_torch import Mpo
        from renormalizer_tpu_torch.tn import TTNO, BasisTree

        self.model = holstein_model(self.config)
        self.ansatz = self.config["ansatz"]
        if self.ansatz == "mps":
            self.operator = Mpo(self.model)
        elif self.ansatz == "ttns-binary":
            self.tree = BasisTree.binary(self.model.basis)
            self.operator = TTNO(self.tree, self.model.ham_terms)
        else:
            raise ValueError(f"unknown ansatz {self.ansatz!r}")
        for seed in self.warmup_starts:
            self._solve(self._draw(seed))

    def _draw(self, seed):
        """The random start of one solve."""
        m, qntot = int(self.config["m"]), int(self.config["qntot"])
        if self.ansatz == "mps":
            from renormalizer_tpu_torch import Mps
            from renormalizer_tpu_torch.backend import backend

            # Mps.random draws from the backend's seed, which has no setter
            backend._seed = seed
            return Mps.random(self.model, qntot, m, percent=1.0)
        return random_ttns(self.tree, qntot, m, np.random.default_rng(seed))

    def _solve(self, start):
        m = int(self.config["m"])
        procedure = [[m, p] for p in self.traffic["procedure_percent"]]
        if self.ansatz == "mps":
            from renormalizer_tpu_torch import optimize_mps

            start.optimize_config.procedure = procedure
            start.optimize_config.method = self.traffic["method"]
            energies, out = optimize_mps(start, self.operator)
            return float(min(energies)), out
        from renormalizer_tpu_torch.tn import gs as tree_gs

        energies = tree_gs.optimize_ttns(start, self.operator, procedure)
        return float(np.real(energies[-1])), start

    def before(self, i):
        """Each start of the pool is drawn once, at its first use; a solve
        runs on a copy of it with tensors of its own."""
        j = i % self.whole
        if j not in self.pool:
            self.pool[j] = self._draw(self.starts[j])
        start = self.pool[j].copy()
        if self.ansatz == "mps":
            for k in range(len(start)):
                start[k] = start[k].clone()
        else:
            for node in start:
                node.tensor = node.tensor.copy() if isinstance(node.tensor, np.ndarray) \
                    else node.tensor.clone()
        self.start = start

    def unit(self, i):
        self.last = self._solve(self.start)

    def after(self, i):
        if i in self.picked:
            self.kept[i] = self.last
        self.last = self.start = None

    def judge(self):
        numbers = []
        for i in sorted(self.kept):
            energy, out = self.kept[i]
            state = chain_state(out) if self.ansatz == "mps" else tree_state(out)
            numbers.append(judge.ground_state(self.config, state, energy))
        return numbers


class TdvpSteps(Runner):
    def setup(self):
        from renormalizer_tpu_torch import EvolveConfig, EvolveMethod, Mpo, Mps
        from renormalizer_tpu_torch.backend import backend

        if self.config["ansatz"] != "mps":
            raise ValueError("tdvp_ps traffic runs on an MPS configuration")
        self.model = holstein_model(self.config)
        self.operator = Mpo(self.model)
        self.labels = [b.dof for b in self.model.basis]
        backend._seed = derive(self.seed, STREAM_START, 0)
        self.state = Mps.random(self.model, int(self.config["qntot"]), int(self.config["m"]),
                                percent=1.0)
        self.state.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps,
                                                adaptive=bool(self.traffic["adaptive"]))
        self.dt = float(self.traffic["dt"])
        self.from_start = self._keep()
        for w in range(int(self.traffic["warmup_units"])):
            self.unit(-1)
            if w == 0:
                self.from_start["after"] = [t.clone() for t in self.state]

    def _keep(self):
        s = self.state
        if s.qnidx != (0 if s.to_right else len(s) - 1):
            raise RuntimeError("a step does not start at the end of the chain")
        return {"before": [t.clone() for t in s], "first_to_right": bool(s.to_right)}

    def before(self, i):
        if i in self.picked:
            self.kept[i] = self._keep()

    def unit(self, i):
        self.state = self.state.evolve(self.operator, self.dt)

    def after(self, i):
        if i in self.picked:
            self.kept[i]["after"] = [t.clone() for t in self.state]

    def judge(self):
        return [judge.tdvp_step(self.config, self.labels, k["before"], k["after"], self.dt,
                                k["first_to_right"])
                for k in [self.from_start] + [k for _, k in sorted(self.kept.items())]]


KINDS = {"ground_state": GroundState, "tdvp_ps": TdvpSteps}
