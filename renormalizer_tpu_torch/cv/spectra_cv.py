r"""Frequency-domain DDMRG (correction vector) base machinery.

Port of ``renormalizer_tpu/cv/spectra_cv.py`` (reference
``renormalizer/cv/spectra_cv.py:17-205``).  Per frequency point the response
comes from sweeping a site-local linear solve of
((H - e0 - omega)^2 + eta^2) |x> = -eta mu |0> (``zerot.py``) or its
Liouville-space counterpart (``finitet.py``).

``batch_run`` never forks: ``cores > 1`` interleaves that many frequency
sweeps, site update by site update, in one process on the one card (the JAX
package pins its workers to ``jax.local_devices()``; the port targets
one card).  Each worker's numbers are those of the serial loop over its
chunk of frequencies.
"""

import copy
import logging

import numpy as np
import torch

from renormalizer_tpu_torch.mps import Mpo
from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

logger = logging.getLogger(__name__)


class _Worker:
    """One in-flight chunk of frequency sweeps."""

    def __init__(self, solver, omegas, indices):
        self.solver = solver
        self.omegas = list(omegas)
        self.indices = list(indices)  # global positions in freq_reg
        self.gen = None
        self.current = None
        self.results = []  # (global_index, value)

    def step(self) -> bool:
        """Advance one site update; False when the whole chunk is done."""
        if self.gen is None:
            if not self.omegas:
                return False
            self.current = (self.omegas.pop(0), self.indices.pop(0))
            self.gen = self.solver._cv_solve_steps(self.current[0])
        try:
            next(self.gen)
        except StopIteration as stop:
            self.results.append((self.current[1], stop.value))
            self.gen = None
        return True


def batch_run(freq_reg, cores, obj, filename=None):
    """The CV response over a frequency window.  ``cores`` bounds the
    number of interleaved in-flight frequency sweeps; each takes a
    contiguous chunk of ``freq_reg`` (warm starts stay continuous in omega)
    and its own copy of ``obj`` (:meth:`SpectraCv.clone_for_batch`)."""
    logger.info(f"{len(freq_reg)} total frequency points to do")
    obj.batch_run = True
    nworkers = max(1, min(int(cores), len(freq_reg)))
    if nworkers == 1:
        spectra = []
        for omega in freq_reg:
            spectra.append(obj.cv_solve(omega))
            if filename is not None:
                np.save(f"{filename}", spectra)
        return spectra

    logger.info(f"{nworkers} interleaved in-process workers")
    workers = []
    for idx in np.array_split(np.arange(len(freq_reg)), nworkers):
        if len(idx):
            workers.append(_Worker(obj.clone_for_batch(),
                                   [freq_reg[i] for i in idx], idx))

    def _collect():
        return [v for _, v in sorted(p for wk in workers for p in wk.results)]

    live = list(workers)
    n_done = 0
    while live:
        live = [wk for wk in live if wk.step()]
        if filename is not None:
            # checkpoint after every completed frequency point
            done = sum(len(wk.results) for wk in workers)
            if done != n_done:
                n_done = done
                np.save(f"{filename}", _collect())
    spectra = _collect()
    if filename is not None:
        np.save(f"{filename}", spectra)
    return spectra


class SpectraCv:
    def __init__(self, model, spectratype, m_max, eta, h_mpo=None,
                 method="1site", procedure_cv=None, rtol=1e-5, b_mps=None,
                 e0=None, cv_mps=None):
        self.model = model
        assert spectratype in ("abs", "emi", None)
        self.spectratype = spectratype
        self.m_max = m_max
        self.eta = eta
        self.h_mpo = h_mpo if h_mpo is not None else Mpo(model)
        assert method in ("1site", "2site")
        self.method = method
        logger.info(f"cv optimize method: {method}")
        if procedure_cv is None:
            procedure_cv = [0.4, 0.4, 0.2, 0.2, 0.1, 0.1] + [0] * 45
        self.procedure_cv = procedure_cv
        self.rtol = rtol

        if b_mps is None:
            self.b_mps, self.e0 = self.init_b_mps()
        else:
            self.b_mps = b_mps
            self.e0 = e0
        self.cv_mps = cv_mps if cv_mps is not None else self.init_cv_mps()
        self.cv_mps.compress_config = CompressConfig(
            CompressCriteria.fixed, max_bonddim=m_max)

        self.hop_time = []
        self.macro_iteration_result = []
        # (omega, sweeps, converged) of every ``cv_solve``
        self.solve_log = []
        self.batch_run = False
        logger.info("DDMRG job created.")

    def cv_solve(self, omega):
        """Sweeping solve at one frequency; returns the response value.  The
        previous frequency's ``cv_mps`` is the warm start."""
        gen = self._cv_solve_steps(omega)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    def _cv_solve_steps(self, omega):
        """Generator form of :meth:`cv_solve`: yields after every site
        update; the per-site responses stay on the device until the sweep
        ends, read together in one host read per sweep."""
        self.clear_res()
        converged = False
        len_cv = len(self.cv_mps)
        self.oper_prepare(omega)

        lr_group = None
        isweep = 0
        for idx, procedure in enumerate(self.procedure_cv):
            isweep = idx + 1
            if self.cv_mps.to_right and self.cv_mps.qnidx == 0:
                irange = np.arange(1 if self.method == "1site" else 2, len_cv + 1)
            elif (not self.cv_mps.to_right) and self.cv_mps.qnidx == self.cv_mps.site_num - 1:
                irange = np.arange(len_cv, 0 if self.method == "1site" else 1, -1)
            else:
                raise AssertionError
            if isweep == 1:
                lr_group = self.initialize_LR()
            micro = []
            for isite in irange:
                l_value = self.optimize_cv(lr_group, isite, percent=procedure)
                at_sweep_end = self.method == "1site" and (
                    ((not self.cv_mps.to_right) and isite == 1)
                    or (self.cv_mps.to_right and isite == len_cv))
                if not at_sweep_end:
                    lr_group = self.update_LR(lr_group, isite)
                micro.append(-1.0 / (np.pi * self.eta) * l_value.reshape(()))
                yield
            micro = [float(v) for v in torch.stack(micro).real.cpu().numpy()]
            logger.debug(f"omega:{omega}, isweep:{isweep}, responses:{micro}")
            self.cv_mps.to_right = not self.cv_mps.to_right
            self.macro_iteration_result.append(max(micro))
            if idx > 0 and procedure == 0:
                v1, v2 = sorted(self.macro_iteration_result)[-2:]
                if abs((v1 - v2) / v1) < self.rtol:
                    converged = True
                    break
        self.solve_log.append((omega, isweep, converged))
        if converged:
            logger.info("cv converged!")
        else:
            logger.warning("cv *NOT* converged!")
        logger.info(f"omega:{omega}, sweeps:{isweep}, "
                    f"res:{max(self.macro_iteration_result)}")
        res = max(self.macro_iteration_result)
        if self.batch_run:
            self.clear_res()
        return res

    def clear_res(self):
        self.hop_time.clear()
        self.macro_iteration_result.clear()

    def clone_for_batch(self) -> "SpectraCv":
        """An independent copy of this solver for one ``batch_run`` worker."""
        new = copy.copy(self)
        new.hop_time = []
        new.macro_iteration_result = []
        new.solve_log = []
        new.batch_run = True
        for attr in ("cv_mps", "b_mps", "h_mpo", "a_oper"):
            mp = getattr(new, attr, None)
            if mp is not None:
                setattr(new, attr, mp.copy())
        # subclass aliases (finite temperature names)
        if hasattr(new, "cv_mpo"):
            new.cv_mpo = new.cv_mps
        if hasattr(new, "b_mpo"):
            new.b_mpo = new.b_mps
        return new

    # subclass hooks
    def init_cv_mps(self):
        raise NotImplementedError

    def init_b_mps(self):
        raise NotImplementedError

    def oper_prepare(self, omega):
        raise NotImplementedError

    def optimize_cv(self, lr_group, isite, percent=0):
        raise NotImplementedError

    def initialize_LR(self):
        raise NotImplementedError

    def update_LR(self, lr_group, isite):
        raise NotImplementedError
