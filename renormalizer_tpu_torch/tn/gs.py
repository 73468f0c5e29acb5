r"""DMRG ground state on tree tensor networks.

Port of ``renormalizer_tpu/tn/gs.py`` (reference
``renormalizer/tn/gs.py:18-131``): recursive 2-site sweeps, each local
eigenproblem solved in the qn-masked full local space by the port's Davidson
(``davidson``; several roots: the block ``davidson_multiroot``), scipy's
``eigsh`` over the device matvec (``algo="arpack"``) or a dense eigh in
double precision (``"direct"``, ``eigh_wide``), then truncated by
``TTNS.update_2site`` (the Jacobi kernel).  The JAX package's global-mesh
branch (the sharded tree matvec) is not carried.
"""

import logging
from typing import List, Union

import numpy as np
import torch

from renormalizer_tpu_torch.backend import backend, np_dtype
from renormalizer_tpu_torch.lib.solvers import davidson, davidson_multiroot, eigh_wide
from renormalizer_tpu_torch.tn.hop_expr import hop_expr2
from renormalizer_tpu_torch.tn.node import TreeNodeTensor
from renormalizer_tpu_torch.tn.tree import TTNEnviron, TTNO, TTNS

logger = logging.getLogger(__name__)


def _solver_tol() -> float:
    return 1e-5 if backend.is_32bits else 1e-10


def optimize_ttns(ttns: TTNS, ttno: TTNO, procedure=None):
    """Macro sweeps over the optimization procedure; returns the final
    micro-sweep energy of each macro sweep (reference semantics)."""
    sweeps = ttns.optimize_config.procedure if procedure is None else procedure
    ttne = TTNEnviron(ttns, ttno)
    macro_e = []
    for isweep, (m, percent) in enumerate(sweeps):
        micro_e = optimize_recursion(ttns.root, ttns, ttno, ttne, m, percent)
        # with nroots > 1 each micro energy is a vector; rank by the lowest root
        best = min(np.atleast_1d(np.real(e))[0] for e in micro_e)
        logger.info(
            f"TTNS macro sweep {isweep} (m={m}, percent={percent}): "
            f"best micro e {best:.10g}"
        )
        macro_e.append(micro_e[-1])
    return macro_e


def optimize_recursion(
    snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron,
    m: Union[int, List[int]], percent: float = 0,
) -> List[float]:
    """Optimize ``snode``'s bonds with all of its children, depth-first."""
    assert snode.children  # 2-site algorithm needs at least two nodes
    micro_e = []
    for ichild, child in enumerate(snode.children):
        if child.children:
            e, c = optimize_2site(child, ttns, ttno, ttne)
            micro_e.append(e)
            ttns.update_2site(child, c, m, percent, cano_parent=False)
            ttne.update_2site(child, ttns, ttno)
            micro_e.extend(optimize_recursion(child, ttns, ttno, ttne, m))
        e, c = optimize_2site(child, ttns, ttno, ttne)
        micro_e.append(e)
        ttns.update_2site(child, c, m, percent, cano_parent=True)
        ttne.update_2site(child, ttns, ttno)
    return micro_e


def optimize_2site(snode: TreeNodeTensor, ttns: TTNS, ttno: TTNO, ttne: TTNEnviron):
    """Solve the local 2-site eigenproblem in the qn-restricted full space."""
    cguess = ttns.merge_with_parent(snode)
    qn_mask = ttns.get_qnmask(snode, include_parent=True)
    mask_flat = backend.tensor(qn_mask.ravel())
    expr, hdiag = hop_expr2(snode, ttns, ttno, ttne)
    cshape = qn_mask.shape

    def hop(x):
        x = torch.where(mask_flat, x, 0)
        out = expr(x.reshape(cshape)).reshape(-1)
        return torch.where(mask_flat, out, 0)

    nroots = ttns.optimize_config.nroots
    algo = ttns.optimize_config.algo
    hdiag_eff = torch.where(mask_flat, hdiag.reshape(-1).real, 1e10)
    x0 = torch.where(mask_flat, cguess.reshape(-1), 0)
    if nroots > 1:
        # state-averaged: block Davidson for the nroots lowest local
        # eigenpairs; the truncation averages their density matrices
        rng = np.random.default_rng(2019)
        x0_list = [x0] + [
            torch.where(mask_flat, backend.tensor(rng.random(qn_mask.size) - 0.5,
                                                  dtype=x0.dtype), 0)
            for _ in range(nroots - 1)
        ]
        thetas, big_x, _ = davidson_multiroot(
            lambda rows: torch.stack([hop(r) for r in rows]), x0_list,
            hdiag_eff, nroots, tol=_solver_tol(), max_cycle=100)
        es = [float(t) for t in thetas.cpu().numpy()]
        cs = [big_x[i].reshape(cshape) for i in range(nroots)]
        return es, cs
    if algo == "davidson":
        e, c, _ = davidson(hop, x0, hdiag_eff, tol=_solver_tol(), max_cycle=100)
        e = float(e)
    elif algo == "arpack":
        # host Lanczos (scipy eigsh) restricted to the masked subspace, each
        # matvec on the device (reference tree option: ``tn/gs.py:105-109``)
        import scipy.sparse.linalg

        idx = np.nonzero(qn_mask.ravel())[0]
        if len(idx) <= 1:
            return _eigh_dense_masked(hop, qn_mask, cshape, x0.dtype)
        idx_dev = backend.tensor(idx)
        dim = qn_mask.size

        def matvec(x):
            full = torch.zeros(dim, dtype=x0.dtype, device=backend.device)
            full[idx_dev] = backend.tensor(np.asarray(x).ravel(), dtype=x0.dtype)
            return hop(full)[idx_dev].cpu().numpy()

        lo = scipy.sparse.linalg.LinearOperator(
            (len(idx), len(idx)), matvec=matvec, dtype=np_dtype(x0.dtype))
        v0 = x0.cpu().numpy()[idx]
        w, v = scipy.sparse.linalg.eigsh(lo, k=1, which="SA", v0=v0)
        e = float(w[0])
        c = torch.zeros(dim, dtype=x0.dtype, device=backend.device)
        c[idx_dev] = backend.tensor(v[:, 0], dtype=x0.dtype)
    elif algo == "direct":
        return _eigh_dense_masked(hop, qn_mask, cshape, x0.dtype)
    else:
        raise NotImplementedError(f"TTNS eigensolver algo={algo} not available")
    return e, c.reshape(cshape)


def _eigh_dense_masked(hop, qn_mask, cshape, dtype):
    """Materialize H on the masked subspace (one matvec per in-sector unit
    vector) and diagonalize it in double precision."""
    idx = backend.tensor(np.nonzero(qn_mask.ravel())[0])
    dim = qn_mask.size
    unit = torch.zeros((len(idx), dim), dtype=dtype, device=backend.device)
    unit[torch.arange(len(idx), device=backend.device), idx] = 1
    a = torch.stack([hop(u)[idx] for u in unit])
    assert torch.allclose(a, a.mH, atol=1e-8 if dtype in (torch.float64, torch.complex128)
                          else 1e-4)
    evals, evecs = eigh_wide((a + a.mH) / 2)
    c_full = torch.zeros(dim, dtype=dtype, device=backend.device)
    c_full[idx] = evecs[:, 0]
    return float(evals[0]), c_full.reshape(cshape)
