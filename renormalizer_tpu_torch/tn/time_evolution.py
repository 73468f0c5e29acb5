r"""Time evolution of tree tensor network states.

Port of ``renormalizer_tpu/tn/time_evolution.py`` (reference
``renormalizer/tn/time_evolution.py:22-298``): TDVP-VMF (one global
adaptive RKF45 with regularized inverses), P&C-RK4, TDVP-PS (stack-based
forward/backward walks) and TDVP-PS2 (recursive 2-site), registered in
``tn.tree.EVOLVE_METHODS``.  Each local propagation is the port's Lanczos
``expm_krylov``; TDVP-PS2 truncates through ``TTNS.update_2site``.

VMF integrates in double precision whatever the working precision, as the
MPS VMF does (``Mps._evolve_tdvp_mu_vmf``): the regularized inverse of a
node's overlap amplifies its right-hand side along the padding directions
of the bond (1/reg(s) up to 1e10), which single-precision rounding turns
into noise that stalls the RKF45 controller.  The regularized inversion is
a host ``scipy.linalg.eigh`` in float64, as in the JAX package: one host
read of each non-root node's overlap per right-hand side, counted in
:data:`TREE_COUNTS`.  The JAX package also reads every node's derivative
back to the host per right-hand side; here the derivative stays on the
device.

:data:`TREE_COUNTS` ``local_steps`` counts the Krylov propagations of
TDVP-PS/PS2 (the JAX package reads each one's step count from the device;
the port's Lanczos runs a fixed number of steps, a host integer).
"""

import logging
from math import factorial
from typing import List, Tuple

import numpy as np
import scipy.linalg
import torch

from renormalizer_tpu_torch.backend import backend
from renormalizer_tpu_torch.lib.solvers import expm_krylov, solve_ivp
from renormalizer_tpu_torch.mps.lib import compressed_sum
from renormalizer_tpu_torch.mps.trunc_device import _double
from renormalizer_tpu_torch.ops.contract import einsum
from renormalizer_tpu_torch.tn.hop_expr import hop_expr0, hop_expr1, hop_expr2
from renormalizer_tpu_torch.tn.node import TreeNodeTensor, copy_connection
from renormalizer_tpu_torch.tn.tree import EVOLVE_METHODS, TTNEnviron, TTNO, TTNS
from renormalizer_tpu_torch.utils.configs import EvolveMethod

logger = logging.getLogger(__name__)

# Totals since import: Krylov propagations of TDVP-PS/PS2 (``local_steps``)
# and the overlaps VMF reads to the host for their regularized inverses
# (``vmf_host_reads``, one per non-root node per right-hand side).
TREE_COUNTS = {"local_steps": 0, "vmf_host_reads": 0}


def regularized_inversion(m, eps):
    """Regularized inverse of a Hermitian overlap on the host in float64."""
    w, u = scipy.linalg.eigh(m)
    w = w + eps * np.exp(-w / eps)
    return u @ np.diag(1 / w) @ u.T.conj()


def time_derivative_vmf(ttns: TTNS, ttno: TTNO, masks=None):
    """Tangent-space derivative of all nodes for VMF evolution, flattened
    over each node's qn mask (reference ``tn/time_evolution.py:22-47``)."""
    environ_s = TTNEnviron(ttns, TTNO.dummy(ttns.basis))
    environ_h = TTNEnviron(ttns, ttno)
    if masks is None:
        masks = [ttns.get_qnmask(node) for node in ttns.node_list]

    deriv_list = []
    for inode, node in enumerate(ttns.node_list):
        hop = hop_expr1(node, ttns, ttno, environ_h)
        dim_parent = node.shape[-1]
        tensor = node.tensor
        deriv = hop(tensor).reshape(-1, dim_parent)
        if node.parent is not None:
            tensor2d = tensor.reshape(-1, dim_parent)
            proj = tensor2d.conj() @ tensor2d.T
            ovlp = environ_s.node_list[inode].environ_parent.reshape(dim_parent, dim_parent)
            TREE_COUNTS["vmf_host_reads"] += 1
            ovlp_inv = regularized_inversion(
                ovlp.detach().cpu().numpy().astype(
                    np.complex128 if ovlp.is_complex() else np.float64),
                ttns.evolve_config.reg_epsilon)
            eye = torch.eye(proj.shape[0], dtype=proj.dtype, device=proj.device)
            deriv = einsum("bf,bg,fh->gh", deriv, eye - proj,
                           backend.tensor(np.ascontiguousarray(ovlp_inv.T)))
        mask = torch.as_tensor(masks[inode], device=deriv.device).reshape(deriv.shape)
        deriv_list.append(deriv[mask])
    return torch.cat(deriv_list)


def _double_ttno(ttno: TTNO) -> TTNO:
    """A double-precision twin of ``ttno`` (itself when it already is),
    cached on it."""
    wide = _double(ttno.root.tensor).dtype
    if ttno.root.tensor.dtype == wide:
        return ttno
    twin = getattr(ttno, "_double_twin", None)
    if twin is None:
        nodes = [TreeNodeTensor(_double(n.tensor), n.qn) for n in ttno.node_list]
        twin = TTNO(ttno.basis, ttno.terms,
                    root=copy_connection(ttno.node_list, nodes))
        ttno._double_twin = twin
    return twin


def evolve_tdvp_vmf(ttns: TTNS, ttno: TTNO, coeff, tau: float, first_step=None):
    narrow = ttns.root.tensor.dtype
    work = ttns.metacopy()
    for node in work:
        node.tensor = _double(node.tensor)
    ttno = _double_ttno(ttno)
    masks = [ttns.get_qnmask(node) for node in ttns.node_list]

    def ivp_func(t, params):
        ttns_t = TTNS.from_tensors(work, params, masks)
        return coeff * time_derivative_vmf(ttns_t, ttno, masks)

    init_y = torch.cat([
        node.tensor[torch.as_tensor(mask, device=node.tensor.device)]
        for node, mask in zip(work.node_list, masks)
    ])
    sol = solve_ivp(
        ivp_func, (0, tau), init_y, first_step=first_step,
        atol=ttns.evolve_config.ivp_atol, rtol=ttns.evolve_config.ivp_rtol,
    )
    logger.info(f"VMF func called: {sol.nfev}. RKF steps: {sol.nsteps}")
    new_ttns = TTNS.from_tensors(work, sol.y, masks)
    for node in new_ttns:
        node.tensor = node.tensor.to(narrow)
    new_ttns.canonicalise()
    return new_ttns


def evolve_prop_and_compress_tdrk4(ttns: TTNS, ttno: TTNO, coeff, tau: float):
    termlist = [ttns]
    for _ in range(4):
        termlist.append(ttno.contract(termlist[-1]))
    for i, term in enumerate(termlist):
        term.scale((coeff * tau) ** i / factorial(i), inplace=True)
    return compressed_sum(termlist)


# --- projector splitting ---------------------------------------------------

def _krylov(hop, shape, dt, v0):
    out, j = expm_krylov(lambda y: hop(y.reshape(shape)).reshape(-1), dt, v0.reshape(-1))
    TREE_COUNTS["local_steps"] += 1
    return out, j


def evolve_1site(snode, ttns, ttno, ttne, coeff, tau):
    ms = snode.tensor
    hop = hop_expr1(snode, ttns, ttno, ttne)
    return _krylov(hop, ms.shape, coeff * tau, ms)


def evolve_2site(snode, ttns, ttno, ttne, coeff, tau):
    ms2 = ttns.merge_with_parent(snode)
    hop, _ = hop_expr2(snode, ttns, ttno, ttne)
    return _krylov(hop, ms2.shape, coeff * tau, ms2)


def evolve_0site(ms, snode, ttns, ttno, ttne, coeff, tau):
    hop = hop_expr0(snode, ttns, ttno, ttne)
    return _krylov(hop, ms.shape, coeff * tau, ms)


def evolve_tdvp_ps(ttns: TTNS, ttno: TTNO, coeff, tau: float):
    """Second-order one-site projector splitting
    (reference ``tn/time_evolution.py:79-174``)."""
    ttns.check_canonical()
    ttne = TTNEnviron(ttns, ttno)
    _tdvp_ps_forward(ttns, ttno, ttne, coeff, tau / 2)
    _tdvp_ps_backward(ttns, ttno, ttne, coeff, tau / 2)
    return ttns


def _tdvp_ps_forward(ttns, ttno, ttne, coeff, tau) -> List[int]:
    """Postorder walk: each node's subtrees are evolved first, then the node
    itself, then its parent bond is evolved backwards in time."""
    local_steps: List[int] = []

    def site_step(snode):
        ms, j = evolve_1site(snode, ttns, ttno, ttne, coeff, tau)
        snode.tensor = ms.reshape(snode.shape)
        local_steps.append(int(j))

    def bond_step_toward_parent(snode):
        r = ttns.decompose_to_parent(snode)
        ttne.build_children_environ_node(snode, ttns, ttno)
        r_t, j = evolve_0site(r.T, snode, ttns, ttno, ttne, coeff, -tau)
        ttns.merge_to_parent(snode, r_t.reshape(r.T.shape).T)
        local_steps.append(int(j))

    # (node, number of children already fully processed)
    agenda: List[Tuple[TreeNodeTensor, int]] = [(ttns.root, 0)]
    while agenda:
        snode, done = agenda.pop()
        if done < len(snode.children):
            # canonical center moves into the next child; revisit later
            agenda.append((snode, done + 1))
            ttns.push_cano_to_child(snode, done)
            ttne.build_parent_environ_node(snode, done, ttns, ttno)
            agenda.append((snode.children[done], 0))
            continue
        site_step(snode)
        if snode.parent is not None:
            bond_step_toward_parent(snode)
    return local_steps


def _tdvp_ps_backward(ttns, ttno, ttne, coeff, tau) -> List[int]:
    """Preorder walk mirroring :func:`_tdvp_ps_forward`: the node is evolved
    on first visit, then each child bond is evolved backwards before its
    subtree."""
    local_steps: List[int] = []
    agenda: List[Tuple[TreeNodeTensor, int]] = [(ttns.root, 0)]
    while agenda:
        snode, done = agenda.pop()
        if done == 0:
            ms, j = evolve_1site(snode, ttns, ttno, ttne, coeff, tau)
            snode.tensor = ms.reshape(snode.shape)
            local_steps.append(int(j))
        if done == len(snode.children):
            if snode is not ttns.root:
                ttns.push_cano_to_parent(snode)
                ttne.build_children_environ_node(snode, ttns, ttno)
            continue
        agenda.append((snode, done + 1))
        child = snode.children[done]
        r = ttns.decompose_to_child(snode, done)
        ttne.build_parent_environ_node(snode, done, ttns, ttno)
        r2, j = evolve_0site(r, child, ttns, ttno, ttne, coeff, -tau)
        ttns.merge_to_child(snode, done, r2.reshape(r.shape))
        local_steps.append(int(j))
        agenda.append((child, 0))
    return local_steps


def evolve_tdvp_ps2(ttns: TTNS, ttno: TTNO, coeff, tau: float):
    """Second-order two-site projector splitting
    (reference ``tn/time_evolution.py:177-259``)."""
    ttns.check_canonical()
    ttne = TTNEnviron(ttns, ttno)
    _tdvp_ps2_recursion_forward(ttns.root, ttns, ttno, ttne, coeff, tau / 2)
    _tdvp_ps2_recursion_backward(ttns.root, ttns, ttno, ttne, coeff, tau / 2)
    return ttns


def _tdvp_ps2_recursion_forward(snode, ttns, ttno, ttne, coeff, tau) -> List[int]:
    """Evolve all of snode's children bonds (canonical center at snode on
    entry and exit)."""
    assert snode.children
    local_steps: List[int] = []
    for ichild, child in enumerate(snode.children):
        if child.children:
            ttns.push_cano_to_child(snode, ichild)
            ttne.update_1bond(child, ttns, ttno)
            local_steps.extend(
                _tdvp_ps2_recursion_forward(child, ttns, ttno, ttne, coeff, tau)
            )
        ms2, j = evolve_2site(child, ttns, ttno, ttne, coeff, tau)
        local_steps.append(int(j))
        ttns.update_2site(child, ms2.reshape(-1), cano_parent=True)
        ttne.update_2site(child, ttns, ttno)
        if snode is ttns.root and ichild == len(snode.children) - 1:
            continue
        ms, j = evolve_1site(snode, ttns, ttno, ttne, coeff, -tau)
        snode.tensor = ms.reshape(snode.shape)
        local_steps.append(int(j))
        ttne.update_1site(snode, ttns, ttno)
    return local_steps


def _tdvp_ps2_recursion_backward(snode, ttns, ttno, ttne, coeff, tau) -> List[int]:
    assert snode.children
    local_steps: List[int] = []
    for ichild, child in reversed(list(enumerate(snode.children))):
        if not (snode is ttns.root and ichild == len(snode.children) - 1):
            ms, j = evolve_1site(snode, ttns, ttno, ttne, coeff, -tau)
            snode.tensor = ms.reshape(snode.shape)
            local_steps.append(int(j))
            ttne.update_1site(snode, ttns, ttno)
        ms2, j = evolve_2site(child, ttns, ttno, ttne, coeff, tau)
        local_steps.append(int(j))
        ttns.update_2site(child, ms2.reshape(-1), cano_parent=not child.children)
        ttne.update_2site(child, ttns, ttno)
        if child.children:
            local_steps.extend(
                _tdvp_ps2_recursion_backward(child, ttns, ttno, ttne, coeff, tau)
            )
            ttns.push_cano_to_parent(child)
            ttne.update_1bond(child, ttns, ttno)
    return local_steps


EVOLVE_METHODS[EvolveMethod.tdvp_vmf] = evolve_tdvp_vmf
EVOLVE_METHODS[EvolveMethod.prop_and_compress_tdrk4] = evolve_prop_and_compress_tdrk4
EVOLVE_METHODS[EvolveMethod.tdvp_ps] = evolve_tdvp_ps
EVOLVE_METHODS[EvolveMethod.tdvp_ps2] = evolve_tdvp_ps2
