r"""Tensor contractions of the MPS engine, in torch.

Port of ``renormalizer_tpu/ops/contract.py``.  The JAX package hands each
einsum to XLA; here :func:`einsum` contracts pairwise in an order chosen
once per (formula, shapes) by an exhaustive search over pairwise orders
(the operand counts are at most seven), and each pairwise step is a
``torch.einsum`` of two operands, i.e. a batched matmul.  These are plain
large products that the JAX package ran outside any Pallas kernel.
"""

import itertools
from typing import Dict, Tuple

import torch

# ``(formula, shapes) -> plan``: the pairwise steps ``(slot_a, slot_b,
# two-operand formula)`` and the final transpose formula (or None).  Plans
# are small plain data, one per distinct shape.
_PLANS: Dict[Tuple, Tuple] = {}


def _parse(formula: str):
    ins, out = formula.replace(" ", "").split("->")
    return ins.split(","), out


def _best_tree(terms, out: str, sizes: Dict[str, int]):
    """Cheapest pairwise contraction tree (by multiply-adds), found by
    dynamic programming over operand subsets.  A tree is an operand index
    or a pair of trees."""
    n = len(terms)
    letters_of = [set(t) for t in terms]

    def kept(mask):
        inside = set().union(*(letters_of[i] for i in range(n) if mask >> i & 1))
        outside = set(out).union(
            *(letters_of[i] for i in range(n) if not mask >> i & 1))
        return inside & outside

    best = {1 << i: (0, i) for i in range(n)}
    for size in range(2, n + 1):
        for combo in itertools.combinations(range(n), size):
            mask = sum(1 << i for i in combo)
            cand = None
            sub = (mask - 1) & mask
            while sub:
                other = mask ^ sub
                if sub < other:  # each split once
                    flops = 1
                    for c in kept(sub) | kept(other):
                        flops *= sizes[c]
                    cost = best[sub][0] + best[other][0] + flops
                    if cand is None or cost < cand[0]:
                        cand = (cost, (best[sub][1], best[other][1]))
                sub = (sub - 1) & mask
            best[mask] = cand
    return best[(1 << n) - 1][1]


def _plan(formula: str, shapes) -> Tuple:
    key = (formula, shapes)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    terms, out = _parse(formula)
    sizes = {c: d for term, shape in zip(terms, shapes)
             for c, d in zip(term, shape)}
    slots = list(terms)  # index string of every operand and intermediate
    steps = []

    def emit(node):
        if isinstance(node, int):
            return node, {node}
        (a, leaves_a), (b, leaves_b) = emit(node[0]), emit(node[1])
        leaves = leaves_a | leaves_b
        outside = set(out).union(*(set(terms[i]) for i in range(len(terms))
                                   if i not in leaves))
        lo = "".join(c for c in dict.fromkeys(slots[a] + slots[b])
                     if c in outside)
        steps.append((a, b, f"{slots[a]},{slots[b]}->{lo}"))
        slots.append(lo)
        return len(slots) - 1, leaves

    root, _ = emit(_best_tree(terms, out, sizes))
    plan = (tuple(steps), None if slots[root] == out else f"{slots[root]}->{out}")
    _PLANS[key] = plan
    return plan


def einsum(formula: str, *arrays: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` contracted pairwise along a cached optimal order.
    Operands of mixed dtype are promoted to a common one first; this is a
    guard only: the evolution converts its MPO and environments to the
    state's dtype once, so the hot loops arrive here already unified and
    ``Tensor.to`` returns its argument."""
    dtype = arrays[0].dtype
    for a in arrays[1:]:
        if a.dtype != dtype:
            dtype = torch.promote_types(dtype, a.dtype)
    arrays = [a.to(dtype) for a in arrays]
    if len(arrays) <= 2:
        return torch.einsum(formula, *arrays)
    steps, final = _plan(formula, tuple(tuple(a.shape) for a in arrays))
    vals = arrays
    for a, b, sub in steps:
        vals.append(torch.einsum(sub, vals[a], vals[b]))
        vals[a] = vals[b] = None  # free intermediates early
    res = vals[-1]
    return res if final is None else torch.einsum(final, res)


# --- environment single-site updates ------------------------------------
# diagrams (reference ``mps/lib.py:169-250``):
#   L-domain:  S-a-S-f      R-domain:  -f-S-a-S
#                  d                       d
#              O-b-O-g                 -g-O-b-O
#                  e                       e
#              S-c-S-h                 -h-S-c-S

_ENV_FORMULAS = {
    # (domain, ms_ndim): formula over (environ, ms_conj, mo, ms)
    ("L", 3): "abc,adf,bdeg,ceh->fgh",
    ("L", 4): "abc,adlf,bdeg,celh->fgh",
    ("R", 3): "abc,fda,gdeb,hec->fgh",
    ("R", 4): "abc,fdla,gdeb,helc->fgh",
}


def contract_one_site(environ, ms, mo, domain, ms_conj=None):
    """Absorb one (mps, mpo, mps*) column into an environment tensor.
    4-dim ``ms`` (MpDm) traces the ancilla index."""
    formula = _ENV_FORMULAS[(domain, ms.ndim)]
    if ms_conj is None:
        ms_conj = ms.conj()
    return einsum(formula, environ, ms_conj, mo, ms)


# --- effective-Hamiltonian matvecs ---------------------------------------
# hop(c) = L . W[...] . R . c, the hot loop of DMRG
# (reference ``mps/hop_expr.py:7-117``); formulas keyed by
# (nsite, ancilla, twolayer).  The two-layer (H-w)^2 entries mirror the JAX
# package's table; the port's DMRG does not use them yet.

_HOP_FORMULAS = {
    # zero site: S-a l-S / O-b b-O / S-c k-S
    (0, False, False): ("abc,lbk,ck->al", 2),
    # one site
    (1, False, False): ("abc,bdef,lfk,cek->adl", 3),
    (1, True, False): ("abc,bdef,lfk,cegk->adgl", 3),
    # two site
    (2, False, False): ("abc,bdef,fghj,ljk,cehk->adgl", 4),
    (2, True, False): ("abc,bdef,fghj,ljk,cemhnk->admgnl", 4),
    # two-layer (H-w)^2 variants used by interior-eigenvalue DMRG and CV
    (1, False, True): ("abcd,befg,cfhi,jgik,aej->dhk", 4),
    (2, False, True): ("abcd,befg,cfhi,gjkl,ikmn,olnp,aejo->dhmp", 6),
}


def hop_spec(ltensor, rtensor, cmo, cshape):
    """Return ``(formula, operands)`` such that
    ``einsum(formula, *operands, c) == H_eff @ c``."""
    nsite = len(cmo)
    ancilla = 2 * nsite + 2 == len(cshape)
    formula, _ = _HOP_FORMULAS[(nsite, ancilla if nsite else False, False)]
    return formula, (ltensor, *cmo, rtensor)


def hop_expr(ltensor, rtensor, cmo, cshape):
    """The effective-H matvec closure for the given environments and
    center-site MPO tensors.  ``cshape`` disambiguates the ancilla case."""
    formula, operands = hop_spec(ltensor, rtensor, cmo, cshape)
    return lambda c: einsum(formula, *operands, c)


# --- effective-H diagonals for preconditioning ----------------------------

def hop_diag(ltensor, rtensor, cmo):
    """Diagonal of the effective Hamiltonian
    (reference ``mps/gs.py:422-469``)."""
    ldiag = torch.einsum("aba->ba", ltensor)
    rdiag = torch.einsum("aba->ba", rtensor)
    cdiags = [torch.einsum("abbc->abc", m) for m in cmo]
    if len(cmo) == 1:
        return einsum("ba,bcg,gf->acf", ldiag, cdiags[0], rdiag)
    return einsum("ba,bce,edg,gf->acdf", ldiag, cdiags[0], cdiags[1], rdiag)


def hop_dense(ltensor, rtensor, cmo):
    """Materialize the dense effective Hamiltonian (for small local problems,
    reference ``mps/gs.py:307-369``)."""
    if len(cmo) == 1:
        return einsum("abc,bdef,lfk->adlcek", ltensor, cmo[0], rtensor)
    return einsum("abc,bdef,fghj,ljk->adglcehk", ltensor, cmo[0], cmo[1], rtensor)


# --- transfer-matrix chain ------------------------------------------------

def chain_overlap_device(mts1, mts2, conj_first: bool = False) -> torch.Tensor:
    """``<mts1 (conj) | mts2>`` as a 0-d device tensor (no host fetch)."""
    assert len(mts1) == len(mts2) and len({t.ndim for t in mts1}) == 1
    contract = {3: "abc,abd->dc", 4: "abcd,abce->ed"}[mts1[0].ndim]
    dtype = torch.promote_types(mts1[0].dtype, mts2[0].dtype)
    e0 = torch.ones((1, 1), dtype=dtype, device=mts1[0].device)
    for mt1, mt2 in zip(mts1, mts2):
        e0 = torch.tensordot(e0, mt2.to(dtype), dims=1)
        mt1 = mt1.conj() if conj_first else mt1
        e0 = torch.einsum(contract, e0, mt1.to(dtype))
    return e0[0, 0]


def chain_overlap(mts1, mts2, conj_first: bool = False) -> complex:
    """``sum_i <mts1_i (conj) | mts2_i>`` transfer-matrix chain, fetched."""
    return complex(chain_overlap_device(mts1, mts2, conj_first).item())


def normalize_chain_device(mts, qnidx: int) -> torch.Tensor:
    """The canonical-center tensor scaled to a unit-norm state, with the
    norm kept on the device."""
    norm2 = chain_overlap_device(mts, mts, conj_first=True).real
    tiny = torch.finfo(norm2.dtype).tiny
    return mts[qnidx] * torch.rsqrt(torch.clamp(norm2, min=tiny))


def tensordot1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over one axis (the bond-merge workhorse)."""
    if a.dtype != b.dtype:
        dtype = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dtype), b.to(dtype)
    return torch.tensordot(a, b, dims=1)
