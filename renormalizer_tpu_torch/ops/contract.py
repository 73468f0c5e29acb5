r"""Tensor contractions of the MPS and tree engines, in torch.

Port of ``renormalizer_tpu/ops/contract.py``.  The JAX package hands each
einsum to XLA; here :func:`einsum` contracts pairwise in an order chosen
once per (formula, shapes): by an exhaustive search over pairwise orders up
to :data:`EXACT_MAX` operands (every MPS formula, the binary tree's 2-site
hop), and above it greedily, cheapest pair first (the 2-site hop of
``t3ns``/``ternary_mctdh`` trees has 8-9 operands, ``todense`` of a tree one
per node, and the exhaustive search grows as 3^n).  Each pairwise step is a
``torch.einsum`` of two operands, i.e. a batched matmul; a label repeated
inside one operand takes that operand's diagonal, as in ``torch.einsum`` of
the whole formula.  These are plain large products that the JAX package ran
outside any Pallas kernel.  :func:`einsum_interleaved` takes hashable labels
(the tree engine's) instead of letters.
"""

import string
from typing import Dict, Tuple

import torch

# ``(formula, shapes) -> plan``: the pairwise steps ``(slot_a, slot_b,
# two-operand formula)`` and the final transpose formula (or None).  Plans
# are small plain data, one per distinct shape.
_PLANS: Dict[Tuple, Tuple] = {}

# operand counts up to which the pairwise order is searched exhaustively
EXACT_MAX = 8


def _parse(formula: str):
    ins, out = formula.replace(" ", "").split("->")
    return ins.split(","), out


def _flops(letters, sizes) -> int:
    flops = 1
    for c in letters:
        flops *= sizes[c]
    return flops


def _best_tree(terms, out: str, sizes: Dict[str, int]):
    """Cheapest pairwise contraction tree (by multiply-adds), found by
    dynamic programming over operand subsets.  A tree is an operand index
    or a pair of trees."""
    n = len(terms)
    full = (1 << n) - 1
    inside = [frozenset()] * (1 << n)
    for mask in range(1, 1 << n):
        low = mask & -mask
        inside[mask] = inside[mask ^ low] | set(terms[low.bit_length() - 1])
    # the labels an intermediate of the operands in ``mask`` keeps
    kept = [inside[m] & (inside[full ^ m] | set(out)) for m in range(1 << n)]

    best = {1 << i: (0, i) for i in range(n)}
    for mask in sorted(range(1, 1 << n), key=lambda m: bin(m).count("1")):
        if mask in best:
            continue
        cand = None
        sub = (mask - 1) & mask
        while sub:
            other = mask ^ sub
            if sub < other:  # each split once
                cost = (best[sub][0] + best[other][0]
                        + _flops(kept[sub] | kept[other], sizes))
                if cand is None or cost < cand[0]:
                    cand = (cost, (best[sub][1], best[other][1]))
            sub = (sub - 1) & mask
        best[mask] = cand
    return best[full][1]


def _greedy_tree(terms, out: str, sizes: Dict[str, int]):
    """Pairwise contraction tree built greedily: at each step the pair whose
    contraction costs the fewest multiply-adds (ties: the smaller result).
    For operand counts past :data:`EXACT_MAX`."""
    active = [(i, set(t)) for i, t in enumerate(terms)]
    while len(active) > 1:
        pick = None
        for a in range(len(active)):
            for b in range(a + 1, len(active)):
                outside = set(out).union(*(active[k][1] for k in range(len(active))
                                           if k not in (a, b)))
                union = active[a][1] | active[b][1]
                key = (_flops(union, sizes), _flops(union & outside, sizes))
                if pick is None or key < pick[0]:
                    pick = (key, a, b, union & outside)
        _, a, b, letters = pick
        node = (active[a][0], active[b][0])
        active = [x for k, x in enumerate(active) if k not in (a, b)]
        active.append((node, letters))
    return active[0][0]


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

    search = _best_tree if len(terms) <= EXACT_MAX else _greedy_tree
    root, _ = emit(search(terms, out, sizes))
    plan = (tuple(steps), None if slots[root] == out else f"{slots[root]}->{out}")
    _PLANS[key] = plan
    return plan


def einsum(formula: str, *arrays: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` contracted pairwise along a cached optimal order.
    Operands of mixed dtype are promoted to a common one first.  The
    evolution converts its MPO and environments to the state's dtype once,
    so its hot loops arrive here already unified and ``Tensor.to`` returns
    its argument; the correction vector's double-precision environments
    meet single-precision site tensors here and promote them."""
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


# --- interleaved einsum over hashable index labels ------------------------
# the tree engine names an index by a (tree, parent-dofs, child-dofs) tuple
# rather than by a letter

_LETTERS = string.ascii_letters


def label_formula(index_lists, out_indices) -> str:
    """The einsum formula of operands labeled by ``index_lists`` with the
    output ``out_indices``: each distinct label becomes one of the 52
    letters ``a-zA-Z`` that ``torch.einsum`` accepts, in order of first
    appearance."""
    label_map = {}

    def to_letters(labels):
        out = []
        for lab in labels:
            if lab not in label_map:
                if len(label_map) == len(_LETTERS):
                    raise ValueError(
                        f"einsum over more than {len(_LETTERS)} distinct labels: "
                        "torch.einsum accepts only the letters a-zA-Z")
                label_map[lab] = _LETTERS[len(label_map)]
            out.append(label_map[lab])
        return "".join(out)

    lhs = ",".join(to_letters(labels) for labels in index_lists)
    return lhs + "->" + to_letters(out_indices)


def interleaved_formula(*args):
    """Map ``(t0, idx0, t1, idx1, ..., out_idx)`` label lists to a standard
    einsum ``(formula, tensors)`` pair without contracting."""
    assert len(args) % 2 == 1
    *pairs, out_indices = args
    return label_formula(pairs[1::2], out_indices), list(pairs[0::2])


def einsum_interleaved(*args):
    """``einsum_interleaved(t0, idx0, t1, idx1, ..., out_idx)`` where each
    ``idx`` is a sequence of hashable labels: :func:`einsum` of the letter
    formula :func:`label_formula` makes of them."""
    formula, tensors = interleaved_formula(*args)
    return einsum(formula, *tensors)


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


def contract_one_site_multi_mpo(environ, ms, mos, domain, ms_conj=None):
    """Environment update with a list of stacked MPOs, the environment
    carrying one leg per MPO (reference ``mps/lib.py:121-166``); used with
    ``[mpo, mpo]`` for the (H - w)^2 targeting of ``optimize_mps``."""
    if ms_conj is None:
        ms_conj = ms.conj()
    dtype = ms.dtype
    for t in (environ, ms_conj, *mos):
        dtype = torch.promote_types(dtype, t.dtype)
    environ, ms, ms_conj = environ.to(dtype), ms.to(dtype), ms_conj.to(dtype)
    mos = [mo.to(dtype) for mo in mos]
    if ms.ndim == 4:
        ms_conj = ms_conj.permute(0, 2, 1, 3)
    elif ms.ndim != 3:
        raise ValueError(f"MPS ndim is not 3 or 4, got {ms.ndim}")
    if domain == "L":
        out = torch.tensordot(environ, ms_conj, dims=([0], [0]))
        for mo in mos:
            out = torch.tensordot(out, mo, dims=([0, out.ndim - 2], [0, 1]))
        if ms.ndim == 3:
            return torch.tensordot(out, ms, dims=([0, out.ndim - 2], [0, 1]))
        return torch.tensordot(out, ms, dims=([0, 1, out.ndim - 2], [0, 2, 1]))
    out = torch.tensordot(environ, ms_conj, dims=([0], [ms_conj.ndim - 1]))
    for mo in mos:
        out = torch.tensordot(out, mo, dims=([0, out.ndim - 1], [3, 1]))
    if ms.ndim == 3:
        return torch.tensordot(out, ms, dims=([0, out.ndim - 1], [2, 1]))
    return torch.tensordot(out, ms, dims=([0, 2, out.ndim - 1], [3, 2, 1]))


# --- effective-Hamiltonian matvecs ---------------------------------------
# hop(c) = L . W[...] . R . c, the hot loop of DMRG
# (reference ``mps/hop_expr.py:7-117``); formulas keyed by
# (nsite, ancilla, twolayer).  The two-layer entries apply (H - w)^2 with
# 4-leg environments: the omega-targeted DMRG and the correction vector.

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


def hop_spec(ltensor, rtensor, cmo, cshape, twolayer: bool = False):
    """Return ``(formula, operands)`` such that
    ``einsum(formula, *operands, c) == H_eff @ c``; with ``twolayer`` the
    operator is the square of the one-layer one, each MPO tensor appearing
    twice (4-leg environments from ``Environ(mps, [mpo, mpo])``)."""
    nsite = len(cmo)
    ancilla = 2 * nsite + 2 == len(cshape)
    if twolayer:
        assert nsite in (1, 2) and not ancilla
        formula, _ = _HOP_FORMULAS[(nsite, False, True)]
        if nsite == 1:
            return formula, (ltensor, cmo[0], cmo[0], rtensor)
        return formula, (ltensor, cmo[0], cmo[0], cmo[1], cmo[1], rtensor)
    formula, _ = _HOP_FORMULAS[(nsite, ancilla if nsite else False, False)]
    return formula, (ltensor, *cmo, rtensor)


def hop_expr(ltensor, rtensor, cmo, cshape, twolayer: bool = False):
    """The effective-H matvec closure for the given environments and
    center-site MPO tensors.  ``cshape`` disambiguates the ancilla case."""
    formula, operands = hop_spec(ltensor, rtensor, cmo, cshape, twolayer)
    return lambda c: einsum(formula, *operands, c)


# --- effective-H diagonals for preconditioning ----------------------------

def hop_diag(ltensor, rtensor, cmo, twolayer: bool = False):
    """Diagonal of the effective Hamiltonian
    (reference ``mps/gs.py:422-469``)."""
    if twolayer:
        if len(cmo) == 1:
            return einsum("abca,bdef,cedg,hfgh->adh",
                          ltensor, cmo[0], cmo[0], rtensor)
        return einsum("abca,bdef,cedg,fhij,gihk,ljkl->adhl",
                      ltensor, cmo[0], cmo[0], cmo[1], cmo[1], rtensor)
    ldiag = torch.einsum("aba->ba", ltensor)
    rdiag = torch.einsum("aba->ba", rtensor)
    cdiags = [torch.einsum("abbc->abc", m) for m in cmo]
    if len(cmo) == 1:
        return einsum("ba,bcg,gf->acf", ldiag, cdiags[0], rdiag)
    return einsum("ba,bce,edg,gf->acdf", ldiag, cdiags[0], cdiags[1], rdiag)


def hop_dense(ltensor, rtensor, cmo, twolayer: bool = False):
    """Materialize the dense effective Hamiltonian (for small local problems,
    reference ``mps/gs.py:307-369``)."""
    if twolayer:
        if len(cmo) == 1:
            return einsum("abcd,befg,cfhi,jgik->aejdhk",
                          ltensor, cmo[0], cmo[0], rtensor)
        return einsum("abcd,befg,cfhi,gjkl,ikmn,olnp->aejodhmp",
                      ltensor, cmo[0], cmo[0], cmo[1], cmo[1], rtensor)
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
