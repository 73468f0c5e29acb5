r"""Bond-tensor-parallel effective-Hamiltonian application.

Port of ``renormalizer_tpu/parallel/hop.py``.  The hop einsum
(``ops.contract._HOP_FORMULAS``) contracts ``L, W..., R, x -> out``.  ``L``
is cut along its uncontracted (bra) bond into one slice per row of the
mesh's ``i`` axis, ``R`` along its bra bond into one slice per column of
``j``; the MPO cores and ``x`` are replicated.  Block ``(a, b)`` of ``H @ x``
is the port's planned :func:`ops.contract.einsum` of L's slice ``a`` and R's
slice ``b`` on ``mesh.devices[0, a, b]``, with no communication.  The blocks
then come home to the caller's device and are assembled along the output's
``i`` axis, then its ``j`` axis: the counterpart of the JAX package's two
tiled ``all_gather`` (one per mesh axis a matvec).  FLOPs per device scale
as 1 / (ni nj).  The JAX package replicates the ``data`` axis; the port
uses data row 0.

The operands are cut and placed once per solve (:meth:`ShardedHop.bind`),
not once per matvec.  Indivisible shapes return ``None`` (the caller runs
the unsharded einsum) and count as ``fallback``.

There is no HLO to read, so the JAX package's ``hlo_collective_inventory``
has no counterpart: the port counts the gathers it runs (:data:`GATHERS`),
each with the bytes of its gathered result, as XLA reports an
``all-gather``'s result shape.  The factories themselves count the solves
that engaged and those that fell back (:data:`STATS`), so the JAX package's
``record_engagement`` (a second divisibility check beside the factory's)
and its engaged-executable registry have no counterpart, and
:func:`audit_engaged_collectives` reads :data:`GATHERS` instead of
replaying each engaged hop.
"""

from functools import lru_cache

import torch

from renormalizer_tpu_torch.ops.contract import einsum

# Per-process counters: how many effective-H solves the factories sharded
# and how many fell back to the unsharded einsum (divisibility gate).
STATS = {"sharded": 0, "fallback": 0}

# Every gather the sharded hops ran (one per mesh axis of size > 1 a
# matvec, ``bytes`` summing the gathered results) and the matvecs that ran
# them.
GATHERS = {"count": 0, "bytes": 0, "matvecs": 0}


def reset_stats():
    STATS.update(sharded=0, fallback=0)
    GATHERS.update(count=0, bytes=0, matvecs=0)


def _ij(mesh):
    axes = mesh.shape
    return axes.get("i", 1), axes.get("j", 1)


def _counted(hop):
    STATS["fallback" if hop is None else "sharded"] += 1
    return hop


@lru_cache(maxsize=None)
def _parse_shard_axes(formula: str):
    """Positions of the shardable bra-bond axes: (L axis, R axis, their
    positions in the output subscript)."""
    ins, out = formula.split("->")
    terms = ins.split(",")
    lterm, rterm = terms[0], terms[-2]
    l_lab = next((c for c in lterm if c in out), None)
    r_lab = next((c for c in rterm if c in out and c != l_lab), None)
    if l_lab is None or r_lab is None:
        return None
    return (
        len(terms),
        lterm.index(l_lab),
        rterm.index(r_lab),
        out.index(l_lab),
        out.index(r_lab),
        len(out),
    )


@lru_cache(maxsize=None)
def _parse_shard_axes_general(formula: str, operand_shapes, ni: int, nj: int):
    """Two distinct operands whose free (output) axes can carry the ``i``
    and ``j`` mesh axes of an arbitrary hop einsum.

    An output label owned by exactly one input term is a free bra axis of
    that term: slicing the term along it slices the output along the same
    label with every other operand replicated.  This covers the MPS L/R case
    and the tree hops, whose bra bonds live on child and parent
    environments.  Returns ``((term_a, ax_a, out_a), (term_b, ax_b,
    out_b))`` or ``None``."""
    ins, out = formula.split("->")
    terms = ins.split(",")
    owner = {}
    for t_idx, term in enumerate(terms):
        for c in set(term):
            owner[c] = -1 if c in owner else t_idx
    # the last term is the local (ket) tensor x: its axes are not bra bonds
    cands = [
        (owner[c], terms[owner[c]].index(c), out.index(c))
        for c in out
        if owner.get(c, -1) not in (-1, len(terms) - 1)
    ]
    for a in cands:
        if operand_shapes[a[0]][a[1]] % ni != 0:
            continue
        for b in cands:
            if b[0] == a[0]:
                continue
            if operand_shapes[b[0]][b[1]] % nj == 0:
                return a, b
    return None


class ShardedHop:
    """``H @ x`` over the mesh: operand ``split_i[0]`` cut along its axis
    ``split_i[1]`` over ``i`` (output axis ``split_i[2]``), operand
    ``split_j[0]`` likewise over ``j``, every other operand replicated.

    ``hop(*operands, x)`` returns the flat product, as the JAX package's
    ``shard_map`` does; :meth:`bind` places the operands once and returns
    the matvec of a solve."""

    def __init__(self, mesh, formula: str, cshape, split_i, split_j):
        self.mesh = mesh
        self.formula = formula
        self.cshape = tuple(cshape)
        self.split_i = split_i
        self.split_j = split_j

    def place(self, *operands):
        """The operands of every block ``(a, b)`` on its device, as a
        ``[a][b] -> (device, operands)`` table.  A replicated operand is
        copied once per distinct device."""
        ni, nj = _ij(self.mesh)
        ti, ai, _ = self.split_i
        tj, aj, _ = self.split_j
        slices_i = operands[ti].tensor_split(ni, dim=ai)
        slices_j = operands[tj].tensor_split(nj, dim=aj)
        copies = {}

        def on(dev, key, t):
            if (dev, key) not in copies:
                copies[(dev, key)] = t.to(dev)
            return copies[(dev, key)]

        table = []
        for a in range(ni):
            row = []
            for b in range(nj):
                dev = self.mesh.devices[0, a, b]
                ops = []
                for k, t in enumerate(operands):
                    if k == ti:
                        ops.append(on(dev, ("i", a), slices_i[a]))
                    elif k == tj:
                        ops.append(on(dev, ("j", b), slices_j[b]))
                    else:
                        ops.append(on(dev, k, t))
                row.append((dev, ops))
            table.append(row)
        return table

    def bind(self, *operands):
        """The matvec ``x -> H @ x`` (flat) of one solve, its operands
        placed once."""
        table = self.place(*operands)
        return lambda x: self._apply(table, x)

    def __call__(self, *args):
        *operands, x = args
        return self.bind(*operands)(x)

    def _apply(self, table, x):
        home = x.device
        c = x.reshape(self.cshape)
        xs = {}
        blocks = []
        for row in table:
            out_row = []
            for dev, ops in row:
                if dev not in xs:
                    xs[dev] = c.to(dev)
                out_row.append(einsum(self.formula, *ops, xs[dev]))
            blocks.append(out_row)
        ni, nj = len(table), len(table[0])
        oi, oj = self.split_i[2], self.split_j[2]
        # gather over i (along the output's i axis), then over j
        cols = [torch.cat([blocks[a][b].to(home) for a in range(ni)], dim=oi)
                for b in range(nj)]
        out = torch.cat(cols, dim=oj)
        GATHERS["matvecs"] += 1
        for size, gathered in ((ni, cols[0]), (nj, out)):
            if size > 1:
                GATHERS["count"] += 1
                GATHERS["bytes"] += gathered.numel() * gathered.element_size()
        return out.reshape(-1)


def _mps_hop(mesh, formula, operand_shapes, cshape):
    ni, nj = _ij(mesh)
    parsed = _parse_shard_axes(formula) if ni * nj > 1 else None
    if parsed is None:
        return None
    _, l_ax, r_ax, out_l, out_r, _ = parsed
    lshape, rshape = operand_shapes[0], operand_shapes[-1]
    if lshape[l_ax] % ni != 0 or rshape[r_ax] % nj != 0:
        return None
    return ShardedHop(mesh, formula, cshape, (0, l_ax, out_l),
                      (len(operand_shapes) - 1, r_ax, out_r))


def sharded_hop_factory(mesh, formula: str, operand_shapes, cshape):
    """A sharded ``hop(operands..., x) -> H@x`` (:class:`ShardedHop`) or
    ``None`` if the formula or shapes cannot be distributed over ``mesh``;
    counted in :data:`STATS` as ``sharded`` or ``fallback``."""
    return _counted(None if mesh is None
                    else _mps_hop(mesh, formula, operand_shapes, cshape))


def _general_hop(mesh, formula, operand_shapes, cshape):
    ni, nj = _ij(mesh)
    if ni * nj == 1:
        return None
    parsed = _parse_shard_axes_general(formula, tuple(map(tuple, operand_shapes)),
                                       ni, nj)
    return None if parsed is None else ShardedHop(mesh, formula, cshape, *parsed)


def sharded_general_hop_factory(mesh, formula: str, operand_shapes, cshape):
    """Like :func:`sharded_hop_factory` for an arbitrary effective-H einsum
    (tree tensor networks): the two divisible free bra axes that
    :func:`_parse_shard_axes_general` finds carry ``i`` and ``j``."""
    return _counted(None if mesh is None
                    else _general_hop(mesh, formula, operand_shapes, cshape))


def collective_inventory(fn, *example_args) -> dict:
    """The gathers one call of the sharded hop ``fn`` on ``example_args``
    runs: ``{"all-gather": {"count", "bytes"}}``.  It runs the call and
    counts (the JAX package compiles it and reads the HLO); the run's own
    :data:`GATHERS` tally is left as it was."""
    before = dict(GATHERS)
    try:
        fn(*example_args)
        count = GATHERS["count"] - before["count"]
        nbytes = GATHERS["bytes"] - before["bytes"]
    finally:
        GATHERS.update(before)
    return {"all-gather": {"count": count, "bytes": nbytes}} if count else {}


def audit_engaged_collectives(n_sweeps: int = 1) -> dict:
    """The gathers the sharded hops ran since :func:`reset_stats`
    (:data:`GATHERS`), per matvec and per sweep of ``n_sweeps``:
    ``{"matvecs", "per_matvec", "per_sweep"}``, each per-entry
    ``{"all-gather": {"count", "bytes"}}`` (empty when nothing gathered)."""
    count, nbytes, matvecs = GATHERS["count"], GATHERS["bytes"], GATHERS["matvecs"]

    def per(n):
        if not count:
            return {}
        return {"all-gather": {"count": count / n, "bytes": nbytes / n}}

    return {"matvecs": matvecs, "per_matvec": per(matvecs) if matvecs else {},
            "per_sweep": per(n_sweeps)}
