"""The numbers that decide ``correct``, worked out from the program's outputs
with the reference's own Hamiltonian, in double precision.

* ``e_gap``: how far the energy the program reports lies from the energy of
  the state it returned, |E_reported - <psi|H|psi>/<psi|psi>| / |E|.
* ``sigma_rel`` (a chain): the state's energy spread,
  sqrt(<H^2> - <H>^2) / |E|; an eigenstate reads 0.
* ``resid_rel`` (a tree): the residual of the root's eigenproblem with every
  other node an isometry towards it, |H_root c - E c| / (|E| |c|); a state
  that no update of the root can lower reads 0.
* ``step_dist``: the distance |psi_ref - psi| / |psi_ref| between the state
  after the program's step and the reference's step from the same state.
* ``bond_short`` (every state): the configuration's bond dimension M less
  the largest bond of the returned state; a state cut below M reads more
  than 0.
* ``electrons_off`` (every state): |<N>/<psi|psi> - qntot|, the state's
  electron number against the configuration's; a state of another sector
  reads 1 or more.
"""

import math

import torch

from reference import holstein, network, tdvp


def _wide(t):
    return t.to(torch.complex128 if t.is_complex() else torch.float64)


def _nodes(state):
    return [dict(n, tensor=_wide(n["tensor"])) for n in state["nodes"]]


def _sector(config, nodes, root):
    """``bond_short`` and ``electrons_off`` of a network."""
    bonds = [n["tensor"].shape[-1] for i, n in enumerate(nodes) if i != root]
    t = nodes[root]["tensor"]
    n_op = network.operator(nodes, root, holstein.electron_number(config), t.dtype, t.device)
    norm = network.scalar(network.envs_up(nodes, root, []), root).real
    electrons = network.scalar(network.envs_up(nodes, root, [n_op]), root).real / norm
    return dict(bond_short=float(int(config["m"]) - max(bonds)),
                electrons_off=abs(float(electrons) - int(config["qntot"])))


def ground_state(config, state, e_reported):
    """``e_gap``, ``bond_short``, ``electrons_off`` and ``sigma_rel``
    (chains) or ``resid_rel`` (trees) of one returned state: ``config`` the
    configuration, ``state`` with ``nodes`` and ``root`` as in
    :mod:`reference.network`, ``kind`` "chain" or "tree"."""
    _, terms = holstein.chain(config)
    nodes, root = _nodes(state), state["root"]
    sector = _sector(config, nodes, root)
    h = network.operator(nodes, root, terms, nodes[root]["tensor"].dtype,
                         nodes[root]["tensor"].device)
    if state["kind"] == "chain":
        norm = network.scalar(network.envs_up(nodes, root, []), root).real
        e1 = network.scalar(network.envs_up(nodes, root, [h]), root).real / norm
        e2 = network.scalar(network.envs_up(nodes, root, [h, h]), root).real / norm
        energy = float(e1)
        spread = float(e2 - e1 * e1)
        return dict(sector, energy=energy, e_gap=abs(e_reported - energy) / abs(energy),
                    sigma_rel=math.sqrt(max(spread, 0.0)) / abs(energy))
    nodes = network.canonical_to_root(nodes, root)
    envs = network.envs_up(nodes, root, [h])
    kids = nodes[root]["children"]
    c = nodes[root]["tensor"]
    hc, _ = network.node_apply(nodes[root], [envs[k] for k in kids], [h[root]])
    hc = hc.reshape(c.shape)
    cc = torch.vdot(c.reshape(-1), c.reshape(-1)).real
    energy = float(torch.vdot(c.reshape(-1), hc.reshape(-1)).real / cc)
    resid = float(torch.linalg.vector_norm(hc - energy * c) / cc.sqrt())
    return dict(sector, energy=energy, e_gap=abs(e_reported - energy) / abs(energy),
                resid_rel=resid / abs(energy))


def tdvp_step(config, labels, before, after, dt, first_to_right):
    """``step_dist``, ``bond_short`` and ``electrons_off`` of one step:
    ``before``/``after`` the program's chain site tensors (l, d, r) around
    its step, ``labels`` its sites' labels."""
    sites, terms = holstein.chain(config)
    if [lab for lab, _ in sites] != list(labels):
        raise ValueError(f"the program's sites {labels} are not the chain's {sites}")
    start = [t.to(torch.complex128) for t in before]
    ops = tdvp.chain_operator(sites, terms, torch.complex128, start[0].device)
    ref = tdvp.step(start, ops, dt, first_to_right)
    got = [t.to(torch.complex128) for t in after]
    nref = tdvp.overlap(ref, ref).real
    ngot = tdvp.overlap(got, got).real
    cross = tdvp.overlap(ref, got).real
    dist2 = float(nref + ngot - 2 * cross)
    chain = [{"tensor": t.reshape(t.shape[1:]) if i == 0 else t,
              "children": [i - 1] if i else [], "label": lab}
             for i, (t, lab) in enumerate(zip(got, labels))]
    return dict(_sector(config, chain, len(chain) - 1),
                step_dist=math.sqrt(max(dist2, 0.0) / float(nref)))
