"""Tree tensor networks, their operators and contractions, in double precision.

A network is a list of nodes, each a dict with ``tensor`` (legs: one per
child in ``children`` order, one physical leg, the parent bond last; the
root's parent bond has size 1), ``children`` (node indices) and ``label``
(the site's label in the Hamiltonian's terms).  A matrix product state is
the chain whose node i has the child i - 1 and whose root is the last site.

The operator of a sum of product terms is built as a finite-state machine on
the tree's edges: an edge carries "identity" (no factor below it), "done" (a
whole term below it) or one channel per term that has factors on both sides
of it.  Each node's tensor has legs ``[child channels..., out, in, parent
channel]``.
"""

import string

import numpy as np
import torch

ID, DONE = "id", "done"


def _sym(letters, label):
    if label not in letters:
        letters[label] = string.ascii_letters[len(letters)]
    return letters[label]


def ct(a, la, b, lb, out):
    """``einsum`` of two labelled tensors; labels are any hashables."""
    letters = {}
    spec = (''.join(_sym(letters, x) for x in la) + ',' +
            ''.join(_sym(letters, x) for x in lb) + '->' +
            ''.join(_sym(letters, x) for x in out))
    return torch.einsum(spec, a, b)


def postorder(nodes, root):
    order, stack = [], [(root, False)]
    while stack:
        n, done = stack.pop()
        if done:
            order.append(n)
            continue
        stack.append((n, True))
        stack.extend((c, False) for c in reversed(nodes[n]["children"]))
    return order


def operator(nodes, root, terms, dtype, device):
    """The tree operator of ``terms`` (list of ``(coef, {label: matrix})``):
    one tensor per node, legs ``[child channels..., out, in, parent]``."""
    order = postorder(nodes, root)
    below = {}
    for n in order:
        s = {nodes[n]["label"]}
        for c in nodes[n]["children"]:
            s |= below[c]
        below[n] = s
    for _, factors in terms:
        missing = set(factors) - below[root]
        if missing:
            raise ValueError(f"term acts on labels {missing} outside the network")

    def channels(n):
        if n == root:
            return {DONE: 0}
        ch = {ID: 0, DONE: 1}
        for t, (_, factors) in enumerate(terms):
            inside = len(set(factors) & below[n])
            if 0 < inside < len(factors):
                ch[t] = len(ch)
        return ch

    chans = {n: channels(n) for n in order}
    ops = []
    for n in range(len(nodes)):
        node = nodes[n]
        kids = node["children"]
        d = node["tensor"].shape[len(kids)]
        eye = np.eye(d)
        w = np.zeros([len(chans[c]) for c in kids] + [d, d, len(chans[n])])

        def put(kid_ch, mat, parent_ch, coef=1.0):
            idx = tuple(chans[c][k] for c, k in zip(kids, kid_ch))
            w[idx + (slice(None), slice(None), chans[n][parent_ch])] += coef * mat

        if ID in chans[n]:
            put([ID] * len(kids), eye, ID)
        for j in range(len(kids)):
            put([DONE if i == j else ID for i in range(len(kids))], eye, DONE)
        for t, (coef, factors) in enumerate(terms):
            labels = set(factors)
            if not labels <= below[n] and not labels & below[n]:
                continue
            if any(labels <= below[c] for c in kids):
                continue  # finished below this node
            kid_ch = [t if labels & below[c] else ID for c in kids]
            mat = factors.get(node["label"], eye)
            if labels <= below[n]:
                put(kid_ch, mat, DONE, coef)
            else:
                put(kid_ch, mat, t)
        ops.append(torch.as_tensor(w, dtype=dtype, device=device))
    return ops


def envs_up(nodes, root, layers, bra=None):
    """Environments from the leaves up: for each node, the tensor with legs
    ``[bra parent, one channel per layer, ket parent]`` of its subtree.
    ``layers`` is a list of operators (0, 1 or 2 of them); ``bra`` another
    network on the same tree (default: the ket itself)."""
    bra = nodes if bra is None else bra
    envs = {}
    for n in postorder(nodes, root):
        t, lt = node_apply(nodes[n], [envs[c] for c in nodes[n]["children"]],
                           [ops[n] for ops in layers])
        kb = bra[n]["tensor"].conj()
        nk = len(nodes[n]["children"])
        lb = [("b", j) for j in range(nk)] + ["s", "bp"]
        out = ["bp"] + [("x", i, "p") for i in range(len(layers))] + ["kp"]
        envs[n] = ct(t, lt, kb, lb, out)
    return envs


def node_apply(node, child_envs, ws):
    """The node's ket tensor with its children's environments and its layers'
    operator tensors contracted in; legs ``[("b", j)..., ("x", i, "p")...,
    "s", "kp"]``."""
    nk = len(node["children"])
    nl = len(ws)
    t = node["tensor"]
    lt = [("k", j) for j in range(nk)] + ["s", "kp"]
    for j, e in enumerate(child_envs):
        le = [("b", j)] + [("x", i, j) for i in range(nl)] + [("k", j)]
        out = [x for x in lt if x != ("k", j)] + le[:-1]
        t, lt = ct(t, lt, e, le, out), out
    for i, w in enumerate(ws):
        lw = [("x", i, j) for j in range(nk)] + ["so", "s", ("x", i, "p")]
        out = [x for x in lt if x != "s" and x not in lw] + ["so", ("x", i, "p")]
        t = ct(t, lt, w, lw, out)
        lt = ["s" if x == "so" else x for x in out]
    order = [("b", j) for j in range(nk)] + [("x", i, "p") for i in range(nl)] + ["s", "kp"]
    return t.permute([lt.index(x) for x in order]), order


def scalar(envs, root):
    return envs[root].reshape(-1)[0]


def canonical_to_root(nodes, root):
    """A copy of the network in which every node but the root is an isometry
    from its children and physical leg onto its parent bond (QR, leaves
    first); the root then holds the whole state's weight."""
    nodes = [dict(n, tensor=n["tensor"].clone()) for n in nodes]
    parent = {c: p for p, n in enumerate(nodes) for c in n["children"]}
    for n in postorder(nodes, root):
        if n == root:
            continue
        t = nodes[n]["tensor"]
        q, r = torch.linalg.qr(t.reshape(-1, t.shape[-1]))
        nodes[n]["tensor"] = q.reshape(t.shape[:-1] + (q.shape[1],))
        p = parent[n]
        j = nodes[p]["children"].index(n)
        pt = torch.tensordot(r, nodes[p]["tensor"], dims=([1], [j]))
        nodes[p]["tensor"] = torch.movedim(pt, 0, j)
    return nodes
