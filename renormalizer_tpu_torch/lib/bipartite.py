r"""Bipartite maximum matching and minimum vertex cover (Koenig's theorem).

Used by the symbolic MPO compiler's graph-decomposition algorithm
(reference ``renormalizer/lib/bipartite_matching/bipartite_matching.py:12-128``,
itself adapted from the public tryalgo library).  Host-side graph code.
"""

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching as _scipy_matching


def _augment_iterative(u0, bigraph, match):
    """Find an augmenting path from free vertex ``u0`` (Hungarian algorithm
    step), iteratively to avoid recursion limits."""
    # DFS over alternating paths
    visit = [False] * (max((max(adj, default=-1) for adj in bigraph), default=-1) + 1)

    def augment(u):
        for v in bigraph[u]:
            if not visit[v]:
                visit[v] = True
                if match[v] is None or augment(match[v]):
                    match[v] = u
                    return True
        return False

    return augment(u0)


def max_bipartite_matching(bigraph):
    """Maximum matching; ``bigraph[u]`` lists neighbors of u in V.
    Returns ``match`` with ``match[v] == u`` iff (u, v) is matched."""
    n_v = max((max(adj, default=-1) for adj in bigraph), default=-1) + 1
    match = [None] * n_v
    for u in range(len(bigraph)):
        _augment_iterative(u, bigraph, match)
    return match


# alias kept for API parity with the reference
max_bipartite_matching2 = max_bipartite_matching


def bipartite_vertex_cover(bigraph, algo="Hopcroft-Karp"):
    r"""Minimum vertex cover of a bipartite graph by Koenig's theorem.

    Parameters
    ----------
    bigraph : list of lists
        Adjacency: ``bigraph[u]`` is the neighbor list of u (in V).
    algo : str
        "Hopcroft-Karp" (scipy's matching) or "Hungarian" (pure python).

    Returns
    -------
    (coverU, coverV) : boolean lists marking the cover vertices.
    """
    if algo == "Hopcroft-Karp":
        coords = np.array(
            [(u, v) for u, adj in enumerate(bigraph) for v in adj]
        )
        graph = csr_matrix(
            (np.ones(coords.shape[0]), (coords[:, 0], coords[:, 1]))
        )
        match_v = _scipy_matching(graph, perm_type="row")
        match_v = [None if x == -1 else int(x) for x in match_v]
        n_u, n_v = graph.shape
    elif algo == "Hungarian":
        match_v = max_bipartite_matching(bigraph)
        n_u, n_v = len(bigraph), len(match_v)
    else:
        raise ValueError(f"unknown bipartite algo {algo}")

    matched_u = set(m for m in match_v if m is not None)

    # Koenig construction: alternating forest from free U vertices,
    # implemented with a worklist (no deep recursion).
    visit_u = [False] * n_u
    visit_v = [False] * n_v
    worklist = set(range(n_u)) - matched_u
    while worklist:
        u = worklist.pop()
        visit_u[u] = True
        for v in bigraph[u]:
            if not visit_v[v]:
                visit_v[v] = True
                # the matching is maximum, so v must be matched
                assert match_v[v] is not None
                worklist.add(match_v[v])
    cover_u = [not b for b in visit_u]
    return cover_u, visit_v
