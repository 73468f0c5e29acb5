from renormalizer_tpu_torch.lib.solvers import davidson, davidson_multiroot, expm_krylov, solve_ivp
from renormalizer_tpu_torch.lib.bipartite import bipartite_vertex_cover, max_bipartite_matching
