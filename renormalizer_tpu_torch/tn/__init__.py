from renormalizer_tpu_torch.tn.node import TreeNodeBasis, TreeNodeTensor, copy_connection
from renormalizer_tpu_torch.tn.treebase import BasisTree, Tree
from renormalizer_tpu_torch.tn.tree import TTNO, TTNS, TTNEnviron, TTNBase, from_mps
from renormalizer_tpu_torch.tn.gs import optimize_ttns
# registers the evolution methods
from renormalizer_tpu_torch.tn.time_evolution import EVOLVE_METHODS
from renormalizer_tpu_torch.tn.utils_eph import max_entangled_ex
