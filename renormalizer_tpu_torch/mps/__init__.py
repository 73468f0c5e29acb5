from renormalizer_tpu_torch.mps.mps import Mps
from renormalizer_tpu_torch.mps.mpo import Mpo
from renormalizer_tpu_torch.mps.gs import optimize_mps
from renormalizer_tpu_torch.mps.lib import compressed_sum
