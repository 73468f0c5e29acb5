from renormalizer_tpu_torch.mps.mps import Mps, BraKetPair
from renormalizer_tpu_torch.mps.mpo import Mpo, StackedMpo
from renormalizer_tpu_torch.mps.mpdm import MpDm
from renormalizer_tpu_torch.mps.thermalprop import ThermalProp, load_thermal_state
from renormalizer_tpu_torch.mps.gs import DmrgFCISolver, optimize_mps
from renormalizer_tpu_torch.mps.lib import compressed_sum
from renormalizer_tpu_torch.mps.tda import TDA
