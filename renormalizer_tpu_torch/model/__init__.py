from renormalizer_tpu_torch.model.op import Op, OpSum
from renormalizer_tpu_torch.model.basis import (
    BasisSet,
    BasisSHO,
    BasisMultiElectronVac,
    BasisSimpleElectron,
    BasisHalfSpin,
)
from renormalizer_tpu_torch.model.phonon import Phonon
from renormalizer_tpu_torch.model.mol import Mol
from renormalizer_tpu_torch.model.model import (
    Model,
    HolsteinModel,
    SpinBosonModel,
    construct_j_matrix,
)
