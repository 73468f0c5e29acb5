from renormalizer_tpu_torch.model.op import Op, OpSum
from renormalizer_tpu_torch.model.basis import (
    BasisSet,
    BasisSHO,
    BasisHopsBoson,
    BasisSineDVR,
    BasisMultiElectron,
    BasisMultiElectronVac,
    BasisSimpleElectron,
    BasisHalfSpin,
    BasisDummy,
)
from renormalizer_tpu_torch.model.phonon import Phonon
from renormalizer_tpu_torch.model.mol import Mol
from renormalizer_tpu_torch.model.model import (
    Model,
    HolsteinModel,
    SpinBosonModel,
    TI1DModel,
    construct_j_matrix,
    load_from_dict,
    heisenberg_ops,
)
from renormalizer_tpu_torch.model import h_qc
