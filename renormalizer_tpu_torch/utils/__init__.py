from renormalizer_tpu_torch.utils import constant
from renormalizer_tpu_torch.utils.quantity import Quantity
from renormalizer_tpu_torch.utils.configs import (
    CompressConfig,
    CompressCriteria,
    OptimizeConfig,
    EvolveConfig,
    EvolveMethod,
    OFS,
)
from renormalizer_tpu_torch.utils.rk import RungeKutta, TaylorExpansion
from renormalizer_tpu_torch.utils.utils import (
    sizeof_fmt,
    cached_property,
    calc_vn_entropy,
    calc_vn_entropy_dm,
)
from renormalizer_tpu_torch.utils import log
from renormalizer_tpu_torch.utils.tdmps import TdMpsJob
