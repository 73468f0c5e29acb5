from renormalizer_tpu_torch.utils import constant
from renormalizer_tpu_torch.utils.quantity import Quantity
from renormalizer_tpu_torch.utils.configs import (
    CompressConfig,
    CompressCriteria,
    OptimizeConfig,
    OFS,
)
from renormalizer_tpu_torch.utils.utils import cached_property
from renormalizer_tpu_torch.utils import log
