from renormalizer_tpu_torch.cv.zerot import SpectraZtCV
from renormalizer_tpu_torch.cv.finitet import SpectraFtCV
