from renormalizer_tpu_torch.cv.spectra_cv import SpectraCv, batch_run
from renormalizer_tpu_torch.cv.zerot import SpectraZtCV
from renormalizer_tpu_torch.cv.finitet import SpectraFtCV
