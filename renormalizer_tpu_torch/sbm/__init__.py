from renormalizer_tpu_torch.sbm.sbm import SpinBosonDynamics
from renormalizer_tpu_torch.sbm.lib import DebyeSDF, OhmicSDF, ColeDavidsonSDF, param2mollist
