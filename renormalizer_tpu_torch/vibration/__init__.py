from renormalizer_tpu_torch.vibration.vscf import Vscf
