from renormalizer_tpu_torch.ops import contract
