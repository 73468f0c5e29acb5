"""Host reads of a truncation spectrum per solve: the growth of
``trunc_device.SPECTRUM_READS`` over the traced window."""


def install(probe):
    from renormalizer_tpu_torch.mps import trunc_device

    probe.state["spectrum_reads"] = trunc_device.SPECTRUM_READS


def read(probe):
    from renormalizer_tpu_torch.mps import trunc_device

    return (trunc_device.SPECTRUM_READS - probe.state["spectrum_reads"]) / probe.units
