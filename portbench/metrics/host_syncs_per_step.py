"""Host waits on the device per step: the runtime's stream, device and event
synchronisations in the profile, less the harness's own two per unit."""


def read(probe):
    return (probe.trace.syncs - probe.harness_syncs) / probe.units
