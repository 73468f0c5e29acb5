"""DMRG sweeps per ground-state solve: calls of mps/gs.py's
``single_sweep`` and root calls of tn/gs.py's
``optimize_recursion``, counted by wrappers on those names."""


def install(probe):
    from renormalizer_tpu_torch.mps import gs
    from renormalizer_tpu_torch.tn import gs as tree_gs

    probe.state["sweeps"] = 0
    single_sweep, recursion = gs.single_sweep, tree_gs.optimize_recursion

    def counted_sweep(*args, **kwargs):
        probe.state["sweeps"] += 1
        return single_sweep(*args, **kwargs)

    def counted_recursion(snode, state, *args, **kwargs):
        if snode is state.root:
            probe.state["sweeps"] += 1
        return recursion(snode, state, *args, **kwargs)

    probe.patch(gs, "single_sweep", counted_sweep)
    probe.patch(tree_gs, "optimize_recursion", counted_recursion)


def read(probe):
    if not probe.state["sweeps"]:
        return None
    return probe.state["sweeps"] / probe.units
