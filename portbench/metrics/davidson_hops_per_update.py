"""Davidson iterations per site update: the ``niter`` that ``davidson_fused``
(the MPS path, called by ``mps/gs.py``) and ``davidson`` (the tree path,
called by ``tn/gs.py``) return, read by wrappers on those names."""


def install(probe):
    from renormalizer_tpu_torch.mps import gs
    from renormalizer_tpu_torch.tn import gs as tree_gs

    probe.state["davidson"] = []

    def counted(solver):
        def wrapped(*args, **kwargs):
            out = solver(*args, **kwargs)
            probe.state["davidson"].append(int(out[2]))
            return out
        return wrapped

    probe.patch(gs, "davidson_fused", counted(gs.davidson_fused))
    probe.patch(tree_gs, "davidson", counted(tree_gs.davidson))


def read(probe):
    calls = probe.state["davidson"]
    return sum(calls) / len(calls) if calls else None
