"""Named per-step observable collection for time-dependent jobs.

A :class:`Property` holds a table of named operators (single MPOs or MPO
lists) and accumulates their expectation values every time the driving
:class:`TdMpsJob` calls it — the mechanism any job uses to collect extra
user-defined observables beyond its built-ins.  Port of
``renormalizer_tpu/property/property.py`` (reference
``renormalizer/property/property.py:4-80``); name conventions (the special
``"e_rdm"`` key, the diagonal-observable names ``x``/``x^2``/``n``) follow
the reference so user scripts port unchanged.
"""

from typing import Dict, List, Union

from renormalizer_tpu_torch.mps import MpDm, Mpo, Mps

# property names evaluated as <bra|op|bra> and <ket|op|ket> separately (vs
# the default transition amplitude <bra|op|ket>) in the BraKetPair variant
_DIAGONAL_NAMES = frozenset(("x", "x^2", "n"))


def _expect(state, op: Union[Mpo, list], conj_state=None):
    """Expectation of one registered operator entry: a bare MPO goes through
    the single-operator path, a list through the shared-environment cache."""
    if isinstance(op, Mpo):
        return state.expectation(op, conj_state)
    if isinstance(op, list):
        if conj_state is not None:
            raise ValueError("MPO lists do not support a custom bra state")
        return state.expectations(op)
    raise TypeError(f"unsupported property operator type: {type(op)}")


class Property:
    """Accumulates named observables over a time-dependent run.

    ``prop_mpos`` maps each name in ``prop_strs`` to an :class:`Mpo` (or a
    list of them); results land in ``self.prop_res[name]``, one entry per
    recorded step.  Complex-valued results require ``dump_type=".npz"`` on
    the driving job.
    """

    def __init__(self, prop_strs: List[str], prop_mpos: Dict[str, Mpo]):
        self.prop_strs = list(prop_strs)
        self.prop_mpos = prop_mpos
        self.prop_res: Dict[str, list] = {name: [] for name in self.prop_strs}

    def calc_properties(self, mps: Union[Mps, MpDm], mps_conj=None):
        """Record every registered observable on ``mps`` (optionally with an
        explicit conjugate state).  ``"e_rdm"`` is computed from the state's
        own electronic RDM rather than an operator table entry."""
        for name in self.prop_strs:
            if name == "e_rdm":
                value = mps.calc_edof_rdm()
            elif name in self.prop_mpos:
                value = _expect(mps, self.prop_mpos[name], mps_conj)
            else:
                raise NotImplementedError(
                    f"property '{name}' has no registered operator")
            self.prop_res[name].append(value)

    def calc_properties_braketpair(self, pair):
        """BraKetPair variant: diagonal names record (bra, ket) expectation
        pairs; everything else records the transition amplitude."""
        for name in self.prop_strs:
            op = self.prop_mpos[name]
            if name in _DIAGONAL_NAMES:
                value = [_expect(pair.bra_mps, op), _expect(pair.ket_mps, op)]
            else:
                value = pair.ket_mps.expectation(op, pair.bra_mps)
            self.prop_res[name].append(value)
