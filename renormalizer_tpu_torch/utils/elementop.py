r"""Second-quantization matrix elements for 2-level electrons and truncated
harmonic oscillators (reference ``renormalizer/utils/elementop.py``); a
numpy copy of ``renormalizer_tpu/utils/elementop.py``.

Implemented by building the operator matrices from the ladder operators and
reading out elements, rather than per-element closed-form rules.
"""

from functools import lru_cache

import numpy as np


def _ladder(n: int) -> np.ndarray:
    """Annihilation operator b in an n-level truncated Fock space."""
    return np.diag(np.sqrt(np.arange(1, n)), k=1)


@lru_cache(maxsize=None)
def _ph_matrix(op: str, size: int) -> np.ndarray:
    b = _ladder(size)
    bd = b.T
    table = {
        "b": b,
        r"b^\dagger": bd,
        r"b^\dagger b": bd @ b,
        r"b^\dagger + b": bd + b,
        "Iden": np.eye(size),
    }
    if op in table:
        return table[op]
    if op.startswith(r"(b^\dagger + b)^"):
        power = int(op.split("^")[-1])
        return np.linalg.matrix_power(bd + b, power)
    raise ValueError(f"Unknown phonon operator: {op}")


@lru_cache(maxsize=None)
def _e_matrix(op: str) -> np.ndarray:
    a = np.array([[0.0, 1.0], [0.0, 0.0]])  # annihilation |0><1|
    ad = a.T
    table = {
        "a": a,
        r"a^\dagger": ad,
        r"a^\dagger a": ad @ a,
        "Iden": np.eye(2),
        "sigma_x": np.array([[0.0, 1.0], [1.0, 0.0]]),
        "sigma_y": np.array([[0.0, -1.0j], [1.0j, 0.0]]),
        "sigma_z": np.array([[1.0, 0.0], [0.0, -1.0]]),
    }
    if op in table:
        return table[op]
    raise ValueError(f"Unknown electronic operator: {op}")


def e_element_op(op: str, ibra: int, iket: int):
    """<ibra| op |iket> for a 2-level electronic site."""
    assert 0 <= ibra < 2 and 0 <= iket < 2
    return _e_matrix(op)[ibra, iket]


def ph_element_op(op: str, ibra: int, iket: int):
    """<ibra| op |iket> for a truncated oscillator (any size >= indices)."""
    assert 0 <= ibra and 0 <= iket
    size = max(ibra, iket) + 1 + 4  # enough levels for exact elements
    return _ph_matrix(op, size)[ibra, iket]


def get_op_matrix(op: str, size: int, op_type: str) -> np.ndarray:
    assert op_type in ("e", "ph")
    if op_type == "e":
        assert size == 2
        return np.array(_e_matrix(op))
    # compute with a buffer so operator powers use untruncated intermediate
    # states (matrix elements must not depend on the truncation)
    return np.array(_ph_matrix(op, size + 4)[:size, :size])


def e_op_matrix(op: str) -> np.ndarray:
    return get_op_matrix(op, 2, "e")


def ph_op_matrix(op: str, size: int) -> np.ndarray:
    return get_op_matrix(op, size, "ph")


def construct_e_op_dict():
    return {op: e_op_matrix(op) for op in ("a", r"a^\dagger", r"a^\dagger a", "Iden")}


def construct_ph_op_dict(size: int):
    ops = ["b", r"b^\dagger", r"b^\dagger b", r"b^\dagger + b", "Iden",
           r"(b^\dagger + b)^2", r"(b^\dagger + b)^3"]
    return {op: ph_op_matrix(op, size) for op in ops}
