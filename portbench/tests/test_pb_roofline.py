"""The Gram eigensolver's bound against hand-worked values."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness.roofline import jacobi_bound_ms  # noqa: E402


@pytest.mark.parametrize("batch, n, ms, bound_by", [
    # n = 2: 9 * 8 = 72 operations (1.07e-9 ms) against 4 * (8 + 2) = 40
    # bytes over 3.35e12 B/s = 1.194e-8 ms: the bytes bound
    (1, 2, 40 / 3.35e12 * 1e3, "bytes"),
    # n = 8: 4608 operations (6.88e-8 ms) against 4 * (128 + 8) = 544 bytes
    # (1.624e-7 ms): still the bytes
    (1, 8, 544 / 3.35e12 * 1e3, "bytes"),
    # n = 288, two matrices: 2 * 9 * 288^3 = 429,981,696 operations over
    # 67e12 = 6.4176e-3 ms against 1,329,408 bytes (3.97e-4 ms)
    (2, 288, 429981696 / 67e12 * 1e3, "operations"),
    # n = 1056: 9 * 1056^3 = 10,598,252,544 operations = 0.15818 ms
    (1, 1056, 10598252544 / 67e12 * 1e3, "operations"),
])
def test_hand_worked(batch, n, ms, bound_by):
    got, by = jacobi_bound_ms(batch, n, 4)
    assert by == bound_by
    assert got == pytest.approx(ms, rel=1e-12)


def test_hand_worked_magnitudes():
    assert jacobi_bound_ms(1, 2)[0] == pytest.approx(1.19403e-8, rel=1e-5)
    assert jacobi_bound_ms(1, 8)[0] == pytest.approx(1.62388e-7, rel=1e-5)
    assert jacobi_bound_ms(2, 288)[0] == pytest.approx(6.41764e-3, rel=1e-5)
    assert jacobi_bound_ms(1, 1056)[0] == pytest.approx(0.158183, rel=1e-5)
