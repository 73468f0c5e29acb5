"""How far a single-precision ``torch.linalg.eigh`` puts the lowest
eigenvalue of QC-DMRG's dense local problems, against the same float32
matrix solved in double precision.

The run is ``chip_smoke.py`` phase 13(b)'s: 2-site DMRG of H2O/STO-3G
(``tests/data/h2o_fcidump.txt``, [5, 5] electrons, M=50) in fp32.  Every
local problem small enough for the dense solve (``gs.eigh_direct``, under
1000 elements) is built again and its lowest eigenvalue taken three ways:
``torch.linalg.eigh`` in float32 on the run's device, the same matrix in
float64 on that device, and float32 on the CPU (LAPACK).  One line per
local problem (size, the three against the FCI energy), then the largest
gap of each float32 solve from the float64 one.  The DMRG itself solves in
double precision (``solvers.eigh_wide``), so the path is the shipped one.

Run from the root of the repo: ``python3 eigh_precision_probe.py`` on the
card (``RENO_PLATFORM=cpu RENO_DTYPE=fp32`` on the CPU).
"""

import numpy as np
import torch

H2O_FCIDUMP = "tests/data/h2o_fcidump.txt"
H2O_FCI = -75.008697516450
M = 50


def main():
    import renormalizer_tpu_torch as rt
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.model import h_qc
    from renormalizer_tpu_torch.mps import gs
    from renormalizer_tpu_torch.ops.contract import hop_dense

    assert backend.is_32bits, "run in fp32 (the card's default)"
    h1e, h2e, nuc = h_qc.read_fcidump(H2O_FCIDUMP, 7)
    rows = []
    eigh_direct = gs.eigh_direct

    def recording(mps, qn_mask, ltensor, rtensor, cmo, omega=None):
        idx = gs._mask_index(qn_mask)
        dim = qn_mask.size
        ham = hop_dense(ltensor, rtensor, cmo).reshape(dim, dim)[idx][:, idx]
        rows.append((len(idx),
                     float(torch.linalg.eigvalsh(ham)[0]),
                     float(torch.linalg.eigvalsh(ham.double())[0]),
                     float(torch.linalg.eigvalsh(ham.cpu())[0])))
        return eigh_direct(mps, qn_mask, ltensor, rtensor, cmo, omega)

    gs.eigh_direct = recording
    basis, terms = h_qc.qc_model(h1e, h2e)
    model = rt.Model(basis, terms)
    mps = rt.Mps.random(model, [5, 5], M, percent=1.0)
    mps.optimize_config.procedure = [[M, 0.4], [M, 0.2], [M, 0.1]] + [[M, 0]] * 6
    mps.optimize_config.method = "2site"
    energies, _ = rt.optimize_mps(mps, rt.Mpo(model))
    print(f"{backend.device}: sweeps' lowest energy - FCI "
          f"{min(energies) + nuc - H2O_FCI:+.3e}; local problems solved densely "
          f"{len(rows)}", flush=True)
    for n, w_dev, w64, w_cpu in rows:
        print(f"n {n:4d}: float32 on {backend.device.type} {w_dev + nuc - H2O_FCI:+.3e}, "
              f"float64 {w64 + nuc - H2O_FCI:+.3e}, float32 LAPACK "
              f"{w_cpu + nuc - H2O_FCI:+.3e}", flush=True)
    gaps = np.array([(abs(d - w), abs(c - w), n) for n, d, w, c in rows])
    worst = int(np.argmax(gaps[:, 0]))
    print(f"largest |float32 - float64| of the lowest eigenvalue: on "
          f"{backend.device.type} {gaps[worst, 0]:.3e} (n {int(gaps[worst, 2])}), "
          f"LAPACK {gaps[:, 1].max():.3e}", flush=True)


if __name__ == "__main__":
    main()
