"""Two candidate routes above the masked batch's byte budget, timed on the
same site updates, and the spectrum that sizes ``chip_smoke.py`` phase
15(b).

  gather    ``--sweeps`` percent-0 sweeps of 2-site DMRG of the bench chain
            (``chip_smoke.holstein_chain(6)``) from ``Mps.random`` at
            ``--m`` (1024: the phonon-phonon updates are (6144, 6144)
            coefficients of two sectors, 302 MB as a masked batch, above
            ``trunc_device.MASK_BUDGET``).  Every update above the budget is
            recorded, and its candidates are then computed by a
            gather-batched route (:func:`gathered_batch` below, the JAX
            package's design: every sector gathered at the update-wide
            padded extents, one Gram launch) and by the port's per-sector
            path (``trunc_device._per_sector``, one launch a sector), each
            with its host read of the spectrum and the gather of the top
            ``--m`` states, in the order gathered, per-sector, per-sector,
            gathered, ``--reps`` times.  Prints per update shape the median
            seconds of each route and the largest difference of their kept
            spectra, relative to the largest singular value.
  spectrum  phase 4's DMRG at M=256, then for each update of one more
            percent-0 sweep the number of the coefficient's singular values
            above each threshold relative to ||C||_F, per sector: by a
            double-precision SVD, by the port's exact (full-rank) candidates
            and by its default sketch (``SKETCH_CAP`` states), both in the
            coefficient's precision as the truncation computes them.

Run from the root of the repo on a CUDA device:
``python3 gather_probe.py gather spectrum``.  The last line is a JSON
summary; every time stands beside the card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from chip_smoke import PROCEDURE, holstein_chain

THRESHOLDS = (1e-4, 1e-5, 1e-6, 1e-7, 1e-8, 1e-9, 1e-10)
# rounding quantum of the gathered route's padded sector extents (the JAX
# package's RENO_TRUNC_BUCKET default)
BUCKET_QUANT = 64


def gathered_batch(cmat, secs, cap, transpose, gen):
    """All sectors as one batch of blocks gathered with index arrays padded
    to the update-wide extents (mlp, nrp), each rounded up to
    BUCKET_QUANT; the padding is masked to exact zeros, so one
    ``trunc_device._candidate_core`` over the stacked sector axis (one Gram
    launch) gives each sector's candidates, scattered back into the full row
    space.  Returns (vals (nsec_p, rows_out, l1p), lam, l1p)."""
    from renormalizer_tpu_torch.mps.trunc_device import (
        OVERSAMPLE, _candidate_core, _device_idx)

    m, n = cmat.shape
    mlp = min(-(-max(len(s[1]) for s in secs) // BUCKET_QUANT) * BUCKET_QUANT, m)
    nrp = min(-(-max(len(s[2]) for s in secs) // BUCKET_QUANT) * BUCKET_QUANT, n)
    l1p = min(min(mlp, nrp), cap + OVERSAMPLE)
    nsec_p = -(-len(secs) // 2) * 2
    gr_b = np.zeros((nsec_p, mlp), dtype=np.int64)
    gc_b = np.zeros((nsec_p, nrp), dtype=np.int64)
    mask_r = np.zeros((nsec_p, mlp), dtype=bool)
    mask_c = np.zeros((nsec_p, nrp), dtype=bool)
    l1_b = np.zeros(nsec_p, dtype=np.int64)
    for i, (_, lset, rset) in enumerate(secs):
        gr_b[i, :len(lset)] = lset
        gc_b[i, :len(rset)] = rset
        mask_r[i, :len(lset)] = True
        mask_c[i, :len(rset)] = True
        l1_b[i] = min(len(lset), len(rset), l1p)
    dev = cmat.device
    gr, gc = _device_idx(gr_b, dev), _device_idx(gc_b, dev)
    mr, mc = _device_idx(mask_r, dev), _device_idx(mask_c, dev)
    block = cmat[gr[:, :, None], gc[:, None, :]] \
        * (mr[:, :, None] & mc[:, None, :]).to(cmat.dtype)
    a = block.mT if transpose else block
    vals, lam = _candidate_core(a, mc if transpose else mr,
                                _device_idx(l1_b, dev), l1p, gen)
    # pad rows of vals are exact zeros, so adding them onto row 0 is exact
    rows_out = n if transpose else m
    scatter = (gc if transpose else gr)[:, :, None].expand_as(vals)
    out = torch.zeros((nsec_p, rows_out, l1p), dtype=vals.dtype, device=dev)
    return out.scatter_add_(1, scatter, vals), lam, l1p


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0]


def _recorded_sweeps(mps, mpo, m, keep, sweeps=1):
    """``sweeps`` percent-0 sweeps of ``mps`` at fixed M = ``m`` with every
    ``trunc_device.candidates`` call that ``keep`` accepts recorded (its
    arguments, the coefficient copied); returns the records and the
    sweeps' seconds."""
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

    records = []
    candidates = trunc_device.candidates

    def recording(coef, qnbigl, qnbigr, qntot, system, cap, *args, **kwargs):
        if keep(coef, qnbigl, qnbigr, qntot):
            records.append((backend.tensor(coef).detach().clone(), qnbigl.copy(),
                            qnbigr.copy(), np.array(qntot), system, cap))
        return candidates(coef, qnbigl, qnbigr, qntot, system, cap, *args, **kwargs)

    trunc_device.candidates = recording
    mps.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=m)
    try:
        mps.ensure_left_canonical()
        environ = gs.Environ(mps, mpo, "L")
        backend.sync()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            gs.single_sweep(mps, mpo, environ, None, 0, None)
        backend.sync()
        seconds = time.perf_counter() - t0
    finally:
        trunc_device.candidates = candidates
    return records, seconds


def _sectors(coef, qnbigl, qnbigr, qntot):
    from renormalizer_tpu_torch.mps.svd_qn import _sector_indices

    qn_size = len(qntot)
    localqnl = np.asarray(qnbigl).reshape(-1, qn_size)
    localqnr = np.asarray(qnbigr).reshape(-1, qn_size)
    cmat = coef.reshape(len(localqnl), len(localqnr))
    secs = [s for s in _sector_indices(localqnl, localqnr, qntot)
            if min(len(s[1]), len(s[2])) > 0]
    return cmat, secs


def part_gather(m, reps, sweeps, card):
    from renormalizer_tpu_torch import Mpo, Mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device

    model = holstein_chain(6)
    mpo = Mpo(model)
    mps = Mps.random(model, 1, m, percent=1.0)

    def over_budget(coef, qnbigl, qnbigr, qntot):
        cmat, secs = _sectors(backend.tensor(coef), qnbigl, qnbigr,
                              np.atleast_1d(qntot))
        nsec_p = -(-len(secs) // 2) * 2
        return (len(secs) > 1 and nsec_p * cmat.numel() * cmat.element_size()
                > trunc_device.MASK_BUDGET)

    records, sweep_s = _recorded_sweeps(mps, mpo, m, over_budget, sweeps)
    print(f"[gather] {sweeps} sweeps at M={m}: {sweep_s:.3f} s ({card}); "
          f"{len(records)} updates above the {trunc_device.MASK_BUDGET} byte "
          f"mask budget", flush=True)

    def route(name, cmat, secs, cap, transpose):
        gen = backend.generator()
        if name == "gathered":
            vals, lam, _ = gathered_batch(cmat, secs, cap, transpose, gen)
            parts = vals.permute(1, 0, 2).reshape(vals.shape[1], -1)
            lam = lam.reshape(-1)
        else:
            part_list, _, lam, _ = trunc_device._per_sector(
                cmat, secs, cap, transpose, False, False, gen)
            parts = torch.cat(part_list, dim=1)
        sigma = trunc_device.lam_to_sigma(lam)
        top = np.argsort(-sigma, kind="stable")[:cap]
        kept = parts[:, torch.as_tensor(top, device=parts.device)]
        backend.sync()
        return np.sort(sigma[top])[::-1], kept

    rows = {}
    for coef, qnbigl, qnbigr, qntot, system, cap in records:
        cmat, secs = _sectors(coef, qnbigl, qnbigr, qntot)
        transpose = system == "R"
        key = (tuple(cmat.shape), tuple(len(s[1]) for s in secs),
               tuple(len(s[2]) for s in secs), system)
        times = {"gathered": [], "per-sector": []}
        spectra = {}
        for _ in range(reps):
            for name in ("gathered", "per-sector", "per-sector", "gathered"):
                backend.sync()
                t0 = time.perf_counter()
                spectra[name], _ = route(name, cmat, secs, cap, transpose)
                times[name].append(time.perf_counter() - t0)
        s_g, s_p = spectra["gathered"], spectra["per-sector"]
        diff = float(np.abs(s_g - s_p).max() / s_g[0])
        row = rows.setdefault(key, {"updates": 0, "gathered": [], "per-sector": [],
                                    "spectrum_diff": 0.0})
        row["updates"] += 1
        row["gathered"] += times["gathered"]
        row["per-sector"] += times["per-sector"]
        row["spectrum_diff"] = max(row["spectrum_diff"], diff)
    summary = []
    for (shape, lrows, rrows, system), row in rows.items():
        g = statistics.median(row["gathered"])
        p = statistics.median(row["per-sector"])
        print(f"[gather] C {shape} sectors rows {lrows} cols {rrows} system "
              f"{system}, {row['updates']} updates: median s gathered {g:.6f} "
              f"per-sector {p:.6f} (per-sector / gathered {p / g:.3f}); kept "
              f"spectra differ by {row['spectrum_diff']:.2e} of sigma_max "
              f"({card})", flush=True)
        summary.append(dict(shape=list(shape), sector_rows=list(lrows),
                            sector_cols=list(rrows), system=system,
                            updates=row["updates"], gathered_s=g, per_sector_s=p,
                            spectrum_diff=row["spectrum_diff"]))
    total_g = sum(r["gathered_s"] * r["updates"] for r in summary)
    total_p = sum(r["per_sector_s"] * r["updates"] for r in summary)
    print(f"[gather] the sweeps' updates above the budget: gathered {total_g:.4f} s, "
          f"per-sector {total_p:.4f} s ({card})", flush=True)
    return dict(m=m, sweeps=sweeps, sweep_s=sweep_s, rows=summary, gathered_s=total_g,
                per_sector_s=total_p)


def part_spectrum(card):
    from renormalizer_tpu_torch import Mpo, Mps, optimize_mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device

    model = holstein_chain(6)
    mpo = Mpo(model)
    mps = Mps.random(model, 1, 256, percent=1.0)
    mps.optimize_config.procedure = PROCEDURE
    mps.optimize_config.method = "2site"
    _, opt = optimize_mps(mps, mpo)
    records, _ = _recorded_sweeps(opt, mpo, 256, lambda *args: True)
    out = []
    for coef, qnbigl, qnbigr, qntot, system, _ in records:
        cmat, secs = _sectors(coef, qnbigl, qnbigr, qntot)
        norm = float(torch.linalg.matrix_norm(cmat.to(torch.float64)))
        # sectors in the order of their labels, as the candidates' below
        label = (lambda nl: tuple(nl)) if system == "L" else (lambda nl: tuple(qntot - nl))
        svd = [torch.linalg.svdvals(cmat[backend.tensor(l)][:, backend.tensor(r)]
                                    .to(torch.float64)).cpu().numpy() / norm
               for _, l, r in sorted(secs, key=lambda sec: label(sec[0]))]
        found = {"svd": svd}
        rank = min(cmat.shape)
        for name, cap in (("exact", rank), ("sketch", trunc_device.SKETCH_CAP)):
            if name == "sketch" and rank <= cap:
                continue
            _, sigma, qn_list = trunc_device.candidates(
                coef, qnbigl, qnbigr, qntot, system, cap, want_complement=False)
            labels = sorted(set(qn_list))
            found[name] = [sigma[[q == lab for q in qn_list]] / norm for lab in labels]
        counts = {name: {f"{t:.0e}": [int((x > t).sum()) for x in per]
                         for t in THRESHOLDS} for name, per in found.items()}
        widest = max(min(len(l), len(r)) for _, l, r in secs)
        print(f"[spectrum] C {tuple(cmat.shape)} ({len(secs)} sectors, widest "
              f"rank {widest}): singular values above threshold x ||C||_F per "
              f"sector: {counts}", flush=True)
        out.append(dict(shape=list(cmat.shape), widest_rank=widest, counts=counts))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parts", nargs="+", choices=("gather", "spectrum"))
    parser.add_argument("--m", type=int, default=1024)
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--sweeps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_probe.py needs a CUDA device")
    card = _card()
    print(card, flush=True)
    result = {}
    if "spectrum" in args.parts:
        result["spectrum"] = part_spectrum(card)
    if "gather" in args.parts:
        result["gather"] = part_gather(args.m, args.reps, args.sweeps, card)
    print(json.dumps(dict(result, card=card)))


if __name__ == "__main__":
    main()
