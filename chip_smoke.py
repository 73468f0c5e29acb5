#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (renormalizer_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: the card's name and power limit; the port's device is CUDA;
  2. build: compiles csrc/*.cu with nvcc for sm_90a (first use);
  3. kernel versus plain: the block-Jacobi eigensolver kernel and its plain
     torch version on the same seeded matrices, both held against
     torch.linalg.eigh (tolerances relative to ||A||_F: eigenvalues 1e-5 f32
     / 1e-11 f64, |V^T V - I| 1e-4 / 1e-12, |AV - VL| 1e-4 / 1e-11, up to
     n = 288; past n = 288 the f32 tolerances grow as n / 288), the ten
     (1, n, n) shapes that phases 6(d), 9 and 10 solve among them; then, at
     the DMRG path's shapes (2, 288, 288) and (1, 544, 544), the evolution
     path's (1, 48, 48), the Kubo path's (1, n, n), n = 106, 8, 2, 25, and
     phase 12's widest and batched shapes (EXCITED_PATH_GRAMS: (1, 384, 384),
     (1, 160, 160), (2, 64, 64), (2, 96, 96)), f32, the kernel, the plain
     version and torch.linalg.eigh timed in turns, the sweeps each timed
     solve took, and the kernel's bound (the plain version in one call per
     shape, without a warm-up, and not at the widest shapes PLAIN_UNTIMED:
     seconds a call, no yardstick); phase 12's shapes are also held against
     the plain version;
  4. main path: 2-site DMRG of the 6-molecule Holstein chain (18 sites) at
     M=256 in fp32, through Mps.random / Mpo / optimize_mps; the energy must be
     within 1e-6 of 0.11503887 and the truncation's Gram eigh must have gone
     through the kernel.  Each Gram eigh's residual and sweep count are kept
     on the device and read once at the end: the script prints how many
     launches ran to the sweep cap and the (batch, n) histogram.
  5. evolution against a dense oracle (fp32/complex64): 10 TDVP-PS steps of
     0.2 on the 3-molecule, 2-level Holstein model (electronic occupations)
     and on a 3-mode spin-boson model through SpinBosonDynamics (sigma_z),
     against scipy.linalg.expm of a kron-assembled dense Hamiltonian: mean
     cumulative deviation < 1e-4, norm within 1e-5 of 1, all finite;
  6. the evolution path at full width, one first step and 2 timed steps of
     TDVP-PS (dt 0.2) each: (a) the 32-site spin-boson chain at M=48 from a
     random state, (b) the qn-structured 6-molecule, 4-level Holstein chain
     at M=48, (c) the DMRG path's 6-level chain at M=256, (d) the
     SpinBosonDynamics job on the 32-site chain at M=48, whose constructor
     compresses real states (each sector block by torch.linalg.svd, counted:
     at least one; no real Gram eigh around the kernel; the (batch, n) of
     every launch, its sweeps and residual are printed, none may run to the
     sweep cap, and every one of these Grams is solved again by the plain
     version and compared; the steps' compresses of the complex state factor
     by torch.linalg.svd too, counted: at least one).  After every step: norm within 1e-4 of 1, <psi|H|psi>
     constant within ENERGY_RTOL * max(1, |E|), all tensors finite; in (d)
     sigma_z(0) = 1 and |sigma_z| <= 1 + 1e-5.  Prints seconds per step, bond
     dimensions and the site visits by branch (fused / unfused).
  8. the finite-temperature path against dense oracles, on the JAX package's
     test models: (a) ThermalProp (TDVP-PS) of 3 molecules at 1500 K, the
     electronic occupations within 1e-4 of the dense thermal populations;
     (b) TransportKubo of 5 molecules at 50000 K, M=24, TDVP-PS in imaginary
     and real time, C(t) within 5e-2 of the dense Liouville correlation; (c)
     SpectraFiniteT absorption, C(t) within SPECTRA_RTOL |C(0)| of the dense
     two-way oracle; (d) P&C, adaptive P&C, RK4 and Butcher-tableau RK on
     the 3-molecule, 2-level chain, occupations within 1e-4 (mean cumulative
     deviation) of scipy.linalg.expm;
  9. TransportKubo at full width on the bench chain (18 sites, 298 K, M=64):
     10 imaginary-time TDVP-PS steps to beta/2, the current operator applied
     and compressed, then one first and four timed real-time steps of 20 a.u.
     (bra and ket one TDVP-PS step each).  Prints the seconds of each; the
     thermal state finite, its electronic occupations summing to 1 within
     1e-4 and its energy below that of beta = 0; bra and ket norms within
     NORM_TOL and <H> within ENERGY_RTOL max(1, |E|) of their first values;
     |Im C(0)| <= 1e-4 |C(0)| and |C(t)| <= 1.001 |C(0)|.  The constructor's
     compresses factor by torch.linalg.svd (counted: at least one), and its
     Jacobi launches are recorded as in 6(d): none at the sweep cap, a shape
     that phase 3 did not hold (KUBO_PATH_GRAMS) held against the plain
     version, every one solved again by torch.linalg.eigh inside phase 3's
     f32 tolerances.
 10. the rest of Mps.evolve and its jobs: (a) against dense oracles on the
     JAX package's test models: TDVP-PS2, MU-VMF, VMF and MU-CMF on the
     3-molecule, 2-level chain (occupations within 1e-4, MU-CMF 5e-4, mean
     cumulative deviation; RKF45 nfev/nsteps per step printed),
     SpectralFunctionZT on the 4-cell TI1DModel ring (G(0) within 1e-5 of
     -i delta_ij) and the band-limit ChargeDiffusionDynamics (r^2 within
     1e-3 of 2 J^2 t^2); at full width on the bench chain (18 sites, fixed
     M=64, one first and two timed steps) (b) ChargeDiffusionDynamics at
     T=0 from the relaxed start with MU-VMF, dt 1 a.u. (a step of 20 a.u.
     takes ~4500 right-hand sides, ~13 minutes, on the H100), and (c) with
     TDVP-PS2, dt 20 a.u.: norm within NORM_TOL, occupations summing to 1 within
     1e-4, r^2 finite and >= 0, <H> within CHARGE_ENERGY_DRIFT max(1, |E|)
     of its start; the constructors' Jacobi launches recorded as in phase 9
     (CHARGE_PATH_GRAMS); (d) ThermalProp of the chain's MpDm at 298 K with
     MU-VMF in imaginary time and a Property collector (e_rdm and
     e_ph_static_correlation): two TDVP-PS steps of beta/20 (from the freshly
     expanded state MU-VMF stalls: its RKF45 step fell to ~1e-7 a.u. within
     0.015 a.u.), then one first and one timed MU-VMF step of beta/100: the
     Jacobi kernel inside the time loop, every launch recorded (none at the
     sweep cap, every shape in THERMAL_PATH_GRAMS, every Gram solved again by
     torch.linalg.eigh inside phase 3's f32 tolerances), launches per step
     printed.  A Gram shape of phases 6(d), 9 and 10 that phase 3 did not
     hold is held against the plain version on the path's own Grams.
 11. the excited-state slice on the JAX package's test models against dense
     oracles, in fp32 (EXCITED_BOUNDS: tests/test_mps.py's and
     tests/test_apps.py's bounds, two of them set by a CPU fp32 rehearsal):
     state-averaged DMRG of 2 roots, omega-targeted DMRG, the arpack, lobpcg
     and primme eigensolvers, TDA, VSCF, vibronic dynamics, SpectraZtCV and
     SpectraFtCV (absorption 1- and 2-site, emission);
 12. at the bench chain's full width (18 sites, fp32): (a) state-averaged
     2-site DMRG of 2 roots at M=64 against the JAX package's CPU fp64
     energies (SA_REF, within SA_TOL; root 1 above root 0), seconds per
     sweep; (b) SpectraZtCV absorption at M=64 (ground state by
     procedure_gs up to M=64), 1-site, eta 0.05 eV, 2.50/2.60/2.70 eV
     through batch_run(freqs, 1, obj), at most 8 sweeps each: every response
     finite, > 0 and converged to rtol; seconds per frequency and per sweep,
     CG iterations per site; then batch_run(freqs, 3, obj) from the same
     start (one interleaved worker per frequency), timed and within 1e-4 of
     the serial loop.  Each path's Jacobi launches are counted from 0
     (launches_by_path state_averaged_dmrg and cv_zerot), none may reach
     the sweep cap, every one is solved again by torch.linalg.eigh inside
     phase 3's tolerances, those of a shape phase 3 did not hold also by
     the plain version, and no Gram may go around the kernel.
 13. quantum chemistry: (a) in a child process with RENO_DTYPE=fp64 (a
     non-zero exit fails the script), 2-site QC-DMRG of H2O/STO-3G
     (tests/data/h2o_fcidump.txt: 14 spin-orbital sites, [5, 5] electrons,
     two-component quantum numbers) at M=50 through read_fcidump / qc_model
     / Mpo / Mps.random / optimize_mps, within 1e-8 of the published FCI
     energy -75.008697516450, every real Gram through the f64 kernel (the
     seconds of Mpo(model) and of each sweep, the MPO bond dimensions and
     the launches by (batch, n) printed; a Gram shape phase 3 did not hold
     held against the plain version); and (d) padding_seed_probe.py's
     thermal case at seeds 2019, 0, 1 and 2, each under 1e-5 off the dense
     RDM, the largest within 3x the smallest; (b) the same H2O run in fp32,
     its lowest sweep energy within H2O_TOL_FP32 (the result's energy
     evaluated in double precision printed); (c) the slice's small oracles
     at the JAX tests' bounds (QC_BOUNDS): qc_model with Mpo and StackedMpo,
     StackedMpo DMRG, OFS-S DMRG of the scheme-1 chain against GS_E and of
     a paired-spin chain against its dense energy, TDVP-PS2 with OFS-S
     against expm (each with at least one swap of try_swap_site),
     variational_compress, DmrgFCISolver, read_fcidump; then phase 10(a)'s
     MU-CMF fp32 deviation at seeds 2019, 0 and 1 (a record).
 14. the tree engine (renormalizer_tpu_torch.tn): (a) tree DMRG of the
     DMRG model on BasisTree.binary at M=TREE_M in fp32 through TTNO /
     TTNS.random / optimize_ttns, the sweeps' lowest energy within
     TREE_E_TOL of E_REF, every Gram through the kernel (recorded as in
     phase 12: none at the sweep cap, each solved again by
     torch.linalg.eigh, the shapes phase 3 did not hold by the plain
     version; launches_by_path tree_dmrg), the widest and the two most
     frequent Gram shapes timed against the plain version and
     torch.linalg.eigh; each sweep's seconds and energy, the largest 2-site
     coefficient and the peak device memory printed; (b) the pyrazine
     MCTDH check of tests/test_pyr4.py::test_pyr4_ttns in complex64, the
     S1/S2 populations within PYR_TOL of tests/data/pyr4_mctdh.npy at all
     61 points, seconds per step printed; (c) tree TDVP-PS, TDVP-PS2 and
     VMF against scipy.linalg.expm, state-averaged tree DMRG, the
     thermofield state and from_mps at TREE_BOUNDS.
 15. the site update's host-hiding machinery and the tiering, on the
     DMRG model (every sweep of the procedure run, as bench.py drives its
     steady state; per sweep the seconds, PLAN_STATS, the host reads of a
     spectrum, the index cache's hits and misses): (a) phase 4's DMRG
     with the asynchronous static-plan selection (RENO_ASYNC_TRUNC=1, the
     card's default), without it (=0), then without and with it again
     (the two modes timed in alternated order), each within E_TOL of E_REF,
     static updates in the percent-0 sweeps reading no spectrum; (b)
     threshold-criteria DMRG from (a)'s converged state (CompressCriteria.
     both, SKETCH_THRESHOLD, max_bonddim M; 2-site ranks up to 1536) exact,
     sketched (exact cap SKETCH_EXACT_CAP: the default sketch of
     SKETCH_GRAM states; frob_norm must run) and starved (a sketch of one
     state: the saturation check must retry exactly on the device), each
     within E_TOL of E_REF and within SKETCH_RTOL of each other; (c) (a)'s
     synchronous run with RENO_HOST_OFFLOAD=2 and every site offloadable:
     evictions and restores, cold tensors in pinned host memory, energies
     within OFFLOAD_RTOL of (a)'s, peak device memory of both; (d) 14(a)
     with and without the tree's plan reuse; (e) a trace from RENO_PROFILE.
     Every Gram shape held against the plain version (phase 3, which holds
     and times the (2, SKETCH_GRAM) Gram, or _hold_unheld); the sketched
     run's most frequent and widest shapes timed; launches_by_path
     async_dmrg, sync_dmrg, sketch_threshold_dmrg, offload_dmrg,
     tree_dmrg_async.
 16. the mesh (renormalizer_tpu_torch.parallel) on a (1, 2, 2) mesh: four
     distinct cards when four are visible, else cuda:0 named four times
     (every piece of the sharded path runs, the copies between cards do
     not); the number of distinct devices is printed.  (a) phase 4's DMRG
     under the mesh, the bond-parallel hop of every divisible site update
     and, on several distinct cards only, the sectors placed round-robin:
     the energy within E_TOL of E_REF and of phase 4's, at least one
     sharded update; printed: the sharded and fallback counts, the gathers
     run with their bytes per matvec and per sweep, the sweep seconds
     beside phase 4's, the sectors placed per device, PLAN_STATS and the
     Jacobi launches (none at the sweep cap; the shapes phase 3 did not
     hold against the plain version; launches_by_path sharded_dmrg); (b)
     candidates of (a)'s widest coefficient (several sectors) with
     placement forced on and off, bitwise equal; (c) 14(a) under the mesh,
     the general tree hop engaged, within
     TREE_E_TOL (launches_by_path sharded_tree_dmrg); (d) with a second
     visible card one Jacobi launch there held against the plain version,
     else a line saying it was not exercised; (e) phase 4's DMRG without
     and with the mesh in alternated order (unsharded, sharded, sharded,
     unsharded), every sweep run: each within E_TOL, the median of the last
     five sweeps of each run and their ratios printed.
 17. the package's own examples (examples/*.py, read as text, their
     renormalizer_tpu imports rewritten to the port by
     renormalizer_tpu_torch.run_examples; never imported): (a) the eight
     with references, in this process through run_example on the card in
     the default fp32 (hubbard.py in fp64, EXAMPLES_FP64: it asserts its
     energy within 1e-6, below fp32's reach), each under a GramRecord
     (every Jacobi launch recorded, none at the sweep cap, the shapes phase
     3 did not hold held against the plain version; launches_by_path example_<name> for each
     example that launches the kernel, at least holstein_gs): the numbers
     each prints against the JAX package's fp64 CPU run (EXAMPLE_REFS:
     holstein_gs's last sweep energy 1e-5, qc_dmrg 1e-4, the tree DMRG
     energy 1e-5, hubbard and ssh 1e-5 max(1, |E|), both sigma_z(t) series
     1e-3 at every sample, the DDMRG responses 1e-3 relative), the port's
     device printed and required to be cuda; (b) fmo.py, which has no
     reference, last, in a child process through the runner, fp32 then
     fp64, each within FMO_TIMEOUT: its BChl populations' rows sum to 1,
     every entry in [0, 1], the first row BChl 1 alone (FMO_TOL), the fp32
     final row within FMO_FP32_TOL of the fp64 one.
A [summary] line repeats the run's times as JSON, so that the end of the
output carries them, with the seconds of each phase and of the whole script.  The line before the last holds the kernel record as
JSON (with the launches of each path: DMRG, SpinBosonDynamics,
TransportKubo, ChargeDiffusionDynamics, the MU-VMF ThermalProp,
state-averaged DMRG, SpectraZtCV, QC-DMRG, tree DMRG, phase 15's, 16's
and 17's examples); the last
line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 and prints
no result.

    python3 chip_smoke.py --profile

runs the DMRG main path under torch.profiler and adds its device time per
kernel and the card's busy share of that run's wall time; then (phase 7) it
does the same for one more step of each of 6(a)-(d), of the Kubo job of
phase 9 and of 10(b)-(d), and counts that step's host synchronisations by
the operator that asked for them, and runs 14(a) under the profiler too.

    python3 chip_smoke.py --tree [--profile]

runs phases 1, 2 and 14 alone and prints no result line, and

    python3 chip_smoke.py --hide

phases 1, 2, 4 and 15 (no result line), and

    python3 chip_smoke.py --mesh [--profile]

phases 1, 2, 4 and 16 (no result line; with --profile 16(a) runs under
the profiler, as does the full run's 16(a) with --profile), and

    python3 chip_smoke.py --examples

phases 1, 2 and 17 (no result line).
"""

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time

_T0 = time.perf_counter()
E_REF = 0.11503887      # converged bench energy, M=256, fp32
E_TOL = 1e-6
M = 256
PROCEDURE = [[M, 0.4], [M, 0.2]] + [[M, 0]] * 6
JACOBI_SOURCE = "renormalizer_tpu_torch/csrc/jacobi.cu"
JACOBI_REPLACES = "renormalizer_tpu/ops/jacobi.py:238"
# Energy drift allowed per phase-6 run, relative to max(1, |E|).  One-site
# TDVP-PS conserves <H> exactly (each Krylov propagation is unitary inside its
# space and commutes with the projected H), so the drift is rounding only: a
# CPU fp64 run of the same four configurations at M=16 (M=8 for (c)) drifts
# by at most 8e-15 of that scale over 5 steps, the same runs in fp32 by at
# most 2.9e-6 (each <psi|H|psi> is itself a sum of ~1e3 fp32 terms); 5e-5
# leaves a factor of 17 over that and is 20x tighter than 1e-3.
ENERGY_RTOL = 5e-5
NORM_TOL = 1e-4
# n of the (1, n, n) f32 Grams that the SpinBosonDynamics constructor of phase
# 6(d) solves (32 sites, M=48); phase 3 holds the kernel against its plain
# version at each, and 6(d) fails if it solves a shape that is not listed
EVOLVE_PATH_GRAMS = (2, 3, 8, 9, 12, 27, 32, 39, 48, 75)
# n of the (1, n, n) f32 Grams that the TransportKubo constructor of phase 9
# solves (the bench chain, M=64: 52 n before the expansion spread its
# zero-weight padding over the sectors, and the seven more it solves since);
# phase 3 holds the kernel against its plain version at each n <= 288 and at
# the largest, and phase 9 fails on a shape that is not listed
KUBO_PATH_GRAMS = (2, 6, 8, 10, 14, 16, 18, 19, 20, 21, 22, 23, 24, 25, 26,
                   27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
                   42, 43, 44, 49, 50, 51, 52, 54, 55, 58, 64, 71, 78, 80, 82,
                   84, 86, 90, 91, 92, 95, 96, 97, 98, 100, 101, 102, 103, 106)
# n of the (1, n, n) f32 Grams that the ChargeDiffusionDynamics constructors
# of phase 10(b)-(c) solve (the bench chain, M=64: the expansion), and of the
# Grams of phase 10(d)'s ThermalProp, by itemsize: f32 in its constructor
# (the expansion), f64 in the time steps (MU-VMF integrates in double
# precision); phase 3 holds the kernel against its plain version at each, and
# phase 10 fails on a shape that is not listed
CHARGE_PATH_GRAMS = (1, 4, 5, 6, 7, 13, 14, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                     26, 27, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 41, 42,
                     44, 45, 46, 47, 49, 50, 52, 54, 56, 57)
THERMAL_PATH_GRAMS = {4: (2, 6, 8, 14, 16, 18, 19, 20, 21, 23, 24, 25, 26, 27, 29,
                         30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 43, 44,
                         51, 52, 58, 64, 71),
                      8: (2, 26, 27, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 64)}
# (batch, n) of phase 12's f32 Grams that phase 3 holds: the widest sector
# block of the state-averaged density matrix (384), the correction vector's
# widest (160), and the batched shapes the two paths solve most often
EXCITED_PATH_GRAMS = ((1, 384), (1, 160), (2, 64), (2, 96))
# <H> drift allowed in phase 10(b)-(c), relative to max(1, |E|): a CPU fp32
# rehearsal (3 molecules, M=16, three steps of 20 a.u.) drifts by 2.0e-8 with
# MU-VMF and 3.3e-8 with TDVP-PS2; the bound of phase 6 leaves a factor of
# 1500 over that for the full width
CHARGE_ENERGY_DRIFT = 5e-5
# phase 8(a)'s imaginary-time steps to beta/2, and 8(c)'s bound on
# |C - C_dense| / |C(0)|
THERMAL_STEPS = 20
SPECTRA_RTOL = 1e-5
# phase 11's bounds: those of tests/test_mps.py and tests/test_apps.py
# (fp64), except where a CPU fp32 rehearsal of the same runs
# (RENO_PLATFORM=cpu RENO_DTYPE=fp32)
# could not meet them: omega-targeted DMRG 1e-8 (fp32: 1.34e-7, the
# rounding of <H> ~ 1) and arpack 1e-7 (fp32: 2.53e-6), set here to 1e-6
# and 1e-5
EXCITED_BOUNDS = dict(nroots=1e-6, omega=1e-6, arpack=1e-5, tda=2e-3, lobpcg=1e-5,
                      vscf=1e-6, vibronic=1e-3, cv_zerot=1e-3, cv_finitet=1e-4)
# phase 12(a): the two roots of state-averaged 2-site DMRG of the bench
# chain at M=64, procedure [[64, 0.4], [64, 0.2]] + [[64, 0]] * 4, from
# Mps.random(model, 1, 64, percent=1.0), by the JAX package on the CPU in
# fp64 (its last sweep)
SA_REF = (0.11503893096837466, 0.11551480196055311)
SA_TOL = 1e-5
# phase 13: H2O/STO-3G QC-DMRG (tests/test_qc.py::test_qc_dmrg_h2o) against
# the published FCI energy, nuclear repulsion included
H2O_FCIDUMP = "tests/data/h2o_fcidump.txt"
H2O_FCI = -75.008697516450
QC_M = 50
H2O_TOL_FP64 = 1e-8
# 13(b) in fp32 gates the lowest sweep energy as 13(a) does.  A CPU fp32
# rehearsal of the port (RENO_PLATFORM=cpu RENO_DTYPE=fp32 python3
# qc_host_probe.py --seeds 2019 2 3 4 5 6 7) ends 1.9e-5 below the FCI
# energy at the default seed and 1.9e-5 ... 5.8e-5 below at the others
# (seeds 0 and 1 stall 2.39e-2 above, as in fp64).  The energy of the fp32
# result evaluated in double precision is printed beside it (3.08e-6
# below on the CPU: the fp32 rounding of the MPO's coefficients)
H2O_TOL_FP32 = 1e-4
# 13(c): the bounds of tests/test_qc.py, tests/test_mps.py and
# tests/test_torch_qc.py (fp64), except where a CPU fp32 rehearsal of the
# same runs could not meet them: the 3-orbital QC-DMRG 1e-8 (fp32: 1.34e-8
# and 1.06e-7 stacked), variational_compress 1e-10 (fp32: 2.23e-5),
# DmrgFCISolver 1e-8 (fp32: 2.46e-7), OFS-S DMRG of the paired spins 1e-10
# (fp32: 8.18e-7) and TDVP-PS2 with OFS-S 1e-6 (fp32: 3.75e-5), set here to
# 5e-6, 2e-4, 5e-6, 1e-5 and 5e-4
QC_BOUNDS = dict(qc=5e-6, stacked_mpo=1e-4, ofs=1e-5, ofs_dense=1e-5, ofs_tdvp=5e-4,
                 variational=2e-4, fci_solver=5e-6)
# 13(d): padding_seed_probe.py's thermal case at these seeds of the port's
# generator, each under PADDING_TOL, the largest within PADDING_SPREAD times
# the smallest
PADDING_SEEDS = (2019, 0, 1, 2)
PADDING_TOL = 1e-5
PADDING_SPREAD = 3
# phase 14(a): tree DMRG of the DMRG model on BasisTree.binary at TREE_M,
# gated on the sweeps' lowest energy within TREE_E_TOL of E_REF (12(a)'s fp32
# gate; the JAX package's tree reaches 0.115038931 at M=16 in fp64 on the CPU)
TREE_M = 32
TREE_E_TOL = 1e-5
# phase 14(b): tests/test_pyr4.py::test_pyr4_ttns's protocol and bound
PYR_STEPS = 60
PYR_TOL = 2e-2
PYR_MCTDH = "tests/data/pyr4_mctdh.npy"
# phase 15(b): threshold-criteria DMRG from 15(a)'s converged M=256 state,
# whose phonon-phonon 2-site coefficients are (1536, 1536) of rank 1536:
# CompressCriteria.both at SKETCH_THRESHOLD and max_bonddim M, SKETCH_SWEEPS
# percent-0 sweeps.  The sketched and starved runs lower
# trunc_device.EXACT_CAP to SKETCH_EXACT_CAP, below that rank, so those
# updates sketch the default SKETCH_CAP + OVERSAMPLE = 1056 states (the
# starved run SKETCH_CAP = 1: 33 states, which the saturation check must
# reject).  The three runs' lowest energies agree to SKETCH_RTOL
# (relative); 15(c)'s energies equal 15(a)'s synchronous run's to
# OFFLOAD_RTOL
SKETCH_THRESHOLD = 1e-6
SKETCH_EXACT_CAP = 1024
SKETCH_SWEEPS = 2
SKETCH_GRAM = 1056
SKETCH_RTOL = 1e-6
OFFLOAD_RTOL = 1e-8
# phase 14(c): the bounds of tests/test_tn.py and tests/test_torch_tn*.py
# (fp64), except where a CPU fp32 rehearsal (RENO_PLATFORM=cpu
# RENO_DTYPE=fp32) could not meet them: the thermofield occupations 1e-10
# (fp32: 9.93e-9, the rounding of 1/3), its TDVP-PS energy drift 1e-6 (fp32:
# 1.55e-5) and the from_mps expectation 1e-8 (fp32: 2.38e-7, the rounding of
# <H> ~ 1), set here to 1e-6, 1e-4 and 1e-6; and the thermofield norm 1e-8,
# below fp32's resolution at 1 (the rehearsal read 0, the H100 2.98e-8, one
# unit in the last place), set here to 1e-6
TREE_BOUNDS = dict(evolve=1e-4, nroots=1e-6, thermofield_occupation=1e-6,
                   thermofield_energy=1e-4, thermofield_norm=1e-6, from_mps=1e-6)
# phase 17: the numbers the package's examples print, against fp64
# references printed by the JAX package's own examples/*.py, run unmodified
# on the CPU (JAX_PLATFORMS=cpu RENO_DTYPE=fp64) from a copy outside the
# tests.
# Each entry: the label the number follows, which numbers of the bracket or
# line are compared ("last", "first" or "all"), the reference, the
# tolerance and its scale ("abs"; "max1": times max(1, |E|); "rel": times
# |reference|)
EXAMPLE_REFS = {
    "holstein_gs.py": ("sweep energies:", "last", (0.09524617585657086,), 1e-5, "abs"),
    # within phase 13(b)'s fp32 QC bound
    "qc_dmrg.py": ("E(DMRG) =", "first", (-1.4990925922996068,), 1e-4, "abs"),
    "ttns_mctdh.py": ("tree DMRG energy:", "first", (0.08671799387880011,), 1e-5, "abs"),
    "hubbard.py": ("GS energy:", "first", (-3.09256532,), 1e-5, "max1"),
    "ssh.py": ("polaron GS energy", "first", (-1.95243584,), 1e-5, "max1"),
    "sbm_dynamics.py": ("sigma_z(t):", "all", (
        1.0, 0.9280827123363344, 0.7229138054151647, 0.41467419490226437,
        0.04867269541581348, -0.3213602832795962, -0.6412181223473458,
        -0.8642238162835435, -0.9581115609180533, -0.9097681536726996,
        -0.7271357377638008, -0.43799682727008926, -0.08582285020439484,
        0.2766983316209004, 0.5954961329261611, 0.8231494196175538,
        0.925923903077592, 0.8887689690097615, 0.7175319253948893,
        0.4380621713118031, 0.09234073078987631), 1e-3, "abs"),
    # printed rounded to 4 decimals by the example itself
    "ttns_sbm.py": ("sigma_z(t):", "all", (
        0.9801, 0.9213, 0.8264, 0.6992, 0.5449, 0.3698, 0.1809, -0.0145, -0.2085,
        -0.3936), 1e-3, "abs"),
    "absorption_spectrum.py": ("DDMRG response:", "all", (
        39.792704439405206, 15.91879742452164, 7.9588920988497, 4.6819205635274175,
        2.6529866472098282), 1e-3, "rel"),
}
# examples run in fp64 on the card (backend.use_64bits for their run): the
# example asserts more than fp32 resolves.  hubbard.py asserts its energy
# within 1e-6 of exact diagonalization; in fp32 the port's DMRG lands
# 1.65e-6 below (-3.09256697 on the CPU), and on an H100 in fp32 the
# example's assert fails as well
EXAMPLES_FP64 = ("hubbard.py",)
# fmo.py has no reference (the JAX package's run did not finish): it runs in
# a child process through the examples runner in fp32 and in fp64, each
# within its limit (seconds), and its BChl populations are checked: rows sum
# to 1 and entries lie in [0, 1] within FMO_TOL, the first row is BChl 1
# alone, the fp32 final row within FMO_FP32_TOL of the fp64 one.  The limits
# are about 3.5x the first card run's 34.6 s (fp32) and 33.8 s (fp64),
# the child process's start included (NVIDIA H100 80GB HBM3, 700 W)
FMO_TIMEOUT = {"fp32": 120, "fp64": 120}
FMO_TOL = 1e-4
FMO_FP32_TOL = 2e-3
# phase 3 times the plain version at every timed shape but these, the
# widest, where one call took 7.3-29.2 s on an H100: each is held
# against the plain version all the same
PLAIN_UNTIMED = ((1, 544, 544), (1, 384, 384), (2, SKETCH_GRAM, SKETCH_GRAM))
# phase 3's tolerances relative to ||A||_F: eigenvalues, |V^T V - I|,
# |AV - VL| (f32 ones grow as n / 288 past n = 288)
TOL_F32 = dict(eig=1e-5, orth=1e-4, resid=1e-4)
TOL_F64 = dict(eig=1e-11, orth=1e-12, resid=1e-11)
# published H100 SXM peaks at 700 W (NVIDIA data sheet): FP32 outside the
# tensor cores, HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_times_in_turns(fns, reps, warm=None):
    """Median milliseconds of each ``fns[name]()`` by CUDA events, after one
    warm-up each of those in ``warm`` (default: all); the functions take
    turns, ``reps[name]`` times each."""
    import torch

    for name, fn in fns.items():
        if warm is None or name in warm:
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for i in range(max(reps.values())):
        for name, fn in fns.items():
            if i >= reps[name]:
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def jacobi_bound_ms(bsz, n, itemsize):
    """Least time of a (bsz, n, n) symmetric eigendecomposition with
    eigenvectors on the card, and what sets it: the textbook ~9 n^3
    operations per matrix (symmetric QR with eigenvectors, Golub & Van Loan
    §8.3; about one sweep of scalar Jacobi, 9 n^2 (n - 1)) over the FP32
    peak, against each input read once and each output (V, w) written once
    over the HBM rate.  It does not depend on the sweeps a solver takes."""
    flops = 9.0 * n ** 3 * bsz
    nbytes = itemsize * bsz * (2 * n * n + n)
    ms_ops, ms_bytes = 1e3 * flops / FP32_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ms_ops, "operations") if ms_ops >= ms_bytes else (ms_bytes, "bytes")


def phase_environment():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    from renormalizer_tpu_torch.backend import backend

    check(backend.device.type == "cuda", f"port device is {backend.device}")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name} "
          f"count {torch.cuda.device_count()} port {backend.device} "
          f"fp{32 if backend.is_32bits else 64}", flush=True)
    return name, card


def phase_build():
    from renormalizer_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    print(f"[build] {_build.build_info['path']} in {seconds:.2f} s "
          f"(nvcc {_build.build_info['seconds']:.2f} s)", flush=True)
    for line in _build.build_info["log"].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"[build] {line.strip()}", flush=True)


def _symmetric(rng, shape, dtype):
    import numpy as np
    import torch

    a = rng.standard_normal(shape)
    a = (a + np.swapaxes(a, -1, -2)) / 2
    return torch.tensor(a, dtype=dtype, device="cuda")


def _eigh_errors(a, w, v):
    """Errors of (w, v) relative to ||A||_F (the norm of the Jacobi
    convergence rule): eigenvalues against torch.linalg.eigvalsh in f64,
    |V^T V - I| and |AV - V diag(w)|, each as a max over entries."""
    import torch

    a3, w2, v3 = (a, w, v) if a.ndim == 3 else (a[None], w[None], v[None])
    ad, wd, vd = a3.double(), w2.double(), v3.double()
    # an all-zero Gram (an empty sector block) has exact zero errors
    norm = torch.clamp(torch.linalg.matrix_norm(ad)[:, None], min=1e-300)
    err_w = float(((wd - torch.linalg.eigvalsh(ad)).abs() / norm).max())
    eye = torch.eye(a3.shape[-1], dtype=torch.float64, device=a.device)
    err_o = float((vd.mT @ vd - eye).abs().max())
    err_r = float(((ad @ vd - vd * wd[:, None, :]).abs() / norm[:, :, None]).max())
    return err_w, err_o, err_r


def _check_eigh(tag, errors, tol):
    err_w, err_o, err_r = errors
    check(err_w < tol["eig"], f"{tag}: eigenvalues off by {err_w:.2e}·|A|")
    check(err_o < tol["orth"], f"{tag}: |V^T V - I| = {err_o:.2e}")
    check(err_r < tol["resid"], f"{tag}: |AV - VL| = {err_r:.2e}·|A|")


def _phase3_cases():
    """Phase 3's (shape, dtype, seed) cases: cases added after the first
    runs draw from their own seeds (None: the shared stream), so the draws
    after them (the clustered case, the timed input) stay those of earlier
    runs."""
    import torch

    cases = [((n, n), dt, None) for dt in (torch.float32, torch.float64)
             for n in (16, 24, 96, 250, 288)]
    # batches at the masked path's width; 544 = l1 + l2 of a growth sweep's
    # per-sector Gram at M=256, the widest the main path solves
    cases += [((2, 288, 288), torch.float32, None),
              ((8, 288, 288), torch.float32, None),
              ((544, 544), torch.float32, 544)]
    # every (batch, n) that the SpinBosonDynamics constructor of phase 6(d)
    # solves: n below one block of 16, and n that the wrapper pads to 32, to
    # 64 (39, 48) and to 96 (75)
    cases += [((1, n, n), torch.float32, 6000 + n) for n in EVOLVE_PATH_GRAMS]
    # and every n of the TransportKubo constructor of phase 9 up to 288, and
    # its largest
    kubo_n = sorted(({n for n in KUBO_PATH_GRAMS if n <= 288}
                     | set(sorted(KUBO_PATH_GRAMS)[-1:])) - set(EVOLVE_PATH_GRAMS))
    cases += [((1, n, n), torch.float32, 7000 + n) for n in kubo_n]
    # and the n of phase 10's paths that no earlier case holds, f32 and f64
    held = set(EVOLVE_PATH_GRAMS) | set(kubo_n)
    for size, dt in ((4, torch.float32), (8, torch.float64)):
        new = sorted(set(CHARGE_PATH_GRAMS if size == 4 else ())
                     | set(THERMAL_PATH_GRAMS[size]))
        cases += [((1, n, n), dt, 8000 + n) for n in new
                  if size == 8 or n not in held]
    # phase 12's widest and most frequent shapes that no earlier case holds
    cases += [((b, n, n), torch.float32, 9000 + 10 * n + b) for b, n in EXCITED_PATH_GRAMS]
    # the sketched threshold mode's Gram of phase 15(b): two sectors of
    # trunc_device.SKETCH_CAP + OVERSAMPLE states
    cases += [((2, SKETCH_GRAM, SKETCH_GRAM), torch.float32, SKETCH_GRAM)]
    return cases


def phase3_held():
    """The (batch, n, itemsize) of every Gram shape phase 3 holds."""
    return {(shape[0] if len(shape) == 3 else 1, shape[-1], dt.itemsize)
            for shape, dt, _ in _phase3_cases()}


def phase_kernels():
    import numpy as np
    import torch

    from renormalizer_tpu_torch.ops.jacobi import (
        MAX_EXTRA_SWEEPS, default_sweeps, jacobi_eigh, jacobi_eigh_reference)

    tols = {torch.float32: TOL_F32, torch.float64: TOL_F64}
    rng = np.random.default_rng(2019)
    main_err = None
    for shape, dt, seed in _phase3_cases():
        a = _symmetric(rng if seed is None else np.random.default_rng(seed),
                       shape, dt)
        w, v = jacobi_eigh(a)
        w_p, v_p = jacobi_eigh_reference(a)
        torch.cuda.synchronize()
        tag = f"{tuple(shape)} {str(dt)[6:]}"
        grow = max(1.0, shape[-1] / 288) if dt == torch.float32 else 1.0
        tol = {k: t * grow for k, t in tols[dt].items()}
        errs, errs_p = _eigh_errors(a, w, v), _eigh_errors(a, w_p, v_p)
        err = float((w - w_p).abs().max())
        unscaled = all(e < t for found in (errs, errs_p)
                       for e, t in zip(found, tols[dt].values()))
        print(f"[kernel] {tag}: kernel eig/orth/resid "
              f"{' '.join(f'{e:.2e}' for e in errs)}; plain "
              f"{' '.join(f'{e:.2e}' for e in errs_p)}; |w - w_plain| {err:.2e}"
              + ("" if grow == 1.0 else
                 f"; within the unscaled n <= 288 tolerances: {unscaled}"),
              flush=True)
        _check_eigh(tag + " kernel", errs, tol)
        _check_eigh(tag + " plain", errs_p, tol)
        # both are within tol of the oracle, so within 2 tol of each other
        scale = float(torch.linalg.matrix_norm(a).min())
        check(err < 2 * tol["eig"] * scale,
              f"{tag}: kernel and plain eigenvalues differ by {err:.2e}")
        if tuple(shape) == (2, 288, 288):
            main_err = err
    # clustered spectrum over 12 decades with a low base sweep count: the
    # kernel must extend the sweeps and report a small residual
    lam_true = np.repeat(10.0 ** np.arange(-6, 6), 8)
    q, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    a = (q * lam_true) @ q.T
    a = torch.tensor((a + a.T) / 2, dtype=torch.float64, device="cuda")
    w, v, resid, nsweeps = jacobi_eigh(a, sweeps=2, return_resid=True,
                                       return_sweeps=True)
    lam = torch.tensor(np.sort(lam_true), dtype=torch.float64, device="cuda")
    rel = float(((w - lam).abs() / lam).max())
    absd = float((w - lam).abs().max())
    print(f"[kernel] clustered f64 sweeps=2: {int(nsweeps)} sweeps (cap "
          f"{2 + MAX_EXTRA_SWEEPS}), resid {float(resid):.2e} "
          f"eig rel {rel:.2e} abs {absd:.2e}", flush=True)
    check(float(resid) < 1e-7, f"clustered: resid {float(resid):.2e}")
    check(bool(torch.all((w - lam).abs() <= 1e-8 * lam + 1e-10)),
          "clustered: eigenvalues off")

    timed = {}
    cap = default_sweeps(torch.float32) + MAX_EXTRA_SWEEPS
    # the DMRG path's two widest shapes, the evolution path's most frequent
    # one (78 of the 403 launches of phase 6(d)), the Kubo path's widest
    # (106) and three most frequent (8, 2, 25) of phase 9, phase 12's
    # widest and batched shapes (EXCITED_PATH_GRAMS) and phase 15(b)'s
    # sketched Gram
    for shape in ((2, 288, 288), (1, 544, 544), (1, 48, 48), (1, 106, 106),
                  (1, 8, 8), (1, 2, 2), (1, 25, 25),
                  *((b, n, n) for b, n in EXCITED_PATH_GRAMS),
                  (2, SKETCH_GRAM, SKETCH_GRAM)):
        # the first timed input is drawn after the clustered case, as in
        # earlier runs; the others from their own seeds
        a = _symmetric(rng if shape[-1] == 288
                       else np.random.default_rng(10 * shape[-1] + shape[0] - 1),
                       shape, torch.float32)
        plain_out = []
        fns = {"kernel": lambda: jacobi_eigh(a),
               "torch.linalg.eigh": lambda: torch.linalg.eigh(a)}
        # the plain version is timed in one call, without a warm-up: it is
        # seconds a call and no yardstick; at the widest shapes (held
        # against it above) it is not timed at all
        if shape not in PLAIN_UNTIMED:
            fns["plain"] = lambda: plain_out.append(
                jacobi_eigh_reference(a, return_sweeps=True))
        ms = cuda_times_in_turns(fns, {"kernel": 10, "torch.linalg.eigh": 10, "plain": 1},
                                 warm=("kernel", "torch.linalg.eigh"))
        ms.setdefault("plain", None)
        sweeps = jacobi_eigh(a, return_sweeps=True)[2].tolist()
        sweeps_p = plain_out[0][2].tolist() if plain_out else []
        capped = sum(s >= cap for s in sweeps + sweeps_p)
        bound, bound_by = jacobi_bound_ms(shape[0], shape[-1], 4)
        plain_ms = "not timed" if ms["plain"] is None else f"{ms['plain']:.3f}"
        print(f"[kernel] {shape} f32 median ms: kernel {ms['kernel']:.3f} "
              f"plain {plain_ms} torch.linalg.eigh "
              f"{ms['torch.linalg.eigh']:.3f}; sweeps kernel {sweeps} plain "
              f"{sweeps_p or 'not run'} (cap {cap}), {capped} timed solves at the cap; "
              f"bound {bound:.6f} ms ({bound_by})", flush=True)
        check(capped == 0, f"{shape}: {capped} timed solves ran to the sweep cap")
        timed[shape] = dict(ms, bound_ms=bound, bound_by=bound_by)
    return dict(max_abs_err=main_err, timed=timed, tol_f32=tols[torch.float32])


class GramRecord:
    """Stands in for ``trunc_device.jacobi_eigh`` while a path runs: the
    shape of every Gram eigh, its residual and sweep count left on the device
    (no sync per launch), and with ``keep_grams`` every Gram with the
    eigenpairs the kernel gave for it."""

    def __init__(self, keep_grams=False):
        self.grams, self.kept, self.keep_grams = [], {}, keep_grams
        self.itemsizes = []

    def shapes(self):
        """The (batch, n, itemsize) of every launch."""
        return [(b, n, size) for (b, n, _, _), size in zip(self.grams, self.itemsizes)]

    def __call__(self, g, *args, **kwargs):
        from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

        key = (g.shape[0] if g.ndim == 3 else 1, g.shape[-1])
        copy = g.clone() if self.keep_grams else None
        w, v, resid, nsweeps = jacobi_eigh(g, *args, return_resid=True,
                                           return_sweeps=True, **kwargs)
        self.grams.append(key + (resid.reshape(-1), nsweeps.reshape(-1)))
        self.itemsizes.append(g.element_size())
        if self.keep_grams:
            n = key[1]
            self.kept.setdefault((n, g.element_size()), []).append(
                (copy.reshape(-1, n, n), w.reshape(-1, n), v.reshape(-1, n, n)))
        return w, v

    def report(self, tag, launches):
        """Read the record back (one sync), print it and fail on a launch
        that ran to the sweep cap; returns the (batch, n) histogram."""
        import torch

        from renormalizer_tpu_torch.ops.jacobi import (
            MAX_EXTRA_SWEEPS, default_sweeps)

        cap = default_sweeps(torch.float32) + MAX_EXTRA_SWEEPS
        sweeps = [t[3].tolist() for t in self.grams]
        resid_max = (float(torch.cat([t[2] for t in self.grams]).max())
                     if self.grams else 0.0)
        at_cap = sum(max(s) >= cap for s in sweeps)
        hist = collections.Counter((b, n) for b, n, _, _ in self.grams)
        if len(set(self.itemsizes)) > 1:
            hist = collections.Counter(
                (b, n, f"f{8 * size}") for b, n, size in self.shapes())
        sweep_hist = collections.Counter(x for s in sweeps for x in s)
        print(f"{tag} Gram eigh launches at the sweep cap ({cap}): {at_cap} of "
              f"{len(self.grams)}; sweeps per solve "
              f"{dict(sorted(sweep_hist.items()))}; largest resid "
              f"{resid_max:.2e}", flush=True)
        print(f"{tag} (batch, n) of the launches: {dict(sorted(hist.items()))}",
              flush=True)
        check(len(self.grams) == launches,
              f"{tag} {len(self.grams)} recorded Grams, {launches} launches")
        check(at_cap == 0, f"{tag} {at_cap} launches ran to the sweep cap")
        return hist

    def check_against_plain(self, tag, tol, only=None):
        """Every kept Gram (or those of the (n, itemsize) in ``only``), with
        the eigenpairs the kernel gave the path, against the plain version on
        the same Gram (one batch per padded size,
        ``jacobi_eigh_reference_stacks``): both inside the phase-3
        tolerances (relative to ||A||_F, grown as n / 288 past n = 288 in
        f32), and their eigenvalues within twice the eigenvalue tolerance of
        each other."""
        import torch

        from renormalizer_tpu_torch.ops.jacobi import (
            jacobi_eigh_reference_stacks, padded_size)

        groups = collections.defaultdict(list)
        for (n, size), kept in sorted(self.kept.items()):
            if only is None or (n, size) in only:
                groups[(padded_size(n), size)].append(
                    [torch.cat(parts) for parts in zip(*kept)])
        worst, count = 0.0, 0
        for group in groups.values():
            plain = jacobi_eigh_reference_stacks([g for g, _, _ in group])
            for (g, w, v), (w_p, v_p) in zip(group, plain):
                n = g.shape[-1]
                # phase 3's rule: f32 tolerances grow as n / 288 past n = 288
                grow = max(1.0, n / 288) if g.dtype == torch.float32 else 1.0
                tol_n = {k: t * grow for k, t in tol.items()}
                _check_eigh(f"{tag} n={n} kernel", _eigh_errors(g, w, v), tol_n)
                _check_eigh(f"{tag} n={n} plain", _eigh_errors(g, w_p, v_p), tol_n)
                # in f64: an all-zero Gram has exact zero eigenvalues
                scale = torch.clamp(torch.linalg.matrix_norm(g.double())[:, None],
                                    min=1e-300)
                err = float(((w - w_p).abs() / scale).max())
                check(err < 2 * tol_n["eig"], f"{tag} n={n}: kernel and plain "
                      f"eigenvalues differ by {err:.2e}·|A|")
                worst, count = max(worst, err), count + len(g)
        print(f"{tag} the path's own {count} Grams: kernel (as the path got "
              f"it) and plain inside the phase-3 tolerances; largest "
              f"|w - w_plain| {worst:.2e}·|A|", flush=True)

    def check_against_library(self, tag, tol):
        """Every kept Gram, with the eigenpairs the kernel gave the path,
        solved again by torch.linalg.eigh (in f64): the kernel's eigenvalues,
        |V^T V - I| and |AV - VL| inside the phase-3 f32 tolerances (relative
        to ||A||_F, grown as n / 288 past n = 288)."""
        import torch

        worst, count = [0.0, 0.0, 0.0], 0
        for (n, _), kept in sorted(self.kept.items()):
            g, w, v = (torch.cat(parts) for parts in zip(*kept))
            grow = max(1.0, n / 288)
            errs = _eigh_errors(g, w, v)
            _check_eigh(f"{tag} n={n} kernel", errs, {k: t * grow for k, t in tol.items()})
            worst = [max(a, b) for a, b in zip(worst, errs)]
            count += len(g)
        print(f"{tag} the path's own {count} Grams against torch.linalg.eigh: "
              f"inside the phase-3 tolerances; largest eig/orth/resid "
              f"{' '.join(f'{e:.2e}' for e in worst)}", flush=True)


def phase_main_path(card):
    import numpy as np
    import torch

    from renormalizer_tpu_torch import Mpo, Mps, optimize_mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

    model = holstein_chain(6)
    check(model.nsite == 18, f"bench model has {model.nsite} sites")
    mpo = Mpo(model)
    mps = Mps.random(model, 1, M, percent=1.0)
    mps.optimize_config.procedure = PROCEDURE
    mps.optimize_config.method = "2site"

    sweep_times = []
    single_sweep = gs.single_sweep

    def timed_sweep(*args, **kwargs):
        backend.sync()
        t0 = time.perf_counter()
        out = single_sweep(*args, **kwargs)
        backend.sync()
        sweep_times.append(time.perf_counter() - t0)
        return out

    grams = GramRecord()
    gs.single_sweep = timed_sweep
    trunc_device.jacobi_eigh = grams
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        t0 = time.perf_counter()
        energies, opt = optimize_mps(mps, mpo)
        backend.sync()
        total = time.perf_counter() - t0
        launches = jacobi_eigh.launches
        elsewhere = trunc_device.LINALG_EIGH_GRAMS
    finally:
        gs.single_sweep = single_sweep
        trunc_device.jacobi_eigh = jacobi_eigh
    e_min = float(min(energies))
    print(f"[main] energies per sweep: {[float(e) for e in energies]}", flush=True)
    print(f"[main] sweep seconds ({card}): "
          f"{[round(t, 4) for t in sweep_times]}; total {total:.2f} s", flush=True)
    print(f"[main] lowest energy {e_min:.10f} (reference {E_REF}, "
          f"diff {e_min - E_REF:+.3e}); bond dims {opt.bond_dims}", flush=True)
    print(f"[main] jacobi launches {launches}; Gram eigh elsewhere {elsewhere}",
          flush=True)
    grams.report("[main]", launches)
    check(abs(e_min - E_REF) < E_TOL,
          f"energy {e_min} not within {E_TOL} of {E_REF}")
    check(launches > 0, "the main path never launched the Jacobi kernel")
    check(elsewhere == 0, f"{elsewhere} Gram eigh went around the kernel")
    check(max(opt.bond_dims) <= M and len(opt) == 18, "bad result shape")
    check(all(bool(torch.isfinite(t).all()) for t in opt), "non-finite MPS")
    e_exp = opt.expectation(mpo)
    print(f"[main] <psi|H|psi> of the result {e_exp:.10f}", flush=True)
    check(abs(e_exp - e_min) < 1e-5, f"expectation {e_exp} vs energy {e_min}")
    return launches, total, dict(energy=e_min, sweeps=sweep_times, total=total)


def dense_operator(model, terms):
    """Dense matrix of a sum of ``Op`` terms, kron-assembled from
    ``basis.op_mat`` (independent of the port's MPO compiler)."""
    import numpy as np

    dim = int(np.prod(model.pbond_list))
    dense = np.zeros((dim, dim), dtype=complex)
    for op in terms:
        elem_ops, factor = op.split_elementary(model.dof_to_siteidx)
        site_mats = {
            model.dof_to_siteidx[e.dofs[0]]: model.dof_to_basis[e.dofs[0]].op_mat(e)
            for e in elem_ops
        }
        full = np.eye(1)
        for i, b in enumerate(model.basis):
            full = np.kron(full, site_mats.get(i, np.eye(b.nbas)))
        dense = dense + factor * full
    return dense


def _all_finite(mps):
    import torch

    return all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all())
               for t in mps)


def phase_oracle(nsteps=10, dt=0.2):
    """Phase 5: TDVP-PS against scipy.linalg.expm on two small models."""
    import numpy as np
    import scipy.linalg

    from renormalizer_tpu_torch import (
        EvolveConfig, EvolveMethod, HolsteinModel, Mol, Mpo, Mps, Op, Phonon,
        Quantity)
    from renormalizer_tpu_torch.sbm import SpinBosonDynamics, param2mollist

    def propagate(h, psi0, observables):
        out = []
        for i in range(1, nsteps + 1):
            psi = scipy.linalg.expm(-1j * dt * i * h) @ psi0
            out.append([np.real(psi.conj() @ o @ psi) for o in observables])
        return np.array(out)

    # the 3-molecule, 2-level Holstein model: a^dagger_0 |gs>, expanded with
    # the Hamiltonian as hint, H offset by the initial energy
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    mps = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
    mps = mps.expand_bond_dimension(hint_mpo=Mpo(model))
    e0 = mps.expectation(Mpo(model))
    mpo = Mpo(model, offset=Quantity(e0))
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    h = dense_operator(model, model.ham_terms)
    h = h - e0 * np.eye(len(h))
    occ = [dense_operator(model, [Op(r"a^\dagger a", dof)]) for dof in model.e_dofs]
    oracle = propagate(h, mps.todense().astype(complex), occ)
    deviations = []
    for i in range(nsteps):
        mps = mps.evolve(mpo, dt)
        deviations.append(float(np.abs(mps.e_occupations - oracle[i]).mean()))
        check(abs(mps.mp_norm - 1) < 1e-5, f"[oracle] holstein norm {mps.mp_norm}")
        check(_all_finite(mps), "[oracle] holstein: non-finite MPS")
    mcd = float(np.mean(deviations))
    print(f"[oracle] holstein 3x2: e_occupations mean cumulative deviation "
          f"{mcd:.3e} over {nsteps} steps of {dt} (bond dims {mps.bond_dims})",
          flush=True)
    check(mcd < 1e-4, f"[oracle] holstein deviation {mcd}")

    # a 3-mode spin-boson model through the job class
    model = param2mollist(0.05, Quantity(1), Quantity(20), 1, 3)
    job = SpinBosonDynamics(model, evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
    job.evolve(evolve_dt=dt, nsteps=nsteps)
    h = dense_operator(model, model.ham_terms)
    psi0 = np.zeros(len(h), dtype=complex)
    psi0[0] = 1.0  # spin up, bath vacuum
    oracle = propagate(h, psi0, [dense_operator(model, [Op("sigma_z", "spin")])])[:, 0]
    sigma_z = np.array(job.sigma_z)
    mcd = float(np.abs(sigma_z[1:] - oracle).mean())
    norm = job.latest_mps.mp_norm
    print(f"[oracle] spin-boson 3 modes: sigma_z mean cumulative deviation "
          f"{mcd:.3e}; sigma_z(t) {[round(float(x), 6) for x in sigma_z]}; "
          f"norm {norm:.7f}", flush=True)
    check(sigma_z[0] == 1.0, f"[oracle] sigma_z(0) = {sigma_z[0]}")
    check(mcd < 1e-4, f"[oracle] spin-boson deviation {mcd}")
    check(abs(norm - 1) < 1e-5, f"[oracle] spin-boson norm {norm}")
    check(_all_finite(job.latest_mps) and np.isfinite(sigma_z).all(),
          "[oracle] spin-boson: non-finite result")


def holstein_chain(levels, dipole=None):
    """The bench.py chain: 6 molecules x 2 modes of ``levels`` levels (with
    a transition dipole for the spectra)."""
    from renormalizer_tpu_torch import HolsteinModel, Mol, Phonon, Quantity

    ph_list = [Phonon.simple_phonon(Quantity(w, "cm-1"), Quantity(d), levels)
               for w, d in zip([106.51, 1555.55], [30.1370, 8.7729])]
    mol = Mol(Quantity(2.67, "eV"), ph_list, dipole)
    return HolsteinModel([mol] * 6, Quantity(-0.1, "eV"))


class StepChecks:
    """The per-step checks of phase 6: norm, energy against the first
    reading, finiteness."""

    def __init__(self, tag, mpo, state_of=lambda state: state):
        self.tag, self.mpo, self.state_of = tag, mpo, state_of
        self.energies, self.norms = [], []

    def __call__(self, state):
        mps = self.state_of(state)
        energy, norm = mps.expectation(self.mpo), mps.mp_norm
        self.energies.append(float(complex(energy).real))
        self.norms.append(norm)
        check(abs(complex(energy).imag) <= ENERGY_RTOL * max(1.0, abs(energy)),
              f"{self.tag}: <H> = {energy} is not real")
        check(_all_finite(mps), f"{self.tag}: non-finite MPS")
        check(abs(norm - 1) < NORM_TOL, f"{self.tag}: norm {norm}")
        e0 = self.energies[0]
        check(abs(self.energies[-1] - e0) <= ENERGY_RTOL * max(1.0, abs(e0)),
              f"{self.tag}: <H> moved from {e0} to {self.energies[-1]}")

    def report(self):
        e0 = self.energies[0]
        drift = max(abs(e - e0) for e in self.energies)
        print(f"{self.tag} <H> {e0:.8f}, largest drift {drift:.3e} "
              f"({drift / max(1.0, abs(e0)):.2e} of max(1, |E|), allowed "
              f"{ENERGY_RTOL:.0e}); norms {[round(x, 7) for x in self.norms]}",
              flush=True)


def run_steps(tag, card, step, state, checks, nsteps=3):
    """One first step (bond growth, plan caching) and ``nsteps - 1`` timed
    ones, each between two device syncs.  ``step(state)`` returns the next
    state; ``checks(state)`` runs outside the timed region."""
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import mps as mps_module

    visits0 = dict(mps_module.TDVP_PS_VISITS)
    seconds = []
    for _ in range(nsteps):
        backend.sync()
        t0 = time.perf_counter()
        state = step(state)
        backend.sync()
        seconds.append(time.perf_counter() - t0)
        checks(state)
    visits = {k: v - visits0[k] for k, v in mps_module.TDVP_PS_VISITS.items()}
    print(f"{tag} ({card}) first step {seconds[0]:.4f} s; timed steps "
          f"{[round(t, 4) for t in seconds[1:]]} s; site visits {visits}",
          flush=True)
    checks.report()
    return state, seconds


def phase_evolution(card, profile, gram_tol, m_small=48, m_large=256, nph=31):
    """Phase 6 (and 7 with ``profile``): TDVP-PS at full width.  ``gram_tol``
    are phase 3's f32 tolerances, for the Grams that (d) solves."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch import (
        CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod, Mpo, Mps,
        Quantity)
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.sbm import SpinBosonDynamics, param2mollist

    dt = 0.2
    tdvp = EvolveConfig(EvolveMethod.tdvp_ps, adaptive=False)
    sbm_model = param2mollist(0.05, Quantity(1), Quantity(20), 1, nph)
    timed = {}
    for tag, model, qntot, m in (
            ("[evolve a] spin-boson %d sites M=%d" % (nph + 1, m_small),
             sbm_model, 0, m_small),
            ("[evolve b] holstein 6x(1+2) 4 levels qntot=1 M=%d" % m_small,
             holstein_chain(4), 1, m_small),
            ("[evolve c] holstein 6x(1+2) 6 levels qntot=1 M=%d" % m_large,
             holstein_chain(6), 1, m_large)):
        mpo = Mpo(model)
        mps = Mps.random(model, qntot, m, percent=1.0)
        mps.evolve_config = tdvp
        checks = StepChecks(tag, mpo)
        checks(mps)
        mps, seconds = run_steps(tag, card, lambda s: s.evolve(mpo, dt), mps, checks)
        print(f"{tag} bond dims {mps.bond_dims}; complex {mps.is_complex}",
              flush=True)
        check(mps.is_complex and max(mps.bond_dims) <= m, f"{tag}: bad result")
        timed[tag[8]] = seconds[1:]
        if profile:
            phase_profile_step(card, tag[:10], lambda: mps.evolve(mpo, dt))

    # (d) the job entry point: ground_state -> expand_bond_dimension ->
    # process_mps on a real state, then steps whose measurements compress a
    # complex state
    tag = "[evolve d] SpinBosonDynamics %d sites M=%d" % (nph + 1, m_small)
    grams = GramRecord(keep_grams=True)
    trunc_device.jacobi_eigh = grams
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        trunc_device.SVD_BLOCKS = 0
        backend.sync()
        t0 = time.perf_counter()
        job = SpinBosonDynamics(
            sbm_model, compress_config=CompressConfig(CompressCriteria.fixed,
                                                      max_bonddim=m_small),
            evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
        backend.sync()
        construct_s = time.perf_counter() - t0
        launches, elsewhere = jacobi_eigh.launches, trunc_device.LINALG_EIGH_GRAMS
        svd_blocks = trunc_device.SVD_BLOCKS
    finally:
        trunc_device.jacobi_eigh = jacobi_eigh
    print(f"{tag} constructor {construct_s:.3f} s: jacobi launches {launches}, "
          f"Gram eigh elsewhere {elsewhere}, sector blocks of compress factored "
          f"by torch.linalg.svd {svd_blocks}; start bond dims "
          f"{job.latest_mps.bond_dims}; real {not job.latest_mps.is_complex}",
          flush=True)
    # the constructor's compresses factor by SVD, not by a Gram eigh
    check(svd_blocks > 0, f"{tag}: the constructor's compress factored no sector block")
    hist = grams.report(tag[:10], launches)
    if (nph, m_small) == (31, 48):
        unheld = sorted(set(hist) - {(1, n) for n in EVOLVE_PATH_GRAMS})
        print(f"{tag} Gram shapes that phase 3 did not hold (EVOLVE_PATH_GRAMS): "
              f"{unheld}", flush=True)
    grams.check_against_plain(tag[:10], gram_tol)
    check(elsewhere == 0, f"{tag}: {elsewhere} real Gram eigh went around the kernel")
    check(not job.latest_mps.is_complex, f"{tag}: the start state is complex")
    check(max(job.latest_mps.bond_dims) == m_small, f"{tag}: bonds did not expand")
    checks = StepChecks(tag, job.h_mpo, state_of=lambda j: j.latest_mps)
    checks(job)
    trunc_device.SVD_BLOCKS = 0
    _, seconds = run_steps(
        tag, card, lambda j: j.evolve(evolve_dt=dt, nsteps=1), job, checks)
    complex_grams = trunc_device.LINALG_EIGH_GRAMS
    step_svd_blocks = trunc_device.SVD_BLOCKS
    sigma_z = np.array(job.sigma_z)
    print(f"{tag} jacobi launches {jacobi_eigh.launches}, complex Gram eigh "
          f"through torch.linalg.eigh {complex_grams}, complex sector blocks of "
          f"the steps' compresses factored by torch.linalg.svd {step_svd_blocks}; "
          f"sigma_z(t) {[round(float(x), 6) for x in sigma_z]}; bond dims "
          f"{job.latest_mps.bond_dims}", flush=True)
    check(sigma_z[0] == 1.0, f"{tag}: sigma_z(0) = {sigma_z[0]}")
    check(np.isfinite(sigma_z).all() and np.abs(sigma_z).max() <= 1 + 1e-5,
          f"{tag}: sigma_z out of range: {sigma_z}")
    # the steps compress the complex state: by SVD, not by a Gram eigh
    check(step_svd_blocks > 0, f"{tag}: the steps' compresses factored no sector block")
    timed["d"] = seconds[1:]
    if profile:
        phase_profile_step(card, tag[:10],
                           lambda: job.evolve(evolve_dt=dt, nsteps=1))
    return launches, timed


def _sector_of(model, dim):
    """Exciton number of every dense basis state of ``model``."""
    import numpy as np

    dims = model.pbond_list
    return np.array([sum(model.basis[i].sigmaqn[np.unravel_index(s, dims)[i]][0]
                         for i in range(len(dims))) for s in range(dim)])


def phase_finite_t_oracles():
    """Phase 8: the finite-temperature path on small models against dense
    oracles, with the JAX package's own tests' bounds."""
    import numpy as np
    import scipy.linalg

    from renormalizer_tpu_torch import (
        CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod,
        HolsteinModel, MpDm, Mol, Mpo, Mps, Op, Phonon, Quantity, ThermalProp)
    from renormalizer_tpu_torch.spectra import SpectraFiniteT
    from renormalizer_tpu_torch.transport import TransportKubo
    from renormalizer_tpu_torch.transport.kubo import (
        derive_current_terms, pbc_chain_distances)

    tdvp = EvolveConfig(EvolveMethod.tdvp_ps)
    # (a) the thermal state of tests/test_apps.py:540-550: 3 molecules, one
    # 3-level phonon each, 1500 K.  That test takes beta/2 (105 a.u.) in 10
    # TDVP-PS steps in fp64 (occupations 6.6e-6 off the dense ones on the
    # CPU); in fp32 steps that long leave 2.2e-4 (the CPU), 20 steps 4.6e-7
    ph = Phonon.simple_phonon(Quantity(1.0), Quantity(0.6), 3)
    model = HolsteinModel([Mol(Quantity(0.0), [ph], 1.0)] * 3, Quantity(0.1))
    beta = Quantity(1500.0, "K").to_beta()
    t0 = time.perf_counter()
    tp = ThermalProp(MpDm.max_entangled_ex(model), evolve_config=tdvp)
    tp.evolve(None, THERMAL_STEPS, beta / 2j)
    seconds = time.perf_counter() - t0
    h = dense_operator(model, model.ham_terms).real
    s1 = np.nonzero(_sector_of(model, len(h)) == 1)[0]
    rho = scipy.linalg.expm(-beta * h[np.ix_(s1, s1)])
    rho /= np.trace(rho)
    pops = np.array([np.trace(rho @ dense_operator(model, [Op(r"a^\dagger a", dof)])
                              .real[np.ix_(s1, s1)]) for dof in model.e_dofs])
    occ = tp.e_occupations_array[-1]
    dev = float(np.abs(occ - pops).max())
    print(f"[finite-T a] ThermalProp 3 molecules x 3 levels, 1500 K, "
          f"{THERMAL_STEPS} TDVP-PS steps in {seconds:.2f} s: occupations {np.round(occ, 6).tolist()}, "
          f"dense {np.round(pops, 6).tolist()}, largest deviation {dev:.3e} "
          f"(bound 1e-4); energies {np.round(tp.energies, 6).tolist()}", flush=True)
    check(_all_finite(tp.latest_mps), "[finite-T a] non-finite density matrix")
    check(dev < 1e-4, f"[finite-T a] occupations off the dense ones by {dev}")

    # (b) TransportKubo of tests/test_apps.py:425-430 with fixed steps
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 5, Quantity(1), 3)
    temperature = Quantity(50000, "K")
    t0 = time.perf_counter()
    kubo = TransportKubo(
        model, temperature,
        compress_config=CompressConfig(CompressCriteria.fixed, max_bonddim=24),
        ievolve_config=EvolveConfig(EvolveMethod.tdvp_ps), insteps=10,
        evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
    kubo.evolve(evolve_dt=0.5, nsteps=10)
    seconds = time.perf_counter() - t0
    h = dense_operator(model, model.ham_terms).real
    s1 = np.nonzero(_sector_of(model, len(h)) == 1)[0]
    h1 = h[np.ix_(s1, s1)]
    bare, _ = derive_current_terms(model, pbc_chain_distances(model.n_edofs))
    j1 = dense_operator(model, bare).real[np.ix_(s1, s1)]
    rho = scipy.linalg.expm(-temperature.to_beta() * h1)
    rho /= np.trace(rho)
    energies, vecs = np.linalg.eigh(h1)
    rho_e, j_e = vecs.T @ rho @ vecs, vecs.T @ j1 @ vecs
    oracle = np.array([
        -np.trace(rho_e @ ((np.exp(1j * energies * t)[:, None] * j_e)
                           * np.exp(-1j * energies * t)[None, :]) @ j_e)
        for t in kubo.evolve_times_array])
    corr = kubo.auto_corr
    rel = np.abs(corr - oracle) / np.abs(oracle)
    print(f"[finite-T b] TransportKubo 5 molecules, 50000 K, M=24, 10 + 10 "
          f"TDVP-PS steps in {seconds:.2f} s: largest |C - C_dense| / |C_dense| "
          f"{rel.max():.3e} (bound 5e-2); C(t) "
          f"{[complex(round(c.real, 5), round(c.imag, 5)) for c in corr]}", flush=True)
    check(np.isfinite(corr).all(), "[finite-T b] non-finite C(t)")
    check(bool(np.all(np.abs(corr - oracle) <= 5e-2 * np.abs(oracle) + 1e-8)),
          f"[finite-T b] C(t) off the dense oracle by {rel.max()}")

    # (c) SpectraFiniteT("abs") of tests/test_apps.py:495-501
    ph = Phonon.simple_phonon(Quantity(1.0), Quantity(0.4), 2)
    model = HolsteinModel([Mol(Quantity(1.0), [ph], 1.0)] * 2, Quantity(0.2))
    temperature = Quantity(0.2, "a.u.")
    dt, n = 0.4, 5
    job = SpectraFiniteT(model, "abs", temperature, 20, Quantity(0), evolve_config=tdvp)
    job.evolve(evolve_dt=dt, nsteps=n)
    h = dense_operator(model, model.ham_terms)
    s0 = np.nonzero(_sector_of(model, len(h)) == 0)[0]
    rho_h = np.zeros_like(h)
    rho_h[np.ix_(s0, s0)] = scipy.linalg.expm(-temperature.to_beta() / 2 * h[np.ix_(s0, s0)])
    rho_h /= np.linalg.norm(rho_h)
    mu = dense_operator(model, [Op(r"a^\dagger", d, 1.0) for d in model.e_dofs])
    u = scipy.linalg.expm(-1j * h * dt)
    u_gs = scipy.linalg.expm(1j * dense_operator(
        model, [Op(r"b^\dagger b", d, 1.0) for d in model.v_dofs]) * dt)
    ket = mu @ rho_h
    bra = ket.copy()
    oracle = [np.trace(bra.conj().T @ ket)]
    for i in range(1, n + 1):
        if i % 2 == 1:
            ket = u @ ket @ u_gs
        else:
            bra = u.conj().T @ bra @ u_gs.conj().T
        oracle.append(np.trace(bra.conj().T @ ket))
    dev = float(np.abs(np.asarray(job.autocorr) - np.array(oracle)).max() / abs(oracle[0]))
    print(f"[finite-T c] SpectraFiniteT abs, 2 molecules, {n} TDVP-PS steps of "
          f"{dt}: largest |C - C_dense| {dev:.3e} of |C(0)| (bound "
          f"{SPECTRA_RTOL:.0e})", flush=True)
    check(dev < SPECTRA_RTOL, f"[finite-T c] autocorrelation off by {dev}")

    # (d) the P&C family on tests/fixtures.py's exact_model from the start
    # state of tests/test_evolve.py:36-42, as tests/test_evolve.py:71-97
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    init = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
    init = init.expand_bond_dimension(hint_mpo=Mpo(model))
    e0 = init.expectation(Mpo(model))
    mpo = Mpo(model, offset=Quantity(e0))
    h = dense_operator(model, model.ham_terms) - e0 * np.eye(2 ** 6)
    occ_ops = [dense_operator(model, [Op(r"a^\dagger a", dof)]) for dof in model.e_dofs]
    psi0 = init.todense().astype(complex)
    for tag, config, dt, nsteps in (
            ("P&C", EvolveConfig(EvolveMethod.prop_and_compress), 0.2, 10),
            ("P&C adaptive", EvolveConfig(EvolveMethod.prop_and_compress,
                                          adaptive=True, guess_dt=0.2), 1.0, 2),
            ("tdrk4", EvolveConfig(EvolveMethod.prop_and_compress_tdrk4), 0.2, 10),
            ("tdrk", EvolveConfig(EvolveMethod.prop_and_compress_tdrk), 0.2, 10)):
        mps = init.copy()
        mps.compress_config = CompressConfig(CompressCriteria.fixed)
        mps.evolve_config = config
        deviations = []
        t0 = time.perf_counter()
        for i in range(1, nsteps + 1):
            mps = mps.evolve(mpo, dt)
            psi = scipy.linalg.expm(-1j * h * dt * i) @ psi0
            dense = [np.real(psi.conj() @ o @ psi) for o in occ_ops]
            deviations.append(float(np.abs(mps.e_occupations - dense).mean()))
        mcd = float(np.mean(deviations))
        print(f"[finite-T d] {tag}: {nsteps} steps of {dt} in "
              f"{time.perf_counter() - t0:.2f} s, e_occupations mean cumulative "
              f"deviation {mcd:.3e} (bound 1e-4), bond dims {mps.bond_dims}",
              flush=True)
        check(_all_finite(mps), f"[finite-T d] {tag}: non-finite MPS")
        check(mcd < 1e-4, f"[finite-T d] {tag}: deviation {mcd}")


def phase_kubo(card, profile, gram_tol, m=64, insteps=10, nsteps=5):
    """Phase 9: ``TransportKubo`` at full width on the bench chain (and with
    ``profile`` one more real-time step under torch.profiler, phase 7).
    Returns the Jacobi launches of the job's constructor, the seconds per
    imaginary-time step and per timed real-time step."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch import (
        CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod, MpDm,
        Mpo, Quantity)
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import thermalprop, trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.transport import kubo as kubo_module

    tag = f"[kubo] holstein 6x(1+2) 6 levels, 298 K, M={m}"
    model = holstein_chain(6)
    thermal_seconds, props = [], []
    base = thermalprop.ThermalProp

    class TimedThermalProp(base):
        """The job's ThermalProp, kept, with each step between two syncs."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            props.append(self)

        def evolve_single_step(self, evolve_dt):
            backend.sync()
            t0 = time.perf_counter()
            out = super().evolve_single_step(evolve_dt)
            backend.sync()
            thermal_seconds.append(time.perf_counter() - t0)
            return out

    grams = GramRecord(keep_grams=True)
    kubo_module.ThermalProp = TimedThermalProp
    trunc_device.jacobi_eigh = grams
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        trunc_device.SVD_BLOCKS = 0
        backend.sync()
        t0 = time.perf_counter()
        kubo = kubo_module.TransportKubo(
            model, Quantity(298, "K"),
            compress_config=CompressConfig(CompressCriteria.fixed, max_bonddim=m),
            ievolve_config=EvolveConfig(EvolveMethod.tdvp_ps), insteps=insteps,
            evolve_config=EvolveConfig(EvolveMethod.tdvp_ps))
        backend.sync()
        construct_s = time.perf_counter() - t0
        launches, elsewhere = jacobi_eigh.launches, trunc_device.LINALG_EIGH_GRAMS
        svd_blocks = trunc_device.SVD_BLOCKS
    finally:
        kubo_module.ThermalProp = base
        trunc_device.jacobi_eigh = jacobi_eigh
    tp = props[0]
    rho = tp.latest_mps
    n_e = float(tp.e_occupations_array[-1].sum())
    print(f"{tag}: constructor {construct_s:.2f} s, of it {sum(thermal_seconds):.2f} s "
          f"in {len(thermal_seconds)} imaginary-time steps "
          f"({[round(t, 4) for t in thermal_seconds]} s; "
          f"{np.mean(thermal_seconds):.4f} s/step, {card}); init_mps (current "
          f"operator applied and compressed) and expansion "
          f"{construct_s - sum(thermal_seconds):.2f} s; thermal bond dims "
          f"{rho.bond_dims}", flush=True)
    print(f"{tag}: thermal energies {np.round(tp.energies, 6).tolist()}; "
          f"sum of e-occupations at beta/2 {n_e:.7f}", flush=True)
    check(_all_finite(rho), f"{tag}: non-finite thermal state")
    check(abs(n_e - 1) < 1e-4, f"{tag}: sum of electronic occupations {n_e}")
    check(tp.energies[-1] < tp.energies[0],
          f"{tag}: energy at beta/2 {tp.energies[-1]} not below {tp.energies[0]}")
    print(f"{tag}: jacobi launches {launches}, real Gram eigh elsewhere "
          f"{elsewhere}, sector blocks of compress factored by torch.linalg.svd "
          f"{svd_blocks}", flush=True)
    # the job's compresses factor by SVD, not by a Gram eigh
    check(svd_blocks > 0, f"{tag}: the job's compress factored no sector block")
    check(elsewhere == 0, f"{tag}: {elsewhere} real Gram eigh went around the kernel")
    grams.report("[kubo]", launches)
    if m == 64:
        _hold_unheld("[kubo]", grams, {(1, n, 4) for n in KUBO_PATH_GRAMS}, gram_tol)
    grams.check_against_library("[kubo]", gram_tol)

    pairs = kubo.latest_mps
    bra, ket = pairs.bra_mps, pairs.ket_mps
    check(isinstance(bra, MpDm) and not bra.is_complex, f"{tag}: bad start pair")
    readings = {"bra": [], "ket": []}

    def step_checks(job):
        for name, mp in zip(("bra", "ket"), job.latest_mps):
            norm = mp.mp_norm * abs(mp.coeff)
            energy = complex(mp.expectation(job.h_mpo)).real
            readings[name].append((norm, energy))
            n0, e0 = readings[name][0]
            check(_all_finite(mp), f"{tag}: non-finite {name}")
            check(abs(norm - n0) <= NORM_TOL * n0, f"{tag}: {name} norm {n0} -> {norm}")
            check(abs(energy - e0) <= ENERGY_RTOL * max(1.0, abs(e0)),
                  f"{tag}: {name} <H> moved from {e0} to {energy}")

    step_checks(kubo)
    complex0 = trunc_device.LINALG_EIGH_GRAMS
    seconds = []
    for _ in range(nsteps):
        backend.sync()
        t0 = time.perf_counter()
        kubo.evolve(evolve_dt=20.0, nsteps=1)
        backend.sync()
        seconds.append(time.perf_counter() - t0)
        step_checks(kubo)
    corr = kubo.auto_corr
    drift = {k: max(abs(e - v[0][1]) for _, e in v) for k, v in readings.items()}
    print(f"{tag}: real-time steps of 20 a.u. (bra and ket one TDVP-PS step each, "
          f"then ft; {card}): first {seconds[0]:.4f} s, timed "
          f"{[round(t, 4) for t in seconds[1:]]} s; <H> drift bra {drift['bra']:.3e} "
          f"ket {drift['ket']:.3e}; complex Gram eigh through torch.linalg.eigh "
          f"{trunc_device.LINALG_EIGH_GRAMS - complex0}", flush=True)
    print(f"{tag}: C(t) {[f'{c:.6e}' for c in corr]}; "
          f"mobility {kubo.calc_mobility()[1]:.6g} cm^2/(V s) over "
          f"{kubo.evolve_times[-1]:.0f} a.u.", flush=True)
    c0 = abs(corr[0])
    check(np.isfinite(corr).all(), f"{tag}: non-finite C(t)")
    check(abs(corr[0].imag) <= 1e-4 * c0, f"{tag}: C(0) = {corr[0]} is not real")
    check(bool(np.all(np.abs(corr) <= 1.001 * c0)), f"{tag}: |C(t)| grew past |C(0)|")
    if profile:
        phase_profile_step(card, "[kubo]", lambda: kubo.evolve(evolve_dt=20.0, nsteps=1))
    return launches, thermal_seconds, seconds[1:]


def _ivp_delta(before):
    from renormalizer_tpu_torch.lib import solvers

    return {k: solvers.IVP_COUNTS[k] - before[k] for k in ("nfev", "nsteps")}


def phase_vmf_oracles():
    """Phase 10(a): the methods and jobs of this phase on small models against
    dense oracles, with the JAX package's own tests' bounds."""
    import numpy as np
    import scipy.linalg

    from renormalizer_tpu_torch import (
        CompressConfig, EvolveConfig, EvolveMethod, HolsteinModel, Mol, Mpo,
        Mps, Op, Phonon, Quantity, TI1DModel)
    from renormalizer_tpu_torch.lib import solvers
    from renormalizer_tpu_torch.model import BasisSimpleElectron
    from renormalizer_tpu_torch.transport import (
        EDGE_THRESHOLD, ChargeDiffusionDynamics, SpectralFunctionZT)

    # tests/test_evolve.py: the 3-molecule, 2-level chain from a^dagger_0 |gs>
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    init = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
    init = init.expand_bond_dimension(hint_mpo=Mpo(model))
    e0 = init.expectation(Mpo(model))
    mpo = Mpo(model, offset=Quantity(e0))
    h = dense_operator(model, model.ham_terms) - e0 * np.eye(2 ** 6)
    occ_ops = [dense_operator(model, [Op(r"a^\dagger a", dof)]) for dof in model.e_dofs]
    psi0 = init.todense().astype(complex)
    vmf = dict(ivp_rtol=1e-4, ivp_atol=1e-7, force_ovlp=False)
    for tag, method, kwargs, cc, dt, nsteps, bound in (
            ("TDVP-PS2", EvolveMethod.tdvp_ps2, {}, CompressConfig(threshold=1e-6),
             0.2, 10, 1e-4),
            ("MU-VMF", EvolveMethod.tdvp_mu_vmf, vmf, None, 1.0, 1, 1e-4),
            ("VMF", EvolveMethod.tdvp_vmf, vmf, None, 1.0, 1, 1e-4),
            ("MU-CMF", EvolveMethod.tdvp_mu_cmf, {}, None, 0.02, 3, 5e-4)):
        mps = init.copy()
        mps.evolve_config = EvolveConfig(method, **kwargs)
        mps.evolve_config.vmf_auto_switch = False
        if cc is not None:
            mps.compress_config = cc
        deviations, ivp = [], []
        t0 = time.perf_counter()
        for i in range(1, nsteps + 1):
            before = dict(solvers.IVP_COUNTS)
            mps = mps.evolve(mpo, dt)
            ivp.append(_ivp_delta(before))
            psi = scipy.linalg.expm(-1j * h * dt * i) @ psi0
            dense = [np.real(psi.conj() @ o @ psi) for o in occ_ops]
            deviations.append(float(np.abs(mps.e_occupations - dense).mean()))
        mcd = float(np.mean(deviations))
        counts = ("" if not ivp[0]["nfev"] else
                  f"; RKF45 nfev/nsteps per step {[(c['nfev'], c['nsteps']) for c in ivp]}")
        print(f"[vmf a] {tag}: {nsteps} steps of {dt} in {time.perf_counter() - t0:.2f} s, "
              f"e_occupations mean cumulative deviation {mcd:.3e} (bound {bound:.0e}), "
              f"norm {mps.mp_norm:.7f}, bond dims {mps.bond_dims}{counts}", flush=True)
        check(_all_finite(mps), f"[vmf a] {tag}: non-finite MPS")
        check(abs(mps.mp_norm - 1) < 1e-5, f"[vmf a] {tag}: norm {mps.mp_norm}")
        check(mcd < bound, f"[vmf a] {tag}: deviation {mcd}")

    # tests/test_apps.py:266-282: G(0) of the free-electron 4-cell ring
    hop = (Op(r"a^\dagger a", [(0, "e"), (1, "e")], -1.0)
           + Op(r"a^\dagger a", [(1, "e"), (0, "e")], -1.0))
    ring = TI1DModel([BasisSimpleElectron("e")], [], hop, 4)
    job = SpectralFunctionZT(ring)
    job.evolve(0.1, 2)
    g0 = job.G_array[0]
    dev = max(abs(g0[0] * 1j - 1), float(np.abs(g0[1:]).max()))
    print(f"[vmf a] SpectralFunctionZT 4-cell ring: G(0) {np.round(g0, 7).tolist()}, "
          f"largest deviation from -i delta_ij {dev:.3e} (bound 1e-5)", flush=True)
    check(np.isfinite(job.G_array).all() and dev < 1e-5,
          f"[vmf a] SpectralFunctionZT G(0) off by {dev}")

    # tests/test_apps.py:467-484: band-limit charge diffusion, r^2 = 2 J^2 t^2
    ph_list = [Phonon.simple_phonon(Quantity(1e-10, "cm-1"), Quantity(1e-10, "a.u."), 4)]
    j_constant = Quantity(0.8, "eV")
    chain = HolsteinModel([Mol(Quantity(0), ph_list)] * 13, j_constant, 3)
    t0 = time.perf_counter()
    ct = ChargeDiffusionDynamics(chain, evolve_config=EvolveConfig(EvolveMethod.prop_and_compress))
    ct.evolve(4, 25)
    analytical = 2 * j_constant.as_au() ** 2 * ct.evolve_times_array ** 2
    mask = analytical > 0
    rel = np.abs(np.asarray(ct.r_square_array)[mask] / analytical[mask] - 1)
    edge = ct.latest_mps.e_occupations[0]
    print(f"[vmf a] ChargeDiffusionDynamics band limit, 13 molecules: {len(ct.evolve_times) - 1} "
          f"P&C steps of 4 a.u. in {time.perf_counter() - t0:.2f} s (stopped at the edge, "
          f"occupation {edge:.3e}); largest |r^2 / 2J^2t^2 - 1| {rel.max():.3e} (bound 1e-3)",
          flush=True)
    check(EDGE_THRESHOLD < edge < 0.1, f"[vmf a] band limit: edge occupation {edge}")
    check(rel.max() < 1e-3, f"[vmf a] band limit: r^2 off by {rel.max()}")


class JobSteps:
    """The steps of one job in phase 10 (b)-(d): one first step and the timed
    ones, each between two device syncs, with the RKF45 counts, the Jacobi
    launches and the complex Grams of each step."""

    def __init__(self, tag, card):
        self.tag, self.card = tag, card
        self.seconds, self.ivp, self.launches, self.complex = [], [], [], []

    def run(self, step, nsteps, after=lambda: None):
        from renormalizer_tpu_torch.backend import backend
        from renormalizer_tpu_torch.lib import solvers
        from renormalizer_tpu_torch.mps import trunc_device
        from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

        for _ in range(nsteps):
            before = dict(solvers.IVP_COUNTS)
            launches0, complex0 = jacobi_eigh.launches, trunc_device.LINALG_EIGH_GRAMS
            backend.sync()
            t0 = time.perf_counter()
            step()
            backend.sync()
            self.seconds.append(time.perf_counter() - t0)
            self.ivp.append(_ivp_delta(before))
            self.launches.append(jacobi_eigh.launches - launches0)
            self.complex.append(trunc_device.LINALG_EIGH_GRAMS - complex0)
            after()
        print(f"{self.tag} ({self.card}) first step {self.seconds[0]:.4f} s; timed steps "
              f"{[round(t, 4) for t in self.seconds[1:]]} s; RKF45 nfev/nsteps per step "
              f"{[(c['nfev'], c['nsteps']) for c in self.ivp]}; Jacobi launches per step "
              f"{self.launches}; complex Grams through torch.linalg.eigh per step "
              f"{self.complex}", flush=True)


def _record_constructor(tag, build):
    """Build a job with every Gram eigh recorded; returns the job, its
    constructor seconds, the kernel launches and the GramRecord."""
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

    grams = GramRecord(keep_grams=True)
    trunc_device.jacobi_eigh = grams
    try:
        launches0 = jacobi_eigh.launches
        backend.sync()
        t0 = time.perf_counter()
        job = build()
        backend.sync()
        seconds = time.perf_counter() - t0
        launches = jacobi_eigh.launches - launches0
    finally:
        trunc_device.jacobi_eigh = jacobi_eigh
    print(f"{tag}: constructor {seconds:.2f} s, jacobi launches {launches}", flush=True)
    return job, seconds, launches, grams


def _hold_unheld(tag, grams, held, tol):
    """The path's own Grams of every (batch, n, itemsize) that phase 3 did
    not hold, against the plain version (``GramRecord.check_against_plain``),
    so that every shape the path solves is held against it."""
    unheld = sorted(set(grams.shapes()) - set(held))
    print(f"{tag} Gram shapes that phase 3 did not hold: {unheld}", flush=True)
    if unheld:
        grams.check_against_plain(tag + " (shapes phase 3 did not hold)", tol,
                                  only={(n, size) for _, n, size in unheld})


def _check_held(tag, grams, launches, held, tol):
    """Report a GramRecord (failing on a launch at the sweep cap) and hold
    the Grams of every shape phase 3 did not hold against the plain
    version."""
    hist = grams.report(tag, launches)
    _hold_unheld(tag, grams, held, tol)
    return hist


def phase_vmf_jobs(card, profile, gram_tol, m=64, nsteps=4, thermal_steps=3,
                   dts=None, thermal_div=100, warm_steps=2):
    """Phase 10(b)-(d): the charge-diffusion job with MU-VMF and with
    TDVP-PS2, and ThermalProp with MU-VMF in imaginary time, on the bench
    chain.  Returns the kernel launches of each path and the timed s/step."""
    import numpy as np

    from renormalizer_tpu_torch import (
        CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod, MpDm,
        Quantity, ThermalProp)
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.property import Property, ops as prop_ops
    from renormalizer_tpu_torch.transport import ChargeDiffusionDynamics

    model = holstein_chain(6)
    timed, by_path = {}, {}
    dts = dts or {"b": 20.0, "c": 20.0}
    jacobi_eigh.launches = 0
    trunc_device.LINALG_EIGH_GRAMS = 0
    for key, method in (("b", EvolveMethod.tdvp_mu_vmf), ("c", EvolveMethod.tdvp_ps2)):
        tag = (f"[vmf {key}] ChargeDiffusionDynamics holstein 6x(1+2) 6 levels, T=0, "
               f"{method.name}, M={m}")
        job, _, launches, grams = _record_constructor(tag, lambda: ChargeDiffusionDynamics(
            model, compress_config=CompressConfig(CompressCriteria.fixed, max_bonddim=m),
            evolve_config=EvolveConfig(method), stop_at_edge=False))
        _check_held(f"[vmf {key}]", grams, launches,
                    {(1, n, 4) for n in CHARGE_PATH_GRAMS}, gram_tol)
        grams.check_against_library(f"[vmf {key}]", gram_tol)
        check(not job.latest_mps.is_complex and max(job.latest_mps.bond_dims) == m,
              f"{tag}: start state {job.latest_mps.bond_dims}")
        e0 = job.energies[0]

        def after():
            mps = job.latest_mps
            occ, r2 = np.asarray(job.e_occupations_array[-1]), job.r_square_array[-1]
            check(_all_finite(mps), f"{tag}: non-finite MPS")
            check(abs(mps.mp_norm - 1) < NORM_TOL, f"{tag}: norm {mps.mp_norm}")
            check(abs(occ.sum() - 1) < 1e-4, f"{tag}: occupations sum to {occ.sum()}")
            check(np.isfinite(r2) and r2 >= 0, f"{tag}: r^2 {r2}")
            drift = abs(job.energies[-1] - e0)
            check(drift <= CHARGE_ENERGY_DRIFT * max(1.0, abs(e0)),
                  f"{tag}: <H> moved from {e0} to {job.energies[-1]}")

        steps = JobSteps(f"{tag}, dt {dts[key]} a.u.", card)
        steps.run(lambda: job.evolve(dts[key], 1), nsteps, after)
        drift = max(abs(e - e0) for e in job.energies)
        print(f"{tag}: r^2 {np.round(job.r_square_array, 6).tolist()}; <H> drift "
              f"{drift:.3e} (allowed {CHARGE_ENERGY_DRIFT:.0e} of max(1, |E|)); norm "
              f"{job.latest_mps.mp_norm:.7f}; bond dims {job.latest_mps.bond_dims}", flush=True)
        timed[key] = steps.seconds[1:]
        if key == "c":
            check(sum(steps.complex) > 0, f"{tag}: no complex Gram was counted")
        if profile:
            phase_profile_step(card, f"[vmf {key}]", lambda: job.evolve(dts[key], 1))
    by_path["charge_diffusion"] = jacobi_eigh.launches

    # (d) the kernel inside the time loop: imaginary-time MU-VMF of the MpDm
    tag = f"[vmf d] ThermalProp holstein 6x(1+2) 6 levels, 298 K, tdvp_mu_vmf, M={m}"
    jacobi_eigh.launches = 0
    trunc_device.LINALG_EIGH_GRAMS = 0
    prop_mpos = {}
    for imol in range(model.mol_num):
        prop_mpos.update(prop_ops.e_ph_static_correlation(model, imol=imol))
    prop = Property(["e_rdm"] + list(prop_mpos), prop_mpos)
    beta = Quantity(298, "K").to_beta()
    rho = MpDm.max_entangled_ex(model)
    rho.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=m)
    grams = GramRecord(keep_grams=True)
    trunc_device.jacobi_eigh = grams
    try:
        t0 = time.perf_counter()
        tp = ThermalProp(rho, evolve_config=EvolveConfig(EvolveMethod.tdvp_ps),
                         properties=prop)
        construct = jacobi_eigh.launches
        # MU-VMF from the freshly expanded state (all bonds at 1e-10 padding)
        # is too stiff to step: warm up by TDVP-PS, then switch
        tp.evolve(None, warm_steps, beta / 20j)
        tp.latest_mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_mu_vmf)
        print(f"{tag}: constructor and {warm_steps} TDVP-PS steps of beta/20 "
              f"{time.perf_counter() - t0:.2f} s, jacobi launches {construct} and "
              f"{jacobi_eigh.launches - construct}; bond dims {tp.latest_mps.bond_dims}",
              flush=True)

        def after():
            rdm = np.asarray(prop.prop_res["e_rdm"][-1])
            occ = tp.e_occupations_array[-1]
            check(_all_finite(tp.latest_mps), f"{tag}: non-finite density matrix")
            check(abs(occ.sum() - 1) < 1e-4, f"{tag}: occupations sum to {occ.sum()}")
            check(np.isfinite(rdm).all() and abs(np.trace(rdm) - 1) < 1e-4,
                  f"{tag}: e_rdm trace {np.trace(rdm)}")
            check(tp.energies[-1] < tp.energies[-2], f"{tag}: energy did not fall")

        steps = JobSteps(f"{tag}, steps of beta/{thermal_div}", card)
        steps.run(lambda: tp.evolve(None, 1, beta / thermal_div / 1j), thermal_steps, after)
    finally:
        trunc_device.jacobi_eigh = jacobi_eigh
    launches = jacobi_eigh.launches
    check(all(n > 0 for n in steps.launches),
          f"{tag}: a time step launched the Jacobi kernel {steps.launches} times")
    _check_held("[vmf d]", grams, launches,
                {(1, n, size) for size, ns in THERMAL_PATH_GRAMS.items() for n in ns},
                gram_tol)
    grams.check_against_library("[vmf d]", gram_tol)
    corr = {k: float(np.real(v[-1])) for k, v in prop.prop_res.items() if k != "e_rdm"}
    print(f"{tag}: energies {np.round(tp.energies, 6).tolist()}; e_rdm diagonal "
          f"{np.round(np.diag(prop.prop_res['e_rdm'][-1]).real, 6).tolist()}; "
          f"S_0_j_0 {[round(corr[f'S_0_{j}_0'], 6) for j in range(model.mol_num)]}",
          flush=True)
    by_path["thermal_vmf"] = launches
    timed["d"] = steps.seconds[1:]
    if profile:
        phase_profile_step(card, "[vmf d]", lambda: tp.evolve(None, 1, beta / thermal_div / 1j))
    return by_path, timed


def phase_excited_oracles():
    """Phase 11: the excited-state and correction-vector slice on the JAX
    package's test models against dense oracles, in fp32, with the bounds of
    tests/test_mps.py and tests/test_apps.py, or EXCITED_BOUNDS where a CPU
    fp32 rehearsal of the same runs showed fp32 cannot meet them."""
    import numpy as np
    import scipy.linalg

    from renormalizer_tpu_torch import (
        HolsteinModel, Model, Mol, Mpo, Mps, Op, OptimizeConfig, Phonon, Quantity)
    from renormalizer_tpu_torch.cv import SpectraFtCV, SpectraZtCV
    from renormalizer_tpu_torch.model import BasisHalfSpin, BasisSHO
    from renormalizer_tpu_torch.mps import TDA
    from renormalizer_tpu_torch.mps.gs import construct_mps_mpo, optimize_mps
    from renormalizer_tpu_torch.utils import constant
    from renormalizer_tpu_torch.vibration import Vscf
    from renormalizer_tpu_torch.vibronic import VibronicModelDynamics

    def report(tag, err, bound):
        print(f"[excited] {tag}: {err:.3e} (bound {bound:.0e})", flush=True)
        check(np.isfinite(err) and err < bound, f"[excited] {tag}: {err} >= {bound}")

    # tests/fixtures.py's exact_model: 3 molecules, 2-level phonons, J = 1
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    h = dense_operator(model, model.ham_terms).real
    sector = np.nonzero(_sector_of(model, len(h)) == 1)[0]
    w1 = np.linalg.eigvalsh(h[np.ix_(sector, sector)])
    mps, mpo = construct_mps_mpo(model, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0], [16, 0]]
    mps.optimize_config.nroots = 2
    energies, roots = optimize_mps(mps.copy(), mpo)
    report("state-averaged DMRG, 2 roots, |E - E_dense|",
           float(np.abs(np.array(sorted(energies[-1])) - w1[:2]).max()),
           EXCITED_BOUNDS["nroots"])
    check(len(roots) == 2, "[excited] nroots: not one MPS per root")
    mps = Mps.random(model, 1, 24)
    mps.optimize_config = OptimizeConfig(
        procedure=[[24, 0.4], [24, 0.2], [24, 0.1], [24, 0], [24, 0], [24, 0]])
    _, opt = optimize_mps(mps, Mpo(model), omega=w1[1] + 0.02)
    report("omega-targeted DMRG, |<H> - E_1|",
           abs(float(opt.expectation(Mpo(model))) - w1[1]), EXCITED_BOUNDS["omega"])
    mps = Mps.random(model, 1, 16)
    mps.optimize_config = OptimizeConfig(procedure=[[16, 0.4], [16, 0.2], [16, 0], [16, 0]])
    mps.optimize_config.algo = "arpack"
    energies, _ = optimize_mps(mps, Mpo(model))
    report("arpack DMRG, |E - 0.3361574408|", abs(min(energies) - 0.3361574408),
           EXCITED_BOUNDS["arpack"])
    mps, mpo = construct_mps_mpo(model, 16, 1)
    mps.optimize_config.procedure = [[8, 0.4], [16, 0.2], [16, 0], [16, 0]]
    _, gs_mps = optimize_mps(mps.copy(), mpo)
    e_tda = TDA(model, mpo, gs_mps, nroots=3).kernel()
    report("TDA, |E - E_dense| of the two lowest",
           float(np.abs(e_tda[:2] - w1[1:3]).max()), EXCITED_BOUNDS["tda"])

    # tests/fixtures.py's 3-molecule Holstein model (GS_E regression)
    j_matrix = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3],
                         [-0.2, -0.3, 0.0]]) / constant.au2ev
    ph_list = [Phonon([w, w], [Quantity(0), d], 4) for w, d in
               zip([Quantity(106.51, "cm^{-1}"), Quantity(1555.55, "cm^{-1}")],
                   [Quantity(30.1370, "a.u."), Quantity(8.7729, "a.u.")])]
    fixture = HolsteinModel([Mol(Quantity(2.67, "eV"), ph_list, 15.45)] * 3, j_matrix)
    gs_e = 0.08401412 + fixture.gs_zpe
    for algo in ("lobpcg", "primme"):
        mps = Mps.random(fixture, 1, 10, percent=1.0)
        mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [40, 0], [40, 0]]
        mps.optimize_config.algo = algo
        energies, _ = optimize_mps(mps.copy(), Mpo(fixture))
        report(f"{algo} DMRG, |E - GS_E| / GS_E", abs(min(energies) - gs_e) / gs_e,
               EXCITED_BOUNDS["lobpcg"])

    basis = [BasisSHO("v0", 1.0, 8), BasisSHO("v1", 0.5, 8)]
    scf = Vscf(Model(basis, Op("p^2", "v0", 0.5) + Op("x^2", "v0", 0.5)
                     + Op("p^2", "v1", 0.5) + Op("x^2", "v1", 0.5 * 0.25)))
    scf.kernel(nsweeps=5)
    report("VSCF modal gaps", max(np.abs(np.diff(scf.e[0][:4]) - 1.0).max(),
                                  np.abs(np.diff(scf.e[1][:4]) - 0.5).max()),
           EXCITED_BOUNDS["vscf"])
    terms = (Op("sigma_z", "e", 0.5) + Op("p^2", "v", 0.5) + Op("x^2", "v", 0.5)
             + Op("sigma_x", "e") * Op("x", "v") * 0.2)
    vib = Model([BasisHalfSpin("e"), BasisSHO("v", 1.0, 4)], terms)
    job = VibronicModelDynamics(vib, init_condition={"e": 0, "v": 0})
    job.evolve(0.2, 4)
    hv = dense_operator(vib, vib.ham_terms)
    report("vibronic autocorrelation at 2t", max(
        abs(scipy.linalg.expm(-1j * hv * t)[0, 0] - ac)
        for t, ac in zip(job.autocorr_time, job.autocorr_array)), EXCITED_BOUNDS["vibronic"])

    # tests/test_apps.py's correction-vector dimer
    eta = 0.05
    ph = Phonon.simple_phonon(Quantity(1.0), Quantity(0.4), 2)
    dimer = HolsteinModel([Mol(Quantity(1.0), [ph], 1.0)] * 2, Quantity(0.2))
    hd = dense_operator(dimer, dimer.ham_terms).real
    qn = _sector_of(dimer, len(hd))
    procedure = [0.4, 0.2, 0.1, 0] + [0] * 10

    def mu(op):
        return dense_operator(dimer, [Op(op, d, 1.0) for d in dimer.e_dofs]).real

    s0 = np.nonzero(qn == 0)[0]
    w0, v0 = np.linalg.eigh(hd[np.ix_(s0, s0)])
    gs_vec = np.zeros(len(hd))
    gs_vec[s0] = v0[:, 0]
    ket = mu(r"a^\dagger") @ gs_vec
    cv = SpectraZtCV(dimer, "abs", m_max=16, eta=eta, procedure_cv=procedure)
    for omega in (1.05, 1.5):
        a = hd - (w0[0] + omega) * np.eye(len(hd)) + 1j * eta * np.eye(len(hd))
        oracle = -1 / np.pi * np.imag(ket @ np.linalg.solve(a, ket))
        res = cv.cv_solve(omega)
        report(f"SpectraZtCV omega {omega}, relative", abs(res - oracle) / abs(oracle),
               EXCITED_BOUNDS["cv_zerot"])
    temperature = Quantity(0.5, "a.u.")
    beta = temperature.to_beta()
    e_all, v_all = np.linalg.eigh(hd)
    gaps = e_all[:, None] - e_all[None, :]
    for tag, kwargs, op, sector, freqs in (
            ("abs", dict(spectratype="abs"), r"a^\dagger", 0, (1.05, 1.5)),
            ("emi", dict(spectratype="emi", insteps=50), "a", 1, (-1.05, -1.5)),
            ("abs 2-site", dict(spectratype="abs", method="2site"), r"a^\dagger", 0,
             (1.05, 1.5))):
        sidx = np.nonzero(qn == sector)[0]
        rho = np.zeros_like(hd)
        rho[np.ix_(sidx, sidx)] = scipy.linalg.expm(-beta / 2 * hd[np.ix_(sidx, sidx)])
        rho /= np.linalg.norm(rho)
        b = v_all.T @ (mu(op) @ rho) @ v_all
        cv = SpectraFtCV(dimer, m_max=16, eta=eta, temperature=temperature,
                         procedure_cv=procedure, **kwargs)
        for omega in freqs:
            oracle = eta / np.pi * np.sum(np.abs(b) ** 2 / ((omega - gaps) ** 2 + eta ** 2))
            res = cv.cv_solve(omega)
            report(f"SpectraFtCV {tag} omega {omega}, relative",
                   abs(res - oracle) / oracle, EXCITED_BOUNDS["cv_finitet"])


def phase_excited_jobs(card, gram_tol, m=64):
    """Phase 12, at the bench chain's full width (18 sites, fp32): (a)
    state-averaged 2-site DMRG of 2 roots at M=m against the JAX package's
    CPU fp64 energies (SA_REF, SA_TOL); (b) SpectraZtCV absorption, its
    ground state by procedure_gs up to M=m, 1-site, eta 0.05 eV, three
    frequencies through batch_run(freqs, 1, obj), at most 8 sweeps each:
    every response finite, > 0 and converged to rtol, and the interleaved
    batch_run(freqs, 3, obj) from the same start within 1e-4 of it.  Every
    Jacobi launch of (a) and (b) is recorded (the (batch, n) histogram, none
    at the sweep cap) and solved again by torch.linalg.eigh inside phase
    3's tolerances; a shape phase 3 did not hold also by the plain
    version."""
    import numpy as np

    from renormalizer_tpu_torch import Mpo, Mps, Quantity
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.cv import SpectraZtCV
    from renormalizer_tpu_torch.cv.spectra_cv import batch_run
    from renormalizer_tpu_torch.lib import solvers
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

    model = holstein_chain(6)
    mpo = Mpo(model)
    launches, seconds = {}, {}

    def recorded(tag, run):
        grams = GramRecord(keep_grams=True)
        trunc_device.jacobi_eigh = grams
        try:
            jacobi_eigh.launches = 0
            trunc_device.LINALG_EIGH_GRAMS = 0
            backend.sync()
            t0 = time.perf_counter()
            out = run()
            backend.sync()
            wall = time.perf_counter() - t0
            count = jacobi_eigh.launches
            complex_grams = trunc_device.LINALG_EIGH_GRAMS
        finally:
            trunc_device.jacobi_eigh = jacobi_eigh
        grams.report(tag, count)
        grams.check_against_library(tag, gram_tol)
        _hold_unheld(tag, grams, {(b, n, 4) for b, n in EXCITED_PATH_GRAMS}, gram_tol)
        check(count > 0, f"{tag} never launched the Jacobi kernel")
        check(complex_grams == 0, f"{tag} {complex_grams} Gram eigh went around the kernel")
        return out, wall, count

    # (a)
    mps = Mps.random(model, 1, m, percent=1.0)
    mps.optimize_config.procedure = [[m, 0.4], [m, 0.2]] + [[m, 0]] * 4
    mps.optimize_config.method = "2site"
    mps.optimize_config.nroots = 2
    sweep_times = []
    single_sweep = gs.single_sweep

    def timed_sweep(*args, **kwargs):
        backend.sync()
        t0 = time.perf_counter()
        out = single_sweep(*args, **kwargs)
        backend.sync()
        sweep_times.append(time.perf_counter() - t0)
        return out

    gs.single_sweep = timed_sweep
    try:
        (energies, roots), wall, count = recorded(
            "[excited a]", lambda: gs.optimize_mps(mps, mpo))
    finally:
        gs.single_sweep = single_sweep
    final = sorted(energies[-1])
    print(f"[excited a] root energies per sweep {energies}", flush=True)
    print(f"[excited a] {len(sweep_times)} sweeps, seconds per sweep ({card}) "
          f"{[round(t, 4) for t in sweep_times]}; total {wall:.2f} s; jacobi "
          f"launches {count}; roots {final}, reference {SA_REF}, diff "
          f"{[f'{a - b:+.3e}' for a, b in zip(final, SA_REF)]}", flush=True)
    check(all(abs(a - b) < SA_TOL for a, b in zip(final, SA_REF)),
          f"[excited a] roots {final} not within {SA_TOL} of {SA_REF}")
    check(final[1] > final[0], "[excited a] root 1 does not lie above root 0")
    check(len(roots) == 2 and all(_all_finite(r) for r in roots), "[excited a] bad roots")
    launches["state_averaged_dmrg"] = count
    seconds["state_averaged_dmrg_sweeps"] = sweep_times
    seconds["state_averaged_dmrg_root_diffs"] = [a - b for a, b in zip(final, SA_REF)]

    # (b)
    ev = Quantity(1, "eV").as_au()
    freqs = [2.50 * ev, 2.60 * ev, 2.70 * ev]
    procedure_cv = [0.4, 0.2, 0.1, 0, 0, 0, 0, 0]
    solve_log = []
    cg0 = {}

    def run_cv():
        t0 = time.perf_counter()
        cv = SpectraZtCV(holstein_chain(6, dipole=1.0), "abs", m_max=m,
                         eta=0.05 * ev, h_mpo=mpo,
                         procedure_cv=procedure_cv,
                         procedure_gs=[[16, 0.4], [32, 0.2], [m, 0.1], [m, 0], [m, 0]])
        backend.sync()
        setup = time.perf_counter() - t0
        fresh.append(cv.clone_for_batch())
        cg0.update(solvers.CG_COUNTS)
        out = batch_run(freqs, 1, cv)
        solve_log.extend(cv.solve_log)
        return out, setup

    fresh = []
    (responses, setup), wall, count = recorded("[excited b]", run_cv)
    cg_solves = solvers.CG_COUNTS["solves"] - cg0["solves"]
    cg_iters = solvers.CG_COUNTS["iterations"] - cg0["iterations"]
    sweeps = sum(n for _, n, _ in solve_log)
    per_freq = (wall - setup) / len(freqs)
    print(f"[excited b] responses {responses} at {[round(f, 6) for f in freqs]} a.u.; "
          f"(sweeps, converged) per frequency {[(n, c) for _, n, c in solve_log]}; "
          f"{wall:.2f} s in all ({card}), {setup:.2f} s ground state and b, "
          f"{per_freq:.2f} s per frequency, {per_freq * len(freqs) / max(sweeps, 1):.2f} "
          f"s per sweep; CG iterations per site {cg_iters / max(cg_solves, 1):.2f} "
          f"({cg_iters} in {cg_solves} site solves); jacobi launches {count}", flush=True)
    check(all(np.isfinite(r) and r > 0 for r in responses),
          f"[excited b] responses {responses}")
    check(all(c for _, _, c in solve_log), "[excited b] a frequency did not converge")
    # the same points with one interleaved worker each, from the same start
    backend.sync()
    t0 = time.perf_counter()
    interleaved = batch_run(freqs, len(freqs), fresh[0])
    backend.sync()
    wall_i = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(interleaved, responses))
    print(f"[excited b] batch_run with {len(freqs)} interleaved workers: {wall_i:.2f} s "
          f"({card}) against {wall - setup:.2f} s for the serial loop; responses "
          f"{interleaved}, largest relative difference from the serial loop "
          f"{rel:.2e} (bound 1e-4, the convergence rtol's reach)", flush=True)
    check(rel < 1e-4, f"[excited b] interleaved batch_run off by {rel}")
    seconds["cv_zerot_serial_and_interleaved"] = [wall - setup, wall_i]
    launches["cv_zerot"] = count
    seconds["cv_zerot_per_frequency"] = per_freq
    return launches, seconds


def _qc_model(h1e, h2e, stacked=False):
    """``qc_model`` of spin-orbital integrals: the model, and its MPO (a
    StackedMpo of one Mpo per leading orbital with ``stacked``)."""
    from renormalizer_tpu_torch import Model, Mpo
    from renormalizer_tpu_torch.model.h_qc import qc_model
    from renormalizer_tpu_torch.mps import StackedMpo

    basis, ham_terms = qc_model(h1e, h2e, stacked=stacked)
    if not stacked:
        model = Model(basis, ham_terms)
        return model, Mpo(model)
    model = Model(basis, [t for terms in ham_terms for t in terms])
    return model, StackedMpo([Mpo(Model(basis, terms)) for terms in ham_terms])


def phase_qc_dmrg(tag, card, gram_tol, bound):
    """Phase 13(a)/(b): 2-site QC-DMRG of H2O/STO-3G (H2O_FCIDUMP: 7 spatial
    orbitals, 14 spin-orbital sites, [5, 5] electrons) at M=50 in the
    working precision, as tests/test_qc.py and examples/qc_dmrg.py run it:
    the lowest sweep energy plus the nuclear repulsion within ``bound`` of
    the published FCI energy H2O_FCI (in fp64 the JAX test's gate; the fp32
    result's energy evaluated in double precision printed beside it); every
    real Gram through the kernel
    in the working precision.  Prints the seconds of Mpo(model) and of each sweep,
    the MPO's bond dimensions and the Jacobi launches by (batch, n); the
    Grams of a shape phase 3 did not hold are held against the plain
    version.  Returns the kernel launches and the sweep seconds."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch import Mps, optimize_mps
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.model.h_qc import read_fcidump
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.mps.mps import _double_mpo_twin, _retype
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh

    h1e, h2e, nuc = read_fcidump(H2O_FCIDUMP, 7)
    t0 = time.perf_counter()
    model, mpo = _qc_model(h1e, h2e)
    backend.sync()
    mpo_s = time.perf_counter() - t0
    check(model.nsite == 14, f"{tag} H2O model has {model.nsite} sites")
    print(f"{tag} Mpo(model) of {len(model.ham_terms)} terms: {mpo_s:.2f} s "
          f"({card}); MPO bond dims {mpo.bond_dims}", flush=True)
    mps = Mps.random(model, [5, 5], QC_M, percent=1.0)
    mps.optimize_config.procedure = [[QC_M, 0.4], [QC_M, 0.2], [QC_M, 0.1]] + [[QC_M, 0]] * 6
    mps.optimize_config.method = "2site"

    sweep_times = []
    single_sweep = gs.single_sweep

    def timed_sweep(*args, **kwargs):
        backend.sync()
        t = time.perf_counter()
        out = single_sweep(*args, **kwargs)
        backend.sync()
        sweep_times.append(time.perf_counter() - t)
        return out

    grams = GramRecord(keep_grams=True)
    gs.single_sweep = timed_sweep
    trunc_device.jacobi_eigh = grams
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        energies, opt = optimize_mps(mps, mpo)
        backend.sync()
        launches = jacobi_eigh.launches
        elsewhere = trunc_device.LINALG_EIGH_GRAMS
    finally:
        gs.single_sweep = single_sweep
        trunc_device.jacobi_eigh = jacobi_eigh
    e_sweeps = min(float(np.min(np.asarray(x))) for x in energies) + nuc
    wide = opt.copy()
    _retype(wide, torch.float64)
    e_wide = wide.expectation(_double_mpo_twin(mpo)) / wide.mp_norm ** 2 + nuc
    print(f"{tag} energies per sweep + nuclear repulsion "
          f"{[round(float(x) + nuc, 12) for x in energies]}", flush=True)
    print(f"{tag} {len(sweep_times)} sweeps, seconds per sweep ({card}) "
          f"{[round(t, 4) for t in sweep_times]}; total {sum(sweep_times):.2f} s; "
          f"lowest sweep energy {e_sweeps:.12f} (FCI {H2O_FCI}, diff "
          f"{e_sweeps - H2O_FCI:+.3e}); the result's energy in double precision "
          f"{e_wide:.12f} (diff {e_wide - H2O_FCI:+.3e}); gated: sweeps, bound "
          f"{bound:.0e}; bond dims {opt.bond_dims}; jacobi launches {launches}; "
          f"Gram eigh elsewhere {elsewhere}", flush=True)
    grams.report(tag, launches)
    _hold_unheld(tag, grams, phase3_held(), gram_tol)
    itemsize = torch.empty(0, dtype=backend.real_dtype).element_size()
    check(launches > 0, f"{tag} never launched the Jacobi kernel")
    check(elsewhere == 0, f"{tag} {elsewhere} Gram eigh went around the kernel")
    check(set(grams.itemsizes) == {itemsize},
          f"{tag} Grams of itemsizes {set(grams.itemsizes)}, not {itemsize}")
    check(_all_finite(opt) and max(opt.bond_dims) <= QC_M, f"{tag} bad result")
    check(abs(e_sweeps - H2O_FCI) < bound,
          f"{tag} energy {e_sweeps} not within {bound} of {H2O_FCI}")
    return launches, sweep_times, (e_sweeps - H2O_FCI, e_wide - H2O_FCI)


def phase_qc_oracles():
    """Phase 13(c): the quantum-chemistry slice's small oracles in the
    working precision, at the JAX tests' bounds (QC_BOUNDS; those that are
    fp64 bounds there set by a CPU fp32 rehearsal): tests/test_qc.py's
    3-orbital QC-DMRG with Mpo and StackedMpo against the dense FCI energy;
    tests/test_mps.py's StackedMpo DMRG (the Holstein fixture's terms split
    in two), OFS-S on its scheme-1 chain, variational_compress against the
    dense product and DmrgFCISolver's energy from its own RDMs; read_fcidump
    of H2O_FCIDUMP against a plain parse of the file."""
    import numpy as np

    import scipy.linalg

    from renormalizer_tpu_torch import (
        BasisHalfSpin, CompressConfig, CompressCriteria, HolsteinModel, Model, Mol,
        Mpo, Mps, Op, Phonon, Quantity)
    from renormalizer_tpu_torch.model.h_qc import int_to_h, read_fcidump
    from renormalizer_tpu_torch.mps import DmrgFCISolver, StackedMpo, trunc_device
    from renormalizer_tpu_torch.mps import mpo as mpo_module
    from renormalizer_tpu_torch.mps.gs import construct_mps_mpo, optimize_mps
    from renormalizer_tpu_torch.utils import (
        OFS, EvolveConfig, EvolveMethod, OptimizeConfig, constant)
    from renormalizer_tpu_torch.utils.oracle import (
        dense_hamiltonian, dense_operator, sector_indices)

    def report(name, value, bound, t0):
        print(f"[qc c] {name}: {value:.3e} (bound {bound:.0e}) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        check(np.isfinite(value) and value < bound, f"[qc c] {name}: {value}")

    # tests/test_qc.py: random 3-orbital integrals, [1, 1] electrons
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 3))
    h = (h + h.T) / 2
    c = rng.standard_normal((4, 3, 3))
    c = (c + c.transpose(0, 2, 1)) / 2
    h1e, h2e = int_to_h(h, np.einsum("mij,mkl->ijkl", c, c) * 0.2)
    for stacked in (False, True):
        t0 = time.perf_counter()
        model, mpo = _qc_model(h1e, h2e, stacked)
        hd = dense_hamiltonian(model)
        sec = sector_indices(model, [1, 1])
        e_fci = np.linalg.eigvalsh(hd[np.ix_(sec, sec)])[0]
        mps = Mps.random(model, [1, 1], 16, percent=1.0)
        mps.optimize_config = OptimizeConfig(
            procedure=[[16, 0.4], [16, 0.2], [16, 0.1], [16, 0], [16, 0], [16, 0]])
        mps.optimize_config.method = "2site"
        energies, _ = optimize_mps(mps, mpo)
        e = min(np.min(np.asarray(x)) for x in energies)
        report(f"qc_model 3 orbitals stacked={stacked} |E - E_FCI|", abs(e - e_fci),
               QC_BOUNDS["qc"], t0)

    # tests/fixtures.py's 3-molecule Holstein model
    j_matrix = np.array([[0.0, -0.1, -0.2], [-0.1, 0.0, -0.3],
                         [-0.2, -0.3, 0.0]]) / constant.au2ev
    ph_list = [Phonon([Quantity(w, "cm^{-1}")] * 2, [Quantity(0), Quantity(d, "a.u.")], 4)
               for w, d in ((106.51, 30.1370), (1555.55, 8.7729))]
    holstein = HolsteinModel([Mol(Quantity(2.67, "eV"), ph_list, 15.45)] * 3, j_matrix)
    gs_e = 0.08401412 + holstein.gs_zpe
    t0 = time.perf_counter()
    half = len(holstein.ham_terms) // 2
    stacked = StackedMpo([Mpo(holstein, holstein.ham_terms[:half]),
                          Mpo(holstein, holstein.ham_terms[half:])])
    mps, _ = construct_mps_mpo(holstein, 10, 1)
    mps.optimize_config.procedure = [[10, 0.4], [20, 0.2], [30, 0.1], [30, 0], [30, 0]]
    energies, _ = optimize_mps(mps.copy(), stacked)
    report("StackedMpo DMRG |E - GS_E| / GS_E", abs(min(energies) - gs_e) / gs_e,
           QC_BOUNDS["stacked_mpo"], t0)

    # OFS through the procedure's compress configs (an integer entry would
    # replace the config and drop ``ofs``, as in the JAX package): every swap
    # that try_swap_site makes is counted, and the singular values of both
    # orders come from compress_factors' device SVD (SVD_BLOCKS)
    swaps = []
    try_swap_site = mpo_module.Mpo.try_swap_site

    def counting(self, new_model, swap_jw, algo="Hopcroft-Karp"):
        if any(a.dofs != b.dofs for a, b in zip(self.model.basis, new_model.basis)):
            swaps.append(1)
        return try_swap_site(self, new_model, swap_jw, algo)

    def ofs_procedure(ms):
        return [[CompressConfig(CompressCriteria.fixed, max_bonddim=m, ofs=OFS.ofs_s), p]
                for m, p in ms]

    mpo_module.Mpo.try_swap_site = counting
    try:
        t0 = time.perf_counter()
        swaps.clear()
        blocks = trunc_device.SVD_BLOCKS
        scheme1 = holstein.switch_scheme(1)
        mps, mpo = construct_mps_mpo(scheme1, 10, 1)
        mps.model = Model(mps.model.basis, mps.model.ham_terms)
        mps.optimize_config.procedure = ofs_procedure(
            [(10, 0.4), (20, 0.2), (30, 0.1), (40, 0), (40, 0)])
        mps.optimize_config.method = "2site"
        energies, opt = optimize_mps(mps.copy(), mpo)
        dev = max(abs(energies[-1] - gs_e),
                  abs(opt.expectation(Mpo(opt.model)) - gs_e)) / gs_e
        check(swaps, "[qc c] OFS-S DMRG of the scheme-1 chain made no swap")
        report(f"OFS-S DMRG, scheme-1 chain, {len(swaps)} swaps, "
               f"{trunc_device.SVD_BLOCKS - blocks} SVD blocks, |E - GS_E| / GS_E "
               "(last sweep and <H> of the reordered chain)", dev, QC_BOUNDS["ofs"], t0)

        # spins i and i + 3 coupled, a weak field on each: in the order
        # 0..5 every pair crosses the middle bond, so OFS has swaps to make
        paired = [Op("sigma_z sigma_z", [i, i + 3], 1.0) for i in range(3)]
        paired += [Op(f"sigma_{a} sigma_{b}", [i, i + 3], 0.5)
                   for i in range(3) for a, b in (("+", "-"), ("-", "+"))]
        paired += [Op("sigma_x", i, 0.05 * (i + 1)) for i in range(5)]
        spins = Model([BasisHalfSpin(i) for i in range(6)], paired)
        h = dense_hamiltonian(spins)
        t0 = time.perf_counter()
        swaps.clear()
        mps = Mps.random(spins, 0, 8, percent=1.0)
        mps.optimize_config = OptimizeConfig(
            procedure=ofs_procedure([(4, 0.4), (4, 0.2)] + [(8, 0)] * 4))
        mps.optimize_config.method = "2site"
        energies, opt = optimize_mps(mps, Mpo(spins, algo="Hopcroft-Karp"))
        e_dense = np.linalg.eigvalsh(h)[0]
        dev = max(abs(min(energies) - e_dense),
                  abs(opt.expectation(Mpo(opt.model)) - e_dense))
        check(swaps, "[qc c] OFS-S DMRG of the paired spins made no swap")
        report(f"OFS-S DMRG, paired spins, {len(swaps)} swaps, |E - E_dense| "
               "(lowest sweep and <H> of the reordered chain)", dev,
               QC_BOUNDS["ofs_dense"], t0)

        # TDVP-PS2 with OFS-S from a product state against expm
        t0 = time.perf_counter()
        swaps.clear()
        mps = Mps.hartree_product_state(spins, {i: i % 2 for i in range(6)})
        psi = mps.todense().astype(complex)
        mps.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=8,
                                             ofs=OFS.ofs_s)
        mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps2)
        mps = mps.expand_bond_dimension(Mpo(spins), include_ex=False)
        mpo = Mpo(spins, algo="Hopcroft-Karp")
        for _ in range(8):
            mps = mps.evolve(mpo, 0.1)
        psi = scipy.linalg.expm(-1j * h * 0.8) @ psi
        dev = max(abs(mps.expectation(Mpo(mps.model, Op("sigma_z", dof)))
                      - np.real(psi.conj() @ dense_operator(spins, [Op("sigma_z", dof)])
                                @ psi))
                  for dof in range(6))
        check(swaps, "[qc c] TDVP-PS2 with OFS-S made no swap")
        report(f"TDVP-PS2 with OFS-S, paired spins, {len(swaps)} swaps, max over "
               "DoFs |<sigma_z> - dense| after 8 steps of 0.1", dev,
               QC_BOUNDS["ofs_tdvp"], t0)
    finally:
        mpo_module.Mpo.try_swap_site = try_swap_site

    # tests/fixtures.py's exact_model
    t0 = time.perf_counter()
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    exact = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    mpo = Mpo(exact)
    small = Mps.random(exact, 1, 12)
    small.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=24)
    dense_big = (mpo @ small).todense()
    comp = small.variational_compress(mpo)
    err = np.linalg.norm(comp.todense() - dense_big) / np.linalg.norm(dense_big)
    report("variational_compress relative error", err, QC_BOUNDS["variational"], t0)

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    h1 = rng.standard_normal((2, 2))
    h1 = (h1 + h1.T) / 2
    c = rng.standard_normal((3, 2, 2))
    c = (c + c.transpose(0, 2, 1)) / 2
    h2 = np.einsum("mij,mkl->ijkl", c, c) * 0.3
    solver = DmrgFCISolver()
    e, _ = solver.kernel(h1, h2, 2, (1, 1))
    rdm1 = np.asarray(solver.make_rdm1(None, 2, (1, 1)))
    rdm2 = np.asarray(solver.make_rdm2(None, 2, (1, 1)))
    e_rdm = np.einsum("ij,ij->", h1, rdm1) + 0.5 * np.einsum("ijkl,ijkl->", h2, rdm2)
    dev = max(abs(np.trace(rdm1) - 2), abs(e_rdm - e))
    report("DmrgFCISolver |tr rdm1 - 2|, |E(rdm1, rdm2) - E|", dev, QC_BOUNDS["fci_solver"], t0)

    t0 = time.perf_counter()
    sh, aseri, nuc = read_fcidump(H2O_FCIDUMP, 7)
    rows = np.loadtxt(H2O_FCIDUMP, skiprows=4)
    h, eri = np.zeros((7, 7)), np.zeros((7,) * 4)
    for val, p, q, r, s_ in rows:
        p, q, r, s_ = (int(x) - 1 for x in (p, q, r, s_))
        if r >= 0:
            for i, j, k, l in ((p, q, r, s_), (q, p, r, s_), (p, q, s_, r), (q, p, s_, r)):
                eri[i, j, k, l] = val
        elif p >= 0:
            h[p, q] = h[q, p] = val
    sh_ref, aseri_ref = int_to_h(h, eri)
    nuc_ref = rows[(rows[:, 1:] == 0).all(axis=1), 0]
    dev = max(float(np.abs(sh - sh_ref).max()), float(np.abs(aseri - aseri_ref).max()),
              abs(nuc - float(nuc_ref[-1])))
    check(sh.shape == (14, 14) and aseri.shape == (14,) * 4, "[qc c] read_fcidump shapes")
    report(f"read_fcidump of {H2O_FCIDUMP} against a plain parse (nuclear repulsion "
           f"{nuc})", dev, 1e-15, t0)


def phase_padding_seeds(tag, seeds, run):
    """Phase 13(d): one result that starts from the port's expansion, at each
    of ``seeds`` of the port's generator (``run``: a function of
    padding_seed_probe.py).  Returns the values."""
    from renormalizer_tpu_torch.backend import backend

    values = []
    default = backend._seed
    try:
        for seed in seeds:
            backend._seed = seed
            t0 = time.perf_counter()
            values.append(run())
            print(f"{tag} seed {seed}: {values[-1]:.3e} in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        backend._seed = default
    return values


def phase_qc_fp64(card):
    """The fp64 part of phase 13, in a child process (RENO_DTYPE=fp64):
    (a) the H2O QC-DMRG within 1e-8 of the FCI energy, and (d) the padding
    fault's case of padding_seed_probe.py (10 TDVP-PS steps of beta/20 at
    1500 K from the expanded MpDm of the 3-molecule, 3-level, J = 0.2 chain)
    at PADDING_SEEDS: each under PADDING_TOL off the dense electron RDM, the
    largest within PADDING_SPREAD times the smallest.  Prints one
    ``[qc fp64]`` JSON line for the parent."""
    import padding_seed_probe
    from renormalizer_tpu_torch.backend import backend

    check(not backend.is_32bits, "the fp64 child runs in fp32")
    launches, sweeps, _ = phase_qc_dmrg("[qc a]", card, TOL_F64, H2O_TOL_FP64)
    values = phase_padding_seeds("[qc d] thermal fp64, |e_rdm - dense|",
                                 PADDING_SEEDS, padding_seed_probe.thermal)
    spread = max(values) / min(values)
    print(f"[qc d] largest over smallest {spread:.3f} (bound {PADDING_SPREAD}), "
          f"largest {max(values):.3e} (bound {PADDING_TOL:.0e})", flush=True)
    check(max(values) < PADDING_TOL, f"[qc d] deviations {values}")
    check(spread < PADDING_SPREAD, f"[qc d] deviations {values} spread {spread}")
    print("[qc fp64] " + json.dumps({"launches": launches, "sweep_seconds": sweeps,
                                    "padding": values}), flush=True)


def phase_qc(card, gram_tol):
    """Phase 13: the fp64 child (13(a), 13(d)), then (b) the H2O QC-DMRG in
    the card's default fp32, (c) the small oracles and the MU-CMF fp32
    deviation of phase 10(a) at three seeds (a record, no gate)."""
    import padding_seed_probe

    child = subprocess.run(
        [sys.executable, __file__, "--qc-fp64"], capture_output=True, text=True,
        env={**os.environ, "RENO_DTYPE": "fp64"}, timeout=900)
    sys.stdout.write(child.stdout)
    sys.stdout.flush()
    check(child.returncode == 0,
          f"the fp64 child exited {child.returncode}: {child.stderr[-4000:]}")
    result = json.loads([line for line in child.stdout.splitlines()
                         if line.startswith("[qc fp64] ")][-1][len("[qc fp64] "):])
    launches_32, sweeps_32, devs_32 = phase_qc_dmrg("[qc b]", card, gram_tol,
                                                    H2O_TOL_FP32)
    phase_qc_oracles()
    phase_padding_seeds("[qc d] MU-CMF fp32 (phase 10(a)'s case), mean deviation "
                        "(record, no gate)", (2019, 0, 1), padding_seed_probe.mu_cmf)
    return ({"fp64": result["launches"], "fp32": launches_32},
            {"fp64": result["sweep_seconds"], "fp32": sweeps_32,
             "fp32_sweep_and_double_diffs": devs_32, "padding_fp64": result["padding"]})


def _tree_shapes_timed(tag, grams, hist):
    """The widest and the two most frequent (batch, n) of a path's f32
    Grams (ties: the wider; phases 14(a) and 15), each timed on one of the path's own Grams of
    that shape: the kernel, the plain version (one call, no warm-up) and
    torch.linalg.eigh in turns by CUDA events, beside the bound."""
    import torch

    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh, jacobi_eigh_reference

    widest = max(hist, key=lambda bn: (bn[1], bn[0]))
    frequent = sorted(hist, key=lambda bn: (hist[bn], bn[1]), reverse=True)[:2]
    timed = {}
    for b, n in dict.fromkeys([widest] + frequent):
        a = next(g for g, _, _ in grams.kept[(n, 4)] if g.shape[0] == b)
        ms = cuda_times_in_turns({
            "kernel": lambda: jacobi_eigh(a),
            "torch.linalg.eigh": lambda: torch.linalg.eigh(a),
            "plain": lambda: jacobi_eigh_reference(a)},
            {"kernel": 10, "torch.linalg.eigh": 10, "plain": 1},
            warm=("kernel", "torch.linalg.eigh"))
        bound, bound_by = jacobi_bound_ms(b, n, 4)
        kind = " and ".join(k for k, hit in (("widest", (b, n) == widest),
                                             ("most frequent", (b, n) == frequent[0]),
                                             ("second most frequent",
                                              (b, n) == frequent[-1] != frequent[0]))
                            if hit)
        print(f"{tag} {kind} Gram shape ({b}, {n}, {n}), {hist[(b, n)]} launches: "
              f"median ms kernel {ms['kernel']:.3f} plain {ms['plain']:.3f} "
              f"torch.linalg.eigh {ms['torch.linalg.eigh']:.3f}; bound "
              f"{bound:.6f} ms ({bound_by})", flush=True)
        timed[(b, n, n)] = dict(ms, bound_ms=bound, bound_by=bound_by,
                                launches=hist[(b, n)])
    return timed


def phase_tree_dmrg(card, gram_tol, m=TREE_M, profile=False, tag="[tree a]",
                    time_shapes=True):
    """Phase 14(a): tree DMRG of the bench chain (18 sites) on
    BasisTree.binary at M=m in fp32, through TTNO / TTNS.random /
    optimize_ttns: the sweeps' lowest energy within TREE_E_TOL of E_REF;
    every Gram of the truncation through the kernel (recorded, none at the
    sweep cap, each solved again by torch.linalg.eigh and, for a shape phase
    3 did not hold, by the plain version); the widest and the most frequent
    Gram shape timed (unless ``time_shapes`` is false: phase 15(d) runs it
    again under ``tag``).  Prints each sweep's seconds and energy, the
    largest 2-site coefficient and the peak device memory."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree
    from renormalizer_tpu_torch.tn import gs as tree_gs

    model = holstein_chain(6)
    tree = BasisTree.binary(model.basis)
    t0 = time.perf_counter()
    ttno = TTNO(tree, model.ham_terms)
    backend.sync()
    ttno_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ttns = TTNS.random(tree, 1, m, percent=1.0)
    backend.sync()
    random_s = time.perf_counter() - t0
    print(f"{tag} {len(tree)} nodes; TTNO of {len(model.ham_terms)} terms "
          f"{ttno_s:.2f} s, bond dims {ttno.bond_dims}; TTNS.random (host) "
          f"{random_s:.2f} s, bond dims {ttns.bond_dims}", flush=True)
    procedure = [[m, 0.4], [m, 0.2]] + [[m, 0]] * 4
    sweep_times = []
    recursion = tree_gs.optimize_recursion

    def timed_recursion(snode, state, *args, **kwargs):
        if snode is not state.root:
            return recursion(snode, state, *args, **kwargs)
        backend.sync()
        t = time.perf_counter()
        out = recursion(snode, state, *args, **kwargs)
        backend.sync()
        sweep_times.append(time.perf_counter() - t)
        return out

    grams = GramRecord(keep_grams=True)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile else contextlib.nullcontext()
    tree_gs.optimize_recursion = timed_recursion
    trunc_device.jacobi_eigh = grams
    torch.cuda.reset_peak_memory_stats()
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        backend.sync()
        t0 = time.perf_counter()
        with prof:
            energies = tree_gs.optimize_ttns(ttns, ttno, procedure)
            backend.sync()
        wall = time.perf_counter() - t0
        launches = jacobi_eigh.launches
        elsewhere = trunc_device.LINALG_EIGH_GRAMS
    finally:
        tree_gs.optimize_recursion = recursion
        trunc_device.jacobi_eigh = jacobi_eigh
    peak = torch.cuda.max_memory_allocated()
    if profile:
        print_device_breakdown(prof, wall, card)
    lowest = float(min(energies))
    e_state = ttns.expectation(ttno) / ttns.ttns_norm ** 2
    largest = max(
        int(np.prod(n.shape[:-1])) * int(np.prod(n.parent.shape)) // n.shape[-1]
        for n in ttns.node_list if n.parent is not None)
    print(f"{tag} energies per sweep {[round(float(e), 10) for e in energies]}",
          flush=True)
    print(f"{tag} {len(sweep_times)} sweeps, seconds per sweep ({card}) "
          f"{[round(t, 4) for t in sweep_times]}; total {wall:.2f} s; lowest "
          f"{lowest:.10f} (anchor {E_REF}, diff {lowest - E_REF:+.3e}, bound "
          f"{TREE_E_TOL:.0e}); <psi|H|psi> of the result {e_state:.10f}; bond dims "
          f"{ttns.bond_dims}; largest 2-site coefficient {largest} entries "
          f"({largest * 4 / 2**20:.1f} MiB in fp32); peak device memory "
          f"{peak / 2**30:.3f} GiB; jacobi launches {launches}; Gram eigh "
          f"elsewhere {elsewhere}", flush=True)
    hist = grams.report(tag, launches)
    grams.check_against_library(tag, gram_tol)
    _hold_unheld(tag, grams, phase3_held(), gram_tol)
    check(launches > 0, f"{tag} never launched the Jacobi kernel")
    check(elsewhere == 0, f"{tag} {elsewhere} Gram eigh went around the kernel")
    check(all(bool(torch.isfinite(n.tensor).all()) for n in ttns)
          and max(ttns.bond_dims) <= m, f"{tag} bad result")
    check(abs(lowest - E_REF) < TREE_E_TOL,
          f"{tag} energy {lowest} not within {TREE_E_TOL} of {E_REF}")
    timed = _tree_shapes_timed(tag, grams, hist) if time_shapes else {}
    return launches, dict(sweeps=sweep_times, energy_diff=lowest - E_REF,
                          peak_gib=peak / 2**30, timed=timed, energies=energies)


def phase_tree_pyrazine(card, nsteps=PYR_STEPS):
    """Phase 14(b): tests/test_pyr4.py::test_pyr4_ttns on the card in
    complex64: 4-mode pyrazine (nbas 30) on BasisTree.binary from S2,
    expand_bond_dimension(ttno), TDVP-PS with CompressConfig(fixed,
    max_bonddim=10), 60 steps of 2 fs; S1/S2 populations within PYR_TOL of
    the Heidelberg MCTDH data at every point."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch import CompressConfig, CompressCriteria, EvolveConfig, EvolveMethod, Op
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.model.pyrazine import E_DOFS, pyrazine_model
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.tn import TTNO, TTNS, BasisTree
    from renormalizer_tpu_torch.utils.constant import fs2au

    tag = "[tree b]"
    mctdh = np.load(PYR_MCTDH)[::4][:nsteps + 1, 1:]
    model = pyrazine_model()
    tree = BasisTree.binary(model.basis)
    jacobi_eigh.launches = 0
    t0 = time.perf_counter()
    ttno = TTNO(tree, model.ham_terms)
    ttns = TTNS(tree, condition={"s2": 1}).expand_bond_dimension(ttno)
    ttns.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    ttns.compress_config = CompressConfig(CompressCriteria.fixed, max_bonddim=10)
    occ_ttnos = [TTNO(tree, [Op(r"a^\dagger a", s)]) for s in E_DOFS]
    occ = [[float(np.real(ttns.expectation(o))) for o in occ_ttnos]]
    backend.sync()
    setup = time.perf_counter() - t0
    steps = []
    for _ in range(nsteps):
        t0 = time.perf_counter()
        ttns = ttns.evolve(ttno, 2 * fs2au)
        backend.sync()
        steps.append(time.perf_counter() - t0)
        occ.append([float(np.real(ttns.expectation(o))) for o in occ_ttnos])
    occ = np.array(occ)
    dev = np.abs(occ - mctdh)
    print(f"{tag} set-up {setup:.2f} s; {nsteps} TDVP-PS steps of 2 fs, seconds "
          f"per step ({card}) mean {np.mean(steps):.4f} min {min(steps):.4f} max "
          f"{max(steps):.4f}, total {sum(steps):.2f} s; state {ttns.root.tensor.dtype}, "
          f"bond dims {ttns.bond_dims}; jacobi launches {jacobi_eigh.launches}",
          flush=True)
    print(f"{tag} S1/S2 populations at 0, 30, 60, 90, 120 fs: "
          f"{[[round(float(x), 4) for x in occ[i]] for i in range(0, nsteps + 1, 15)]}; "
          f"MCTDH {[[round(float(x), 4) for x in mctdh[i]] for i in range(0, nsteps + 1, 15)]}; "
          f"largest deviation {dev.max():.3e} at {2 * int(dev.max(axis=1).argmax())} fs "
          f"(bound {PYR_TOL})", flush=True)
    check(ttns.root.tensor.dtype == torch.complex64, f"{tag} state is {ttns.root.tensor.dtype}")
    check(np.isfinite(occ).all() and dev.max() < PYR_TOL,
          f"{tag} populations {dev.max():.3e} off MCTDH")
    return steps, float(dev.max())


def phase_tree_oracles():
    """Phase 14(c): the tree engine's small oracles on tests/test_tn.py's
    models in fp32, at TREE_BOUNDS: TDVP-PS, TDVP-PS2 and VMF against
    scipy.linalg.expm, state-averaged tree DMRG (2 roots) against the dense
    sector spectrum, the thermofield state (max_entangled_ex) and its
    TDVP-PS, and the from_mps round trip."""
    import numpy as np
    import scipy.linalg

    from renormalizer_tpu_torch import (
        CompressConfig, EvolveConfig, EvolveMethod, HolsteinModel, Mol, Mpo, Mps,
        Op, Phonon, Quantity)
    from renormalizer_tpu_torch.tn import (
        TTNO, TTNS, BasisTree, from_mps, max_entangled_ex, optimize_ttns)
    from renormalizer_tpu_torch.tn.time_evolution import TREE_COUNTS

    tag = "[tree c]"
    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    tree = BasisTree.binary(model.basis)
    ttno = TTNO(tree, model.ham_terms)
    start = TTNS(tree, condition={0: 1}).expand_bond_dimension(ttno)
    h = dense_operator(model, model.ham_terms)
    occ_ops = [dense_operator(model, [Op(r"a^\dagger a", d)]) for d in model.e_dofs]
    occ_ttnos = [TTNO(tree, [Op(r"a^\dagger a", d)]) for d in model.e_dofs]
    results = {}
    for method in ("tdvp_ps", "tdvp_ps2", "tdvp_vmf"):
        ttns = start.copy()
        ttns.evolve_config = EvolveConfig(EvolveMethod[method])
        if method == "tdvp_ps2":
            ttns.compress_config = CompressConfig(threshold=1e-7)
        psi0 = ttns.todense(order=model.basis).ravel().astype(complex)
        counts0 = dict(TREE_COUNTS)
        devs = []
        for i in range(1, 6):
            ttns = ttns.evolve(ttno, 0.2)
            psi = scipy.linalg.expm(-1j * h * 0.2 * i) @ psi0
            oracle = [np.real(psi.conj() @ o @ psi) for o in occ_ops]
            devs.append(np.abs(np.array([ttns.expectation(o) for o in occ_ttnos])
                               - oracle).mean())
        results[method] = float(np.mean(devs))
        print(f"{tag} {method}: 5 steps of 0.2, mean occupation deviation from "
              f"expm {results[method]:.3e} (bound {TREE_BOUNDS['evolve']}); "
              f"Krylov propagations {TREE_COUNTS['local_steps'] - counts0['local_steps']}, "
              f"VMF overlaps read to the host "
              f"{TREE_COUNTS['vmf_host_reads'] - counts0['vmf_host_reads']}", flush=True)
        check(results[method] < TREE_BOUNDS["evolve"], f"{tag} {method} {results[method]}")

    ttns = TTNS.random(tree, 1, 16)
    ttns.optimize_config.nroots = 2
    energies = optimize_ttns(ttns, ttno, [[8, 0.4], [16, 0.2], [16, 0], [16, 0], [16, 0]])
    sector = np.nonzero(_sector_of(model, len(h)) == 1)[0]
    exact = np.linalg.eigvalsh(h[np.ix_(sector, sector)].real)[:2]
    results["nroots"] = float(np.abs(np.sort(energies[-1]) - exact).max())
    print(f"{tag} state-averaged tree DMRG, 2 roots: {sorted(energies[-1])} against "
          f"{exact.tolist()}, largest deviation {results['nroots']:.3e} (bound "
          f"{TREE_BOUNDS['nroots']})", flush=True)
    check(results["nroots"] < TREE_BOUNDS["nroots"], f"{tag} nroots {results['nroots']}")

    tree2 = tree.add_auxiliary_space()
    hot = max_entangled_ex(tree2)
    occ0 = [hot.expectation(TTNO(tree2, [Op(r"a^\dagger a", d)])) for d in model.e_dofs]
    results["thermofield_occupation"] = float(np.abs(np.array(occ0) - 1 / 3).max())
    ttno2 = TTNO(tree2, model.ham_terms)
    hot = hot.expand_bond_dimension(ttno2)
    hot.evolve_config = EvolveConfig(EvolveMethod.tdvp_ps)
    e0 = hot.expectation(ttno2)
    for _ in range(3):
        hot = hot.evolve(ttno2, 4.0)
    results["thermofield_energy"] = float(abs(hot.expectation(ttno2) - e0))
    results["thermofield_norm"] = float(abs(hot.ttns_norm - 1))
    print(f"{tag} max_entangled_ex: occupations {[round(float(x), 8) for x in occ0]}; "
          f"after 3 TDVP-PS steps of 4.0 energy drift {results['thermofield_energy']:.3e}, "
          f"norm - 1 {results['thermofield_norm']:.3e} (bounds "
          f"{TREE_BOUNDS['thermofield_occupation']}, {TREE_BOUNDS['thermofield_energy']}, "
          f"{TREE_BOUNDS['thermofield_norm']})", flush=True)
    for key in ("thermofield_occupation", "thermofield_energy", "thermofield_norm"):
        check(results[key] < TREE_BOUNDS[key], f"{tag} {key} {results[key]}")

    mps = Mps.random(model, 1, 8)
    _, ttns, ttno_lin = from_mps(mps)
    results["from_mps"] = float(abs(ttns.expectation(ttno_lin) - mps.expectation(Mpo(model))))
    print(f"{tag} from_mps: |<H>_tree - <H>_mps| {results['from_mps']:.3e} (bound "
          f"{TREE_BOUNDS['from_mps']})", flush=True)
    check(results["from_mps"] < TREE_BOUNDS["from_mps"], f"{tag} from_mps {results['from_mps']}")
    return results


def phase_tree(card, gram_tol, profile=False):
    """Phase 14: the tree engine, (a) tree DMRG at full width, (b) the
    pyrazine MCTDH check, (c) the small oracles."""
    launches, dmrg = phase_tree_dmrg(card, gram_tol, profile=profile)
    steps, pyr_dev = phase_tree_pyrazine(card)
    oracles = phase_tree_oracles()
    return launches, dict(dmrg, pyrazine_steps=steps, pyrazine_dev=pyr_dev,
                          oracles=oracles)


@contextlib.contextmanager
def _environ(**values):
    """The port's knobs set for a block (they are read at call time), and
    restored after it; RENO_HOST_OFFLOAD's cached read is cleared both
    ways."""
    from renormalizer_tpu_torch.mps import offload

    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    offload.hot_window.cache_clear()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        offload.hot_window.cache_clear()


@contextlib.contextmanager
def _constants(**values):
    """trunc_device's module constants set for a block, and restored after
    it."""
    from renormalizer_tpu_torch.mps import trunc_device

    old = {k: getattr(trunc_device, k) for k in values}
    for k, v in values.items():
        setattr(trunc_device, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(trunc_device, k, v)


def _merged(records):
    """One GramRecord holding the Grams of several, so that a shape phase 3
    did not hold is held by one plain call per padded size."""
    out = GramRecord(keep_grams=True)
    for rec in records:
        out.grams += rec.grams
        out.itemsizes += rec.itemsizes
        for key, kept in rec.kept.items():
            out.kept.setdefault(key, []).extend(kept)
    return out


def _hide_counters():
    from renormalizer_tpu_torch.mps import trunc_device

    stats = trunc_device.PLAN_STATS
    return dict(static=stats["static"], stale=stats["stale"], sync=stats["sync"],
                noarm=stats["noarm"], reads=trunc_device.SPECTRUM_READS,
                hits=trunc_device.IDX_CACHE_STATS["hits"],
                misses=trunc_device.IDX_CACHE_STATS["misses"],
                retries=trunc_device.SKETCH_RETRIES)


def _hide_dmrg(tag, card, mps, mpo, env, consts=None):
    """The sweeps of ``mps.optimize_config.procedure`` under the environment
    ``env`` and trunc_device's constants ``consts``, every one of them (as bench.py drives its steady state: the
    sweep loop of optimize_mps without its early stop, so that a plan meets
    its pattern again), every Gram recorded (kept for the plain version):
    per sweep its seconds, the site updates and the selection paths they
    took (PLAN_STATS), the host reads of a spectrum, the index cache's hits
    and misses and the exact retries of a sketch; the sync reasons of the run; the
    peak device memory."""
    import torch

    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.mps.mp import MatrixProduct
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

    grams = GramRecord(keep_grams=True)
    count = collections.Counter()
    update = MatrixProduct._update_mps_device
    sweeps, energies = [], []

    def counted_update(self, *args, **kwargs):
        static, reads = trunc_device.PLAN_STATS["static"], trunc_device.SPECTRUM_READS
        count["updates"] += 1
        out = update(self, *args, **kwargs)
        if trunc_device.PLAN_STATS["static"] > static:
            count["static_reads"] += trunc_device.SPECTRUM_READS - reads
        return out

    with _environ(**env), _constants(**(consts or {})):
        trunc_device.reset_plan_stats()
        trunc_device.jacobi_eigh = grams
        MatrixProduct._update_mps_device = counted_update
        torch.cuda.reset_peak_memory_stats()
        # earlier runs' kept Grams stay allocated: the peak is read above it
        base = torch.cuda.memory_allocated()
        try:
            jacobi_eigh.launches = 0
            trunc_device.LINALG_EIGH_GRAMS = 0
            backend.sync()
            t0 = time.perf_counter()
            mps.ensure_left_canonical()
            environ = gs.Environ(mps, mpo, "L")
            opt_e_idx = None
            for config, percent in mps.optimize_config.procedure:
                mps.compress_config = config if isinstance(config, CompressConfig) \
                    else CompressConfig(CompressCriteria.fixed, max_bonddim=config)
                before, updates = _hide_counters(), count["updates"]
                backend.sync()
                t1 = time.perf_counter()
                micro, _ = gs.single_sweep(mps, mpo, environ, None, percent, opt_e_idx)
                backend.sync()
                seconds = time.perf_counter() - t1
                after = _hide_counters()
                sweeps.append(dict(seconds=seconds, percent=percent,
                                   updates=count["updates"] - updates,
                                   **{k: after[k] - before[k] for k in after}))
                e, opt_e_idx = min(micro)
                energies.append(e)
            total = time.perf_counter() - t0
            launches = jacobi_eigh.launches
            elsewhere = trunc_device.LINALG_EIGH_GRAMS
        finally:
            trunc_device.jacobi_eigh = jacobi_eigh
            MatrixProduct._update_mps_device = update
        reasons = collections.Counter(
            r for _, r in trunc_device.PLAN_STATS.get("sync_sites", []))
    opt = mps
    peak = torch.cuda.max_memory_allocated() - base
    e_min = float(min(energies))
    print(f"{tag} {env}: lowest {e_min:.10f} (diff {e_min - E_REF:+.3e}); "
          f"{total:.2f} s; peak device memory {peak / 2**30:.3f} GiB above the "
          f"{base / 2**30:.3f} GiB allocated before the run; bond dims "
          f"{opt.bond_dims}; jacobi launches {launches}; sync reasons "
          f"{dict(reasons)}", flush=True)
    for i, sw in enumerate(sweeps):
        print(f"{tag}   sweep {i} (percent {sw['percent']}): {sw['seconds']:.4f} s "
              f"({card}); {sw['updates']} updates: static {sw['static']} stale "
              f"{sw['stale']} sync {sw['sync']} noarm {sw['noarm']}; spectrum "
              f"reads {sw['reads']}; index cache hits {sw['hits']} misses "
              f"{sw['misses']}; sketch retries {sw['retries']}", flush=True)
    check(elsewhere == 0, f"{tag} {elsewhere} Gram eigh went around the kernel")
    check(all(bool(torch.isfinite(t).all()) for t in opt), f"{tag} non-finite MPS")
    totals = {k: sum(sw[k] for sw in sweeps) for k in sweeps[0] if k != "percent"}
    return dict(energies=[float(e) for e in energies], e_min=e_min, sweeps=sweeps,
                totals=totals, launches=launches, grams=grams, peak=peak,
                static_reads=count["static_reads"],
                opt=opt, reasons=dict(reasons))


def phase_hide_async(card, gram_tol):
    """Phase 15(a): phase 4's DMRG with the asynchronous static-plan
    selection (RENO_ASYNC_TRUNC=1), synchronously (=0), then synchronously
    and asynchronously again, so that the two modes are timed in alternated
    order: each within E_TOL of E_REF; static updates in the percent-0
    sweeps of the asynchronous runs, which read no spectrum (the reads
    counted around each static update).  Launches by (batch, n) per run;
    the Grams are held against the plain version with 15(c)'s."""
    from renormalizer_tpu_torch import Mpo, Mps

    tag = "[hide a]"
    model = holstein_chain(6)
    mpo = Mpo(model)
    seed = Mps.random(model, 1, M, percent=1.0)
    runs = {}
    for name, flag in (("async", 1), ("sync", 0), ("sync2", 0), ("async2", 1)):
        mps = seed.copy()
        mps.optimize_config.procedure = PROCEDURE
        mps.optimize_config.method = "2site"
        run = _hide_dmrg(f"{tag} {name}", card, mps, mpo, dict(RENO_ASYNC_TRUNC=flag))
        run["hist"] = run["grams"].report(f"{tag} {name}", run["launches"])
        runs[name] = run
        check(abs(run["e_min"] - E_REF) < E_TOL,
              f"{tag} {name}: energy {run['e_min']} not within {E_TOL} of {E_REF}")
        tot = run["totals"]
        if not flag:
            check(tot["static"] == tot["stale"] == tot["sync"] == 0,
                  f"{tag} {name} run took the plan paths: {tot}")
            continue
        static0 = sum(sw["static"] for sw in run["sweeps"] if sw["percent"] == 0)
        check(static0 > 0, f"{tag} {name}: no static update in the percent-0 sweeps")
        check(run["static_reads"] == 0,
              f"{tag} {name}: static updates read {run['static_reads']} spectra")
    for name, run in runs.items():
        tot = run["totals"]
        print(f"{tag} {name}: sweep seconds {[round(sw['seconds'], 4) for sw in run['sweeps']]}"
              f"; static share {tot['static'] / tot['updates']:.3f} of "
              f"{tot['updates']} updates; spectrum reads {tot['reads']}", flush=True)
    return runs


def phase_hide_sketch(card, gram_tol, start):
    """Phase 15(b): threshold-criteria DMRG from ``start`` (15(a)'s
    converged M=256 state) with CompressCriteria.both at SKETCH_THRESHOLD
    and max_bonddim M, SKETCH_SWEEPS percent-0 sweeps: exact (the default
    caps: full-rank candidates, up to rank 1536), sketched (exact cap
    SKETCH_EXACT_CAP: the phonon-phonon updates sketch SKETCH_GRAM states,
    normalized by frob_norm) and starved (sketch cap 1: the saturation check
    must send updates back to exact candidates on the device).  Gates: each
    within E_TOL of E_REF, the three lowest energies within SKETCH_RTOL of
    each other, frob_norm ran in the sketched run, the (batch, SKETCH_GRAM)
    Grams were launched, retries in the starved run; every shape held
    against the plain version."""
    from renormalizer_tpu_torch import Mpo
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

    tag = "[hide b]"
    mpo = Mpo(holstein_chain(6))
    frob = trunc_device.frob_norm
    calls = collections.Counter()

    def counted_frob(arr):
        calls["frob"] += 1
        return frob(arr)

    runs = {}
    trunc_device.frob_norm = counted_frob
    try:
        for name, consts in (
                ("exact", {}),
                ("sketched", dict(EXACT_CAP=SKETCH_EXACT_CAP)),
                ("starved", dict(EXACT_CAP=SKETCH_EXACT_CAP, SKETCH_CAP=1))):
            calls.clear()
            mps = start.copy()
            mps.optimize_config.procedure = [
                [CompressConfig(CompressCriteria.both, threshold=SKETCH_THRESHOLD,
                                max_bonddim=M), 0] for _ in range(SKETCH_SWEEPS)]
            mps.optimize_config.method = "2site"
            run = _hide_dmrg(f"{tag} {name}", card, mps, mpo, {}, consts)
            run["frob"] = calls["frob"]
            run["hist"] = run["grams"].report(f"{tag} {name}", run["launches"])
            runs[name] = run
            print(f"{tag} {name}: frob_norm calls {run['frob']}, sketch retries "
                  f"{run['totals']['retries']}", flush=True)
            check(abs(run["e_min"] - E_REF) < E_TOL,
                  f"{tag} {name}: energy {run['e_min']} not within {E_TOL} of {E_REF}")
    finally:
        trunc_device.frob_norm = frob
    check(runs["exact"]["frob"] == 0 and runs["exact"]["totals"]["retries"] == 0,
          f"{tag} the exact run sketched")
    check(runs["sketched"]["frob"] > 0, f"{tag} frob_norm never ran in the sketched run")
    check(any(n == SKETCH_GRAM for _, n in runs["sketched"]["hist"]),
          f"{tag} the sketched run launched no (batch, {SKETCH_GRAM}) Gram")
    check(runs["starved"]["totals"]["retries"] > 0, f"{tag} no exact retry")
    e_exact = runs["exact"]["e_min"]
    for name in ("sketched", "starved"):
        rel = abs(runs[name]["e_min"] - e_exact) / abs(e_exact)
        print(f"{tag} {name}: lowest energy off the exact run's by {rel:.3e} "
              f"(relative)", flush=True)
        check(rel < SKETCH_RTOL, f"{tag} {name} energy {runs[name]['e_min']} vs {e_exact}")
    _hold_unheld(tag, _merged([r["grams"] for r in runs.values()]), phase3_held(),
                 gram_tol)
    timed = _tree_shapes_timed(f"{tag} sketched", runs["sketched"]["grams"],
                               runs["sketched"]["hist"])
    return runs, timed


def phase_hide_offload(card, sync_run):
    """Phase 15(c): 15(a)'s synchronous run with RENO_HOST_OFFLOAD=2 and
    every site tensor offloadable (dump_matrix_size = 1 in each procedure
    entry): environments evicted and restored, cold environments and sites
    seen in pinned host memory, the energies those of 15(a)'s synchronous
    run to OFFLOAD_RTOL."""
    import numpy as np

    from renormalizer_tpu_torch import Mpo, Mps
    from renormalizer_tpu_torch.mps import gs, offload
    from renormalizer_tpu_torch.mps.mp import MatrixProduct
    from renormalizer_tpu_torch.utils import CompressConfig, CompressCriteria

    tag = "[hide c]"
    model = holstein_chain(6)
    mpo = Mpo(model)
    mps = Mps.random(model, 1, M, percent=1.0)
    mps.optimize_config.procedure = [
        [CompressConfig(CompressCriteria.fixed, max_bonddim=m, dump_matrix_size=1), p]
        for m, p in PROCEDURE]
    mps.optimize_config.method = "2site"
    mps.compress_config.dump_matrix_size = 1
    seen = collections.Counter()
    stores = []
    environ_cls = gs.Environ
    offload_sites = MatrixProduct._offload_cold_sites
    evict = offload.TieredStore._evict

    class RecordedEnviron(environ_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            stores.append(self._store)

    def recorded_offload(self, center):
        offload_sites(self, center)
        seen["cold sites"] += len(self._cold_sites)
        seen["pinned sites"] += sum(self._mp[i].device.type == "cpu" and self._mp[i].is_pinned()
                                    for i in self._cold_sites)

    def recorded_evict(self):
        evict(self)
        seen["cold environments"] += len(self._cold)
        seen["pinned environments"] += sum(
            self._data[k].device.type == "cpu" and self._data[k].is_pinned()
            for k in self._cold)

    gs.Environ = RecordedEnviron
    MatrixProduct._offload_cold_sites = recorded_offload
    offload.TieredStore._evict = recorded_evict
    try:
        run = _hide_dmrg(tag, card, mps, mpo,
                         dict(RENO_ASYNC_TRUNC=0, RENO_HOST_OFFLOAD=2))
    finally:
        gs.Environ = environ_cls
        MatrixProduct._offload_cold_sites = offload_sites
        offload.TieredStore._evict = evict
    evicted = sum(s.n_evicted for s in stores)
    restored = sum(s.n_restored for s in stores)
    run["hist"] = run["grams"].report(tag, run["launches"])
    e, e_ref = np.array(run["energies"]), np.array(sync_run["energies"])
    rel = float(np.abs(e - e_ref).max() / np.abs(e_ref).max()) if len(e) == len(e_ref) \
        else float("inf")
    print(f"{tag} environments evicted {evicted} restored {restored}; "
          f"{dict(seen)}; energies off 15(a)'s synchronous run by {rel:.3e} "
          f"(relative); peak device memory {run['peak'] / 2**30:.3f} GiB against "
          f"{sync_run['peak'] / 2**30:.3f} GiB untiered ({card})", flush=True)
    check(len(stores) > 0 and all(isinstance(s, offload.TieredStore) for s in stores),
          f"{tag} the environments were not tiered")
    check(evicted > 0 and restored > 0, f"{tag} evicted {evicted} restored {restored}")
    check(seen["pinned environments"] > 0 and seen["pinned sites"] > 0,
          f"{tag} no cold tensor seen in pinned host memory: {dict(seen)}")
    check(rel < OFFLOAD_RTOL, f"{tag} energies {run['energies']} vs {sync_run['energies']}")
    return run, dict(evicted=evicted, restored=restored, **seen)


def phase_hide_tree(card, gram_tol):
    """Phase 15(d): phase 14(a) synchronously and with the plan reuse
    (RENO_ASYNC_TRUNC=0 and 1): both within TREE_E_TOL of E_REF (14(a)'s own
    gate) and the previous visit's spectrum reused in the asynchronous
    run."""
    from renormalizer_tpu_torch.mps import trunc_device

    out = {}
    for flag in (0, 1):
        with _environ(RENO_ASYNC_TRUNC=flag):
            trunc_device.reset_plan_stats()
            launches, run = phase_tree_dmrg(card, gram_tol, tag=f"[hide d] async={flag}",
                                            time_shapes=False)
            stats = dict(trunc_device.PLAN_STATS)
        print(f"[hide d] async={flag}: plan reuse {stats['tree_stale']}, current "
              f"spectrum {stats['tree_sync']}", flush=True)
        out[flag] = dict(run, launches=launches, reuse=stats["tree_stale"])
    check(out[0]["reuse"] == 0, "[hide d] the synchronous run reused a plan")
    check(out[1]["reuse"] > 0, "[hide d] the asynchronous run never reused a plan")
    return out


def phase_hide_profile(card):
    """Phase 15(e): two percent-0 sweeps (the fewest that optimize_mps
    returns a state from) of a 2-molecule chain at M=8 under RENO_PROFILE:
    optimize_mps's maybe_profile must write a trace.  The chain is small
    because the trace holds every operator: two sweeps of the bench chain
    at M=16 wrote 256 MB in a CPU rehearsal."""
    import tempfile

    from renormalizer_tpu_torch import HolsteinModel, Mpo, Mps, Quantity, optimize_mps

    chain = holstein_chain(4)
    model = HolsteinModel(chain.mol_list[:2], Quantity(-0.1, "eV"))
    mps = Mps.random(model, 1, 8, percent=1.0)
    mps.optimize_config.procedure = [[8, 0]] * 2
    with tempfile.TemporaryDirectory() as tmp:
        with _environ(RENO_PROFILE=tmp):
            t0 = time.perf_counter()
            optimize_mps(mps, Mpo(model))
            seconds = time.perf_counter() - t0
        path = os.path.join(tmp, "dmrg", "trace.json")
        size = os.path.getsize(path) if os.path.exists(path) else 0
    print(f"[hide e] two sweeps under RENO_PROFILE {seconds:.2f} s ({card}); "
          f"trace {size} bytes", flush=True)
    check(size > 0, "[hide e] no trace written")
    return size


def phase_hide(card, gram_tol):
    """Phase 15: the site update's host-hiding machinery and the tiering on
    the bench chain at full width, (a)-(e)."""
    runs_a = phase_hide_async(card, gram_tol)
    runs_b, timed_b = phase_hide_sketch(card, gram_tol, runs_a["sync"]["opt"])
    run_c, tiers = phase_hide_offload(card, runs_a["sync"])
    _hold_unheld("[hide a, c]", _merged([r["grams"] for r in (*runs_a.values(), run_c)]),
                 phase3_held(), gram_tol)
    tree = phase_hide_tree(card, gram_tol)
    trace_bytes = phase_hide_profile(card)
    launches = {"async_dmrg": runs_a["async"]["launches"],
                "sync_dmrg": runs_a["sync"]["launches"],
                "sketch_threshold_dmrg": runs_b["sketched"]["launches"],
                "offload_dmrg": run_c["launches"],
                "tree_dmrg_async": tree[1]["launches"]}
    summary = {
        "sweep_seconds": {name: [round(sw["seconds"], 4) for sw in run["sweeps"]]
                          for name, run in runs_a.items()},
        "static_share": {name: round(run["totals"]["static"] / run["totals"]["updates"], 3)
                         for name, run in runs_a.items()},
        "spectrum_reads": {name: run["totals"]["reads"] for name, run in runs_a.items()},
        "index_cache": {name: [run["totals"]["hits"], run["totals"]["misses"]]
                        for name, run in runs_a.items()},
        "sketch_energy_diffs": {name: f"{run['e_min'] - E_REF:+.3e}"
                                for name, run in runs_b.items()},
        "sketch_retries": {name: run["totals"]["retries"] for name, run in runs_b.items()},
        "offload": dict(tiers, peak_gib=round(run_c["peak"] / 2**30, 3),
                        untiered_peak_gib=round(runs_a["sync"]["peak"] / 2**30, 3),
                        sweep_seconds=[round(sw["seconds"], 4) for sw in run_c["sweeps"]]),
        "tree_sweep_seconds": {f"async={k}": [round(t, 4) for t in v["sweeps"]]
                               for k, v in tree.items()},
        "tree_plan_reuse": tree[1]["reuse"],
        "trace_bytes": trace_bytes,
        "gram_ms": {f"sketched {k}": {n: round(v[n], 3) for n in
                                    ("kernel", "plain", "torch.linalg.eigh")}
                    | {"launches": v["launches"]}
                    for k, v in timed_b.items()},
    }
    return launches, summary


def _mesh_for_card():
    """Phase 16's (1, 2, 2) mesh: four distinct cards when four are
    visible, else the first card named four times (every piece of the
    sharded path runs; the copies between cards are skipped)."""
    import torch

    from renormalizer_tpu_torch import parallel as par

    if torch.cuda.device_count() >= 4:
        mesh = par.make_mesh(i=2, j=2)
    else:
        mesh = par.make_mesh(i=2, j=2, devices=[torch.device("cuda", 0)] * 4)
    distinct = len(set(mesh.devices.flat))
    print(f"[mesh] mesh {mesh.shape} over {[str(d) for d in mesh.devices.flat]}: "
          f"{distinct} distinct device(s) of {torch.cuda.device_count()} visible",
          flush=True)
    return mesh, distinct


def phase_mesh_dmrg(card, gram_tol, mesh, distinct, main, profile=False):
    """Phase 16(a): phase 4's DMRG (M=256, its procedure) under the mesh:
    the bond-parallel hop of every divisible site update, and the sectors
    placed round-robin over the mesh's devices when it spans more than one
    distinct card (the default rule; none on one card).  Gates: the energy
    within E_TOL of E_REF and of phase 4's; at least one sharded update;
    sectors placed exactly when the mesh has several distinct cards; every
    Gram through the kernel, none at the sweep cap, the shapes phase 3 did
    not hold against the plain version.  Returns the launches, the run's
    numbers and the arguments of the run's widest candidates call (16(b)'s
    coefficient: only a reference is kept inside the timed window, the
    copy is made after it).  With ``profile`` the run is traced by
    torch.profiler and its device time per kernel and busy share printed."""
    import torch

    from renormalizer_tpu_torch import Mpo, Mps, optimize_mps
    from renormalizer_tpu_torch import parallel as par
    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import gs, trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.parallel import hop as phop

    tag = "[mesh a]"
    model = holstein_chain(6)
    mpo = Mpo(model)
    mps = Mps.random(model, 1, M, percent=1.0)
    mps.optimize_config.procedure = PROCEDURE
    mps.optimize_config.method = "2site"
    sweep_times = []
    single_sweep = gs.single_sweep
    candidates = trunc_device.candidates
    widest = {}

    def timed_sweep(*args, **kwargs):
        backend.sync()
        t0 = time.perf_counter()
        out = single_sweep(*args, **kwargs)
        backend.sync()
        sweep_times.append(time.perf_counter() - t0)
        return out

    def recorded_candidates(*args, **kwargs):
        # a reference to the widest coefficient: no copy, no wait
        if args[0].numel() > widest.get("numel", 0):
            widest.update(args=args, kwargs=kwargs, numel=args[0].numel())
        return candidates(*args, **kwargs)

    grams = GramRecord(keep_grams=True)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile else contextlib.nullcontext()
    gs.single_sweep = timed_sweep
    trunc_device.candidates = recorded_candidates
    trunc_device.jacobi_eigh = grams
    par.set_global_mesh(mesh)
    phop.reset_stats()
    trunc_device.SECTORS_PLACED.clear()
    trunc_device.reset_plan_stats()
    try:
        jacobi_eigh.launches = 0
        trunc_device.LINALG_EIGH_GRAMS = 0
        backend.sync()
        t0 = time.perf_counter()
        with prof:
            energies, opt = optimize_mps(mps, mpo)
            backend.sync()
        total = time.perf_counter() - t0
        launches = jacobi_eigh.launches
        elsewhere = trunc_device.LINALG_EIGH_GRAMS
        stats = {k: phop.STATS[k] for k in ("sharded", "fallback")}
        gathers = dict(phop.GATHERS)
        placed = dict(trunc_device.SECTORS_PLACED)
        plan = {k: v for k, v in trunc_device.PLAN_STATS.items()
                if v and k != "sync_sites"}
        plan["sync_reasons"] = dict(collections.Counter(
            r for _, r in trunc_device.PLAN_STATS.get("sync_sites", [])))
        audit = phop.audit_engaged_collectives(n_sweeps=len(sweep_times))
    finally:
        par.set_global_mesh(None)
        gs.single_sweep = single_sweep
        trunc_device.candidates = candidates
        trunc_device.jacobi_eigh = jacobi_eigh
    placed_call = dict(widest, args=(widest["args"][0].clone(),) + widest["args"][1:])
    if profile:
        print_device_breakdown(prof, total, card)
    e_min = float(min(energies))
    none = {"count": 0, "bytes": 0}
    per_sweep = audit["per_sweep"].get("all-gather", none)
    per_matvec = audit["per_matvec"].get("all-gather", none)
    print(f"{tag} energies per sweep: {[float(e) for e in energies]}", flush=True)
    print(f"{tag} lowest energy {e_min:.10f} (reference {E_REF}, diff "
          f"{e_min - E_REF:+.3e}; phase 4 {main['energy']:.10f}, diff "
          f"{e_min - main['energy']:+.3e}); bond dims {opt.bond_dims}", flush=True)
    print(f"{tag} sweep seconds ({card}): sharded "
          f"{[round(t, 4) for t in sweep_times]}, total {total:.2f} s; phase 4 "
          f"{[round(t, 4) for t in main['sweeps']]}, total {main['total']:.2f} s",
          flush=True)
    print(f"{tag} site updates sharded {stats['sharded']}, fallback "
          f"{stats['fallback']}; sharded matvecs {audit['matvecs']}; gathers run "
          f"{gathers['count']} ({gathers['bytes']} bytes): per matvec "
          f"{per_matvec['count']:.1f} gathers, {per_matvec['bytes']:.0f} bytes; per "
          f"sweep {per_sweep['count']:.1f} gathers, {per_sweep['bytes']:.0f} bytes",
          flush=True)
    print(f"{tag} sectors placed per device {placed} ({distinct} distinct "
          f"device(s): placed only on several); PLAN_STATS {plan}; jacobi "
          f"launches {launches}; Gram eigh elsewhere {elsewhere}", flush=True)
    grams.report(tag, launches)
    _hold_unheld(tag, grams, phase3_held(), gram_tol)
    check(abs(e_min - E_REF) < E_TOL, f"{tag} energy {e_min} not within {E_TOL} of {E_REF}")
    check(abs(e_min - main["energy"]) < E_TOL,
          f"{tag} energy {e_min} not within {E_TOL} of phase 4's {main['energy']}")
    check(stats["sharded"] > 0, f"{tag} no site update was sharded")
    check((sum(placed.values()) > 0) == (distinct > 1),
          f"{tag} sectors placed {placed} on a mesh of {distinct} distinct device(s)")
    check(launches > 0, f"{tag} never launched the Jacobi kernel")
    check(elsewhere == 0, f"{tag} {elsewhere} Gram eigh went around the kernel")
    check(max(opt.bond_dims) <= M and len(opt) == 18, f"{tag} bad result shape")
    check(all(bool(torch.isfinite(t).all()) and t.device == backend.device for t in opt),
          f"{tag} a site tensor is non-finite or off the home device")
    summary = dict(sweeps=[round(t, 4) for t in sweep_times], total=round(total, 4),
                   energy_diff=f"{e_min - E_REF:+.3e}", sharded=stats["sharded"],
                   fallback=stats["fallback"], gathers_per_sweep=per_sweep,
                   gathers_per_matvec=per_matvec, gathers_run=gathers, sectors_placed=placed, plan_stats=plan)
    return launches, summary, placed_call


def phase_mesh_candidates(mesh, call):
    """Phase 16(b): candidates of 16(a)'s widest coefficient (several
    sectors) with the sectors placed over the mesh (``PLACE_SECTORS``
    forced on, so a mesh of one card places too) and without, both through
    the per-sector path (MASK_BUDGET 0): bitwise equal."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch import parallel as par
    from renormalizer_tpu_torch.mps import trunc_device

    tag = "[mesh b]"
    coef, qnbigl, qnbigr, qntot, system, cap = call["args"]
    kwargs = dict(want_complement=call["kwargs"].get("want_complement", False))
    runs = {}
    par.set_global_mesh(mesh)
    try:
        for flag in (False, True):
            with _constants(MASK_BUDGET=0, PLACE_SECTORS=flag):
                trunc_device.SECTORS_PLACED.clear()
                parts, sigma, qn_list = trunc_device.candidates(
                    coef, qnbigl, qnbigr, qntot, system, cap, **kwargs)
                runs[flag] = (parts, sigma, qn_list, dict(trunc_device.SECTORS_PLACED))
    finally:
        par.set_global_mesh(None)
    (p0, s0, q0, d0), (p1, s1, q1, d1) = runs[False], runs[True]
    shape = tuple(int(d) for d in coef.shape)
    print(f"{tag} coefficient {shape}, cap {cap}, {len(p1)} sectors; placed "
          f"{d1} (off: {d0}); candidate columns {[p.shape[1] for p in p1]}", flush=True)
    check(not d0 and sum(d1.values()) == len(p1) > 1, f"{tag} placement {d0} / {d1}")
    check(q0 == q1 and np.array_equal(s0, s1)
          and all(torch.equal(a, b) for a, b in zip(p0, p1)),
          f"{tag} placement changed the candidates")
    print(f"{tag} candidates and spectra bitwise equal with placement on and off",
          flush=True)


def phase_mesh_tree(card, gram_tol, mesh):
    """Phase 16(c): 14(a)'s tree DMRG under the mesh: the general hop
    engaged, the energy within 14(a)'s gate."""
    from renormalizer_tpu_torch import parallel as par
    from renormalizer_tpu_torch.parallel import hop as phop

    par.set_global_mesh(mesh)
    phop.reset_stats()
    try:
        launches, out = phase_tree_dmrg(card, gram_tol, tag="[mesh c]",
                                        time_shapes=False)
        stats = dict(phop.STATS)
    finally:
        par.set_global_mesh(None)
    print(f"[mesh c] tree updates sharded {stats['sharded']}, fallback "
          f"{stats['fallback']} (the general factory: the tree calls no other)",
          flush=True)
    check(stats["sharded"] > 0, "[mesh c] the general tree hop never engaged")
    return launches, dict(sweeps=[round(t, 4) for t in out["sweeps"]],
                          energy_diff=f"{out['energy_diff']:+.3e}", **stats)


def phase_mesh_second_device(gram_tol):
    """Phase 16(d): with a second visible card, one Jacobi launch there
    held against the plain version; else says that it was not exercised."""
    import numpy as np
    import torch

    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh, jacobi_eigh_reference

    tag = "[mesh d]"
    if torch.cuda.device_count() < 2:
        print(f"{tag} one visible device: a Jacobi launch on a second device was "
              f"NOT exercised", flush=True)
        return False
    dev = torch.device("cuda", 1)
    a = _symmetric(np.random.default_rng(16), (2, 288, 288), torch.float32).to(dev)
    launches0 = jacobi_eigh.launches
    w, v = jacobi_eigh(a)
    torch.cuda.synchronize(dev)
    w_p, v_p = jacobi_eigh_reference(a)
    check(jacobi_eigh.launches == launches0 + 1 and w.device == dev == v.device,
          f"{tag} the launch did not run on {dev}")
    _check_eigh(f"{tag} kernel on {dev}", _eigh_errors(a, w, v), gram_tol)
    _check_eigh(f"{tag} plain on {dev}", _eigh_errors(a, w_p, v_p), gram_tol)
    err = float((w - w_p).abs().max() / torch.linalg.matrix_norm(a).max())
    check(err < 2 * gram_tol["eig"], f"{tag} kernel and plain differ by {err:.2e}·|A|")
    print(f"{tag} one (2, 288, 288) launch on {dev}: kernel and plain inside the "
          f"phase-3 tolerances, |w - w_plain| {err:.2e}·|A|", flush=True)
    return True


def phase_mesh_alternated(card, gram_tol, mesh):
    """Phase 16(e): phase 4's DMRG from a fresh start without and with the
    mesh in alternated order (unsharded, sharded, sharded, unsharded), every
    sweep of the procedure run (``_hide_dmrg``, the card's default
    selection): each within E_TOL of E_REF; printed: the median of each
    run's last five sweeps, their ratio in each adjacent pair, the gathers
    run per sweep.  The sharded runs' Gram shapes that phase 3 did not hold
    are held against the plain version."""
    import numpy as np

    from renormalizer_tpu_torch import Mpo, Mps
    from renormalizer_tpu_torch import parallel as par
    from renormalizer_tpu_torch.parallel import hop as phop

    tag = "[mesh e]"
    model = holstein_chain(6)
    mpo = Mpo(model)
    runs = []
    for sharded in (False, True, True, False):
        mps = Mps.random(model, 1, M, percent=1.0)
        mps.optimize_config.procedure = PROCEDURE
        mps.optimize_config.method = "2site"
        par.set_global_mesh(mesh if sharded else None)
        phop.reset_stats()
        try:
            run = _hide_dmrg(f"{tag} {'sharded' if sharded else 'unsharded'}", card,
                             mps, mpo, {})
        finally:
            par.set_global_mesh(None)
        run["gathers"] = dict(phop.GATHERS)
        run["steady"] = float(np.median([sw["seconds"] for sw in run["sweeps"][-5:]]))
        runs.append((sharded, run))
        check(abs(run["e_min"] - E_REF) < E_TOL,
              f"{tag} energy {run['e_min']} not within {E_TOL} of {E_REF}")
    ratios = [round(runs[1][1]["steady"] / runs[0][1]["steady"], 3),
              round(runs[2][1]["steady"] / runs[3][1]["steady"], 3)]
    print(f"{tag} median of the last five sweeps ({card}), in order: "
          f"{[('sharded' if s else 'unsharded', round(r['steady'], 4)) for s, r in runs]}; "
          f"sharded / unsharded in the two adjacent pairs {ratios}; gathers run per "
          f"sweep (sharded runs) "
          f"{[round(r['gathers']['count'] / len(r['sweeps']), 1) for s, r in runs if s]}",
          flush=True)
    _hold_unheld(tag, _merged([r["grams"] for s, r in runs if s]), phase3_held(),
                 gram_tol)
    return dict(steady_medians=[round(r["steady"], 4) for _, r in runs],
                order=["sharded" if s else "unsharded" for s, _ in runs],
                ratios=ratios,
                sweeps=[[round(sw["seconds"], 4) for sw in r["sweeps"]] for _, r in runs],
                energy_diffs=[f"{r['e_min'] - E_REF:+.3e}" for _, r in runs])


def phase_mesh(card, gram_tol, main, profile=False):
    """Phase 16: the port's mesh parallelism on the card, (a)-(e)."""
    mesh, distinct = _mesh_for_card()
    launches, dmrg, call = phase_mesh_dmrg(card, gram_tol, mesh, distinct, main, profile)
    phase_mesh_candidates(mesh, call)
    tree_launches, tree = phase_mesh_tree(card, gram_tol, mesh)
    second = phase_mesh_second_device(gram_tol)
    alternated = phase_mesh_alternated(card, gram_tol, mesh)
    return ({"sharded_dmrg": launches, "sharded_tree_dmrg": tree_launches},
            dict(distinct_devices=distinct, dmrg=dmrg, tree=tree,
                 second_device_launch=second, alternated=alternated))


_NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _printed_numbers(text, label, pick):
    """The numbers an example printed after its last ``label``: those of
    the bracket that follows (it may span lines; ``np.float64(x)`` counts
    as x) or, without a bracket on the label's line, of the rest of that
    line; ``pick`` keeps the first, the last or all of them."""
    at = text.rfind(label)
    check(at >= 0, f"the example printed no {label!r}")
    rest = text[at + len(label):]
    line = rest.split("\n", 1)[0]
    body = rest[rest.index("["):rest.index("]")] if "[" in line else line
    found = [float(x) for x in _NUMBER.findall(body)]
    check(found, f"no number after {label!r}")
    return {"first": found[:1], "last": found[-1:], "all": found}[pick]


def _check_example(tag, text, spec):
    """Hold the numbers an example printed against EXAMPLE_REFS's entry;
    returns the largest deviation in units of the tolerance's scale."""
    label, pick, ref, tol, scale = spec
    got = _printed_numbers(text, label, pick)
    check(len(got) == len(ref), f"{tag} printed {len(got)} numbers, "
          f"the reference has {len(ref)}")
    devs = []
    for g, r in zip(got, ref):
        unit = {"abs": 1.0, "max1": max(1.0, abs(r)), "rel": abs(r)}[scale]
        devs.append(abs(g - r) / unit)
    worst = max(devs)
    print(f"{tag} {label} {got if len(got) <= 4 else got[:2] + ['...'] + got[-2:]}; "
          f"largest deviation from the fp64 reference {worst:.3e}"
          f"{'' if scale == 'abs' else ' (' + scale + ')'} (bound {tol:.0e})",
          flush=True)
    check(worst <= tol, f"{tag} {worst:.3e} off the reference (bound {tol:.0e})")
    return worst


def phase_examples_in_process(card, gram_tol):
    """Phase 17(a): the eight examples with references, in this process
    through run_examples.run_example on the card in the default precision
    (EXAMPLES_FP64 in fp64), each under a GramRecord: every Jacobi launch recorded (none at the sweep
    cap; the shapes phase 3 did not hold held against the plain version),
    the printed numbers against EXAMPLE_REFS."""
    import torch

    from renormalizer_tpu_torch.backend import backend
    from renormalizer_tpu_torch.mps import trunc_device
    from renormalizer_tpu_torch.ops.jacobi import jacobi_eigh
    from renormalizer_tpu_torch.run_examples import EXAMPLES, run_example

    print(f"[examples] port device {backend.device}, "
          f"fp{32 if backend.is_32bits else 64} ({card})", flush=True)
    check(backend.device.type == "cuda", f"[examples] port device is {backend.device}")
    held = phase3_held()
    launches, seconds, devs = {}, {}, {}
    for name, spec in EXAMPLE_REFS.items():
        tag = f"[examples a] {name}"
        grams = GramRecord(keep_grams=True)
        trunc_device.jacobi_eigh = grams
        was_32 = backend.is_32bits
        if name in EXAMPLES_FP64:
            backend.use_64bits()
        try:
            launches0 = jacobi_eigh.launches
            text, secs = run_example(os.path.join(EXAMPLES, name))
            torch.cuda.synchronize()
            n = jacobi_eigh.launches - launches0
        finally:
            trunc_device.jacobi_eigh = jacobi_eigh
            (backend.use_32bits if was_32 else backend.use_64bits)()
        check(backend.device.type == "cuda", f"{tag} left the port on {backend.device}")
        print(f"{tag}: fp{64 if name in EXAMPLES_FP64 else 32 if was_32 else 64}, "
              f"{secs:.2f} s, jacobi launches {n}", flush=True)
        devs[name] = _check_example(tag, text, spec)
        _check_held(tag, grams, n, held, gram_tol)
        seconds[name] = round(secs, 3)
        if n:
            launches["example_" + name[:-len(".py")]] = n
    check("example_holstein_gs" in launches,
          "[examples a] holstein_gs.py never launched the Jacobi kernel")
    return launches, dict(seconds=seconds, deviations={k: f"{v:.3e}" for k, v in devs.items()})


def phase_fmo():
    """Phase 17(b): fmo.py in a child process through the examples runner,
    fp32 (the card's default) then fp64, each within FMO_TIMEOUT: the BChl
    populations' rows sum to 1, every entry in [0, 1] (both within
    FMO_TOL), the first row BChl 1 alone, and the fp32 final row within
    FMO_FP32_TOL of the fp64 one.  Running out of time fails the phase."""
    import tempfile

    import numpy as np

    from renormalizer_tpu_torch.run_examples import EXAMPLES, run_in_subprocess

    rows, seconds = {}, {}
    for prec in ("fp32", "fp64"):
        tag = f"[examples b] fmo.py {prec}"
        with tempfile.TemporaryDirectory(prefix="fmo_") as tmp:
            res = run_in_subprocess(os.path.join(EXAMPLES, "fmo.py"), FMO_TIMEOUT[prec],
                                    env={"RENO_DTYPE": prec},
                                    dump=os.path.join(tmp, "numbers.json"))
        print(f"{tag}: {res['status']} in {res['seconds']:.2f} s "
              f"(limit {FMO_TIMEOUT[prec]} s)", flush=True)
        check(res["status"] == "ok",
              f"{tag} {res['status']}: {res['output'][-4000:]}")
        numbers = res["numbers"]
        occ = np.asarray(numbers["occ"], dtype=float)
        bchl = occ[:, np.argsort(numbers["PERM"])]
        sums = np.abs(bchl.sum(axis=1) - 1).max()
        first = np.abs(bchl[0] - np.eye(7)[0]).max()
        print(f"{tag}: {len(bchl)} rows; largest |row sum - 1| {sums:.3e}, entries in "
              f"[{bchl.min():.3e}, {bchl.max():.6f}], first row off BChl 1 alone by "
              f"{first:.3e}; final row {np.round(bchl[-1], 6).tolist()}", flush=True)
        check(sums < FMO_TOL, f"{tag} a row sums {sums:.3e} off 1")
        check(bchl.min() >= -FMO_TOL and bchl.max() <= 1 + FMO_TOL,
              f"{tag} an entry outside [0, 1]")
        check(first < FMO_TOL, f"{tag} the first row is not BChl 1 alone")
        rows[prec], seconds[prec] = bchl[-1], round(res["seconds"], 2)
    diff = float(np.abs(rows["fp32"] - rows["fp64"]).max())
    print(f"[examples b] fmo.py final row fp32 - fp64: {diff:.3e} "
          f"(bound {FMO_FP32_TOL:.0e})", flush=True)
    check(diff < FMO_FP32_TOL, f"[examples b] fmo fp32 final row {diff:.3e} off fp64")
    return dict(seconds=seconds, fp32_fp64_final_row=f"{diff:.3e}")


def phase_examples(card, gram_tol):
    """Phase 17: the package's examples on the card, (a) and (b)."""
    launches, run = phase_examples_in_process(card, gram_tol)
    run["fmo"] = phase_fmo()
    return launches, run


def phase_profile_step(card, tag, step):
    """Phase 7: one more evolution step (``step()``) under torch.profiler."""
    import torch

    from renormalizer_tpu_torch.backend import backend

    backend.sync()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        backend.sync()
        wall_s = time.perf_counter() - t0
    print(f"[profile] one more step of {tag}, {wall_s:.3f} s under the "
          f"profiler", flush=True)
    print_device_breakdown(prof, wall_s, card, top=6)
    # host synchronisations: the runtime calls that wait for the device, and
    # the device-to-host copies (a .item() is one copy and one wait)
    waits = collections.Counter(
        e.name for e in prof.events()
        if "Synchronize" in e.name or "Memcpy DtoH" in e.name)
    print(f"[profile] ({card}) host synchronisations in the step: "
          f"{dict(sorted(waits.items()))}; "
          f"{sum(v for k, v in waits.items() if 'Synchronize' in k)} waits, the "
          f"closing backend.sync() included", flush=True)
    owners = collections.Counter(
        _sync_owner(e) for e in prof.events()
        if "Synchronize" in e.name or "Memcpy DtoH" in e.name)
    print(f"[profile] ({card}) the step's synchronisations by the operator that "
          f"asked for them: {dict(owners.most_common())}", flush=True)


# operators whose host reads belong to a library's algorithm (cuSOLVER's and
# cuBLAS's info/pivot reads), not to the port's own code
_LIBRARY_OPS = ("linalg", "cholesky", "eigh", "_qr", "svd", "lu", "triangular")


def _sync_owner(event):
    """Who waited: ``library <op>`` for a synchronisation inside a linear
    algebra operator, ``port <op>`` for one asked for by an ``.item()``,
    ``.cpu()`` or ``bool(tensor)`` of the port's own (the outermost aten
    operator around it), ``unattributed`` without a parent."""
    chain, parent = [], event.cpu_parent
    while parent is not None:
        chain.append(parent.name)
        parent = parent.cpu_parent
    for name in chain:
        if any(k in name for k in _LIBRARY_OPS):
            return f"library {name}"
    return f"port {chain[-1]}" if chain else "unattributed"


def print_device_breakdown(prof, wall_s, card, top=10):
    """Device time per kernel of a torch.profiler run, and the card's busy
    share of ``wall_s``: the union of the device intervals over the wall."""
    from torch.autograd import DeviceType

    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        us, calls = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (us + end - start, calls + 1)
    check(spans, "the profiler recorded no device activity")
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    total = sum(us for us, _ in per_name.values())
    print(f"[profile] ({card}) device time {total / 1e6:.3f} s in "
          f"{len(spans)} device events; busy {busy / 1e6:.3f} s of "
          f"{wall_s:.3f} s wall ({100 * busy / 1e6 / wall_s:.1f} %)", flush=True)
    jacobi = [v for name, v in per_name.items() if "jacobi_kernel" in name]
    jac_us, jac_calls = sum(us for us, _ in jacobi), sum(c for _, c in jacobi)
    print(f"[profile] ({card}) Jacobi kernel: {jac_us / 1e6:.3f} s in "
          f"{jac_calls} launches, {100 * jac_us / total:.1f} % of device time",
          flush=True)
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    for kname, (us, calls) in ranked[:top]:
        print(f"[profile] {us / 1e6:9.3f} s {100 * us / total:5.1f} % "
              f"{calls:6d} calls {us / calls / 1e3:9.3f} ms/call  {kname[:90]}",
              flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device visible")
    profile = "--profile" in sys.argv[1:]
    if "--qc-fp64" in sys.argv[1:]:
        # phase 13's child process (RENO_DTYPE=fp64)
        phase_qc_fp64(phase_environment()[1])
        return
    if "--tree" in sys.argv[1:]:
        # phases 1, 2 and 14 alone (with --profile: 14(a) under the
        # profiler); no kernel record and no result line
        _, card = phase_environment()
        phase_build()
        phase_tree(card, TOL_F32, profile)
        print(f"[tree] phases 1, 2 and 14 passed in "
              f"{time.perf_counter() - _T0:.1f} s", flush=True)
        return
    if "--hide" in sys.argv[1:]:
        # phases 1, 2, 4 and 15 alone; no kernel record and no result line
        _, card = phase_environment()
        phase_build()
        phase_main_path(card)
        hide_launches, hide_s = phase_hide(card, TOL_F32)
        print("[hide] " + json.dumps(dict(hide_s, launches=hide_launches)), flush=True)
        print(f"[hide] phases 1, 2, 4 and 15 passed in "
              f"{time.perf_counter() - _T0:.1f} s", flush=True)
        return
    if "--mesh" in sys.argv[1:]:
        # phases 1, 2, 4 and 16 alone; no kernel record and no result line
        _, card = phase_environment()
        phase_build()
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profile else contextlib.nullcontext()
        with prof:
            _, wall_s, main_run = phase_main_path(card)
        if profile:
            print_device_breakdown(prof, wall_s, card)
        t0 = time.perf_counter()
        mesh_launches, mesh_s = phase_mesh(card, TOL_F32, main_run, profile)
        print("[mesh] " + json.dumps(dict(mesh_s, launches=mesh_launches,
                                          seconds=round(time.perf_counter() - t0, 1))),
              flush=True)
        print(f"[mesh] phases 1, 2, 4 and 16 passed in "
              f"{time.perf_counter() - _T0:.1f} s", flush=True)
        return
    if "--examples" in sys.argv[1:]:
        # phases 1, 2 and 17 alone; no kernel record and no result line
        _, card = phase_environment()
        phase_build()
        t0 = time.perf_counter()
        example_launches, examples_s = phase_examples(card, TOL_F32)
        print("[examples] " + json.dumps(dict(examples_s, launches=example_launches,
                                              phase_seconds=round(time.perf_counter() - t0, 1))),
              flush=True)
        print(f"[examples] phases 1, 2 and 17 passed in "
              f"{time.perf_counter() - _T0:.1f} s", flush=True)
        return
    phase_s = {}

    def timed(phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        phase_s[phase] = round(time.perf_counter() - t0, 1)
        return out

    name, card = timed("1", phase_environment)
    timed("2", phase_build)
    record = timed("3", phase_kernels)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profile else contextlib.nullcontext()
    t0 = time.perf_counter()
    with prof:
        launches, wall_s, main_run = phase_main_path(card)
    if profile:
        print_device_breakdown(prof, wall_s, card)
    phase_s["4"] = round(time.perf_counter() - t0, 1)
    timed("5", phase_oracle)
    evolve_launches, steps = timed("6", phase_evolution, card, profile, record["tol_f32"])
    timed("8", phase_finite_t_oracles)
    kubo_launches, thermal_s, kubo_s = timed("9", phase_kubo, card, profile,
                                             record["tol_f32"])
    timed("10a", phase_vmf_oracles)
    # depth cut to make room for phase 17 (was 1 + 3 steps of (b),
    # (c) and 1 + 2 of (d)): 1 + 2 and 1 + 1 (first + timed), at full width
    vmf_launches, vmf_s = timed("10b-d", phase_vmf_jobs, card, profile, record["tol_f32"],
                                dts={"b": 1.0, "c": 20.0}, nsteps=3, thermal_steps=2)
    timed("11", phase_excited_oracles)
    excited_launches, excited_s = timed("12", phase_excited_jobs, card, record["tol_f32"])
    qc_launches, qc_s = timed("13", phase_qc, card, record["tol_f32"])
    tree_launches, tree_s = timed("14", phase_tree, card, record["tol_f32"], profile)
    hide_launches, hide_s = timed("15", phase_hide, card, record["tol_f32"])
    mesh_launches, mesh_s = timed("16", phase_mesh, card, record["tol_f32"], main_run,
                                  profile)
    example_launches, examples_s = timed("17", phase_examples, card, record["tol_f32"])
    steady = record["timed"][(2, 288, 288)]
    # the numbers of this run once more, so that the end of the output
    # carries them when its beginning is cut
    print("[summary] " + json.dumps({
        "card": card, "dmrg_seconds": round(wall_s, 4),
        "tdvp_ps_timed_step_seconds": {
            k: [round(t, 4) for t in v] for k, v in steps.items()},
        "kubo_thermal_step_seconds": [round(t, 4) for t in thermal_s],
        "kubo_timed_step_seconds": [round(t, 4) for t in kubo_s],
        "vmf_timed_step_seconds": {k: [round(t, 4) for t in v] for k, v in vmf_s.items()},
        "state_averaged_dmrg_sweep_seconds": [
            round(t, 4) for t in excited_s["state_averaged_dmrg_sweeps"]],
        "cv_zerot_seconds_per_frequency": round(excited_s["cv_zerot_per_frequency"], 4),
        "state_averaged_dmrg_root_diffs": [
            f"{d:+.3e}" for d in excited_s["state_averaged_dmrg_root_diffs"]],
        "cv_zerot_serial_and_interleaved_seconds": [
            round(t, 4) for t in excited_s["cv_zerot_serial_and_interleaved"]],
        "qc_sweep_seconds": {k: [round(t, 4) for t in qc_s[k]] for k in ("fp64", "fp32")},
        "padding_fp64": [f"{v:.3e}" for v in qc_s["padding_fp64"]],
        "qc_fp32_sweep_and_double_diffs": [
            f"{d:+.3e}" for d in qc_s["fp32_sweep_and_double_diffs"]],
        "tree_dmrg_sweep_seconds": [round(t, 4) for t in tree_s["sweeps"]],
        "tree_dmrg_energy_diff": f"{tree_s['energy_diff']:+.3e}",
        "tree_dmrg_peak_gib": round(tree_s["peak_gib"], 3),
        "tree_gram_ms": {str(k): {n: round(v[n], 3) for n in
                                  ("kernel", "plain", "torch.linalg.eigh")}
                         for k, v in tree_s["timed"].items()},
        "pyrazine_step_seconds": [round(min(tree_s["pyrazine_steps"]), 4),
                                  round(sum(tree_s["pyrazine_steps"])
                                        / len(tree_s["pyrazine_steps"]), 4),
                                  round(max(tree_s["pyrazine_steps"]), 4)],
        "pyrazine_max_deviation": f"{tree_s['pyrazine_dev']:.3e}",
        "tree_oracles": {k: f"{v:.3e}" for k, v in tree_s["oracles"].items()},
        "host_hiding": hide_s,
        "mesh": mesh_s,
        "examples": examples_s,
        "jacobi_ms": {str(k): round(v["kernel"], 3)
                      for k, v in record["timed"].items()},
        "eigh_ms": {str(k): round(v["torch.linalg.eigh"], 3)
                    for k, v in record["timed"].items()},
        "plain_ms": {str(k): round(v["plain"], 3) for k, v in record["timed"].items()
                     if v["plain"] is not None},
        "phase_seconds": phase_s,
        "script_seconds": round(time.perf_counter() - _T0, 1)}), flush=True)
    by_path = {"dmrg": launches, "spin_boson_dynamics": evolve_launches,
               "transport_kubo": kubo_launches, **vmf_launches, **excited_launches,
               "qc": qc_launches["fp64"] + qc_launches["fp32"],
               "tree_dmrg": tree_launches, **hide_launches, **mesh_launches,
               **example_launches}
    print(f"[kernels] jacobi_eigh launches: DMRG path {launches}, "
          f"SpinBosonDynamics constructor {evolve_launches}, TransportKubo "
          f"constructor {kubo_launches}, ChargeDiffusionDynamics (b)-(c) "
          f"{vmf_launches['charge_diffusion']}, MU-VMF ThermalProp (d) "
          f"{vmf_launches['thermal_vmf']}, state-averaged DMRG (12a) "
          f"{excited_launches['state_averaged_dmrg']}, SpectraZtCV (12b) "
          f"{excited_launches['cv_zerot']}, H2O QC-DMRG (13a fp64 + 13b fp32) "
          f"{qc_launches['fp64']} + {qc_launches['fp32']}, tree DMRG (14a) "
          f"{tree_launches}, phase 15 {hide_launches}, phase 16 {mesh_launches}, "
          f"phase 17 {example_launches}",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "jacobi_eigh", "route": "cuda", "source": JACOBI_SOURCE,
        "replaces": JACOBI_REPLACES, "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": record["max_abs_err"], "ms": steady["kernel"],
        "plain_ms": steady["plain"], "bound_ms": steady["bound_ms"],
        "bound_by": steady["bound_by"],
        "library_ms": steady["torch.linalg.eigh"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
