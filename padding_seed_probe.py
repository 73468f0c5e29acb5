"""How the expansion's padding moves two results with the seed of the
port's generator, and with the factorization that chooses the padding.

``compress`` factorizes each sector block by ``trunc_device._resolved_range``
(deflation down to 64 eps |a|, then seeded Gaussian completions of weight
0).  Two results that start from ``expand_bond_dimension`` depend on those
directions:

  thermal  10 TDVP-PS steps of beta/20 at 1500 K from ``MpDm.max_entangled_ex``
           of the 3-molecule, 3-level, J = 0.2 chain (the Tier-1 test
           ``tests/test_torch_dynamics.py::test_thermal_prop_on_the_port_expansion``),
           against the dense one-electron ensemble: the largest deviation of
           the electron RDM;
  mu-cmf   3 MU-CMF steps of 0.02 on ``tests/test_evolve.py``'s 3-molecule,
           2-level chain (``chip_smoke.py`` phase 10(a)), against a dense
           expm: the mean deviation of the occupations.

``--factor`` puts another factorization in ``_resolved_range``'s place:
``gram`` one Gram pass (the compress before the padding repair), ``svd``
numpy's SVD of the block (LAPACK, as the JAX package's host path),
``svd-floor`` the SVD's directions above 64 eps |a| and seeded completions
below, ``svd-zero`` the SVD's directions with the weights below that floor
set to 0.

Run from the root of the repo, on the CPU:
``RENO_PLATFORM=cpu RENO_DTYPE=fp64 python3 padding_seed_probe.py thermal --seeds 2019 0 1 2``
(``RENO_DTYPE=fp32`` for ``mu-cmf`` as phase 10(a) runs it).  One line per
seed.
"""

import argparse

import numpy as np
import scipy.linalg
import torch

from chip_smoke import _sector_of, dense_operator


def _factor(name):
    from renormalizer_tpu_torch.mps import trunc_device

    def svd(a):
        u, s, _ = np.linalg.svd(a.cpu().numpy(), full_matrices=False)
        floor = 64 * np.finfo(s.dtype).eps * np.sqrt((s ** 2).sum())
        return u, s, floor

    def gram(a, gen):
        return trunc_device._gram_pass(a, min(a.shape), 0, gen)

    def svd_all(a, gen):
        u, s, _ = svd(a)
        return torch.as_tensor(u, device=a.device), torch.as_tensor(s ** 2)

    def svd_floor(a, gen):
        u, s, floor = svd(a)
        keep = int((s > floor).sum())
        done = torch.as_tensor(u[:, :keep], device=a.device)
        if keep < len(s):
            done = torch.cat([done, trunc_device._seeded_completion(
                done, len(s) - keep, gen)], dim=1)
        return done, torch.as_tensor(np.where(s > floor, s ** 2, 0))

    def svd_zero(a, gen):
        u, s, floor = svd(a)
        return (torch.as_tensor(u, device=a.device),
                torch.as_tensor(np.where(s > floor, s ** 2, 0)))

    if name != "deflate":
        trunc_device._resolved_range = {"gram": gram, "svd": svd_all,
                                        "svd-floor": svd_floor,
                                        "svd-zero": svd_zero}[name]


def thermal():
    import renormalizer_tpu_torch as rt
    from renormalizer_tpu_torch.model import HolsteinModel, Mol, Op, Phonon
    from renormalizer_tpu_torch.property import Property

    ph = Phonon.simple_phonon(rt.Quantity(1.0), rt.Quantity(0.6), 3)
    model = HolsteinModel([Mol(rt.Quantity(0.0), [ph], 1.0)] * 3, rt.Quantity(0.2))
    beta = rt.Quantity(1500.0, "K").to_beta()
    h = dense_operator(model, model.ham_terms)
    s1 = np.nonzero(_sector_of(model, len(h)) == 1)[0]
    rho = scipy.linalg.expm(-beta * h[np.ix_(s1, s1)])
    rho /= np.trace(rho)
    dense = np.array([[np.real(np.trace(rho @ dense_operator(
        model, [Op(r"a^\dagger a", [di, dj])])[np.ix_(s1, s1)]))
        for dj in model.e_dofs] for di in model.e_dofs])
    prop = Property(["e_rdm"], {})
    job = rt.ThermalProp(rt.MpDm.max_entangled_ex(model),
                         evolve_config=rt.EvolveConfig(rt.EvolveMethod.tdvp_ps),
                         properties=prop)
    job.evolve(None, 10, beta / 2j)
    return float(np.abs(np.asarray(prop.prop_res["e_rdm"][-1]).real - dense).max())


def mu_cmf():
    from renormalizer_tpu_torch import (EvolveConfig, EvolveMethod, HolsteinModel,
                                        Mol, Mpo, Mps, Op, Phonon, Quantity)

    ph = Phonon.simple_phonon(Quantity(1), Quantity(1), 2)
    model = HolsteinModel([Mol(Quantity(0), [ph])] * 3, Quantity(1), 3)
    init = Mpo.onsite(model, r"a^\dagger", dof_set=[0]) @ Mps.ground_state(model, False)
    init = init.expand_bond_dimension(hint_mpo=Mpo(model))
    e0 = init.expectation(Mpo(model))
    mpo = Mpo(model, offset=Quantity(e0))
    h = dense_operator(model, model.ham_terms) - e0 * np.eye(2 ** 6)
    occ_ops = [dense_operator(model, [Op(r"a^\dagger a", dof)]) for dof in model.e_dofs]
    psi0 = init.todense().astype(complex)
    mps = init.copy()
    mps.evolve_config = EvolveConfig(EvolveMethod.tdvp_mu_cmf)
    mps.evolve_config.vmf_auto_switch = False
    deviations = []
    for i in range(1, 4):
        mps = mps.evolve(mpo, 0.02)
        psi = scipy.linalg.expm(-1j * h * 0.02 * i) @ psi0
        dense = [np.real(psi.conj() @ o @ psi) for o in occ_ops]
        deviations.append(float(np.abs(mps.e_occupations - dense).mean()))
    return float(np.mean(deviations))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("case", choices=["thermal", "mu-cmf"])
    parser.add_argument("--seeds", type=int, nargs="+", default=[2019])
    parser.add_argument("--factor", default="deflate",
                        choices=["deflate", "gram", "svd", "svd-floor", "svd-zero"])
    args = parser.parse_args()
    from renormalizer_tpu_torch.backend import backend

    _factor(args.factor)
    run = thermal if args.case == "thermal" else mu_cmf
    for seed in args.seeds:
        backend._seed = seed
        print(f"{args.case} factor={args.factor} dtype={backend.real_dtype} seed={seed}: "
              f"{run():.3e}", flush=True)


if __name__ == "__main__":
    main()
