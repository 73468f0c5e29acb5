r"""Multi-device parallelism over a mesh of ``torch.device``.

Port of ``renormalizer_tpu/parallel/``.  The mesh axes are those of the JAX
package:

* ``data`` — embarrassingly parallel work units (frequency points, roots,
  trajectories); the port's ``cv.spectra_cv.batch_run`` places its workers
  one per visible device on its own and reads no mesh;
* ``i`` / ``j`` — bond-tensor parallelism: the effective-Hamiltonian matvec
  (the DMRG/TDVP hot loop) cut over the bra-side left/right virtual bonds,
  its blocks gathered home.

One Python process drives the whole mesh, as the JAX package's single
controller does: it places tensors on the mesh's devices (no process group,
no launcher).  Usage::

    from renormalizer_tpu_torch.parallel import set_global_mesh, make_mesh
    set_global_mesh(make_mesh(i=2, j=2))   # 4 visible cards
    set_global_mesh(make_mesh(i=2, j=2, devices=["cuda:0"] * 4))  # one card

Once a global mesh is set, ``gs.optimize_mps`` (through
``lib.solvers.davidson_fused``) and ``tn.optimize_ttns`` shard the site
updates whose bond dimensions divide the mesh axes and fall back to the
unsharded einsum for the small edge sites; when the mesh spans more than
one distinct device, the truncation places its quantum-number sectors
round-robin over them (``mps.trunc_device.PLACE_SECTORS``).
"""

from renormalizer_tpu_torch.parallel.mesh import (
    Mesh,
    get_global_mesh,
    make_mesh,
    set_global_mesh,
)
from renormalizer_tpu_torch.parallel.hop import (
    sharded_general_hop_factory,
    sharded_hop_factory,
)
