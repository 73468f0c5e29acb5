"""The benchmark's plain reference: numpy and torch only.

Nothing here imports the measured package or JAX.  It rebuilds each
Hamiltonian from the configuration's physical parameters and judges the
program's outputs (site tensors, reported energies) with its own operator
construction and contractions in double precision.
"""
