"""Solvers (counterpart of ``raft_tpu/solver``): linear assignment.

The function is bound eagerly, as in the JAX package: the submodule and
the function share the name ``linear_assignment``, and the package
attribute must always be the function. The module imports only torch."""

from raft_tpu_torch.solver.linear_assignment import linear_assignment

__all__ = ["linear_assignment"]
