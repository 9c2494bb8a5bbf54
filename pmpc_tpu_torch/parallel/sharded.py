"""The batched solver over the mesh: explicit local shards and explicit
collectives.

Twin of ``pmpc_tpu/parallel/sharded.py``. The JAX wrapper vmaps a
single-problem solver and lets GSPMD partition it; the port's solver is
already batched, and every op of it (the hand Cholesky kernels, the IPMs'
loops) works on local tensors, so the wrapper runs each rank's shard
through the solver and completes only the particle reductions across ranks
(DTensor would have to pass through the hand kernel and every IPM op):

- the batch axis is pure data parallel: each batch rank solves its own
  lanes, and its early exit is its own (a frozen lane does not move, so a
  lane's result does not depend on its neighbours);
- with ``shard_particles`` the solver is rebuilt at M_local = M / n_particle
  on the mesh's particle group: the consensus sums of the assembly and of
  the arrow and Riccati factors, the IPMs' reductions (duality measure,
  step lengths, residuals, the convergence and non-finite tests), the
  Anderson Gram system, the SCP residual's max and the warm start's mean
  are completed over the group (`particles`), and every host decision is
  taken on reduced values, so the ranks of a group take the same branches.
"""

from __future__ import annotations

from typing import Callable

from ..torch_scp import SCPData
from .mesh import coords


def make_sharded_solver(solver: Callable, mesh, shard_particles: bool = True,
                        donate: bool = False) -> Callable:
    """Wrap a `build_scp_solver` result for the mesh.

    Args:
        solver: the solver of the full problem (M particles).
        mesh: a ("batch", "particle") mesh from `make_mesh`.
        shard_particles: spread M over the mesh's particle axis
            (M % n_particle == 0); without it the ranks of a particle group
            solve the same lanes.
        donate: accepted for the JAX wrapper's signature and ignored.

    Returns:
        fn(this rank's shard, from `shard_batched_data`) -> (X, U, info) of
        the rank's lanes (and particles); `distributed.process_allgather`
        assembles the full batch.
    """
    _, _, _, npart = coords(mesh)
    local = solver
    if shard_particles and npart > 1:
        M = solver.build_args["M"]
        if M % npart:
            raise ValueError(f"M = {M} does not split over {npart} particle ranks")
        local = solver.rebuild(M=M // npart, particle_group=mesh.get_group("particle"))

    def call(data: SCPData, state=None):
        return local(data, state)

    call.solver = local
    return call
