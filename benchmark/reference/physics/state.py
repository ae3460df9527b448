"""Physics state (batch-last layout).

Conventions, as in the JAX package:
- env batch axis is LAST everywhere;
- quaternions are xyzw (Isaac convention);
- ``pos``/``quat`` are the base link frame in world coordinates;
- ``vel`` is the base spatial velocity **in base coordinates**,
  stacked (omega(3), v_origin(3)) -> shape (6, N).
"""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.ops import quat as quat_ops


@dataclasses.dataclass(frozen=True)
class PhysicsState:
    pos: torch.Tensor     # (3, N) base origin, world
    quat: torch.Tensor    # (4, N) xyzw, base->world
    vel: torch.Tensor     # (6, N) (omega, v) in base frame
    q: torch.Tensor       # (nq, N) joint positions
    qd: torch.Tensor      # (nq, N) joint velocities

    @property
    def n(self):
        return self.pos.shape[-1]

    def world_lin_vel(self):
        return quat_ops.rotate(self.quat, self.vel[3:6])

    def base_lin_vel(self):
        return self.vel[3:6]

    def base_ang_vel(self):
        return self.vel[0:3]

    @staticmethod
    def from_world_vel(pos, quat, lin_vel_w, ang_vel_w, q, qd):
        omega_b = quat_ops.rotate_inverse(quat, ang_vel_w)
        v_b = quat_ops.rotate_inverse(quat, lin_vel_w)
        return PhysicsState(pos=pos, quat=quat,
                            vel=torch.cat([omega_b, v_b], dim=0), q=q, qd=qd)

    def where(self, mask, other):
        """Per-env select: ``other`` where mask (N,) is True, else self."""
        return PhysicsState(*[torch.where(mask, b, a) for a, b in zip(
            (self.pos, self.quat, self.vel, self.q, self.qd),
            (other.pos, other.quat, other.vel, other.q, other.qd))])
