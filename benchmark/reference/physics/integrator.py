"""Semi-implicit (symplectic) Euler integrator, batch-last: velocities
update first, positions integrate with the NEW velocities. The base
spatial velocity lives in base coordinates, where v_dot equals the
spatial acceleration returned by ABA, so the update is a plain axpy."""
import torch

from benchmark.reference.ops import quat as quat_ops
from benchmark.reference.physics.state import PhysicsState


def integrate(state: PhysicsState, a_base, qdd, dt, qd_cap=None,
              base_ang_cap=None, base_lin_cap=None, q_lower=None,
              q_upper=None) -> PhysicsState:
    """Velocity caps apply BEFORE the position update; q_lower/q_upper
    are hard joint limits enforced as a plastic projection (q clamps to
    the limit and the outward joint velocity zeroes)."""
    vel = state.vel + dt * a_base
    ang, lin_ = vel[0:3], vel[3:6]
    if base_ang_cap is not None:
        ang = ang.clamp(-base_ang_cap, base_ang_cap)
    if base_lin_cap is not None:
        lin_ = lin_.clamp(-base_lin_cap, base_lin_cap)
    vel = torch.cat([ang, lin_], dim=0)
    qd = state.qd + dt * qdd
    if qd_cap is not None:
        qd = torch.clamp(qd, -qd_cap, qd_cap)
    pos = state.pos + dt * quat_ops.rotate(state.quat, vel[3:6])
    quat = quat_ops.integrate(state.quat, vel[0:3], dt)
    q = state.q + dt * qd
    if q_lower is not None:
        qc = torch.clamp(q, q_lower, q_upper)
        qd = torch.where((q > q_upper) & (qd > 0.0), 0.0, qd)
        qd = torch.where((q < q_lower) & (qd < 0.0), 0.0, qd)
        q = qc
    return PhysicsState(pos=pos, quat=quat, vel=vel, q=q, qd=qd)
