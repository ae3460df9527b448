"""Batch-last quaternion / SO(3) operations.

Quaternions are ``(4, ...)`` in ``xyzw`` order (the Isaac Gym convention),
vectors ``(3, ...)``, with the env batch in the trailing axes — the layout
of the JAX package, so tensors compare without transposes.
"""
import math

import torch


def normalize(q):
    """Normalize along axis 0."""
    return q / torch.linalg.vector_norm(q, dim=0, keepdim=True).clamp_min(1e-9)


def mul(a, b):
    """Hamilton product a*b for xyzw quaternions shaped (4, ...)."""
    ax, ay, az, aw = a[0], a[1], a[2], a[3]
    bx, by, bz, bw = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def conj(q):
    return torch.stack([-q[0], -q[1], -q[2], q[3]])


def cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def rotate(q, v):
    """Rotate vector(s) v (3, ...) by quaternion(s) q (4, ...): R(q) @ v."""
    qv = q[:3]
    t = 2.0 * cross(qv, v)
    return v + q[3] * t + cross(qv, t)


def rotate_inverse(q, v):
    """R(q)^T @ v."""
    return rotate(conj(q), v)


def to_matrix(q):
    """Rotation matrix (3, 3, ...) from xyzw quaternion (4, ...)."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)]),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)]),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]),
    ])


def integrate(q, omega_body, dt):
    """q' = q ⊗ exp(dt/2 * omega_body), first order, renormalized."""
    dq = torch.cat([omega_body * (0.5 * dt), torch.ones_like(q[3:4])], dim=0)
    return normalize(mul(q, dq))


def yaw_rotate(q, v):
    """Rotate v by only the yaw component of q (x, y quaternion
    components zeroed, renormalized)."""
    z = torch.zeros_like(q[0])
    q_yaw = torch.stack([z, z, q[2], q[3]])
    return rotate(normalize(q_yaw), v)


def wrap_to_pi(angles):
    """Wrap angles to (-pi, pi]."""
    a = torch.remainder(angles, 2 * math.pi)
    return a - 2 * math.pi * (a > math.pi).to(a.dtype)
