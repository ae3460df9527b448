"""Batch-last small linear algebra (3x3 blocks), unrolled to elementwise ops.

Matrices are ``(3, 3, ...)``, vectors ``(3, ...)`` with the env batch in the
trailing axes, the layout of the JAX package's ``ops/lin.py`` so tensors
compare without transposes. Every product is an explicit component sum,
which keeps the summation order of the reference. This module is the
foundation of the Featherstone dynamics (physics/aba.py) and of the plain
version of the fused physics step (physics/chain_step.py).
"""
import torch


def mv(A, v):
    """Matrix-vector: (3,3,...) @ (3,...) -> (3,...)."""
    return torch.stack([
        A[0, 0] * v[0] + A[0, 1] * v[1] + A[0, 2] * v[2],
        A[1, 0] * v[0] + A[1, 1] * v[1] + A[1, 2] * v[2],
        A[2, 0] * v[0] + A[2, 1] * v[1] + A[2, 2] * v[2],
    ])


def mtv(A, v):
    """Transposed matrix-vector: A^T @ v."""
    return torch.stack([
        A[0, 0] * v[0] + A[1, 0] * v[1] + A[2, 0] * v[2],
        A[0, 1] * v[0] + A[1, 1] * v[1] + A[2, 1] * v[2],
        A[0, 2] * v[0] + A[1, 2] * v[1] + A[2, 2] * v[2],
    ])


def mm(A, B):
    """Matrix-matrix: (3,3,...) @ (3,3,...)."""
    return torch.stack([
        torch.stack([A[i, 0] * B[0, j] + A[i, 1] * B[1, j]
                     + A[i, 2] * B[2, j] for j in range(3)])
        for i in range(3)])


def mmt(A, B):
    """A @ B^T."""
    return torch.stack([
        torch.stack([A[i, 0] * B[j, 0] + A[i, 1] * B[j, 1]
                     + A[i, 2] * B[j, 2] for j in range(3)])
        for i in range(3)])


def transpose(A):
    return torch.stack([
        torch.stack([A[0, 0], A[1, 0], A[2, 0]]),
        torch.stack([A[0, 1], A[1, 1], A[2, 1]]),
        torch.stack([A[0, 2], A[1, 2], A[2, 2]]),
    ])


def outer(a, b):
    """Outer product (3,...) x (3,...) -> (3,3,...)."""
    return torch.stack([
        torch.stack([a[0] * b[0], a[0] * b[1], a[0] * b[2]]),
        torch.stack([a[1] * b[0], a[1] * b[1], a[1] * b[2]]),
        torch.stack([a[2] * b[0], a[2] * b[1], a[2] * b[2]]),
    ])


def skew(v):
    """Skew-symmetric cross-product matrix ṽ with ṽ u = v × u."""
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def eye(batch_shape=(), dtype=torch.float32, device="cpu"):
    one = torch.ones(batch_shape, dtype=dtype, device=device)
    zero = torch.zeros(batch_shape, dtype=dtype, device=device)
    return torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, one, zero]),
        torch.stack([zero, zero, one]),
    ])


def _cofactors(A):
    c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
    c01 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
    c02 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
    c10 = A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2]
    c11 = A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0]
    c12 = A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1]
    c20 = A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]
    c21 = A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]
    c22 = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    det = A[0, 0] * c00 + A[0, 1] * c01 + A[0, 2] * c02
    return (c00, c01, c02, c10, c11, c12, c20, c21, c22), det


def solve33(A, b):
    """Solve A x = b for a batch-last (3,3,...) system by Cramer's rule."""
    (c00, c01, c02, c10, c11, c12, c20, c21, c22), det = _cofactors(A)
    inv_det = 1.0 / det
    x0 = (c00 * b[0] + c10 * b[1] + c20 * b[2]) * inv_det
    x1 = (c01 * b[0] + c11 * b[1] + c21 * b[2]) * inv_det
    x2 = (c02 * b[0] + c12 * b[1] + c22 * b[2]) * inv_det
    return torch.stack([x0, x1, x2])


def inv33(A):
    """Explicit inverse of batch-last (3,3,...) matrices (adjugate/det)."""
    (c00, c01, c02, c10, c11, c12, c20, c21, c22), det = _cofactors(A)
    inv_det = 1.0 / det
    return torch.stack([
        torch.stack([c00, c10, c20]),
        torch.stack([c01, c11, c21]),
        torch.stack([c02, c12, c22]),
    ]) * inv_det


def solve66_sym(AA, AB, BB, b_top, b_bot):
    """Solve the symmetric 6x6 block system [[AA, AB], [AB^T, BB]] x = b
    by the Schur complement of BB (the mass block, always
    well-conditioned):

        S = AA - AB BB^-1 AB^T
        x_top = S^-1 (b_top - AB BB^-1 b_bot)
        x_bot = BB^-1 (b_bot - AB^T x_top)
    """
    BBinv = inv33(BB)
    ABBinv = mm(AB, BBinv)
    S = AA - mmt(ABBinv, AB)
    rhs_top = b_top - mv(ABBinv, b_bot)
    x_top = solve33(S, rhs_top)
    x_bot = mv(BBinv, b_bot - mtv(AB, x_top))
    return x_top, x_bot


# ---- sparse / symmetry-aware variants used by the chain ABA

def skew_mm(v, X):
    """ṽ @ X for v (3,...), X (3,3,...)."""
    x, y, z = v[0], v[1], v[2]
    return torch.stack([
        torch.stack([y * X[2, j] - z * X[1, j] for j in range(3)]),
        torch.stack([z * X[0, j] - x * X[2, j] for j in range(3)]),
        torch.stack([x * X[1, j] - y * X[0, j] for j in range(3)]),
    ])


def mm_skew(X, v):
    """X @ ṽ for X (3,3,...), v (3,...)."""
    x, y, z = v[0], v[1], v[2]
    return torch.stack([
        torch.stack([X[i, 1] * z - X[i, 2] * y,
                     X[i, 2] * x - X[i, 0] * z,
                     X[i, 0] * y - X[i, 1] * x])
        for i in range(3)])


def congruence_sym(R, S):
    """R @ S @ R^T for SYMMETRIC S — computes the 6 unique entries."""
    T = mmt(S, R)
    out = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(i, 3):
            out[i][j] = (R[i, 0] * T[0, j] + R[i, 1] * T[1, j]
                         + R[i, 2] * T[2, j])
            if i != j:
                out[j][i] = out[i][j]
    return torch.stack([torch.stack(r) for r in out])


def outer_sym(a, scale):
    """scale * (a a^T) for a (3,...): 6 unique products."""
    d = [a[0] * scale, a[1] * scale, a[2] * scale]
    o01 = d[0] * a[1]
    o02 = d[0] * a[2]
    o12 = d[1] * a[2]
    return torch.stack([
        torch.stack([d[0] * a[0], o01, o02]),
        torch.stack([o01, d[1] * a[1], o12]),
        torch.stack([o02, o12, d[2] * a[2]]),
    ])
