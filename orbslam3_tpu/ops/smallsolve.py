"""Unrolled small linear solves (fusable, no LAPACK-kernel latency).

jnp.linalg.solve on tiny systems dispatches LU factorization kernels that
dominate latency in sequential optimizer loops (pose-only GN runs 40
dependent iterations).  An unrolled Cholesky keeps the whole iteration in
one fused XLA computation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def _chol_blocks(A):
    """Unrolled scalar Cholesky of (..., n, n) SPD A; returns the lower
    factor as a list-of-lists of (...,) scalars (n small, <= ~8)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    return L


def _tri_lower_inv(L, n):
    """Unrolled inverse of a lower-triangular factor given as scalar
    list-of-lists; returns a dense (..., n, n) array (upper part zero)."""
    M = [[None] * n for _ in range(n)]
    for c in range(n):
        for i in range(n):
            if i < c:
                M[i][c] = jnp.zeros_like(L[0][0])
            else:
                s = jnp.ones_like(L[0][0]) if i == c else jnp.zeros_like(L[0][0])
                for k in range(c, i):
                    s = s - L[i][k] * M[k][c]
                M[i][c] = s / L[i][i]
    rows = [jnp.stack(M[i], axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2)


def solve_psd_blocked(A: jnp.ndarray, b: jnp.ndarray, bs: int = 6
                      ) -> jnp.ndarray:
    """Solve A x = b for SPD (n, n) A with n = K*bs via a block Cholesky
    unrolled over the K block-columns (K static, <= ~32).

    Replaces jnp.linalg.solve's LU custom call, whose fixed kernel
    latency dominates when the solve sits inside a sequential LM scan.  Every step here is a
    small fused einsum; XLA fuses the whole factorization into a handful
    of kernels.  A must be well-conditioned after LM damping (callers
    damp); no pivoting.
    """
    n = A.shape[-1]
    assert n % bs == 0
    K = n // bs
    if K == 1:
        return solve_psd(A, b)
    Ab = A.reshape(K, bs, K, bs).transpose(0, 2, 1, 3)  # (K, K, bs, bs)
    bb = b.reshape(K, bs)

    Lcols = []   # Lcol[j]: (K, bs, bs) = column j of the factor
    Linv_diag = []       # (bs, bs) inverse of each diagonal block factor
    idx = jnp.arange(K)
    for j in range(K):
        Ljj = _chol_blocks(Ab[j, j])
        Linv = _tri_lower_inv(Ljj, bs)                     # (bs, bs)
        Linv_diag.append(Linv)
        # C_i = A[i, j] @ Linv^T for i > j (strictly-below blocks)
        C = jnp.einsum("iab,cb->iac", Ab[:, j], Linv, precision=_HI)      # (K, bs, bs)
        below = (idx > j).astype(A.dtype)[:, None, None]
        Cb = C * below
        Lcols.append(Cb)
        # trailing update: A[i, i'] -= C_i C_i'^T  (only i, i' > j matter;
        # rows/cols <= j receive zeros because Cb is masked)
        Ab = Ab - jnp.einsum("iab,jcb->ijac", Cb, Cb, precision=_HI)

    # forward substitution: y_j = Linv_jj (b_j - sum_{k<j} L[j,k] y_k)
    y = [None] * K
    r = bb
    for j in range(K):
        y[j] = jnp.einsum("ab,b->a", Linv_diag[j], r[j], precision=_HI)
        r = r - jnp.einsum("iab,b->ia", Lcols[j], y[j], precision=_HI)
    # back substitution: x_j = Linv_jj^T (y_j - sum_{k>j} L[k,j]^T x_k);
    # Lmat[i, j] = block (i, j) of the strictly-lower factor
    Lmat = jnp.stack(Lcols, 1)            # (K rows, K cols, bs, bs)
    x = [None] * K
    acc = jnp.zeros_like(bb)
    for j in reversed(range(K)):
        x[j] = jnp.einsum("ba,b->a", Linv_diag[j], y[j] - acc[j], precision=_HI)
        # x_j feeds every earlier block row jp < j through L[j, jp]^T
        # (columns > j of Lmat row j are zero by the masking above)
        acc = acc + jnp.einsum("pab,a->pb", Lmat[j], x[j], precision=_HI)
    return jnp.stack(x, 0).reshape(n)


def solve_psd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for SPD A of static size n (n <= ~16) with an
    unrolled Cholesky (no pivoting; callers damp A).

    A: (..., n, n); b: (..., n).
    """
    n = A.shape[-1]
    # Cholesky: A = L L^T, unrolled
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-12))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)
