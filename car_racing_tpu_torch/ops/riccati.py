"""Time-varying LQR recursions for iLQR (car_racing_tpu/ops/riccati.py:50-163).

:func:`tvlqr_backward` is the backward Riccati pass with an
eigenvalue-clamped, Levenberg-regularized inverse of ``Quu``, and
:func:`tvlqr_rollout` the affine forward rollout.  The JAX package runs
both as ``lax.scan``s over the horizon; here they are Python loops over
the stages.  Each stage keeps the JAX expression's order of operations.
"""

from __future__ import annotations

import torch


def _hypot(x, y):
    """``jnp.hypot``'s formula (the larger leg times ``sqrt(1 + ratio^2)``),
    which rounds differently from libm's ``hypot``."""
    x, y = x.abs(), y.abs()
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    r = hi * torch.sqrt(1 + torch.square(lo / torch.where(hi == 0, torch.ones_like(hi), hi)))
    r = torch.where(hi == 0, hi, r)
    return torch.where(torch.isposinf(x) | torch.isposinf(y), torch.inf, r)


def sym2x2_clamped_inv(M, reg):
    """Inverse of a symmetric 2x2 matrix ``M (..., 2, 2)`` with its
    eigenvalues clamped to ``max(w, 0) + reg``, in closed form through the
    eigenvector angle ``theta = atan2(2b, a - c) / 2``."""
    a, b, c = M[..., 0, 0], 0.5 * (M[..., 0, 1] + M[..., 1, 0]), M[..., 1, 1]
    m = 0.5 * (a + c)
    r = _hypot(0.5 * (a - c), b)
    theta = 0.5 * torch.atan2(2.0 * b, a - c)
    ct, st = torch.cos(theta), torch.sin(theta)
    w_hi = torch.clamp_min(m + r, 0.0) + reg  # eigenvector [ct, st]
    w_lo = torch.clamp_min(m - r, 0.0) + reg  # eigenvector [-st, ct]
    i_hi, i_lo = 1.0 / w_hi, 1.0 / w_lo
    off = (i_hi - i_lo) * ct * st
    return torch.stack([
        torch.stack([i_hi * ct * ct + i_lo * st * st, off], dim=-1),
        torch.stack([off, i_hi * st * st + i_lo * ct * ct], dim=-1),
    ], dim=-2)


def _clamped_inv(M, reg):
    """Eigenvalue-clamped inverse: the closed form for 2x2, ``eigh`` above."""
    if M.shape[-2:] == (2, 2):
        return sym2x2_clamped_inv(M, reg)
    w, V = torch.linalg.eigh(0.5 * (M + M.mT))
    w = torch.clamp_min(w, 0.0) + reg
    return (V * (1.0 / w).unsqueeze(-2)) @ V.mT


def tvlqr_backward(f_x, f_u, l_x, l_u, l_xx, l_uu, Vx_T, Vxx_T, reg):
    """TV-LQR backward pass over a horizon of N stages.

    f_x (N, n, n), f_u (N, n, m): dynamics Jacobians; l_x (N, n), l_u (N, m),
    l_xx (N, n, n), l_uu (N, m, m): stage cost derivatives; Vx_T (n,),
    Vxx_T (n, n): the terminal value; ``reg``: the Levenberg term added to
    ``Quu``'s clamped eigenvalues.  Returns the feedforward gains k (N, m)
    and feedback gains K (N, m, n).
    """
    N = f_x.shape[0]
    Vx, Vxx = Vx_T, Vxx_T
    ks, Ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        fx, fu = f_x[t], f_u[t]
        Qx = l_x[t] + fx.T @ Vx
        Qu = l_u[t] + fu.T @ Vx
        Qxx = l_xx[t] + fx.T @ Vxx @ fx
        Quu = l_uu[t] + fu.T @ Vxx @ fu
        Qux = fu.T @ Vxx @ fx
        Quu_inv = _clamped_inv(0.5 * (Quu + Quu.T), reg)
        k = -Quu_inv @ Qu
        K = -Quu_inv @ Qux
        Vx = Qx - K.T @ Quu @ k
        Vxx = Qxx - K.T @ Quu @ K
        ks[t], Ks[t] = k, K
    return torch.stack(ks), torch.stack(Ks)


def tvlqr_rollout(A, B, x0, u_ref, x_ref, ks, Ks):
    """Affine rollout ``u = u_ref + k + K (x - x_ref)`` through
    ``x+ = A x + B u``; A (n, n), B (n, m) LTI or (N, ...) per stage.
    Returns xs (N+1, n) and us (N, m)."""
    N = ks.shape[0]
    if A.dim() == 2:
        A = A.expand(N, *A.shape)
        B = B.expand(N, *B.shape)
    x = x0
    xs, us = [x0], []
    for t in range(N):
        u = u_ref[t] + ks[t] + Ks[t] @ (x - x_ref[t])
        x = A[t] @ x + B[t] @ u
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)
