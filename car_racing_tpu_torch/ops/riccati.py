"""Riccati recursions (car_racing_tpu/ops/riccati.py).

:func:`dare_iterate` is the fixed-point discrete algebraic Riccati
iteration of the LQR controller; :func:`tvlqr_backward` is the backward
Riccati pass with an eigenvalue-clamped, Levenberg-regularized inverse of
``Quu``, and :func:`tvlqr_rollout` the affine forward rollout, the backbone
of iLQR and of the Riccati KKT path of ``ipm.solve_ocp_qp``;
:func:`tvlqr_backward_parallel` and :func:`tvlqr_rollout_parallel` are
their associative-scan forms.  The JAX package runs the recursions as
``lax.scan``s over the horizon; here they are Python loops over the stages,
and the associative scan follows ``jax.lax.associative_scan``'s odd/even
recursion, each level one batched combine over the whole sequence.  Each
stage keeps the JAX expression's order of operations.  The TV-LQR passes
take an optional leading batch of problems (the JAX package ``vmap``s
them).
"""

from __future__ import annotations

import torch


def _mv(M, v):
    """``M @ v`` for a vector ``v (n,)``, or for a batch of vectors
    ``v (..., n)`` against ``M (..., k, n)``."""
    if v.dim() == 1:
        return M @ v
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def dare_iterate(A, B, Q, R, max_iter: int = 50, eps: float = 1e-2):
    """Iterate ``P <- A'PA - A'PB (R + B'PB)^-1 B'PA + Q`` from ``P = Q``
    for ``max_iter`` steps, holding ``P`` once ``max |P_next - P| < eps``
    (riccati.py:26-47).  The hold is a masked update, so nothing is read
    back to the host.  Returns (P, K) with ``K = (R + B'PB)^-1 B'PA``."""
    P = Q
    done = torch.zeros(Q.shape[:-2], dtype=torch.bool, device=Q.device)
    for _ in range(max_iter):
        BtP = B.mT @ P
        K = torch.linalg.solve_ex(R + BtP @ B, BtP @ A)[0]
        P_next = A.mT @ P @ A - (A.mT @ P @ B) @ K + Q
        done_next = done | ((P_next - P).abs().amax(dim=(-2, -1)) < eps)
        P = torch.where(done[..., None, None], P, P_next)
        done = done_next
    BtP = B.mT @ P
    return P, torch.linalg.solve_ex(R + BtP @ B, BtP @ A)[0]


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

    f_x (..., N, n, n), f_u (..., N, n, m): dynamics Jacobians; l_x
    (..., N, n), l_u (..., N, m), l_xx (..., N, n, n), l_uu (..., N, m, m):
    stage cost derivatives; Vx_T (..., n), Vxx_T (..., n, n): the terminal
    value; ``reg``: the Levenberg term added to ``Quu``'s clamped
    eigenvalues.  The leading batch ``...`` is optional and broadcasts.
    Returns the feedforward gains k (..., N, m) and feedback gains K
    (..., N, m, n).
    """
    N = f_x.shape[-3]
    Vx, Vxx = Vx_T, Vxx_T
    ks, Ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        fx, fu = f_x[..., t, :, :], f_u[..., t, :, :]
        Qx = l_x[..., t, :] + _mv(fx.mT, Vx)
        Qu = l_u[..., t, :] + _mv(fu.mT, Vx)
        Qxx = l_xx[..., t, :, :] + fx.mT @ Vxx @ fx
        Quu = l_uu[..., t, :, :] + fu.mT @ Vxx @ fu
        Qux = fu.mT @ Vxx @ fx
        Quu_inv = _clamped_inv(0.5 * (Quu + Quu.mT), reg)
        k = _mv(-Quu_inv, Qu)
        K = -Quu_inv @ Qux
        Vx = Qx - _mv(K.mT @ Quu, k)
        Vxx = Qxx - K.mT @ Quu @ K
        ks[t], Ks[t] = k, K
    return torch.stack(ks, dim=-2), torch.stack(Ks, dim=-3)


def tvlqr_rollout(A, B, x0, u_ref, x_ref, ks, Ks):
    """Affine rollout ``u = u_ref + k + K (x - x_ref)`` through
    ``x+ = A x + B u``; A (n, n), B (n, m) LTI or (..., N, ...) per stage;
    x0 (..., n), u_ref (..., N, m), x_ref (..., N, n), ks (..., N, m),
    Ks (..., N, m, n), with the same optional leading batch as
    :func:`tvlqr_backward` (x0 carries it).  Returns xs (..., N+1, n) and
    us (..., N, m)."""
    N = ks.shape[-2]
    if A.dim() == 2:
        A = A.expand(N, *A.shape)
        B = B.expand(N, *B.shape)
    x = x0
    xs, us = [x0], []
    for t in range(N):
        u = u_ref[..., t, :] + ks[..., t, :] + _mv(Ks[..., t, :, :], x - x_ref[..., t, :])
        x = _mv(A[..., t, :, :], x) + _mv(B[..., t, :, :], u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


# Temporal-parallel LQR (riccati.py:139-281): the conditional value function
# between two stages is the element (A, b, C, eta, J), and two adjacent
# elements combine by a closed-form elimination of the shared state.  The
# combination is associative, so every suffix value function comes from one
# associative scan of O(log N) depth.


def _solve(M, rhs):
    """``jnp.linalg.solve`` for a batch of matrices: LU with partial
    pivoting, non-finite values where ``M`` is singular, no host sync."""
    return torch.linalg.solve_ex(M, rhs)[0]


def _lqt_combine(e1, e2):
    """Combine adjacent conditional-value elements (``e1`` earlier, ``e2``
    later), elementwise over any leading batch dimensions.  Matrix-vector
    products go through :func:`_mv`, which keeps an explicit trailing axis
    for a batch of vectors: a bare ``M @ v`` on
    ``(B, n, n) @ (B, n)`` would broadcast wrongly when B == n."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    D = eye + C1 @ J2
    DiA1 = _solve(D, A1)
    DiC1 = _solve(D, C1)
    A12 = A2 @ DiA1
    b12 = _mv(A2, _solve(D, b1.unsqueeze(-1)).squeeze(-1) + _mv(DiC1, eta2)) + b2
    C12 = A2 @ DiC1 @ A2.mT + C2
    # (I + J2 C1)^{-1} = D^{-T} for symmetric C1, J2
    Dt = eye + J2 @ C1
    rhs = (eta2 - _mv(J2, b1)).unsqueeze(-1)
    A1T = A1.mT
    eta12 = _mv(A1T, _solve(Dt, rhs).squeeze(-1)) + eta1
    J12 = A1T @ _solve(Dt, J2) @ A1 + J1
    return (A12, b12, C12, eta12, J12)


def _take(x, axis, start, stop=None, step=1):
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(a, b, axis):
    """``a[0], b[0], a[1], b[1], ...`` along ``axis``; ``a`` is as long as
    ``b`` or one longer."""
    n_a, n_b = a.shape[axis], b.shape[axis]
    if n_a > n_b:
        b = torch.cat([b, _take(a, axis, 0, 1)], dim=axis)
    out = torch.stack([a, b], dim=axis + 1).flatten(axis, axis + 1)
    return _take(out, axis, 0, n_a + n_b)


def associative_scan(fn, elems, axis: int = 0, reverse: bool = False):
    """``jax.lax.associative_scan`` for a tuple of tensors scanned along
    ``axis``: the same odd/even recursion, so ``fn`` combines the same
    pairs in the same tree.  Each level is one call of ``fn`` on the whole
    sequence (``fn`` works elementwise over leading dimensions), so the
    depth is O(log N).  With ``reverse`` the scan runs from the end:
    element k combines elements k..N-1, and ``fn`` takes its operands
    (later, earlier), as JAX passes them."""
    elems = tuple(elems)
    if reverse:
        elems = tuple(e.flip(axis) for e in elems)

    def scan(xs):
        n = xs[0].shape[axis]
        if n < 2:
            return xs
        reduced = fn(tuple(_take(x, axis, 0, n - 1, 2) for x in xs),
                     tuple(_take(x, axis, 1, None, 2) for x in xs))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(_take(o, axis, 0, -1) for o in odd),
                      tuple(_take(x, axis, 2, None, 2) for x in xs))
        else:
            even = fn(odd, tuple(_take(x, axis, 2, None, 2) for x in xs))
        even = tuple(torch.cat([_take(x, axis, 0, 1), e], dim=axis) for x, e in zip(xs, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    out = scan(elems)
    return tuple(o.flip(axis) for o in out) if reverse else out


def tvlqr_backward_parallel(f_x, f_u, l_x, l_u, l_xx, l_uu, Vx_T, Vxx_T, reg):
    """Associative-scan TV-LQR backward pass: :func:`tvlqr_backward`'s
    arguments and, for a positive definite ``l_uu`` and convex downstream
    value functions (the IPM case), its gains, at O(log N) depth.

    The value recursion here is exact: ``reg`` and the eigenvalue clamp
    enter only the stage-parallel gain computation (the clamp is
    path-dependent and breaks associativity), so use the sequential pass
    for iLQR's large Levenberg terms.  Returns (k (..., N, m), K (..., N, m,
    n))."""
    batch = torch.broadcast_shapes(f_x.shape[:-3], f_u.shape[:-3], l_x.shape[:-2],
                                   l_u.shape[:-2], l_xx.shape[:-3], l_uu.shape[:-3],
                                   Vx_T.shape[:-1], Vxx_T.shape[:-2])
    f_x, f_u, l_xx, l_uu = (a.expand(*batch, *a.shape[-3:]) for a in (f_x, f_u, l_xx, l_uu))
    l_x, l_u = (a.expand(*batch, *a.shape[-2:]) for a in (l_x, l_u))
    Vx_T, Vxx_T = Vx_T.expand(*batch, *Vx_T.shape[-1:]), Vxx_T.expand(*batch, *Vxx_T.shape[-2:])
    axis, n = len(batch), f_x.shape[-1]

    # stage elements: the control eliminated per stage through l_uu^{-1}
    C = f_u @ _solve(l_uu, f_u.mT)
    b = -(f_u @ _solve(l_uu, l_u.unsqueeze(-1))).squeeze(-1)
    zero = f_x.new_zeros(*batch, 1, n, n)
    # the terminal element: the pure value 1/2 x'Vxx x + Vx'x
    elems = (torch.cat([f_x, zero], dim=axis), torch.cat([b, zero[..., 0]], dim=axis),
             torch.cat([C, zero], dim=axis), torch.cat([-l_x, -Vx_T.unsqueeze(-2)], dim=axis),
             torch.cat([l_xx, Vxx_T.unsqueeze(-3)], dim=axis))
    # suffix[k] = e_k * ... * e_T; suffix[k+1] carries V_{k+1}, the value
    # the stage-k gains need
    suffix = associative_scan(lambda a, c: _lqt_combine(c, a), elems, axis=axis, reverse=True)
    Vx = -_take(suffix[3], axis, 1)
    Vxx = _take(suffix[4], axis, 1)

    Qu = l_u + (f_u.mT @ Vx.unsqueeze(-1)).squeeze(-1)
    Quu = l_uu + f_u.mT @ Vxx @ f_u
    Qux = f_u.mT @ Vxx @ f_x
    Quu_inv = _clamped_inv(0.5 * (Quu + Quu.mT), reg)
    return (-Quu_inv @ Qu.unsqueeze(-1)).squeeze(-1), -Quu_inv @ Qux


def tvlqr_rollout_parallel(A, B, x0, u_ref, x_ref, ks, Ks):
    """Associative-scan :func:`tvlqr_rollout` at O(log N) depth: the
    closed-loop step ``x+ = (A + B K) x + B (u_ref + k - K x_ref)`` is an
    affine map, and affine maps compose associatively."""
    N = ks.shape[-2]
    if A.dim() == 2:
        A = A.expand(N, *A.shape)
        B = B.expand(N, *B.shape)
    M = A + B @ Ks
    v = _mv(B, u_ref + ks - _mv(Ks, x_ref))
    batch = torch.broadcast_shapes(M.shape[:-3], v.shape[:-2], x0.shape[:-1])
    M, v = M.expand(*batch, *M.shape[-3:]), v.expand(*batch, *v.shape[-2:])

    def compose(s1, s2):  # s1 earlier, s2 later: x -> M2 (M1 x + v1) + v2
        M1, v1 = s1
        M2, v2 = s2
        return (M2 @ M1, _mv(M2, v1) + v2)

    Mp, vp = associative_scan(compose, (M, v), axis=len(batch))
    xs = torch.cat([x0.expand(*batch, x0.shape[-1]).unsqueeze(-2),
                    _mv(Mp, x0.unsqueeze(-2)) + vp], dim=-2)
    us = u_ref + ks + _mv(Ks, xs[..., :-1, :] - x_ref)
    return xs, us
