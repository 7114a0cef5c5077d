"""Primal-dual interior point for dense convex QPs
(car_racing_tpu/ops/ipm.py:87-160, 346-579, 816-972).

    min 1/2 z'Hz + g'z   s.t.   C z >= d,   E z = e

and, in :func:`solve_qp_nl`, with nonlinear rows ``c_nl(z) >= 0`` in place
of the equality rows.

Every QP field carries a leading batch dimension, so a fleet or a branch
sweep is one call.  Both solvers run the JAX package's iteration: each
problem freezes once its KKT residual passes ``tol`` or its Newton step
turns non-finite, and the loop ends when every problem is frozen or after
``iters`` iterations.  That early exit follows the JAX code's
``while_loop`` (ipm.py:432-436, 563-567; the module docstring there still
describes a fixed-count scan): a frozen iterate no longer changes, so the
result equals a fixed count of ``iters`` iterations while the batch pays
only the iterations its slowest problem needs.  Testing for the exit reads
one flag back to the host per iteration.

The two solvers differ where the JAX package's do:

- :func:`solve_qp` (the controllers' solver) factors its Newton systems
  with ``torch.linalg.cholesky_ex`` under a 1e-10 ridge when there are no
  equality rows (the JAX package uses ``jnp.linalg.cholesky`` there, not a
  Pallas kernel), and solves the bordered KKT matrix by LU with partial
  pivoting when there are (ipm.py:384-393: the Cholesky+Schur path NaNs on
  LMPC QPs, whose safe-set block leaves Hbar near-singular).
- :func:`solve_qp_batch` (the corridor sweep's solver) sends them through
  kernel K2 under a 1e-9 ridge, and with ``p`` equality rows eliminates
  them by blocks (ipm.py:514-527): K3 solves ``Hbar W = [g_bar | E^T]``,
  then the ``p x p`` Schur system gives ``dnu`` and ``dz = W_g - W_E dnu``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import cholesky, cholesky_multi

GRADE_QP = 1e3  # `converged` reports res < GRADE_QP * tol (ipm.py:63-87)


class IPMSolution(NamedTuple):
    z: torch.Tensor  # (Bt, n) primal solution
    lam: torch.Tensor  # (Bt, m) inequality multipliers (>= 0)
    nu: torch.Tensor  # (Bt, p) equality multipliers
    s: torch.Tensor  # (Bt, m) inequality slacks (> 0)
    converged: torch.Tensor  # (Bt,) bool
    kkt_res: torch.Tensor  # (Bt,) final KKT residual (inf-norm)
    iterations: torch.Tensor  # (Bt,) int32: first iteration under tol, else iters


@dataclasses.dataclass(frozen=True)
class QP:
    """Dense QP data with a leading batch dimension (views may share it)."""

    H: torch.Tensor  # (Bt, n, n)
    g: torch.Tensor  # (Bt, n)
    C: torch.Tensor  # (Bt, m, n) inequality Cz >= d
    d: torch.Tensor  # (Bt, m)
    E: torch.Tensor  # (Bt, p, n) equality Ez = e
    e: torch.Tensor  # (Bt, p)


def _eps_for(dtype):
    """Division/complementarity floors."""
    if dtype == torch.float64:
        return 1e-12, 1e-14
    return 1e-8, 3e-8


def _sigma_cap(dtype):
    """Cap on the barrier ratio lam/s."""
    return 1e14 if dtype == torch.float64 else 1e6


def _eq_reg(dtype):
    """Regularization of the equality block of the KKT matrix."""
    return 1e-10 if dtype == torch.float64 else 1e-6


def _kkt_residual(grad_L, c_i, c_e, s, lam):
    """Inf-norm KKT residual per problem; inputs carry a leading batch."""
    parts = [grad_L.abs(), (c_i - s).abs(), c_e.abs(), (s * lam).abs()]
    return torch.cat(parts, dim=-1).amax(dim=-1)


def _max_step(dv, v, tau):
    """Fraction-to-boundary step length per problem: the largest step in
    (0, 1] that keeps ``v + step * dv`` above ``(1 - tau) v``."""
    ratio = torch.where(dv < 0, -tau * v / dv.clamp_max(-1e-30), torch.inf)
    return ratio.amin(dim=1).clamp_max(1.0)


def _bmv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _bmTv(M, v):
    return (v.unsqueeze(-2) @ M).squeeze(-2)


def _cho_solve(Hbar, g_bar):
    """``jnp.linalg.cholesky`` + ``cho_solve`` semantics: NaN where the
    matrix is not positive definite (``torch.linalg.cholesky`` would raise,
    and the non-finite-step freeze needs the NaN)."""
    L, info = torch.linalg.cholesky_ex(Hbar)
    x = torch.cholesky_solve(g_bar.unsqueeze(-1), L).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, torch.nan)


def _lin_solve(M, v):
    """``jnp.linalg.solve`` semantics for a batch of vectors: LU with
    partial pivoting, non-finite values (no error, no host sync) where
    ``M`` is singular."""
    return torch.linalg.solve_ex(M, v.unsqueeze(-1))[0].squeeze(-1)


def _newton_lu(Hbar, g_bar, E, ce):
    """:func:`solve_qp`'s Newton step (dz, dnu)."""
    Bt, p, n = E.shape
    if not p:
        return _cho_solve(Hbar, g_bar), ce
    reg = -_eq_reg(E.dtype) * torch.eye(p, dtype=E.dtype, device=E.device)
    M = torch.cat([torch.cat([Hbar, E.mT], dim=-1),
                   torch.cat([E, reg.expand(Bt, p, p)], dim=-1)], dim=-2)
    sol = _lin_solve(M, torch.cat([g_bar, -ce], dim=-1))
    return sol[:, :n], sol[:, n:]


def _newton_blocks(solve, solve_multi):
    """:func:`solve_qp_batch`'s Newton step (dz, dnu) through the batched
    SPD solves ``solve`` (one right-hand side) and ``solve_multi``."""

    def newton(Hbar, g_bar, E, ce):
        p = E.shape[-2]
        if not p:
            return solve(Hbar, g_bar), ce
        W = solve_multi(Hbar, torch.cat([g_bar.unsqueeze(-1), E.mT], dim=-1).contiguous())
        W_g, W_E = W[..., 0], W[..., 1:]  # (Bt, n), (Bt, n, p)
        S = E @ W_E + _eq_reg(E.dtype) * torch.eye(p, dtype=E.dtype, device=E.device)
        dnu = _lin_solve(S, _bmv(E, W_g) + ce)
        return W_g - _bmv(W_E, dnu), dnu

    return newton


def _solve(qp: QP, z0, iters, tol, ridge, newton) -> IPMSolution:
    H, g, C, d, E, e = qp.H, qp.g, qp.C, qp.d, qp.E, qp.e
    Bt, n = g.shape
    m = C.shape[-2]
    p = E.shape[-2]
    dtype, dev = g.dtype, g.device
    if tol is None:
        tol = 1e-8 if dtype == torch.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)
    sigma_cap = _sigma_cap(dtype)
    tau = 0.995
    eye = torch.eye(n, dtype=dtype, device=dev)

    def residual(z, s, lam, nu):
        ci = _bmv(C, z) - d
        gL = _bmv(H, z) + g - _bmTv(C, lam)
        ce = e  # (Bt, 0) without equality rows
        if p:
            ce = _bmv(E, z) - e
            gL = gL + _bmTv(E, nu)
        return ci, ce, gL, _kkt_residual(gL, ci, ce, s, lam)

    z = z0
    s = (_bmv(C, z0) - d).clamp_min(1e-2)
    lam = 0.1 / s
    nu = g.new_zeros(Bt, p)
    mu = torch.full((Bt,), 1e-1, dtype=dtype, device=dev)
    done = torch.zeros(Bt, dtype=torch.bool, device=dev)
    done_iter = torch.full((Bt,), -1, dtype=torch.int32, device=dev)

    for k in range(iters):
        if k and bool(done.all()):
            break
        ci, ce, gL, res = residual(z, s, lam, nu)
        done = done | (res < tol)
        done_iter = torch.where(done & (done_iter < 0), k, done_iter)

        s_safe = s.clamp_min(eps_div)
        sl = (lam / s_safe).clamp_max(sigma_cap)
        r_bar = (mu[:, None] - s * lam) / s_safe - sl * (ci - s)
        Hbar = H + (C.mT * sl[:, None, :]) @ C + ridge * eye
        g_bar = -gL + _bmTv(C, r_bar)
        dz, dnu = newton(Hbar, g_bar, E, ce)

        Cdz = _bmv(C, dz)
        ds = Cdz + (ci - s)
        dlam = r_bar - sl * Cdz
        a_s, a_l = _max_step(ds, s, tau), _max_step(dlam, lam, tau)

        # non-finite step guard: freeze a problem whose Newton step went NaN
        ok = (dz.isfinite().all(dim=1) & ds.isfinite().all(dim=1)
              & dlam.isfinite().all(dim=1) & dnu.isfinite().all(dim=1))
        upd = ~done & ok
        u1 = upd[:, None]
        z = torch.where(u1, z + a_s[:, None] * dz, z)
        s = torch.where(u1, s + a_s[:, None] * ds, s)
        lam = torch.where(u1, lam + a_l[:, None] * dlam, lam)
        if p:
            nu = torch.where(u1, nu + a_l[:, None] * dnu, nu)
        duality = (s * lam).sum(dim=1) / max(m, 1)
        mu = torch.where(upd, (0.1 * duality).clamp_min(mu_floor), mu)

    res = residual(z, s, lam, nu)[3]
    return IPMSolution(
        z=z,
        lam=lam,
        nu=nu,
        s=s,
        converged=res < tol * GRADE_QP,
        kkt_res=res,
        iterations=torch.where(done_iter < 0, iters, done_iter).to(torch.int32),
    )


def solve_qp(qp: QP, z0: torch.Tensor, *, iters: int = 30, tol: float | None = None) -> IPMSolution:
    """The dense-QP interior point of ``ipm.solve_qp``, for a batch of
    problems, each as if solved alone (the JAX fleet ``vmap``s it)."""
    return _solve(qp, z0, iters, tol, 1e-10, _newton_lu)


def solve_qp_batch(qp: QP, z0: torch.Tensor, *, iters: int = 30, tol: float | None = None,
                   backend: str = "auto") -> IPMSolution:
    """``ipm.solve_qp_batch``: the Newton systems of the whole batch go
    through K2, or through K3 where there are equality rows
    (``backend="auto"``), or through the kernels' plain versions
    (``"plain"``)."""
    if backend == "auto":
        newton = _newton_blocks(cholesky.solve, cholesky_multi.solve_multi)
    elif backend == "plain":
        newton = _newton_blocks(cholesky.plain, cholesky_multi.plain)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return _solve(qp, z0, iters, tol, 1e-9, newton)


GRADE_NL = 1e2  # solve_qp_nl's `converged` reports res < GRADE_NL * tol (ipm.py:77-81)


def solve_qp_nl(H, g, C, d, c_nl, z0, *, lam0=None, s0=None, iters: int = 40,
                tol: float | None = None, warm_if=None, iters_cap=None) -> IPMSolution:
    """``ipm.solve_qp_nl`` (ipm.py:816-972) for a batch of problems
    ``min 1/2 z'Hz + g'z  s.t.  Cz >= d,  c_nl(z) >= 0``, each as if solved
    alone (the JAX package ``vmap``s it).

    H (Bt, n, n), g (Bt, n), C (Bt, m1, n), d (Bt, m1), z0 (Bt, n);
    ``c_nl(z (Bt, n)) -> (vals (Bt, m2), jac (Bt, m2, n))`` gives the
    nonlinear rows and their Jacobian in closed form (Gauss-Newton: the
    Hessian stays H).  ``lam0``/``s0`` (Bt, m1 + m2) start the multipliers
    and slacks warm; ``warm_if`` (Bt,) bool picks per problem between that
    warm start and the cold one (s from the rows at z0, lam = 0.1/s,
    mu = 0.1); ``iters_cap`` (Bt,) caps each problem's iterations below
    ``iters``.  A problem freezes once its KKT residual passes ``tol``, its
    Newton step turns non-finite, or it reaches its cap; the loop ends when
    every problem is frozen, reading one flag back to the host per
    iteration.  It differs from :func:`solve_qp` where the JAX solver does:
    a 1e-9 ridge, ``mu = 0.2 * duality``, the slack reset onto strictly
    feasible rows after each step, ``converged`` graded with ``GRADE_NL``,
    and ``iterations`` equal to the cap when a problem did not converge.
    """
    if warm_if is not None and (lam0 is None or s0 is None):
        raise ValueError("warm_if selects between the warm (lam0/s0) and cold inits at "
                         "runtime: it requires lam0 and s0")
    Bt, n = z0.shape
    dtype, dev = z0.dtype, z0.device
    if tol is None:
        tol = 1e-8 if dtype == torch.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)
    sigma_cap = _sigma_cap(dtype)
    tau = 0.995
    eye = torch.eye(n, dtype=dtype, device=dev)

    def eval_c(z):
        vals, jac = c_nl(z)
        return torch.cat([_bmv(C, z) - d, vals], dim=-1), torch.cat([C, jac], dim=-2)

    def residual(z, s, lam, ci, Ji):
        gL = _bmv(H, z) + g - _bmTv(Ji, lam)
        return gL, _kkt_residual(gL, ci, z.new_zeros(Bt, 0), s, lam)

    ci0, _ = eval_c(z0)
    m = ci0.shape[-1]
    inv_m = 1.0 / m  # XLA folds the JAX code's `sum / m` into `sum * (1 / m)`
    s_cold = ci0.clamp_min(1e-2)
    lam_cold = 0.1 / s_cold
    mu_cold = torch.full((Bt,), 1e-1, dtype=dtype, device=dev)
    if lam0 is None:
        s, lam, mu = s_cold, lam_cold, mu_cold
    else:
        s = s0.clamp_min(1e-3)
        lam = lam0.clamp_min(1e-3)
        mu = ((s * lam).sum(dim=-1) * inv_m).clamp_min(mu_floor)
        if warm_if is not None:
            w = warm_if[:, None]
            s = torch.where(w, s, s_cold)
            lam = torch.where(w, lam, lam_cold)
            mu = torch.where(warm_if, mu, mu_cold)
    cap = torch.full((Bt,), iters, dtype=torch.int32, device=dev)
    if iters_cap is not None:
        cap = torch.as_tensor(iters_cap, dtype=torch.int32, device=dev).expand(Bt).clamp_max(iters)

    z = z0
    done = torch.zeros(Bt, dtype=torch.bool, device=dev)
    done_iter = torch.full((Bt,), -1, dtype=torch.int32, device=dev)
    for k in range(iters):
        active = ~done & (k < cap)
        if not bool(active.any()):
            break
        ci, Ji = eval_c(z)
        gL, res = residual(z, s, lam, ci, Ji)
        now_done = done | (res < tol)
        done_iter = torch.where(active & now_done & (done_iter < 0), k, done_iter)
        done = torch.where(active, now_done, done)

        s_safe = s.clamp_min(eps_div)
        sl = (lam / s_safe).clamp_max(sigma_cap)
        r_bar = (mu[:, None] - s * lam) / s_safe - sl * (ci - s)
        Hbar = H + (Ji.mT * sl[:, None, :]) @ Ji + 1e-9 * eye
        g_bar = -gL + _bmTv(Ji, r_bar)
        dz = _cho_solve(Hbar, g_bar)
        Jdz = _bmv(Ji, dz)
        ds = Jdz + (ci - s)
        dlam = r_bar - sl * Jdz
        a_s, a_l = _max_step(ds, s, tau), _max_step(dlam, lam, tau)

        # non-finite step guard: freeze a problem whose Newton step went NaN
        ok = dz.isfinite().all(dim=1) & ds.isfinite().all(dim=1) & dlam.isfinite().all(dim=1)
        upd = active & ~now_done & ok
        u1 = upd[:, None]
        z = torch.where(u1, z + a_s[:, None] * dz, z)
        s = torch.where(u1, s + a_s[:, None] * ds, s)
        lam = torch.where(u1, lam + a_l[:, None] * dlam, lam)
        # the slack reset onto strictly feasible rows (ipm.py:939-940)
        ci_new, _ = eval_c(z)
        s = torch.where(u1 & (ci_new > 1e-12), ci_new, s)
        duality = (s * lam).sum(dim=1) * inv_m
        mu = torch.where(upd, (0.2 * duality).clamp_min(mu_floor), mu)

    ci, Ji = eval_c(z)
    _, res = residual(z, s, lam, ci, Ji)
    return IPMSolution(
        z=z,
        lam=lam,
        nu=z.new_zeros(Bt, 0),
        s=s,
        converged=res < tol * GRADE_NL,
        kkt_res=res,
        iterations=torch.where(done_iter < 0, cap, done_iter).to(torch.int32),
    )
