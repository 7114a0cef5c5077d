"""Primal-dual interior point for dense convex QPs
(car_racing_tpu/ops/ipm.py:87-160, 346-579).

    min 1/2 z'Hz + g'z   s.t.   C z >= d,   E z = e

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

The two solvers differ where the JAX package's do: :func:`solve_qp` factors
its Newton systems with ``torch.linalg.cholesky_ex`` (the JAX package uses
``jnp.linalg.cholesky`` there, not a Pallas kernel) under a 1e-10 ridge;
:func:`solve_qp_batch`, the corridor sweep's solver, sends them through
kernel K2 under a 1e-9 ridge.  Equality rows (``p > 0``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import cholesky

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


def _kkt_residual(grad_L, c_i, c_e, s, lam):
    """Inf-norm KKT residual per problem; inputs carry a leading batch."""
    parts = [grad_L.abs(), (c_i - s).abs(), c_e.abs(), (s * lam).abs()]
    return torch.cat(parts, dim=-1).amax(dim=-1)


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


def _solve(qp: QP, z0, iters, tol, ridge, newton_solve) -> IPMSolution:
    H, g, C, d, E, e = qp.H, qp.g, qp.C, qp.d, qp.E, qp.e
    Bt, n = g.shape
    m = C.shape[-2]
    if E.shape[-2]:
        raise NotImplementedError("equality rows (p > 0) are not ported yet")
    dtype, dev = g.dtype, g.device
    if tol is None:
        tol = 1e-8 if dtype == torch.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)
    sigma_cap = _sigma_cap(dtype)
    tau = 0.995
    eye = torch.eye(n, dtype=dtype, device=dev)

    no_eq = e.new_zeros(Bt, 0)

    def residual(z, s, lam):
        ci = _bmv(C, z) - d
        gL = _bmv(H, z) + g - _bmTv(C, lam)
        return ci, gL, _kkt_residual(gL, ci, no_eq, s, lam)

    z = z0
    s = (_bmv(C, z0) - d).clamp_min(1e-2)
    lam = 0.1 / s
    mu = torch.full((Bt,), 1e-1, dtype=dtype, device=dev)
    done = torch.zeros(Bt, dtype=torch.bool, device=dev)
    done_iter = torch.full((Bt,), -1, dtype=torch.int32, device=dev)

    for k in range(iters):
        if k and bool(done.all()):
            break
        ci, gL, res = residual(z, s, lam)
        done = done | (res < tol)
        done_iter = torch.where(done & (done_iter < 0), k, done_iter)

        s_safe = s.clamp_min(eps_div)
        sl = (lam / s_safe).clamp_max(sigma_cap)
        r_bar = (mu[:, None] - s * lam) / s_safe - sl * (ci - s)
        Hbar = H + (C.mT * sl[:, None, :]) @ C + ridge * eye
        g_bar = -gL + _bmTv(C, r_bar)
        dz = newton_solve(Hbar, g_bar)

        Cdz = _bmv(C, dz)
        ds = Cdz + (ci - s)
        dlam = r_bar - sl * Cdz
        neg = lambda dv, v: torch.where(dv < 0, -tau * v / dv.clamp_max(-1e-30), torch.inf)
        a_s = neg(ds, s).amin(dim=1).clamp_max(1.0)
        a_l = neg(dlam, lam).amin(dim=1).clamp_max(1.0)

        # non-finite step guard: freeze a problem whose Newton step went NaN
        ok = (dz.isfinite().all(dim=1) & ds.isfinite().all(dim=1)
              & dlam.isfinite().all(dim=1))
        upd = ~done & ok
        u1 = upd[:, None]
        z = torch.where(u1, z + a_s[:, None] * dz, z)
        s = torch.where(u1, s + a_s[:, None] * ds, s)
        lam = torch.where(u1, lam + a_l[:, None] * dlam, lam)
        duality = (s * lam).sum(dim=1) / max(m, 1)
        mu = torch.where(upd, (0.1 * duality).clamp_min(mu_floor), mu)

    res = residual(z, s, lam)[2]
    return IPMSolution(
        z=z,
        lam=lam,
        nu=no_eq,
        s=s,
        converged=res < tol * GRADE_QP,
        kkt_res=res,
        iterations=torch.where(done_iter < 0, iters, done_iter).to(torch.int32),
    )


def solve_qp(qp: QP, z0: torch.Tensor, *, iters: int = 30, tol: float | None = None) -> IPMSolution:
    """The dense-QP interior point of ``ipm.solve_qp``, for a batch of
    problems, each as if solved alone (the JAX fleet ``vmap``s it)."""
    return _solve(qp, z0, iters, tol, 1e-10, _cho_solve)


def solve_qp_batch(qp: QP, z0: torch.Tensor, *, iters: int = 30, tol: float | None = None,
                   backend: str = "auto") -> IPMSolution:
    """``ipm.solve_qp_batch``: the Newton systems of the whole batch go
    through K2 (``backend="auto"``) or its plain version (``"plain"``)."""
    if backend == "auto":
        newton_solve = cholesky.solve
    elif backend == "plain":
        newton_solve = cholesky.plain
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return _solve(qp, z0, iters, tol, 1e-9, newton_solve)
