"""LMPC learning ops: cost-to-go, safe-set selection, local regression
(car_racing_tpu/ops/lmpc_learning.py:39-233).

The JAX package ``vmap``s the per-stage regression over the horizon; here
the horizon is a leading batch dimension of every function.  Safe sets are
sentinel-padded arrays ``(P, 6)`` whose unused rows hold 1e4; a learning
fleet gives each lane its own, with leading lane dimensions ``(..., P, 6)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import U_DIM, X_DIM

SENTINEL = 1e4
_H_KERNEL = 5.0
_SCALING = (0.1, 1.0, 1.0, 1.0, 1.0)  # diagonal of the feature scaling


def compute_cost(xcurv: torch.Tensor, lap_length) -> torch.Tensor:
    """Backward-DP cost-to-go of a lap ``xcurv (T, 6)``: ``cost[T-1] = 0``
    and, going back, ``cost[k] = cost[k+1] + 1`` while ``s < lap_length``,
    else 0, with the DP started from -1 past ``T - 2``.  Returns (T,).

    Written without the loop: ``cost[k]`` is the distance from ``k`` to the
    first step at or after it with ``s >= lap_length`` (one less where the
    run reaches the end of the lap)."""
    T = xcurv.shape[0]
    before = xcurv[:-1, 4] < lap_length  # (T-1,)
    k = torch.arange(T - 1, device=xcurv.device)
    stops = torch.where(before, T - 1, k)
    nxt = stops.flip(0).cummin(0).values.flip(0)  # first stop at or after k
    cost = (nxt - k - (nxt == T - 1).long()).to(xcurv.dtype)
    return torch.cat([cost, xcurv.new_zeros(1)])


def compute_cost_host(xcurv, lap_length) -> np.ndarray:
    """Numpy :func:`compute_cost` for the host's lap-close glue, as a loop
    (lmpc_learning.py:54-71).  xcurv (T, 6); returns (T,)."""
    xcurv = np.asarray(xcurv)
    T = xcurv.shape[0]
    costs = np.zeros(T)
    nxt = -1.0
    for k in range(T - 2, -1, -1):
        nxt = nxt + 1.0 if xcurv[k, 4] < lap_length else 0.0
        costs[k] = nxt
    return costs


def select_points(ss_iter, qfun_iter, xcurv, num_points: int, shift: int = 0):
    """The ``num_points`` safe-set points from the one nearest (1-norm) to
    ``xcurv (..., 6)`` on; the first nearest wins a tie (``jnp.argmin``),
    and the window start is clipped into the array.

    ss_iter (P, 6) and qfun_iter (P,) shared by the batch, or one per lane,
    (..., P, 6) and (..., P), with lane dimensions leading ``xcurv``'s.
    Returns points (..., 6, num_points) and their cost-to-go
    (..., num_points)."""
    P = ss_iter.shape[-2]
    norm = (ss_iter - xcurv.unsqueeze(-2)).abs().sum(dim=-1)  # (..., P)
    start = (torch.argmin(norm, dim=-1) + shift).clamp(0, P - num_points)
    idx = start.unsqueeze(-1) + torch.arange(num_points, device=ss_iter.device)
    if ss_iter.dim() == 2:
        return ss_iter[idx].transpose(-1, -2), qfun_iter[idx]
    pts = torch.take_along_dim(ss_iter, idx.unsqueeze(-1), dim=-2)
    return pts.transpose(-1, -2), torch.take_along_dim(qfun_iter, idx, dim=-1)


def _kernel_weights(data_zu, valid, x_lin, max_pts: int):
    """The ``max_pts`` rows of ``data_zu (P, 5)`` nearest (scaled 1-norm) to
    each ``x_lin (..., 5)`` and their Epanechnikov weights.

    ``lax.top_k`` keeps the lower index among equal norms; a stable
    ascending sort does the same, so ties at the cut-off select the same
    rows.  Masked rows have norm ``inf`` and weight 0.  Returns
    (idx (..., max_pts), w (..., max_pts))."""
    scaling = torch.diag(torch.tensor(_SCALING, dtype=data_zu.dtype, device=data_zu.device))
    diff = (data_zu - x_lin.unsqueeze(-2)) @ scaling
    norm = torch.where(valid, diff.abs().sum(dim=-1), torch.inf)
    sel_norm, idx = torch.sort(norm, dim=-1, stable=True)
    sel_norm, idx = sel_norm[..., :max_pts], idx[..., :max_pts]
    w = torch.where(sel_norm < _H_KERNEL, (1.0 - (sel_norm / _H_KERNEL) ** 2) * 0.75, 0.0)
    w = torch.where(sel_norm.isfinite(), w, 0.0)
    return idx, w


def _weighted_fit(Z, w, y):
    """``argmin_beta sum_i w_i (Z_i . beta + beta_c - y_i)^2`` by the normal
    equations, under a ridge relative to the Gram matrix's scale.

    Z (..., k, f), w (..., k), y (..., k).  Returns beta (..., f + 1)."""
    M = torch.cat([Z, Z.new_ones(*Z.shape[:-1], 1)], dim=-1)
    Mw = M.mT * w.unsqueeze(-2)
    Q = Mw @ M
    eps = 1e-10 if Z.dtype == torch.float64 else 2e-5
    f = M.shape[-1]
    scale = Q.diagonal(dim1=-2, dim2=-1).sum(-1) / f + 1.0
    Q = Q + (eps * scale)[..., None, None] * torch.eye(f, dtype=Z.dtype, device=Z.device)
    b = (Mw @ y.unsqueeze(-1)).squeeze(-1)
    # solve_ex: no host sync; a singular Q gives non-finite beta, as
    # jnp.linalg.solve does, instead of raising
    return torch.linalg.solve_ex(Q, b.unsqueeze(-1))[0].squeeze(-1)


def _kinematic_rows(curv, xcurv, dt):
    """Rows 3..5 of (A, C): the exact Jacobian of the Frenet kinematic
    update at frozen curvature, written out analytically.

    curv (...,), xcurv (..., 6), dt a float or 0-d tensor.  Returns
    A_rows (..., 3, 6), C_rows (..., 3)."""
    vx, vy, wz, epsi, s, ey = xcurv.unbind(-1)
    ce, se = torch.cos(epsi), torch.sin(epsi)
    den = 1.0 - curv * ey
    s_dot = (vx * ce - vy * se) / den
    kin = torch.stack([
        epsi + dt * (wz - s_dot * curv),
        s + dt * s_dot,
        ey + dt * (vx * se + vy * ce),
    ], dim=-1)
    zero, one = torch.zeros_like(vx), torch.ones_like(vx)
    # gradient of s_dot over (vx, vy, wz, epsi, s, ey)
    ds = torch.stack([ce / den, -se / den, zero, (-vx * se - vy * ce) / den, zero,
                      s_dot * curv / den], dim=-1)
    unit = lambda i: torch.stack([one if j == i else zero for j in range(X_DIM)], dim=-1)
    row_epsi = unit(3) + dt * (unit(2) - ds * curv.unsqueeze(-1))
    row_s = unit(4) + dt * ds
    row_ey = unit(5) + dt * torch.stack([se, ce, zero, vx * ce - vy * se, zero, zero], dim=-1)
    A_rows = torch.stack([row_epsi, row_s, row_ey], dim=-2)
    C_rows = kin - (A_rows @ xcurv.unsqueeze(-1)).squeeze(-1)
    return A_rows, C_rows


def regression_and_linearization(x_lin_state, u_lin, ss_data, u_data, valid, curv, dt,
                                 max_pts: int = 40):
    """(A, B, C) of the dynamics linearized at ``x_lin_state (..., 6)``,
    ``u_lin (..., 2)``.

    Rows 0..2 (vx, vy, wz) are kernel-weighted local least squares on the
    lap data ``ss_data (L, P, 6)``, ``u_data (L, P, 2)``, ``valid (L, P)``
    (rows with a successor sample); rows 3..5 are the exact kinematic
    Jacobian at curvature ``curv (...,)``.  A fleet gives each lane its own
    data, ``(*lanes, L, P, ...)``, with ``lanes`` leading ``x_lin_state``'s
    batch.  Returns A (..., 6, 6), B (..., 6, 2), C (..., 6)."""
    *lanes, L, P, _ = ss_data.shape
    batch = x_lin_state.shape[:-1]
    dtype, dev = x_lin_state.dtype, x_lin_state.device
    x_lin = torch.cat([x_lin_state[..., :3], u_lin], dim=-1)

    # each lane's rows flattened, with a unit dimension for every batch
    # dimension past the lanes (the gathers below broadcast over them)
    ones = [1] * (len(batch) - len(lanes))
    flat_states = ss_data.reshape(*lanes, *ones, L * P, X_DIM)
    flat_u = u_data.reshape(*lanes, *ones, L * P, U_DIM)
    data_zu = torch.cat([flat_states[..., :3], flat_u], dim=-1)
    idx, w = _kernel_weights(data_zu, valid.reshape(*lanes, *ones, L * P), x_lin, max_pts)
    # successor rows: the flat layout keeps each lap's order, and the
    # validity mask already excludes lap ends
    succ = (idx + 1).clamp(0, L * P - 1)
    rows = lambda data, i: torch.take_along_dim(data, i.unsqueeze(-1), dim=-2)
    states, inputs, nxt = rows(flat_states, idx), rows(flat_u, idx), rows(flat_states, succ)

    # the vx channel regresses on [vx, vy, wz, a], vy and wz on [vx, vy, wz, delta]
    Z_vx = torch.cat([states[..., :3], inputs[..., 1:2]], dim=-1)
    Z_lat = torch.cat([states[..., :3], inputs[..., 0:1]], dim=-1)
    beta = _weighted_fit(torch.stack([Z_vx, Z_lat, Z_lat]), w.expand(3, *w.shape),
                         nxt[..., :3].movedim(-1, 0))  # (3, ..., 5)

    A = torch.zeros(*batch, X_DIM, X_DIM, dtype=dtype, device=dev)
    B = torch.zeros(*batch, X_DIM, U_DIM, dtype=dtype, device=dev)
    C = torch.zeros(*batch, X_DIM, dtype=dtype, device=dev)
    for row in range(3):
        A[..., row, :3] = beta[row, ..., :3]
        B[..., row, 1 if row == 0 else 0] = beta[row, ..., 3]
        C[..., row] = beta[row, ..., 4]
    A[..., 3:, :], C[..., 3:] = _kinematic_rows(curv, x_lin_state, dt)
    return A, B, C


# The JAX package vmaps regression_and_linearization over the horizon
# (lmpc_learning.py:219); here the horizon is its batch dimension.
estimate_abc_horizon = regression_and_linearization
