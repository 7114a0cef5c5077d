"""Cubic Bezier reference curves for overtake corridors
(car_racing_tpu/ops/bezier.py:15-132), batched over corridors."""

from __future__ import annotations

import torch


def bezier_curve(control_points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Evaluate cubic Beziers ``control_points (..., 4, 2)`` at ``t (T,)``.
    Returns (..., T, 2)."""
    c0, c1, c2, c3 = (control_points[..., i : i + 1, :] for i in range(4))
    t = t[:, None]
    return (
        c0 * (1 - t) ** 3
        + 3 * c1 * t * (1 - t) ** 2
        + 3 * c2 * t**2 * (1 - t)
        + c3 * t**3
    )


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` with a batch: ``x (..., K)`` over ``xp, fp (..., M)``
    with the same leading dims, ``xp`` sorted ascending.

    Clamped to ``fp[0]`` / ``fp[-1]`` outside ``[xp[0], xp[-1]]``; on a tie
    ``x == xp[i]`` it takes the segment to the right of ``xp[i]``
    (``searchsorted(side="right")``), and a segment no wider than the
    dtype's ``spacing(eps)`` yields its left value, as ``jnp.interp`` does."""
    M = xp.shape[-1]
    batch = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1])
    x = x.expand(*batch, x.shape[-1])
    xp = xp.expand(*batch, M).contiguous()
    fp = fp.expand(*batch, M)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, M - 1)
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = xp1 - xp0
    # np.spacing(eps) of a binary float is eps * eps (eps is a power of 2)
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, fp0, fp0 + ((x - xp0) / torch.where(dx0, 1.0, dx)) * (fp1 - fp0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def interp_ey(bezier_samples: torch.Tensor, s_query: torch.Tensor) -> torch.Tensor:
    """ey(s) by linear interpolation over sampled (s, ey) rows
    ``(..., T, 2)``, clamped at both ends; ``s_query (..., K)``."""
    return interp(s_query, bezier_samples[..., 0], bezier_samples[..., 1])


def corridor_control_points(
    num_veh: int,
    xcurv_ego: torch.Tensor,  # (S, 6)
    veh_info: torch.Tensor,  # (S, num_veh, 3): [s, max ey over pred, min ey over pred]
    max_delta_v: torch.Tensor,  # (S,)
    lap_length: torch.Tensor,
    track_width: torch.Tensor,
    veh_width: torch.Tensor,
    optimal_traj_xcurv: torch.Tensor,  # (T, 6) stored raceline
    prediction_factor: torch.Tensor,
):
    """Control points of the num_veh+1 passing corridors of S egos.

    Corridor 0 passes left of every vehicle, corridor i between vehicles
    i-1 and i (sorted by ey descending), corridor num_veh right of all;
    every row of ``veh_info`` is active.  Returns (S, num_veh+1, 4, 2)."""
    S = xcurv_ego.shape[0]
    n_cor = num_veh + 1
    opt_s = optimal_traj_xcurv[:, 4]
    opt_ey = optimal_traj_xcurv[:, 5]

    def opt_ey_at(s):
        # below the stored range -> first stored value
        s_w = torch.where(s < 0, s + lap_length, s)
        return torch.where(s_w <= opt_s[0], opt_ey[0], interp(s_w, opt_s, opt_ey))

    s0 = xcurv_ego[:, 4:5].expand(S, n_cor)
    s3 = s0 + prediction_factor * max_delta_v[:, None] + 4.0
    wraps = s0 > s3
    span = torch.where(wraps, s3 + lap_length - s0, s3 - s0)
    s1 = s0 + span / 3.0
    s2 = s0 + 2.0 * span / 3.0
    s3 = torch.where(wraps, s3 + lap_length, s3)

    ey0 = xcurv_ego[:, 5:6].expand(S, n_cor)

    idx = torch.arange(n_cor, device=xcurv_ego.device)
    top_ey = veh_info[:, :, 1]  # (S, num_veh)
    ey_top = 0.8 * track_width - (-top_ey[:, :1] - 0.5 * veh_width) * 0.2
    ey_bot = -0.8 * track_width + (top_ey[:, num_veh - 1 : num_veh] - 0.5 * veh_width) * 0.2
    below = idx.clamp(0, num_veh - 1)
    above = (idx - 1).clamp(0, num_veh - 1)
    ey_mid_between = 0.7 * (top_ey[:, below] + 0.5 * veh_width) + 0.3 * (
        top_ey[:, above] - 0.5 * veh_width
    )
    ey_mid = torch.where(idx == 0, ey_top, torch.where(idx == num_veh, ey_bot, ey_mid_between))

    s3_w = torch.where(s3 >= lap_length, s3 - lap_length, s3)
    ey3 = opt_ey_at(s3_w)

    return torch.stack(
        [
            torch.stack([s0, ey0], dim=-1),
            torch.stack([s1, ey_mid], dim=-1),
            torch.stack([s2, ey_mid], dim=-1),
            torch.stack([s3, ey3], dim=-1),
        ],
        dim=-2,
    )


def sample_corridors(control_points: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Sample each corridor's Bezier at num_samples uniform parameters:
    (..., 4, 2) -> (..., num_samples, 2)."""
    t = torch.linspace(0.0, 1.0, num_samples, dtype=control_points.dtype,
                       device=control_points.device)
    return bezier_curve(control_points, t)
