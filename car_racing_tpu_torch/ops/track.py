"""Closed-track geometry (car_racing_tpu/ops/track.py:36-236).

A track spec is rows of ``[segment_length, radius]`` (radius 0 => straight,
signed radius => arc, positive = left turn).  :func:`build_track` walks the
spec on the host in float64, exactly as the JAX package does, and stores the
per-segment arrays as tensors.  The Frenet-to-global conversions take any
leading batch dimensions, which stands in for the JAX package's ``vmap``ped
``*_batch`` variants.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve

_S_TOL = 1e-3  # segment-membership tolerance


@dataclasses.dataclass(frozen=True)
class Track:
    """Closed track as struct-of-arrays over segments."""

    start_xy: torch.Tensor  # (n_seg, 2) segment start point
    end_xy: torch.Tensor  # (n_seg, 2) segment end point
    psi_start: torch.Tensor  # (n_seg,) tangent angle at segment start
    s0: torch.Tensor  # (n_seg,) cumulative arc length at segment start
    seg_len: torch.Tensor  # (n_seg,) segment length
    curv: torch.Tensor  # (n_seg,) signed curvature (0 => straight)
    center_xy: torch.Tensor  # (n_seg, 2) arc center (unused for straights)
    lap_length: torch.Tensor  # () total lap length
    width: torch.Tensor  # () track half-width bound on |ey|

    @property
    def num_segments(self) -> int:
        return self.start_xy.shape[0]


def _wrap(angle):
    """Wrap angle to (-pi, pi]."""
    return np.arctan2(np.sin(angle), np.cos(angle))


def build_track(spec: np.ndarray, width: float = 0.8, *, device="cuda",
                dtype=torch.float64) -> Track:
    """Build a :class:`Track` from ``[length, radius]`` spec rows; a final
    straight segment closes the loop back to the origin."""
    dev = resolve(device)
    spec = np.asarray(spec, dtype=np.float64)
    n = spec.shape[0]
    start_xy = np.zeros((n + 1, 2))
    end_xy = np.zeros((n + 1, 2))
    psi_start = np.zeros(n + 1)
    s0 = np.zeros(n + 1)
    seg_len = np.zeros(n + 1)
    curv = np.zeros(n + 1)
    center_xy = np.zeros((n + 1, 2))

    pos = np.zeros(2)
    ang = 0.0
    s_cum = 0.0
    for i in range(n):
        length, radius = spec[i]
        start_xy[i] = pos
        psi_start[i] = ang
        s0[i] = s_cum
        seg_len[i] = length
        if radius == 0.0:
            end_xy[i] = pos + length * np.array([np.cos(ang), np.sin(ang)])
            pos = end_xy[i]
        else:
            direction = 1.0 if radius >= 0 else -1.0
            R = abs(radius)
            center = pos + R * np.array(
                [np.cos(ang + direction * np.pi / 2), np.sin(ang + direction * np.pi / 2)]
            )
            center_xy[i] = center
            span = length / R
            theta0 = np.arctan2(pos[1] - center[1], pos[0] - center[0])
            theta1 = theta0 + direction * span
            end_xy[i] = center + R * np.array([np.cos(theta1), np.sin(theta1)])
            curv[i] = 1.0 / radius
            ang = _wrap(ang + direction * span)
            pos = end_xy[i]
        s_cum += length
    start_xy[n] = pos
    psi_start[n] = ang
    s0[n] = s_cum
    seg_len[n] = float(np.hypot(*pos))
    s_cum += seg_len[n]

    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)
    return Track(
        start_xy=f(start_xy),
        end_xy=f(end_xy),
        psi_start=f(psi_start),
        s0=f(s0),
        seg_len=f(seg_len),
        curv=f(curv),
        center_xy=f(center_xy),
        lap_length=f(s_cum),
        width=f(width),
    )


def load_track(layout: str, width: float = 0.8, data_dir: str = "data", *,
               device="cuda", dtype=torch.float64) -> Track:
    """Load one of the stock layouts (l_shape, m_shape, goggle, ellipse)."""
    spec = np.genfromtxt(f"{data_dir}/track_layout/{layout}.csv", delimiter=",")
    return build_track(spec, width, device=device, dtype=dtype)


def wrap_s(track: Track, s: torch.Tensor) -> torch.Tensor:
    """Wrap arc length onto [0, lap_length): floor-mod, like ``jnp.mod``."""
    return torch.remainder(s, track.lap_length)


def segment_table(track: Track) -> torch.Tensor:
    """(3, n_seg) rows ``[s0, s0 + seg_len + _S_TOL, curv]``: segment i holds
    the wrapped s with ``s0[i] <= s < hi[i]``."""
    return torch.stack([track.s0, track.s0 + track.seg_len + _S_TOL, track.curv])


def curvature(track: Track, s: torch.Tensor) -> torch.Tensor:
    """Signed curvature at arc length ``s`` (any shape).

    The first segment that holds the wrapped ``s`` wins, and segment 0 when
    none does (argmax over booleans, as in the JAX package)."""
    s = wrap_s(track, s)[..., None]
    inside = (s >= track.s0) & (s < track.s0 + track.seg_len + _S_TOL)
    # torch.argmax returns the first maximal index; it takes no bools
    return track.curv[torch.argmax(inside.to(torch.uint8), dim=-1)]


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle to (-pi, pi]."""
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def _segment_index(track: Track, s: torch.Tensor) -> torch.Tensor:
    """The first segment holding the wrapped ``s`` (segment 0 when none
    does), as :func:`curvature` picks it."""
    inside = (s[..., None] >= track.s0) & (s[..., None] < track.s0 + track.seg_len + _S_TOL)
    return torch.argmax(inside.to(torch.uint8), dim=-1)


def _arc_geometry(track: Track):
    """Per-segment arc quantities with straight-segment guards."""
    is_arc = track.curv != 0.0
    safe_curv = torch.where(is_arc, track.curv, 1.0)
    R = torch.abs(1.0 / safe_curv)
    direction = torch.sign(safe_curv)
    theta0 = torch.atan2(track.start_xy[:, 1] - track.center_xy[:, 1],
                         track.start_xy[:, 0] - track.center_xy[:, 0])
    return is_arc, R, direction, theta0


def frenet_to_global_xy(track: Track, s: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
    """(s, ey) -> (X, Y), shape (..., 2).

    The JAX package sums the candidates of every segment under a one-hot
    mask; the other segments add exact zeros, so taking the picked
    segment's candidate gives the same values."""
    s = wrap_s(track, s)
    i = _segment_index(track, s)
    ds = s - track.s0[i]
    ey = ey[..., None]

    psi0 = track.psi_start[i]
    n_hat = torch.stack([torch.cos(psi0 + torch.pi / 2), torch.sin(psi0 + torch.pi / 2)], dim=-1)
    start = track.start_xy[i]
    straight = start + (ds / track.seg_len[i])[..., None] * (track.end_xy[i] - start) + ey * n_hat

    is_arc, R, direction, theta0 = (a[i] for a in _arc_geometry(track))
    theta = theta0 + direction * (ds / R)
    radial = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    arc = track.center_xy[i] + (R[..., None] - direction[..., None] * ey) * radial
    return torch.where(is_arc[..., None], arc, straight)


def frenet_to_global_psi(track: Track, s: torch.Tensor, ey: torch.Tensor) -> torch.Tensor:
    """Centerline tangent angle at ``s``, wrapped to (-pi, pi]; ``ey`` is
    not read (the JAX signature's)."""
    s = wrap_s(track, s)
    i = _segment_index(track, s)
    is_arc, R, direction, theta0 = (a[i] for a in _arc_geometry(track))
    theta = theta0 + direction * ((s - track.s0[i]) / R)
    psi = torch.where(is_arc, theta + direction * torch.pi / 2, track.psi_start[i])
    return wrap_angle(psi)


def frenet_to_global_state(track: Track, xcurv: torch.Tensor) -> torch.Tensor:
    """``[vx, vy, wz, epsi, s, ey]`` -> ``[vx, vy, wz, psi, X, Y]`` with psi
    the tangent plus epsi; xcurv (..., 6)."""
    s, ey = xcurv[..., 4], xcurv[..., 5]
    xy = frenet_to_global_xy(track, s, ey)
    psi = frenet_to_global_psi(track, s, ey) + xcurv[..., 3]
    return torch.cat([xcurv[..., :3], psi[..., None], xy], dim=-1)
