"""Corridor branch planning as one batched QP solve
(car_racing_tpu/planning/overtake.py:90-257 and the single-device body of
car_racing_tpu/parallel/mesh.py:146-213).

Each overtake corridor is a convex QP over the condensed input sequence:
Bezier tracking, smoothness and progress cost; input, speed and track-width
bounds; gated no-overlap rows against the corridor's neighbours.  A sweep
builds every corridor's QP, solves them in one :func:`ipm.solve_qp_batch`
call (Newton systems through kernel K2), replaces unconverged branches by a
kinematic fallback and picks each scenario's branch by the reference's
progress / collision / hysteresis cost.

Functions take a leading batch of problems ``P``; the LTI input map ``G``
is the same for every problem and is shared.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bezier, ipm, ocp
from ..utils.constants import U_DIM, X_DIM
from ..utils.device import resolve
from ..utils.params import load_lti

# the racing-game traffic shape of the corridor sweep inputs
# (car_racing_tpu/parallel/scaling.py:41-46)
LAP_LENGTH = 50.0
TRACK_WIDTH = 1.0
VEH_WIDTH = 0.2
VEH_LENGTH = 0.4
PRED_FACTOR = 0.6


def corridor_context(xcurv_ego, A, B, num_horizon: int, dt: float = 0.1):
    """Branch-invariant pieces for egos ``(P, 6)``: the condensed LTI
    prediction phi (P, N*6), G (N*6, N*2) and the constant-velocity s
    prediction (P, N+1)."""
    phi, G = ocp.condense_lti(A, B, num_horizon, xcurv_ego)
    ks = torch.arange(num_horizon + 1, dtype=xcurv_ego.dtype, device=xcurv_ego.device)
    s_pred = xcurv_ego[:, 4:5] + ks * dt * xcurv_ego[:, 0:1]
    return phi, G, s_pred


def corridor_branch_qp(phi, G, s_pred, track_width, veh_width, bez, l_ey, l_gate, r_ey,
                       r_gate, num_horizon: int) -> ipm.QP:
    """The corridor QPs of P branches: phi (P, N*6), G shared, s_pred
    (P, N+1), bez (P, N+1, 2) sampled corridor curves, l_ey/r_ey (P, N)
    neighbour ey over the horizon with bool gates l_gate/r_gate (P, N)."""
    N = num_horizon
    P = phi.shape[0]
    dtype, dev = phi.dtype, phi.device
    n_u = N * U_DIM
    s_ref = torch.clamp(s_pred, bez[:, 0, 0:1], bez[:, -1, 0:1])
    ey_ref = bezier.interp_ey(bez, s_ref)

    rows = torch.arange(N, device=dev) * X_DIM
    G_s, p_s = G[rows + 4], phi[:, rows + 4]
    G_ey, p_ey = G[rows + 5], phi[:, rows + 5]

    # bezier tracking 20 * sum_j (ey_j - ey_ref_j)^2 + (s_j - s_ref_j)^2
    H = 2 * 20.0 * (G_ey.mT @ G_ey + G_s.mT @ G_s)
    g = 2 * 20.0 * ((p_ey - ey_ref[:, 1:]) @ G_ey + (p_s - s_ref[:, 1:]) @ G_s)
    # smoothness 30 * sum_{k=2..N-1} (ey_k - ey_{k-1})^2
    D = G_ey[1 : N - 1] - G_ey[0 : N - 2]
    dp = p_ey[:, 1 : N - 1] - p_ey[:, 0 : N - 2]
    H = H + 2 * 30.0 * (D.mT @ D)
    g = g + 2 * 30.0 * (dp @ D)
    # progress -200 * (s_N - s_0)
    g = g + -200.0 * G[-X_DIM + 4]
    H = H + 1e-9 * torch.eye(n_u, dtype=dtype, device=dev)

    # shared rows: input bounds (hardcoded in the reference), vx <= 5,
    # |ey| bounds for stages 1..N-1
    I_u = torch.eye(n_u, dtype=dtype, device=dev)
    G_eyb = G_ey[: N - 1]
    C_shared = torch.cat([I_u, -I_u, -G[rows + 0], G_eyb, -G_eyb])
    u_lo = torch.tensor([-0.5, -1.5], dtype=dtype, device=dev).repeat(N)
    u_hi = torch.tensor([0.5, 1.5], dtype=dtype, device=dev).repeat(N)
    bound = track_width - 0.5 * veh_width
    p_eyb = p_ey[:, : N - 1]
    d_parts = [u_lo.expand(P, n_u), (-u_hi).expand(P, n_u), phi[:, rows + 0] - 5.0,
               -bound - p_eyb, p_eyb - bound]
    C_parts = [C_shared.expand(P, *C_shared.shape)]
    # corridor rows ey_k - obs_ey_k >= veh_width + 0.15 where gated, k = 1..N-1
    margin = veh_width + 0.15
    for obs_ey, gate in ((l_ey, l_gate), (r_ey, r_gate)):
        act = gate[:, 1:N]
        C_parts.append(torch.where(act[:, :, None], G_eyb, 0.0))
        d_parts.append(torch.where(act, margin + obs_ey[:, 1:N] - p_eyb, -1.0))
    return ipm.QP(
        H=H.expand(P, n_u, n_u),
        g=g,
        C=torch.cat(C_parts, dim=1),
        d=torch.cat(d_parts, dim=1),
        E=phi.new_zeros(P, 0, n_u),
        e=phi.new_zeros(P, 0),
    )


def kinematic_fallback_traj(xcurv_ego, bez, num_horizon: int, dt: float = 0.1):
    """Fallback trajectories (P, N+1, 6) for unconverged branches: 1.1x the
    current speed along each corridor's Bezier ey."""
    N = num_horizon
    ar = torch.arange(N + 1, dtype=xcurv_ego.dtype, device=xcurv_ego.device)
    stmp = xcurv_ego[:, 4:5] + 1.1 * ar * dt * xcurv_ego[:, 0:1]
    sclip = torch.clamp(stmp, bez[:, 0, 0:1], bez[:, -1, 0:1])
    X = xcurv_ego.new_zeros(xcurv_ego.shape[0], N + 1, X_DIM)
    X[:, :, 0] = 1.1 * xcurv_ego[:, 0:1]
    X[:, :, 4] = stmp
    X[:, :, 5] = bezier.interp_ey(bez, sclip)
    return X


def branch_selection_cost(X, left_s, left_ey, right_s, right_ey, left_valid, right_valid,
                          veh_length, veh_width, old_dir, br_idx):
    """The reference's branch-selection cost for P planned trajectories
    X (P, N+1, 6): progress reward, collision penalty against the side
    neighbours (P, N+1), direction-switch hysteresis against old_dir (P,)."""
    cost = -10.0 * (X[:, -1, 4] - X[:, 0, 4])

    def side(s_o, ey_o, valid):
        viol = (
            (X[..., 4] - s_o) ** 2 + (X[..., 5] - ey_o) ** 2
            - veh_length**2 - veh_width**2
            < 0.0
        ).sum(dim=-1)
        return torch.where(valid, 100.0 * viol.to(X.dtype), 0.0)

    cost = cost + side(left_s, left_ey, left_valid) + side(right_s, right_ey, right_valid)
    return cost + torch.where((old_dir >= 0) & (br_idx != old_dir), 100.0, 0.0)


def _solve_branch_batch(xcurv_ego, A, B, track_width, veh_width, bezier_samples, left_obs_ey,
                        left_gate, right_obs_ey, right_gate, num_horizon: int = 10):
    """All corridor QPs of one ego ``(6,)`` at once.  Returns (X (n_br, N+1, 6),
    qp_cost (n_br,), converged (n_br,), iterations (n_br,))."""
    N = num_horizon
    n_br = bezier_samples.shape[0]
    x0 = xcurv_ego.expand(n_br, X_DIM)
    phi, G, s_pred = corridor_context(x0, A, B, N)
    qp = corridor_branch_qp(phi, G, s_pred, track_width, veh_width, bezier_samples,
                            left_obs_ey, left_gate, right_obs_ey, right_gate, N)
    sol = ipm.solve_qp_batch(qp, phi.new_zeros(n_br, N * U_DIM), iters=30)
    X = ocp.unpack_states(phi, G, sol.z, x0)
    z = sol.z
    qp_cost = 0.5 * torch.einsum("bi,bij,bj->b", z, qp.H, z) + (qp.g * z).sum(dim=1)
    return X, qp_cost, sol.converged, sol.iterations


def corridor_sweep(
    xcurv_ego,  # (S, 6) per-scenario ego states
    A,
    B,
    track_width,
    veh_width,
    veh_length,
    bezier_samples,  # (S, BR, N+1, 2) sampled corridor curves
    left_ey,  # (S, BR, N+1) left-neighbour ey over the horizon
    left_gate,  # (S, BR, N+1) bool: QP corridor row active
    right_ey,  # (S, BR, N+1)
    right_gate,  # (S, BR, N+1)
    left_s,  # (S, BR, N+1) left neighbour wrapped s (selection)
    right_s,  # (S, BR, N+1)
    left_valid,  # (S, BR) bool: branch has a left neighbour
    right_valid,  # (S, BR)
    active,  # (S, BR) bool: False rows are padding (cost +inf)
    old_dir,  # (S,) int32 previous direction, -1 = none
    num_horizon: int = 10,
    backend: str = "auto",
):
    """The racing game's corridor sweep on one device: ``mesh.corridor_sweep``
    with the collectives replaced by an argmin over each scenario's branches.

    One flat (S*BR)-problem :func:`ipm.solve_qp_batch` (``backend`` picks
    K2 or its plain version), the kinematic fallback for unconverged
    branches, then selection.  Returns (best (S,) int32, X_best (S, N+1, 6),
    costs (S, BR), converged (S, BR), X_all (S, BR, N+1, 6), iters (S, BR)
    int32 per-branch Newton counts)."""
    N = num_horizon
    S, BR = bezier_samples.shape[:2]
    P = S * BR
    rep = lambda t: t.repeat_interleave(BR, dim=0)
    flat = lambda t: t.reshape(P, *t.shape[2:])

    phi_s, G, s_pred = corridor_context(xcurv_ego, A, B, N)
    phi, x0, bez = rep(phi_s), rep(xcurv_ego), flat(bezier_samples)
    qp = corridor_branch_qp(
        phi, G, rep(s_pred), track_width, veh_width, bez,
        flat(left_ey)[:, :N], flat(left_gate)[:, :N],
        flat(right_ey)[:, :N], flat(right_gate)[:, :N], N,
    )
    sol = ipm.solve_qp_batch(qp, phi.new_zeros(P, N * U_DIM), iters=30, backend=backend)
    X = ocp.unpack_states(phi, G, sol.z, x0)
    X = torch.where(sol.converged[:, None, None], X, kinematic_fallback_traj(x0, bez, N))

    br_idx = torch.arange(BR, dtype=torch.int32, device=X.device).repeat(S)
    costs = branch_selection_cost(
        X, flat(left_s), flat(left_ey), flat(right_s), flat(right_ey),
        flat(left_valid), flat(right_valid), veh_length, veh_width, rep(old_dir), br_idx,
    )
    costs = torch.where(flat(active), costs, torch.inf).reshape(S, BR)
    best = torch.argmin(costs, dim=1).to(torch.int32)
    X_all = X.reshape(S, BR, N + 1, X_DIM)
    X_best = X_all[torch.arange(S, device=X.device), best.long()]
    return (best, X_best, costs, sol.converged.reshape(S, BR), X_all,
            sol.iterations.reshape(S, BR))


def corridor_sweep_inputs(S: int, N: int, seed: int = 0, dtype=torch.float32, device="cuda",
                          num_veh: int = 3, data_dir: str = "data"):
    """S racing-game overtake scenarios (num_veh vehicles of interest each,
    sorted by ey descending) and the per-branch arrays the corridor sweep
    takes, made from a numpy seed exactly as
    ``car_racing_tpu.parallel.scaling.corridor_sweep_inputs`` makes them.

    Returns the 17 positional inputs of :func:`corridor_sweep`."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    BR = num_veh + 1
    L, W = LAP_LENGTH, TRACK_WIDTH
    dt = 0.1

    x0 = np.zeros((S, X_DIM))
    x0[:, 0] = rng.uniform(0.6, 1.0, S)  # vx
    x0[:, 4] = rng.uniform(0.0, L - 30.0, S)  # s
    x0[:, 5] = rng.uniform(-0.1, 0.1, S)  # ey

    obs_s0 = x0[:, 4:5] + np.sort(rng.uniform(1.5, 6.0, (S, num_veh)), axis=1)
    obs_ey0 = -np.sort(-rng.uniform(-0.5 * W, 0.5 * W, (S, num_veh)), axis=1)
    obs_vx = rng.uniform(0.2, 0.5, (S, num_veh))

    ks = np.arange(N + 1) * dt
    obs_s = obs_s0[:, :, None] + obs_vx[:, :, None] * ks  # (S, nv, N+1)
    obs_ey = np.broadcast_to(obs_ey0[:, :, None], obs_s.shape).copy()
    obs_s_w = np.mod(obs_s, L)

    # Bezier corridors against a synthetic centerline raceline
    opti = np.zeros((50, X_DIM))
    opti[:, 0] = 0.8
    opti[:, 4] = np.linspace(0.0, L, 50)
    veh_infos = np.stack([obs_s0, obs_ey0, obs_ey0], axis=2)  # (S, nv, 3)
    max_delta_v = np.abs(x0[:, 0:1] - obs_vx).max(axis=1)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=dev)
    cp = bezier.corridor_control_points(
        num_veh, t(x0), t(veh_infos), t(max_delta_v), t(L), t(W), t(VEH_WIDTH), t(opti),
        t(PRED_FACTOR),
    )
    bez = bezier.sample_corridors(cp, N + 1)  # (S, BR, N+1, 2)

    # per-branch neighbour rows + gates (the planner's get_local_traj)
    s_pred = x0[:, 4:5] + ks[None] * x0[:, 0:1]
    gate_of = np.abs(s_pred[:, None] - obs_s_w) <= VEH_LENGTH + 0.15  # (S, nv, N+1)
    br = np.arange(BR)
    li = np.clip(br - 1, 0, num_veh - 1)
    ri = np.clip(br, 0, num_veh - 1)
    left_gate = gate_of[:, li] & (br >= 1)[None, :, None]
    right_gate = gate_of[:, ri] & (br < num_veh)[None, :, None]
    A_lti, B_lti = load_lti(data_dir, device=dev, dtype=dtype)

    b = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.bool, device=dev)
    return (
        t(x0), A_lti, B_lti, t(TRACK_WIDTH), t(VEH_WIDTH), t(VEH_LENGTH), bez,
        t(obs_ey[:, li]), b(left_gate), t(obs_ey[:, ri]), b(right_gate),
        t(obs_s_w[:, li]), t(obs_s_w[:, ri]),
        b(np.broadcast_to(br >= 1, (S, BR))), b(np.broadcast_to(br < num_veh, (S, BR))),
        b(np.ones((S, BR), bool)),
        torch.full((S,), -1, dtype=torch.int32, device=dev),
    )
