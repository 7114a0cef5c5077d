"""Condensed optimal-control-problem builders (car_racing_tpu/ops/ocp.py:29-177).

Receding-horizon problems over LTI dynamics ``x_{k+1} = A x_k + B u_k`` are
condensed onto the input sequence ``U = [u_0; ...; u_{N-1}]``:
``X = [x_1; ...; x_N] = phi(x_0) + G U``.  ``G`` does not depend on ``x_0``,
so it is built once and shared by a batch of initial states; ``phi`` and
the constraint offsets carry the batch dimension.  Time-varying dynamics
may also differ per lane (a learning fleet): then ``G`` carries the lane
dimensions too.
"""

from __future__ import annotations

import torch

from ..utils.constants import X_DIM


def prediction_matrices(A_seq, B_seq, C_seq, x0):
    """Free response and input map of TV linear dynamics.

    A_seq (N, n, n), B_seq (N, n, m), C_seq (N, n), x0 (..., n).
    Returns phi (..., N, n) and G (N, n, N, m), with
    ``x_k = phi[k-1] + sum_j G[k-1, :, j, :] @ u_j``.  Sequences with
    leading lane dimensions, A_seq (*lanes, N, n, n) and so on, give each
    lane its own G (*lanes, N, n, N, m); ``lanes`` lead x0's batch.
    """
    *lanes, N, n, m = B_seq.shape
    phis = []
    x = x0
    for k in range(N):
        if lanes:
            x = (x.unsqueeze(-2) @ A_seq[..., k, :, :].mT).squeeze(-2) + C_seq[..., k, :]
        else:
            x = x @ A_seq[k].mT + C_seq[k]
        phis.append(x)
    G = torch.zeros((*lanes, N, n, N, m), dtype=B_seq.dtype, device=B_seq.device)
    for j in range(N):
        S = B_seq[..., j, :, :]
        G[..., j, :, j, :] = S
        for k in range(j + 1, N):
            S = A_seq[..., k, :, :] @ S
            G[..., k, :, j, :] = S
    return torch.stack(phis, dim=-2), G


def condense(A_seq, B_seq, C_seq, x0):
    """Flattened TV prediction matrices: ``X (..., N*n) = phi + U @ G.mT``.

    Returns (phi (..., N*n), G (N*n, N*m)), or G (*lanes, N*n, N*m) for
    per-lane sequences."""
    phi, G = prediction_matrices(A_seq, B_seq, C_seq, x0)
    *lanes, N, n, _, m = G.shape
    return phi.reshape(*phi.shape[:-2], N * n), G.reshape(*lanes, N * n, N * m)


def condense_lti(A, B, N: int, x0):
    """Closed form of the LTI condensation via matrix powers.

    Returns (phi (..., N*n), G (N*n, N*m)) with block ``G[k, j] = A^(k-j) B``
    for ``k >= j``.
    """
    n, m = B.shape
    P = torch.eye(n, dtype=A.dtype, device=A.device)
    Ps = []
    for _ in range(N + 1):
        Ps.append(P)
        P = A @ P
    Ps = torch.stack(Ps)  # Ps[i] = A^i
    phi = torch.einsum("kij,...j->...ki", Ps[1:], x0)  # x_k = A^k x0, k = 1..N
    k_idx = torch.arange(N, device=A.device)[:, None]
    j_idx = torch.arange(N, device=A.device)[None, :]
    pow_idx = k_idx - j_idx
    blocks = torch.einsum("kjab,bc->kjac", Ps[pow_idx.clamp(0, N)], B)
    blocks = torch.where((pow_idx >= 0)[:, :, None, None], blocks, 0.0)
    G = blocks.permute(0, 2, 1, 3).reshape(N * n, N * m)
    return phi.reshape(*phi.shape[:-2], N * n), G


def lti_sequences(A, B, N, dtype=None):
    """Tile an LTI (A, B) into TV sequences with zero drift."""
    dtype = dtype or A.dtype
    A_seq = A.expand((N,) + A.shape).to(dtype)
    B_seq = B.expand((N,) + B.shape).to(dtype)
    C_seq = torch.zeros((N, A.shape[0]), dtype=dtype, device=A.device)
    return A_seq, B_seq, C_seq


def quadratic_tracking_cost(phi, G, Q, R, x_targets, N):
    """H, g of ``sum_k (x_k - xt_k)' Q (x_k - xt_k) + u_k' R u_k`` over U.

    phi (..., N*n), G (N*n, N*m), x_targets (..., N, n).  H (N*m, N*m) is
    shared by the batch; g is (..., N*m).  A per-lane G (..., N*n, N*m)
    gives a per-lane H (..., N*m, N*m).
    """
    n = Q.shape[0]
    eye = torch.eye(N, dtype=Q.dtype, device=Q.device)
    Qbar = torch.kron(eye, Q)
    Rbar = torch.kron(eye, R)
    dx = phi - x_targets.reshape(*x_targets.shape[:-2], N * n)
    H = 2.0 * (G.mT @ Qbar @ G + Rbar)
    g = 2.0 * _vecmat(dx @ Qbar.mT, G)
    return H, g


def input_rate_cost(dR, N, u_prev):
    """H, g of ``sum_k (u_k - u_{k-1})' dR (u_k - u_{k-1})`` with
    ``u_{-1} = u_prev (..., m)`` (the LMPC input-rate cost).

    H (N*m, N*m) is shared by the batch; g is (..., N*m)."""
    m = dR.shape[0]
    opts = dict(dtype=dR.dtype, device=dR.device)
    D = torch.eye(N * m, **opts) - torch.diag(torch.ones(N * m - m, **opts), -m)
    dRbar = torch.kron(torch.eye(N, **opts), dR)
    H = 2.0 * D.mT @ dRbar @ D
    g = u_prev.new_zeros(*u_prev.shape[:-1], N * m)
    g[..., :m] += -2.0 * u_prev @ dR.mT
    return H, g


def input_box_rows(N, m, u_min, u_max, n_z):
    """Rows ``u_min <= u_k <= u_max`` as ``C z >= d`` over z whose first
    N*m entries are U."""
    I = torch.zeros((N * m, n_z), dtype=u_min.dtype, device=u_min.device)
    I[:, : N * m] = torch.eye(N * m, dtype=u_min.dtype, device=u_min.device)
    C = torch.cat([I, -I], dim=0)
    d = torch.cat([u_min.repeat(N), -u_max.repeat(N)])
    return C, d


def state_bound_rows(G, phi, state_idx, lower, upper, n_z):
    """Rows ``lower <= x_k[state_idx] <= upper`` for k = 1..N, as ``C z >= d``.

    G (N*n, N*m) shared, phi (..., N*n); returns C (2N, n_z), d (..., 2N).
    """
    Nn, Nm = G.shape
    N = Nn // X_DIM
    sel = torch.arange(N, device=G.device) * X_DIM + state_idx
    Gs = G[sel]
    ps = phi[..., sel]
    Z = torch.zeros((N, n_z), dtype=G.dtype, device=G.device)
    Z[:, :Nm] = Gs
    C = torch.cat([Z, -Z], dim=0)
    d = torch.cat([lower - ps, ps - upper], dim=-1)
    return C, d


def stack_rows(*pairs):
    """Concatenate (C, d) row blocks; the d blocks broadcast over a batch."""
    Cs, ds = zip(*pairs)
    batch = torch.broadcast_shapes(*(d.shape[:-1] for d in ds))
    ds = [d.expand(*batch, d.shape[-1]) for d in ds]
    return torch.cat(Cs, dim=-2), torch.cat(ds, dim=-1)


def unpack_states(phi, G, U, x0):
    """State trajectory (..., N+1, n) from flat inputs U (..., N*m); G
    shared (N*n, N*m) or per lane (..., N*n, N*m)."""
    N = phi.shape[-1] // X_DIM
    X = (phi + _vecmat(U, G.mT)).reshape(*phi.shape[:-1], N, X_DIM)
    return torch.cat([x0.unsqueeze(-2), X], dim=-2)


def _vecmat(v, M):
    """``v (..., a) @ M``: M (a, b) shared by the batch, or one per lane
    (..., a, b)."""
    if M.dim() == 2:
        return v @ M
    return (v.unsqueeze(-2) @ M).squeeze(-2)
