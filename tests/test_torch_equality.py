"""Equality-constrained QPs in the PyTorch port against the JAX package, at
float64 on the CPU: K3's plain version against the Pallas kernel in
interpret mode, ``ipm.solve_qp``'s bordered-KKT LU and ``ipm.solve_qp_batch``'s
block elimination (K3) against their JAX counterparts, on random convex QPs
and on LMPC QPs built from the l_shape seed lap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.ops import ipm as jipm
from car_racing_tpu.ops import pallas_kernels
from car_racing_tpu_torch.kernels import cholesky_multi as k3
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import ipm, lmpc_learning, track
from car_racing_tpu_torch.utils import fixtures, params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
FIELDS = ("H", "g", "C", "d", "E", "e")


def cpu(a):
    return torch.as_tensor(np.array(a), device="cpu")


def _spd(rng, B, n, r):
    L = rng.standard_normal((B, n, n))
    return L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n), rng.standard_normal((B, n, r))


@pytest.mark.parametrize("n,r,B", [(12, 4, 16), (24, 8, 32)])
def test_k3_plain_matches_pallas_interpret(n, r, B):
    A, Bm = _spd(np.random.default_rng(n), B, n, r)
    want = np.asarray(pallas_kernels.cholesky_solve_multi_batched(
        jnp.asarray(A), jnp.asarray(Bm), interpret=True))
    k3.launches = 0
    got = k3.solve_multi(cpu(A), cpu(Bm))
    assert k3.launches == 0  # CPU tensors take the plain version
    assert torch.equal(got, k3.plain(cpu(A), cpu(Bm)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)


def test_k3_plain_nan_on_indefinite_like_jnp():
    A, Bm = _spd(np.random.default_rng(1), 3, 6, 2)
    A[1] = -A[1]
    got = k3.plain(cpu(A), cpu(Bm)).numpy()
    assert np.isnan(got[1]).all() and np.isfinite(got[[0, 2]]).all()


def _random_eq_qps(seed, Bt=6, n=10, m=8, p=3):
    """Convex QPs with a strictly feasible start for the inequalities and
    ``p`` consistent equality rows."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((Bt, n, n))
    H = M @ np.transpose(M, (0, 2, 1)) / n + 0.1 * np.eye(n)
    g = rng.standard_normal((Bt, n))
    C = rng.standard_normal((Bt, m, n))
    z0 = 0.1 * rng.standard_normal((Bt, n))
    d = np.einsum("bmn,bn->bm", C, z0) - rng.uniform(0.1, 1.0, (Bt, m))
    E = rng.standard_normal((Bt, p, n))
    e = np.einsum("bpn,bn->bp", E, z0) + 0.1 * rng.standard_normal((Bt, p))
    return (H, g, C, d, E, e), z0


def _jax_each(arrays, z0, iters):
    return [jipm.solve_qp(jipm.QP(*(jnp.asarray(a[b]) for a in arrays)), jnp.asarray(z0[b]),
                          iters=iters) for b in range(len(z0))]


def _stacked(sols):
    """(converged, z, iterations) of a list of single JAX solutions."""
    return (np.array([bool(s.converged) for s in sols]), np.stack([np.asarray(s.z) for s in sols]),
            np.array([int(s.iterations) for s in sols]))


def _objective(arrays, z):
    H, g = arrays[0], arrays[1]
    return 0.5 * np.einsum("bi,bij,bj->b", z, H, z) + np.einsum("bi,bi->b", g, z)


def _assert_like_jax(sol, arrays, conv, z_want, iters_want, iters):
    """converged flags equal; z at 1e-8 where converged.  Where the solve
    stopped at the iteration cap unconverged, the iterate is not a solution
    and its last digits are not reproducible: on the LMPC QPs the two
    implementations' KKT residuals there differ by up to an order of
    magnitude while their objectives agree to a few parts in 1e4, so the
    objective is held at rtol 1e-3 and the residual only by the flag."""
    np.testing.assert_array_equal(sol.converged.numpy(), conv)
    z = sol.z.numpy()
    np.testing.assert_allclose(z[conv], z_want[conv], rtol=0, atol=1e-8)
    capped = ~conv
    np.testing.assert_array_equal(sol.iterations.numpy()[capped], iters)
    np.testing.assert_array_equal(np.asarray(iters_want)[capped], iters)
    np.testing.assert_allclose(_objective(arrays, z)[capped],
                               _objective(arrays, z_want)[capped], rtol=1e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_qp_equality_rows_match_jax(seed):
    arrays, z0 = _random_eq_qps(seed)
    want = _jax_each(arrays, z0, 40)
    sol = ipm.solve_qp(ipm.QP(*map(cpu, arrays)), cpu(z0), iters=40)
    assert sol.converged.all()
    _assert_like_jax(sol, arrays, *_stacked(want), 40)
    np.testing.assert_array_equal(sol.iterations.numpy(), [int(s.iterations) for s in want])
    np.testing.assert_allclose(sol.nu.numpy(), np.stack([np.asarray(s.nu) for s in want]),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("seed", [3, 4])
def test_solve_qp_batch_equality_rows_match_jax(seed):
    arrays, z0 = _random_eq_qps(seed, Bt=8)
    want = jipm.solve_qp_batch(jipm.QP(*map(jnp.asarray, arrays)), jnp.asarray(z0), iters=40)
    sol = ipm.solve_qp_batch(ipm.QP(*map(cpu, arrays)), cpu(z0), iters=40)
    assert sol.converged.all()
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(want.iterations))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(want.z), rtol=0, atol=1e-8)
    plain = ipm.solve_qp_batch(ipm.QP(*map(cpu, arrays)), cpu(z0), iters=40, backend="plain")
    assert torch.equal(plain.z, sol.z)


def lmpc_seed_qps(B, seed=0, layout="l_shape"):
    """``B`` LMPC QPs at the seed lap's first step, from states
    ``xcurv0 + 0.05 N(0, 1)`` (numpy ``seed``), built by the port's
    ``controllers.lmpc_qp``.  Returns (numpy QP fields, z0)."""
    sd = fixtures.load_lmpc_seed(layout, **KW)
    tr = track.load_track(layout, width=1.0, **KW)
    lp = params.LMPCParam.default(**KW)
    N, K_per = lp.num_horizon, lp.num_ss_points // lp.num_ss_iter
    L = tr.lap_length
    xs = sd["xcurv0"] + 0.05 * cpu(np.random.default_rng(seed).standard_normal((B, 6)))
    xs[:, 4] = torch.remainder(xs[:, 4], L)
    lin = sd["lin_points0"][:N]
    A, Bm, C = lmpc_learning.estimate_abc_horizon(
        lin, sd["lin_input0"][:N], torch.stack([sd["ss2"], sd["ss1"]]),
        torch.stack([sd["u2"], sd["u1"]]), torch.stack([sd["valid2"], sd["valid1"]]),
        track.curvature(tr, torch.remainder(lin[:, 4], L)), 0.1)
    p1, q1 = lmpc_learning.select_points(sd["ss1"], sd["q1"], xs, K_per)
    p2, q2 = lmpc_learning.select_points(sd["ss2"], sd["q2"], xs, K_per)
    qp, z0, _, _ = controllers.lmpc_qp(
        xs, lp, A, Bm, C, torch.cat([p1, p2], dim=-1), torch.cat([q1, q2], dim=-1),
        xs.new_zeros(B, 2), params.SystemParam.default(**KW), tr.width)
    return [getattr(qp, f).contiguous().numpy() for f in FIELDS], z0.numpy()


def test_lmpc_qp_shape():
    arrays, z0 = lmpc_seed_qps(2)
    H, g, C, d, E, e = arrays
    assert H.shape == (2, 68, 68) and C.shape == (2, 125, 68) and E.shape == (2, 7, 68)
    assert g.shape == z0.shape == (2, 68) and d.shape == (2, 125) and e.shape == (2, 7)


def test_solve_qp_lmpc_qps_match_jax():
    arrays, z0 = lmpc_seed_qps(8, seed=1)
    want = _stacked(_jax_each(arrays, z0, 40))
    assert want[0].any()
    sol = ipm.solve_qp(ipm.QP(*map(cpu, arrays)), cpu(z0), iters=40)
    _assert_like_jax(sol, arrays, *want, 40)


def test_solve_qp_batch_lmpc_qps_match_jax():
    arrays, z0 = lmpc_seed_qps(8)
    want = jipm.solve_qp_batch(jipm.QP(*map(jnp.asarray, arrays)), jnp.asarray(z0), iters=40)
    assert np.asarray(want.converged).any()
    sol = ipm.solve_qp_batch(ipm.QP(*map(cpu, arrays)), cpu(z0), iters=40)
    _assert_like_jax(sol, arrays, np.asarray(want.converged), np.asarray(want.z),
                     np.asarray(want.iterations), 40)


def test_poisoned_problem_freezes_and_neighbour_converges():
    """tests/test_ipm.py::test_nonfinite_newton_step_guard's pair in f32:
    equality rows at 1e30 overflow the Schur system of one problem; it
    freezes at its last finite iterate while its neighbour converges."""
    f32 = np.float32
    n, m, p = 4, 2, 2
    H = np.eye(n, dtype=f32)
    g = np.array([1.0, -1.0, 0.5, 0.0], f32)
    C = np.eye(n, dtype=f32)[:m]
    d = np.full(m, -10.0, f32)
    E_ok = np.zeros((p, n), f32)
    E_ok[:, :p] = np.eye(p)
    E_bad = np.full((p, n), 1e30, f32)
    z0 = np.array([0.1, -0.1, 0.2, 0.3], f32)
    arrays = [np.stack([H, H]), np.stack([g, g]), np.stack([C, C]), np.stack([d, d]),
              np.stack([E_ok, E_bad]), np.zeros((2, p), f32)]
    z0s = np.stack([z0, z0])
    want = jipm.solve_qp_batch(jipm.QP(*map(jnp.asarray, arrays)), jnp.asarray(z0s), iters=10)
    sol = ipm.solve_qp_batch(ipm.QP(*map(cpu, arrays)), cpu(z0s), iters=10)
    assert sol.z.dtype == torch.float32
    for f in ("z", "lam", "s", "kkt_res"):
        assert getattr(sol, f).isfinite().all(), f
    assert bool(sol.converged[0]) and not bool(sol.converged[1])
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(want.z), rtol=0, atol=1e-5)
