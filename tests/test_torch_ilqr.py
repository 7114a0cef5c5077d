"""The port's iLQR path against the JAX package, at float64 on the CPU: the
Riccati recursions, the cost terms, the controller per step at states
injected from the ``ilqr_ellipse`` golden, the cold closed loop against the
golden and the recorded Levenberg counts, and the warm closed loop against
a JAX run.

The same numpy inputs go through both packages.  The reference's own cold
loop stays within 5e-14 of its golden when the target vx moves by up to 8
ulps (``data/goldens/controller_spread.json``, written by ``python -m
tools.controller_spread``), so the port is held far inside the golden's
1e-3, and its Levenberg counts to the recorded ones step for step.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.models import controllers as jctrl
from car_racing_tpu.ops import dynamics as jdyn
from car_racing_tpu.ops import riccati as jric
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.racing import fused as jfused
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, riccati, track
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import convert, params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
N = 50
OBS_S, OBS_EY, HALF = [0.2, 5.0], [0.0, 0.1], [0.2, 0.1]
XT = [0.8, 0, 0, 0, 0, 0.0]


def cpu(a):
    return torch.as_tensor(np.array(a, np.float64))


def golden():
    return np.loadtxt("data/goldens/ilqr_ellipse.csv", delimiter=",")


def record():
    with open("data/goldens/controller_spread.json") as f:
        return json.load(f)["ilqr_ellipse"]


def test_ilqr_param_carries_across():
    jp = jparams.ILQRParam.default(vt=0.8)
    tp = params.ILQRParam.default(vt=0.8, **KW)
    moved = convert.to_port(params.ILQRParam, convert.numpy_fields(jp), **KW)
    for name, v in convert.numpy_fields(jp).items():
        for p in (tp, moved):
            got = getattr(p, name)
            if isinstance(v, int):
                assert got == v and isinstance(got, int), name
            else:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=name)


def test_polyval_polyder_match_jax():
    """Exact: Horner from zero in ``jnp.polyval``'s order."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(11)
    for deg in (0, 1, 3):
        c = rng.standard_normal((4, deg + 1))
        want = np.stack([np.asarray(jnp.polyval(jnp.asarray(ci), jnp.asarray(x))) for ci in c])
        np.testing.assert_array_equal(fused.polyval(cpu(c), cpu(x)).numpy(), want)
        np.testing.assert_array_equal(fused.polyval(cpu(c[0]), cpu(x)).numpy(), want[0])
        if deg:
            want = np.stack([np.asarray(jnp.polyder(jnp.asarray(ci))) for ci in c])
            np.testing.assert_array_equal(fused.polyder(cpu(c)).numpy(), want)


def test_sym2x2_clamped_inv_matches_jax():
    """Within 1e-14 of the entries' scale, on matrices with positive,
    negative and zero eigenvalues, a zero off-diagonal and equal diagonals;
    ``eigh`` above 2x2 within 1e-12."""
    rng = np.random.default_rng(1)
    Ms = [rng.standard_normal((2, 2)) for _ in range(30)]
    Ms += [np.diag([2.0, -1.0]), np.diag([0.0, 0.0]), np.array([[1.0, 0.5], [0.5, 1.0]]),
           np.array([[3.0, 0.0], [0.0, 3.0]]), np.array([[1e-3, 2.0], [2.0, 1e-3]])]
    for M in Ms:
        M = M + M.T
        for reg in (1e-6, 0.1, 1000.0):
            want = np.asarray(jric.sym2x2_clamped_inv(jnp.asarray(M), reg))
            got = riccati.sym2x2_clamped_inv(cpu(M), reg).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
    got = riccati.sym2x2_clamped_inv(cpu(np.stack([M + M.T for M in Ms])), 0.1).numpy()
    for M, g in zip(Ms, got):  # a batch: the same within the tolerance
        want = np.asarray(jric.sym2x2_clamped_inv(jnp.asarray(M + M.T), 0.1))
        np.testing.assert_allclose(g, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())
    M = rng.standard_normal((3, 3))
    M = M + M.T
    want = np.asarray(jric._clamped_inv(jnp.asarray(M), 0.1))
    np.testing.assert_allclose(riccati._clamped_inv(cpu(M), 0.1).numpy(), want, rtol=1e-12,
                               atol=1e-12)


def _lqr_problem(rng, n_st=8, n=6, m=2):
    f_x = 0.9 * np.eye(n) + 0.05 * rng.standard_normal((n_st, n, n))
    f_u = 0.3 * rng.standard_normal((n_st, n, m))
    l_x, l_u = rng.standard_normal((n_st, n)), rng.standard_normal((n_st, m))
    Lx = rng.standard_normal((n_st, n, n))
    l_xx = Lx @ np.transpose(Lx, (0, 2, 1))
    Lu = rng.standard_normal((n_st, m, m))
    l_uu = Lu @ np.transpose(Lu, (0, 2, 1)) - 1.5 * np.eye(m)  # often indefinite: the clamp acts
    Vx, Vxx = rng.standard_normal(n), np.eye(n)
    return f_x, f_u, l_x, l_u, l_xx, l_uu, Vx, Vxx


@pytest.mark.parametrize("reg", [1.0, 10.0])
def test_tvlqr_backward_and_rollout_match_jax(reg):
    """Gains, states and inputs within 1e-12 of the JAX scans."""
    rng = np.random.default_rng(2)
    prob = _lqr_problem(rng)
    ks, Ks = jric.tvlqr_backward(*map(jnp.asarray, prob), jnp.asarray(reg))
    tk, tK = riccati.tvlqr_backward(*map(cpu, prob), torch.tensor(reg, dtype=F64))
    np.testing.assert_allclose(tk.numpy(), np.asarray(ks), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tK.numpy(), np.asarray(Ks), rtol=1e-12, atol=1e-12)
    x0, u_ref, x_ref = rng.standard_normal(6), rng.standard_normal((8, 2)), rng.standard_normal((8, 6))
    for A, B in ((prob[0][0], prob[1][0]), (prob[0], prob[1])):  # LTI and per stage
        xs, us = jric.tvlqr_rollout(*map(jnp.asarray, (A, B, x0, u_ref, x_ref)), ks, Ks)
        txs, tus = riccati.tvlqr_rollout(*map(cpu, (A, B, x0, u_ref, x_ref)), tk, tK)
        np.testing.assert_allclose(txs.numpy(), np.asarray(xs), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tus.numpy(), np.asarray(us), rtol=1e-12, atol=1e-12)


def _obs_traj(t):
    ts = t + 0.1 * np.arange(N + 1)
    s, ey = np.polyval(OBS_S, ts), np.polyval(OBS_EY, ts)
    zeros = np.zeros_like(s)
    return np.stack([np.full_like(s, OBS_S[0]), zeros, zeros, zeros, s, ey], axis=1)


def test_ilqr_cost_terms_match_jax():
    """Within 1e-14 of each term's scale, near and far from the obstacle."""
    rng = np.random.default_rng(3)
    jp = jparams.ILQRParam.default(vt=0.8)
    tp = params.ILQRParam.default(vt=0.8, **KW)
    for t in (0.0, 2.5, 4.0):
        xvar = golden()[int(t * 10)] + 0.05 * rng.standard_normal((N + 1, 6))
        uvar = 0.1 * rng.standard_normal((N, 2))
        obs = _obs_traj(t)
        want = jctrl._ilqr_cost_terms(jp, jnp.asarray(xvar), jnp.asarray(uvar), jnp.asarray(XT),
                                      jnp.asarray(obs), jnp.asarray(HALF), jnp.asarray(HALF))
        got = controllers._ilqr_cost_terms(tp, cpu(xvar), cpu(uvar), cpu(XT), cpu(obs),
                                           cpu(HALF), cpu(HALF))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), np.broadcast_to(w, g.shape), rtol=1e-14,
                                       atol=1e-14 * np.abs(w).max())


@pytest.mark.parametrize("row", [0, 10, 24, 27, 50, 99])
@pytest.mark.parametrize("warm", [False, True])
def test_ilqr_step_matches_jax_at_injected_states(row, warm):
    """The controller at golden states (rows 24-30 end on a run of rejected
    steps, where the Levenberg rounding decides the count): the same
    iteration count, u_0 and U within 1e-10.  Warm solves start from the
    JAX sequence of the row before, shifted one stage."""
    jp = jparams.ILQRParam.default(vt=0.8)
    tp = params.ILQRParam.default(vt=0.8, **KW)
    g = golden()
    args = lambda x, t: (jnp.asarray(x), jnp.asarray(XT), jp, jnp.asarray(_obs_traj(t)),
                         jnp.asarray(HALF), jnp.asarray(HALF))
    u_init = None
    if warm:
        prev = max(row - 1, 0)
        _, U_prev, _ = jctrl.ilqr(*args(g[prev], 0.1 * prev), return_seq=True)
        U_prev = np.asarray(U_prev)
        u_init = np.concatenate([U_prev[1:], U_prev[-1:]])
    u0, U, it = jctrl.ilqr(*args(g[row], 0.1 * row),
                           u_init=None if u_init is None else jnp.asarray(u_init),
                           return_seq=True)
    tu0, tU, tit = controllers.ilqr(cpu(g[row]), cpu(XT), tp, cpu(_obs_traj(0.1 * row)),
                                    cpu(HALF), cpu(HALF),
                                    u_init=None if u_init is None else cpu(u_init),
                                    return_seq=True)
    assert tit == int(it)
    np.testing.assert_allclose(tU.numpy(), np.asarray(U), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tu0.numpy(), np.asarray(u0), rtol=0, atol=1e-10)


def _setup():
    return (track.load_track("ellipse", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
            params.ILQRParam.default(vt=0.8, **KW), cpu(XT))


def test_rollout_ilqr_cold_matches_golden_and_levenberg_counts():
    """The golden at 1e-3 (the port lands near 1e-14), each step's
    Levenberg iterations equal to the JAX run's recorded counts."""
    zeros = torch.zeros(6, **KW)
    xc, us, its = fused.rollout_ilqr(*_setup(), zeros, zeros, cpu(OBS_S), cpu(OBS_EY),
                                     cpu(HALF), cpu(HALF), n_steps=100, warm_start=False)
    g = golden()
    assert xc.shape == g.shape and us.shape == (100, 2)
    np.testing.assert_allclose(xc.numpy(), g, rtol=0, atol=1e-3)
    assert its.dtype == torch.int32
    assert its.tolist() == record()["levenberg_iterations"]
    assert float(np.abs(xc.numpy() - g).max()) < 1e-12


def test_rollout_ilqr_warm_matches_jax():
    """The shift-warm loop, 30 steps, within 1e-8 of the JAX rollout, with
    the same Levenberg counts."""
    zeros = np.zeros(6)
    want = jfused.rollout_ilqr(
        jtrack.load_track("ellipse", width=1.0), jdyn.BicycleParams.default(),
        jparams.ILQRParam.default(vt=0.8), jnp.asarray(XT), jnp.asarray(zeros),
        jnp.asarray(zeros), jnp.asarray(OBS_S), jnp.asarray(OBS_EY), jnp.asarray(HALF),
        jnp.asarray(HALF), n_steps=30, warm_start=True)
    got = fused.rollout_ilqr(*_setup(), cpu(zeros), cpu(zeros), cpu(OBS_S), cpu(OBS_EY),
                             cpu(HALF), cpu(HALF), n_steps=30, warm_start=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-8)
    assert got[2].tolist() == np.asarray(want[2]).tolist()
