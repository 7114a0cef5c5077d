"""The port's Riccati KKT path and LQR against the JAX package, at float64
on the CPU: ``dare_iterate`` and ``lqr``, ``_lqt_combine``, the parallel
TV-LQR forms and the batched sequential ones, ``ipm.solve_ocp_qp`` (a batch
of problems against JAX per problem) and its non-finite guard,
``mpc_lti(kkt=...)``, and ``ipm._highp``: full float32 matrix products
inside each solver and rollout that the JAX package decorates, the
caller's setting back afterwards.

The same numpy inputs go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.models import controllers as jctrl
from car_racing_tpu.ops import ipm as jipm
from car_racing_tpu.ops import riccati as jric
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, ipm, lmpc_learning, riccati, track
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import convert, fixtures, params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
XT = [0.8, 0, 0, 0, 0, 0.0]
U_MIN, U_MAX = [-0.5, -1.0], [0.5, 1.0]


def cpu(a):
    return torch.as_tensor(np.array(a, np.float64))


def port(cls, jax_obj):
    return convert.to_port(cls, convert.numpy_fields(jax_obj), **KW)


def test_dare_iterate_and_lqr_match_jax():
    jp = jparams.LQRParam.default(vt=0.8)
    tp = params.LQRParam.default(vt=0.8, **KW)
    moved = port(params.LQRParam, jp)
    for name, v in convert.numpy_fields(jp).items():
        for p in (tp, moved):
            got = getattr(p, name)
            if isinstance(v, int):
                assert got == v and isinstance(got, int), name
            else:
                np.testing.assert_array_equal(got.numpy(), v, err_msg=name)
    P, K = jric.dare_iterate(jp.A, jp.B, jp.Q, jp.R, jp.max_iter)
    tP, tK = riccati.dare_iterate(tp.A, tp.B, tp.Q, tp.R, tp.max_iter)
    np.testing.assert_allclose(tP.numpy(), np.asarray(P), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tK.numpy(), np.asarray(K), rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(4)
    xs = np.array([0.5, 0, 0, 0, 1.0, 0.1]) + 0.2 * rng.standard_normal((5, 6))
    got = controllers.lqr(cpu(xs), cpu(XT), tp).numpy()
    for x, g in zip(xs, got):
        np.testing.assert_allclose(g, np.asarray(jctrl.lqr(jnp.asarray(x), jnp.asarray(XT), jp)),
                                   rtol=1e-12, atol=1e-12)


def _random_elements(rng, B, n=6):
    def spd():
        X = rng.normal(size=(B, n, n))
        return np.einsum("bij,bkj->bik", X, X) / n + 0.5 * np.eye(n)

    return (np.eye(n) + 0.1 * rng.normal(size=(B, n, n)), rng.normal(size=(B, n)), spd(),
            rng.normal(size=(B, n)), spd())


@pytest.mark.parametrize("B", [3, 6])  # B == n: the batched matrix-vector trap
def test_lqt_combine_matches_jax(B):
    rng = np.random.default_rng(5 + B)
    e1, e2 = _random_elements(rng, B), _random_elements(rng, B)
    want = jric._lqt_combine(tuple(map(jnp.asarray, e1)), tuple(map(jnp.asarray, e2)))
    got = riccati._lqt_combine(tuple(map(cpu, e1)), tuple(map(cpu, e2)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)


def _tvlqr_problem(rng, N, n=6, m=2, lead=()):
    def spd(sz):
        X = rng.normal(size=(*lead, N, sz, sz))
        return np.einsum("...ij,...kj->...ik", X, X) + 2 * np.eye(sz)

    fx = np.eye(n) + 0.05 * rng.normal(size=(*lead, N, n, n))
    fu = 0.3 * rng.normal(size=(*lead, N, n, m))
    lx, lu = rng.normal(size=(*lead, N, n)), rng.normal(size=(*lead, N, m))
    lxx, luu = spd(n), spd(m)
    VxT = rng.normal(size=(*lead, n))
    Y = rng.normal(size=(*lead, n, n))
    VxxT = np.einsum("...ij,...kj->...ik", Y, Y) + 2 * np.eye(n)
    return fx, fu, lx, lu, lxx, luu, VxT, VxxT


@pytest.mark.parametrize("N", [1, 2, 7, 50])
def test_parallel_riccati_matches_jax_and_sequential(N):
    """Against JAX's associative-scan forms at 1e-10, and against the port's
    sequential recursions at tests/test_ipm.py:246-283's 1e-8 / 1e-10."""
    rng = np.random.default_rng(3 + N)
    prob = _tvlqr_problem(rng, N)
    reg = 1e-9
    kj, Kj = jric.tvlqr_backward_parallel(*map(jnp.asarray, prob), jnp.asarray(reg))
    kp, Kp = riccati.tvlqr_backward_parallel(*map(cpu, prob), torch.tensor(reg, dtype=F64))
    ks, Ks = riccati.tvlqr_backward(*map(cpu, prob), torch.tensor(reg, dtype=F64))
    np.testing.assert_allclose(kp.numpy(), np.asarray(kj), atol=1e-10)
    np.testing.assert_allclose(Kp.numpy(), np.asarray(Kj), atol=1e-10)
    np.testing.assert_allclose(kp.numpy(), ks.numpy(), atol=1e-8)
    np.testing.assert_allclose(Kp.numpy(), Ks.numpy(), atol=1e-8)

    n, m = 6, 2
    A, B = np.eye(n) + 0.05 * rng.normal(size=(n, n)), 0.3 * rng.normal(size=(n, m))
    x0, u_ref, x_ref = rng.normal(size=n), rng.normal(size=(N, m)), rng.normal(size=(N, n))
    xj, uj = jric.tvlqr_rollout_parallel(*map(jnp.asarray, (A, B, x0, u_ref, x_ref)), kj, Kj)
    xp, up = riccati.tvlqr_rollout_parallel(*map(cpu, (A, B, x0, u_ref, x_ref)), kp, Kp)
    xs, us = riccati.tvlqr_rollout(*map(cpu, (A, B, x0, u_ref, x_ref)), kp, Kp)
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-10)
    np.testing.assert_allclose(up.numpy(), np.asarray(uj), atol=1e-10)
    np.testing.assert_allclose(xp.numpy(), xs.numpy(), atol=1e-10)
    np.testing.assert_allclose(up.numpy(), us.numpy(), atol=1e-10)


@pytest.mark.parametrize("parallel", [False, True])
def test_batched_tvlqr_equals_per_problem_calls(parallel):
    """A batch of problems gives, row for row, bit for bit what each problem
    gives as a batch of one; an unbatched call (matrix-vector products in
    place of batched products) agrees to rounding."""
    backward = riccati.tvlqr_backward_parallel if parallel else riccati.tvlqr_backward
    rollout = riccati.tvlqr_rollout_parallel if parallel else riccati.tvlqr_rollout
    rng = np.random.default_rng(11)
    Bt, N, n, m = 4, 9, 6, 2
    prob = tuple(map(cpu, _tvlqr_problem(rng, N, lead=(Bt,))))
    A, B = cpu(np.eye(n) + 0.05 * rng.normal(size=(n, n))), cpu(0.3 * rng.normal(size=(n, m)))
    x0, u_ref, x_ref = (cpu(rng.normal(size=s)) for s in ((Bt, n), (Bt, N, m), (Bt, N, n)))
    reg = torch.tensor(1e-6, dtype=F64)
    k, K = backward(*prob, reg)
    xs, us = rollout(A, B, x0, u_ref, x_ref, k, K)
    for b in range(Bt):
        one = lambda a: a[b:b + 1]
        k1, K1 = backward(*map(one, prob), reg)
        x1, u1 = rollout(A, B, one(x0), one(u_ref), one(x_ref), k1, K1)
        for got, want in ((k[b], k1[0]), (K[b], K1[0]), (xs[b], x1[0]), (us[b], u1[0])):
            assert torch.equal(got, want)
        k0, K0 = backward(*(a[b] for a in prob), reg)
        x00, u00 = rollout(A, B, x0[b], u_ref[b], x_ref[b], k0, K0)
        for got, want in ((k[b], k0), (K[b], K0), (xs[b], x00), (us[b], u00)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-13)


def _ocp_args(x, U0):
    jp = jparams.MPCParam.default(vt=0.8)
    return (jp.A, jp.B, jp.Q, jp.R, x, np.array(XT), np.array(U_MIN), np.array(U_MAX), 0.0, 10.0,
            0.8, U0)


def _states(seed, Bt):
    return (np.array([0.5, 0, 0, 0, 1.0, 0.1])
            + 0.1 * np.random.default_rng(seed).standard_normal((Bt, 6)))


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "stage_parallel"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("N", [10, 50])
def test_solve_ocp_qp_matches_jax_per_problem(N, warm, parallel):
    """A batch of 4 (tests/test_ipm.py:286-319's states) against the JAX
    solve of each problem alone: the same iterations and flags, U and X
    within 1e-10."""
    x = _states(1, 4)
    rng = np.random.default_rng(N + warm)
    U0 = 0.1 * rng.standard_normal((4, N, 2)) if warm else np.zeros((4, N, 2))
    args = _ocp_args(x, U0)
    U, X, sol = ipm.solve_ocp_qp(*map(cpu, args), num_horizon=N, iters=40,
                                 stage_parallel=parallel)
    assert sol.z.shape == (4, N * 2) and torch.equal(sol.z, U.reshape(4, -1))
    for b in range(4):
        jargs = [jnp.asarray(a) for a in args]
        jargs[4], jargs[11] = jnp.asarray(x[b]), jnp.asarray(U0[b])
        Uj, Xj, sj = jipm.solve_ocp_qp(*jargs, num_horizon=N, iters=40, stage_parallel=parallel)
        assert int(sol.iterations[b]) == int(sj.iterations)
        assert bool(sol.converged[b]) == bool(sj.converged) and bool(sj.converged)
        np.testing.assert_allclose(U[b].numpy(), np.asarray(Uj), atol=1e-10)
        np.testing.assert_allclose(X[b].numpy(), np.asarray(Xj), atol=1e-10)
        np.testing.assert_allclose(float(sol.kkt_res[b]), float(sj.kkt_res), rtol=1e-6,
                                   atol=1e-14)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "stage_parallel"])
def test_nonfinite_guard_ocp_qp(parallel):
    """tests/test_ipm.py:363-400: R at 3e38 overflows the f32 Riccati sweep
    on the first iteration; the iterate freezes at its last finite point
    with converged=False, for every problem of the batch."""
    n, m, N = 6, 2, 6
    f32 = torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    A = torch.eye(n, dtype=f32)
    B = torch.zeros(n, m, dtype=f32)
    B[0, 0] = B[1, 1] = 1.0
    R = (3e38 * torch.eye(m)).to(f32)
    x0 = t([[0.5, 0, 0, 0, 0, 0.1], [0.3, 0, 0, 0, 0, -0.1]])
    U, X, sol = ipm.solve_ocp_qp(A, B, torch.eye(n, dtype=f32), R, x0, t(XT), t(U_MIN), t(U_MAX),
                                 t(-10.0), t(10.0), t(0.8), torch.zeros(2, N, m, dtype=f32),
                                 num_horizon=N, iters=10, stage_parallel=parallel)
    for v in (U, X, sol.s, sol.lam):
        assert bool(v.isfinite().all())
    assert not bool(sol.converged.any())


@pytest.mark.parametrize("kkt", ["riccati", "riccati_parallel"])
def test_mpc_lti_kkt_matches_dense_and_jax(kkt):
    jp, js = jparams.MPCParam.default(vt=0.8), jparams.SystemParam.default()
    tp, ts = port(params.MPCParam, jp), port(params.SystemParam, js)
    x = _states(0, 4)
    width = torch.tensor(0.8, dtype=F64)
    solves = []
    u, U, X = controllers.mpc_lti(cpu(x), cpu(XT), tp, ts, width, return_traj=True, kkt=kkt,
                                  solves=solves)
    _, Ud, Xd = controllers.mpc_lti(cpu(x), cpu(XT), tp, ts, width, return_traj=True)
    assert len(solves) == 1 and bool(solves[0].converged.all())
    np.testing.assert_allclose(U.numpy(), Ud.numpy(), atol=1e-6)
    np.testing.assert_allclose(X.numpy(), Xd.numpy(), atol=1e-6)
    assert torch.equal(u, U[:, 0])
    for b in range(4):
        _, Uj, Xj = jctrl.mpc_lti(jnp.asarray(x[b]), jnp.asarray(XT), jp, js, jnp.asarray(0.8),
                                  return_traj=True, kkt=kkt)
        np.testing.assert_allclose(U[b].numpy(), np.asarray(Uj), atol=1e-10)
        np.testing.assert_allclose(X[b].numpy(), np.asarray(Xj), atol=1e-10)
    with pytest.raises(ValueError, match="unknown kkt"):
        controllers.mpc_lti(cpu(x), cpu(XT), tp, ts, width, kkt="banded")


def test_f32_dense_condensed_solve_fails_from_n100_as_in_jax():
    """``chip_smoke.py``'s crossover gates the f32 dense solve's convergence
    only up to N = 50: from N = 100 the condensed problem's residual stays
    above 1e6 after 30 iterations in the JAX package too (run in f32 as the
    package runs there, x64 off), where the Riccati path converges."""
    import dataclasses

    import jax

    x = np.array([0.4, 0, 0, 0, 0.5, 0.1], np.float32)
    with jax.enable_x64(False):
        jp = dataclasses.replace(jparams.MPCParam.default(vt=0.8), num_horizon=100)
        js = jparams.SystemParam.default()
        qp, _, _ = jctrl._tracking_qp(jp, js, jnp.asarray(0.8), jnp.asarray(x), jnp.asarray(XT))
        sol = jipm.solve_qp(qp, jnp.zeros(200), iters=30)
        assert sol.z.dtype == jnp.float32
        assert not bool(sol.converged) and float(sol.kkt_res) > 1e6
    kw = dict(device="cpu", dtype=torch.float32)
    tp = params.MPCParam.default(vt=0.8, **kw)
    tp = params.MPCParam(A=tp.A, B=tp.B, Q=tp.Q, R=tp.R, vt=tp.vt, eyt=tp.eyt, num_horizon=100)
    ts = params.SystemParam.default(**kw)
    for kkt, converged in (("dense", False), ("riccati", True)):
        solves = []
        u = controllers.mpc_lti(torch.as_tensor(x[None]), torch.tensor(XT, **kw), tp, ts,
                                torch.tensor(0.8, **kw), kkt=kkt, solves=solves)
        assert bool(u.isfinite().all())
        assert bool(solves[0].converged[0]) == converged, kkt
        if not converged:
            assert float(solves[0].kkt_res[0]) > 1e6


# ---- ipm._highp ------------------------------------------------------------


class _Inside(Exception):
    pass


def _qp(Bt=2, n=4):
    H = torch.eye(n, dtype=F64).expand(Bt, n, n)
    C = torch.eye(n, dtype=F64).expand(Bt, n, n)
    return ipm.QP(H=H, g=torch.ones(Bt, n, dtype=F64), C=C, d=-torch.ones(Bt, n, dtype=F64),
                  E=torch.zeros(Bt, 0, n, dtype=F64), e=torch.zeros(Bt, 0, dtype=F64))


def _ocp_call():
    args = _ocp_args(_states(2, 2), np.zeros((2, 10, 2)))
    return ipm.solve_ocp_qp(*map(cpu, args), num_horizon=10)


def _lmpc_seed():
    sd = fixtures.load_lmpc_seed("l_shape", **KW)
    heads = (track.load_track("l_shape", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
             params.LMPCParam.default(**KW), params.SystemParam.default(**KW))
    columns = (sd["ss1"], sd["q1"], sd["u1"], sd["counter"], sd["ss2"], sd["q2"], sd["u2"],
               sd["pid_lap_steps"], sd["lin_points0"], sd["lin_input0"])
    return sd, heads, columns


def _mpc_heads():
    return (track.load_track("l_shape", width=0.8, **KW), dynamics.BicycleParams.default(**KW),
            params.MPCParam.default(vt=0.8, **KW), params.SystemParam.default(**KW), cpu(XT))


def _racing(batch):
    sd = fixtures.load_lmpc_seed("l_shape", **KW)
    opti = cpu(np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=","))
    heads = (track.load_track("l_shape", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
             params.LMPCParam.default(**KW), params.RacingGameParam.default(alpha=0.8, **KW),
             params.SystemParam.default(**KW))
    cols = (sd["ss1"], sd["q1"], sd["ss2"], sd["q2"], sd["u1"], sd["u2"], sd["valid1"],
            sd["valid2"], sd["counter"], sd["lin_points0"], sd["lin_input0"],
            cpu([[0.72, 7.5], [0.7, 5.5]]), cpu([[0.0, -0.2], [0.0, -0.5]]), opti)
    if not batch:
        return fused.rollout_racing_game(*heads, sd["xcurv0"], sd["xglob0"], *cols, n_steps=1)
    return fused.rollout_racing_game_batch(*heads, sd["xcurv0"][None], sd["xglob0"][None],
                                           *cols, n_steps=1)


def _lmpc_lap():
    sd = fixtures.load_lmpc_seed("l_shape", **KW)
    heads = (track.load_track("l_shape", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
             params.LMPCParam.default(**KW), params.SystemParam.default(**KW))
    return fused.rollout_lmpc_lap(*heads, sd["xcurv0"], sd["xglob0"], sd["ss1"], sd["q1"],
                                  sd["ss2"], sd["q2"], sd["u1"], sd["u2"], sd["valid1"],
                                  sd["valid2"], sd["counter"], sd["lin_points0"],
                                  sd["lin_input0"], n_steps=1)


def _learning(batch):
    sd, heads, columns = _lmpc_seed()
    if batch:
        return fused.rollout_lmpc_learning_batch(*heads, sd["xcurv0"][None], sd["xglob0"][None],
                                                 *columns, n_laps=1, n_steps=1)
    return fused.rollout_lmpc_learning(*heads, sd["xcurv0"], sd["xglob0"], *columns, n_laps=1,
                                       n_steps=1)


def _obstacles(name):
    zeros, half = torch.zeros(6, **KW), cpu([0.2, 0.1])
    if name == "mpccbf":
        return fused.rollout_mpccbf(
            track.load_track("l_shape", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
            params.MPCCBFParam.default(vt=0.8, **KW), params.SystemParam.default(**KW), cpu(XT),
            zeros, zeros, cpu([[0.2, 4.0]]), cpu([[0.0, 0.1]]), torch.tensor([True]),
            half[None], half, n_steps=1)
    return fused.rollout_ilqr(
        track.load_track("ellipse", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
        params.ILQRParam.default(vt=0.8, **KW), cpu(XT), zeros, zeros, cpu([0.2, 5.0]),
        cpu([0.0, 0.1]), half, half, n_steps=1)


def _nl_call():
    qp = _qp()
    c_nl = lambda z: (z.sum(dim=1, keepdim=True) + 10.0, torch.ones(z.shape[0], 1, z.shape[1],
                                                                    dtype=F64))
    return ipm.solve_qp_nl(qp.H, qp.g, qp.C, qp.d, c_nl, torch.zeros(2, 4, dtype=F64), iters=5)


# the 13 functions the JAX package runs under _highp (ipm.solve is not
# ported): each called, and the inner call that records the precision
HIGHP = {
    "solve_qp": (lambda: ipm.solve_qp(_qp(), torch.zeros(2, 4, dtype=F64)), ipm, "_solve"),
    "solve_qp_batch": (lambda: ipm.solve_qp_batch(_qp(), torch.zeros(2, 4, dtype=F64)), ipm,
                       "_solve"),
    "solve_qp_nl": (_nl_call, ipm, "_kkt_residual"),
    "solve_ocp_qp": (_ocp_call, ipm, "_bmv"),
    "rollout_mpc_tracking": (lambda: fused.rollout_mpc_tracking(
        *_mpc_heads(), torch.zeros(6, **KW), torch.zeros(6, **KW), n_steps=1),
        controllers, "mpc_lti"),
    "rollout_mpc_tracking_batch": (lambda: fused.rollout_mpc_tracking_batch(
        *_mpc_heads(), torch.zeros(2, 6, **KW), torch.zeros(2, 6, **KW), n_steps=1),
        controllers, "mpc_lti"),
    "rollout_mpccbf": (lambda: _obstacles("mpccbf"), controllers, "obstacle_gate_mask"),
    "rollout_ilqr": (lambda: _obstacles("ilqr"), controllers, "ilqr"),
    "rollout_lmpc_lap": (_lmpc_lap, lmpc_learning, "estimate_abc_horizon"),
    "rollout_lmpc_learning": (lambda: _learning(False), lmpc_learning, "estimate_abc_horizon"),
    "rollout_lmpc_learning_batch": (lambda: _learning(True), lmpc_learning,
                                    "estimate_abc_horizon"),
    "rollout_racing_game": (lambda: _racing(False), fused, "racing_game_step"),
    "rollout_racing_game_batch": (lambda: _racing(True), fused, "racing_game_step"),
}


@pytest.fixture
def tf32_outside():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("name", sorted(HIGHP))
def test_highp_pins_full_precision_inside_and_restores_after_a_raise(name, monkeypatch,
                                                                      tf32_outside):
    call, module, inner = HIGHP[name]
    seen = []

    def record(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        raise _Inside

    monkeypatch.setattr(module, inner, record)
    with pytest.raises(_Inside):
        call()
    assert seen == ["highest"]
    assert torch.get_float32_matmul_precision() == "high"


@pytest.mark.parametrize("name", ["solve_qp", "solve_qp_batch", "solve_qp_nl", "solve_ocp_qp",
                                  "rollout_mpc_tracking"])
def test_highp_restores_after_a_normal_return(name, monkeypatch, tf32_outside):
    call, module, inner = HIGHP[name]
    real, seen = getattr(module, inner), []

    def record(*args, **kwargs):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args, **kwargs)

    monkeypatch.setattr(module, inner, record)
    out = call()
    assert out is not None and seen and set(seen) == {"highest"}
    assert torch.get_float32_matmul_precision() == "high"
