"""Module-by-module parity of the PyTorch port with the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``car_racing_tpu_torch`` at float64 on the CPU.  The port's
CPU path is the plain PyTorch version of each kernel; the JAX side runs its
plain ``lax.scan`` / ``jnp.linalg`` path or the Pallas kernel in interpret
mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.models import controllers as jctrl
from car_racing_tpu.ops import bezier as jbez
from car_racing_tpu.ops import dynamics as jdyn
from car_racing_tpu.ops import ipm as jipm
from car_racing_tpu.ops import ocp as jocp
from car_racing_tpu.ops import pallas_kernels
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.parallel import mesh as jmesh
from car_racing_tpu.parallel import scaling
from car_racing_tpu.planning import overtake as jov
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.kernels import cholesky as k2
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import bezier, dynamics, ipm, ocp, track
from car_racing_tpu_torch.planning import overtake
from car_racing_tpu_torch.utils import convert, params

F64 = torch.float64
LAYOUTS = ["l_shape", "goggle", "m_shape", "ellipse"]


def cpu(a):
    return torch.as_tensor(np.array(a), device="cpu")


def port(cls, jax_obj):
    return convert.to_port(cls, convert.numpy_fields(jax_obj), device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def bike_pair():
    jb = jdyn.BicycleParams.default()
    return jb, port(dynamics.BicycleParams, jb)


@pytest.fixture(scope="module")
def mpc_pair():
    jp = (jparams.MPCParam.default(vt=0.8), jparams.SystemParam.default())
    return jp, (port(params.MPCParam, jp[0]), port(params.SystemParam, jp[1]))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_track_matches(layout):
    jt = jtrack.load_track(layout, width=0.9)
    tt = track.load_track(layout, width=0.9, device="cpu", dtype=F64)
    for name, v in convert.numpy_fields(jt).items():
        np.testing.assert_allclose(getattr(tt, name).numpy(), v, rtol=0, atol=1e-13,
                                   err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_curvature_equal_on_random_s(layout):
    jt = jtrack.load_track(layout, width=1.0)
    tt = port(track.Track, jt)
    L = float(jt.lap_length)
    rng = np.random.default_rng(0)
    # random s over three laps either side of 0, plus every segment's ends
    s = np.concatenate([
        rng.uniform(-3 * L, 3 * L, 400),
        np.asarray(jt.s0), np.asarray(jt.s0 + jt.seg_len), [0.0, L, -L, 2 * L],
    ])
    want = np.asarray(jtrack.curvature_batch(jt, jnp.asarray(s)))
    got = track.curvature(tt, cpu(s)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(track.wrap_s(tt, cpu(s)).numpy(),
                                  np.asarray(jtrack.wrap_s(jt, jnp.asarray(s))))


def _period_states(rng, B, negative_vx):
    if negative_vx:
        xc = np.array([-0.15, 0.02, 0.05, 0.01, 3.0, 0.05]) + rng.standard_normal(
            (B, 6)) * np.array([0.1, 0.02, 0.05, 0.05, 2.0, 0.1])
        xc[:, 0] = -np.abs(xc[:, 0])
        u = np.tile([0.02, -0.5], (B, 1))
    else:
        xc = np.array([0.8, 0.01, 0.02, 0.01, 5.0, 0.05]) + 0.3 * rng.standard_normal(
            (B, 6)) * np.array([1, 0.1, 0.1, 0.1, 10, 1])
        u = np.array([0.05, 0.3]) + 0.1 * rng.standard_normal((B, 2))
    return rng.standard_normal((B, 6)), xc, u


@pytest.mark.parametrize("negative_vx,control_dt", [(False, 0.1), (True, 0.02)])
def test_propagate_plain_matches_scan(bike_pair, negative_vx, control_dt):
    jb, tb = bike_pair
    jt = jtrack.load_track("l_shape", width=1.0)
    tt = port(track.Track, jt)
    xg, xc, u = _period_states(np.random.default_rng(3), 16, negative_vx)
    fn = jax.vmap(lambda g, c, v: jdyn.propagate(jt, jb, g, c, v, control_dt=control_dt,
                                                 backend="scan"))
    jg, jc = fn(jnp.asarray(xg), jnp.asarray(xc), jnp.asarray(u))
    tg, tc = dynamics.propagate(tt, tb, cpu(xg), cpu(xc), cpu(u), control_dt=control_dt,
                                backend="plain")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-10)


def test_curv_step_matches(bike_pair):
    jb, tb = bike_pair
    jt = jtrack.load_track("goggle", width=1.0)
    tt = port(track.Track, jt)
    _, xc, u = _period_states(np.random.default_rng(14), 8, False)
    want = np.stack([np.asarray(jdyn.curv_step(jt, jb, jnp.asarray(x), jnp.asarray(v), 0.1))
                     for x, v in zip(xc, u)])
    got = dynamics.curv_step(tt, tb, cpu(xc), cpu(u), 0.1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_condense_and_prediction_matrices_match():
    rng = np.random.default_rng(4)
    N, n, m = 5, 6, 2
    A = np.eye(n) + 0.1 * rng.standard_normal((n, n))
    B = rng.standard_normal((n, m))
    x0 = rng.standard_normal((3, n))
    phi, G = ocp.condense_lti(cpu(A), cpu(B), N, cpu(x0))
    for b in range(3):
        jphi, jG = jocp.condense_lti(jnp.asarray(A), jnp.asarray(B), N, jnp.asarray(x0[b]))
        np.testing.assert_allclose(phi[b].numpy(), np.asarray(jphi), atol=1e-12)
        np.testing.assert_allclose(G.numpy(), np.asarray(jG), atol=1e-12)
    seqs = ocp.lti_sequences(cpu(A), cpu(B), N)
    ph, Gm = ocp.prediction_matrices(*seqs, cpu(x0[0]))
    jph, jGm = jocp.prediction_matrices(*jocp.lti_sequences(jnp.asarray(A), jnp.asarray(B), N),
                                        jnp.asarray(x0[0]))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jph), atol=1e-12)
    np.testing.assert_allclose(Gm.numpy(), np.asarray(jGm), atol=1e-12)


def _random_states(seed, B):
    rng = np.random.default_rng(seed)
    xc = np.zeros((B, 6))
    xc[:, 0] = rng.uniform(0.0, 1.2, B)
    xc[:, 1:4] = 0.05 * rng.standard_normal((B, 3))
    xc[:, 4] = rng.uniform(0.0, 15.0, B)
    xc[:, 5] = rng.uniform(-0.75, 0.75, B)  # near the 0.8 width bound too
    return xc, 0.1 * rng.standard_normal((B, 20))


def test_solve_qp_matches_jax(mpc_pair):
    (jp, js), _ = mpc_pair
    xc, zw = _random_states(5, 6)
    qps = [jctrl._tracking_qp(jp, js, 0.8, jnp.asarray(x), jnp.asarray([0.8, 0, 0, 0, 0, 0.0]))[0]
           for x in xc]
    sols = [jipm.solve_qp(q, jnp.asarray(z), iters=30) for q, z in zip(qps, zw)]
    stack = lambda f: cpu(np.stack([np.asarray(getattr(q, f)) for q in qps]))
    qp = ipm.QP(*(stack(f) for f in ("H", "g", "C", "d", "E", "e")))
    sol = ipm.solve_qp(qp, cpu(zw), iters=30)
    np.testing.assert_allclose(sol.z.numpy(), np.stack([np.asarray(s.z) for s in sols]),
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(sol.iterations.numpy(),
                                  [int(s.iterations) for s in sols])
    np.testing.assert_array_equal(sol.converged.numpy(), [bool(s.converged) for s in sols])


@pytest.mark.parametrize("warm", [False, True])
def test_mpc_lti_u0_matches_jax(mpc_pair, warm):
    (jp, js), (tp, ts) = mpc_pair
    xc, zw = _random_states(6 + warm, 8)
    xt = np.array([0.8, 0, 0, 0, 0, 0.0])
    fn = jax.vmap(lambda x, z: jctrl.mpc_lti(x, jnp.asarray(xt), jp, js, 0.8,
                                             u_warm=z if warm else None))
    want = np.asarray(fn(jnp.asarray(xc), jnp.asarray(zw)))
    got = controllers.mpc_lti(cpu(xc), cpu(xt), tp, ts, torch.tensor(0.8, dtype=F64),
                              u_warm=cpu(zw) if warm else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def test_pid_and_target_state_match():
    xc, _ = _random_states(13, 5)
    xt = controllers.target_state(0.8, 0.1, device="cpu", dtype=F64)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(jctrl.target_state(0.8, 0.1,
                                                                              jnp.float64)))
    want = np.stack([np.asarray(jctrl.pid(jnp.asarray(x), jnp.asarray(xt.numpy()))) for x in xc])
    np.testing.assert_allclose(controllers.pid(cpu(xc), xt).numpy(), want, rtol=0, atol=1e-15)


def _random_qp_batch(seed, Bt=12, n=8, m=14):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((Bt, n, n))
    H = M @ np.transpose(M, (0, 2, 1)) / n + np.eye(n)
    C = rng.standard_normal((Bt, m, n))
    zs = rng.standard_normal((Bt, n))
    d = np.einsum("bij,bj->bi", C, zs) - np.abs(rng.standard_normal((Bt, m)))
    g = rng.standard_normal((Bt, n))
    return H, g, C, d, np.zeros((Bt, 0, n)), np.zeros((Bt, 0))


def test_solve_qp_batch_matches_jax():
    arrs = _random_qp_batch(8)
    jsol = jipm.solve_qp_batch(jipm.QP(*map(jnp.asarray, arrs)),
                               jnp.zeros(arrs[1].shape), iters=30)
    sol = ipm.solve_qp_batch(ipm.QP(*map(cpu, arrs)), torch.zeros(arrs[1].shape, dtype=F64),
                             iters=30)
    np.testing.assert_allclose(sol.z.numpy(), np.asarray(jsol.z), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(jsol.converged))


@pytest.mark.parametrize("B,n", [(16, 8), (130, 20)])
def test_cholesky_plain_matches_pallas_interpret(B, n):
    rng = np.random.default_rng(9)
    L = rng.standard_normal((B, n, n))
    A = L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n)
    b = rng.standard_normal((B, n))
    want = np.asarray(pallas_kernels.cholesky_solve_batched(jnp.asarray(A), jnp.asarray(b),
                                                            interpret=True))
    got = k2.plain(cpu(A), cpu(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


def test_cholesky_plain_nan_on_indefinite_like_jnp():
    A = np.stack([np.eye(3), np.diag([1.0, -1.0, 1.0])])
    b = np.ones((2, 3))
    want = np.asarray(pallas_kernels.solve_batched(jnp.asarray(A), jnp.asarray(b)))
    got = k2.plain(cpu(A), cpu(b)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[0], want[0])
    assert np.isnan(got[1]).all()


def test_interp_matches_jnp():
    rng = np.random.default_rng(10)
    xp = np.sort(rng.uniform(0, 5, 12))
    xp[4] = xp[5]  # a zero-width segment
    fp = rng.standard_normal(12)
    x = np.concatenate([rng.uniform(-1, 6, 200), xp, [xp[0] - 1, xp[-1] + 1]])
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = bezier.interp(cpu(x), cpu(xp), cpu(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    samples = np.stack([xp, fp], axis=1)
    want_ey = np.asarray(jbez.interp_ey(jnp.asarray(samples), jnp.asarray(x)))
    np.testing.assert_allclose(bezier.interp_ey(cpu(samples), cpu(x)).numpy(), want_ey,
                               rtol=0, atol=1e-14)


def test_bezier_and_corridor_points_match():
    rng = np.random.default_rng(11)
    S, nv = 5, 3
    x0 = np.zeros((S, 6))
    x0[:, 0] = rng.uniform(0.5, 1.0, S)
    x0[:, 4] = rng.uniform(0, 48, S)  # some egos near the line: s3 wraps
    x0[:, 5] = rng.uniform(-0.1, 0.1, S)
    vi = np.stack([x0[:, 4:5] + np.sort(rng.uniform(1, 5, (S, nv)), 1),
                   -np.sort(-rng.uniform(-0.5, 0.5, (S, nv)), 1),
                   -np.sort(-rng.uniform(-0.5, 0.5, (S, nv)), 1)], axis=2)
    mdv = rng.uniform(0, 1, S)
    opti = np.zeros((40, 6))
    opti[:, 4] = np.linspace(0.5, 50.0, 40)
    opti[:, 5] = 0.1 * np.sin(opti[:, 4])
    args = (50.0, 1.0, 0.2)
    cp = bezier.corridor_control_points(nv, cpu(x0), cpu(vi), cpu(mdv), *map(
        lambda v: torch.tensor(v, dtype=F64), args), cpu(opti), torch.tensor(0.6, dtype=F64))
    bz = bezier.sample_corridors(cp, 11)
    for s in range(S):
        jcp = jbez.corridor_control_points(nv, jnp.asarray(x0[s]), jnp.asarray(vi[s]),
                                           jnp.asarray(mdv[s]), *map(jnp.asarray, args),
                                           jnp.asarray(opti), jnp.asarray(0.6))
        np.testing.assert_allclose(cp[s].numpy(), np.asarray(jcp), rtol=0, atol=1e-12)
        np.testing.assert_allclose(bz[s].numpy(), np.asarray(jbez.sample_corridors(jcp, 11)),
                                   rtol=0, atol=1e-12)


def test_corridor_sweep_inputs_match():
    want = scaling.corridor_sweep_inputs(6, 10, seed=7, dtype=jnp.float64)
    got = overtake.corridor_sweep_inputs(6, 10, seed=7, dtype=F64, device="cpu")
    assert len(got) == len(want) == 17
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, i
        if w.dtype == bool or w.dtype.kind == "i":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(i))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12, err_msg=str(i))


def test_fallback_and_selection_cost_match():
    rng = np.random.default_rng(12)
    P, N = 6, 10
    x0 = np.abs(rng.standard_normal((P, 6)))
    bez = np.stack([np.sort(rng.uniform(0, 4, (P, N + 1)), 1),
                    rng.standard_normal((P, N + 1))], axis=2)
    X = rng.standard_normal((P, N + 1, 6))
    ls, ley, rs, rey = (0.5 * rng.standard_normal((P, N + 1)) for _ in range(4))
    lv, rv = rng.uniform(size=P) > 0.3, rng.uniform(size=P) > 0.3
    od = np.array([-1, 0, 1, 2, 3, -1], np.int32)
    bi = np.arange(P, dtype=np.int32) % 4
    got_kin = overtake.kinematic_fallback_traj(cpu(x0), cpu(bez), N).numpy()
    got_cost = overtake.branch_selection_cost(
        cpu(X), cpu(ls), cpu(ley), cpu(rs), cpu(rey), cpu(lv), cpu(rv),
        torch.tensor(0.4, dtype=F64), torch.tensor(0.2, dtype=F64), cpu(od), cpu(bi)).numpy()
    for p in range(P):
        np.testing.assert_allclose(
            got_kin[p], np.asarray(jov.kinematic_fallback_traj(jnp.asarray(x0[p]),
                                                               jnp.asarray(bez[p]), N)),
            rtol=0, atol=1e-12)
        want = jov.branch_selection_cost(
            jnp.asarray(X[p]), jnp.asarray(ls[p]), jnp.asarray(ley[p]), jnp.asarray(rs[p]),
            jnp.asarray(rey[p]), jnp.asarray(lv[p]), jnp.asarray(rv[p]), 0.4, 0.2,
            jnp.asarray(od[p]), jnp.asarray(bi[p]))
        np.testing.assert_allclose(got_cost[p], float(want), rtol=0, atol=1e-12)


def test_solve_branch_batch_matches_jax():
    inputs = scaling.corridor_sweep_inputs(1, 10, seed=2, dtype=jnp.float64)
    x0, A, B, tw, vw = inputs[:5]
    bez, ley, lg, rey, rg = (a[0] for a in inputs[6:11])
    want = jov._solve_branch_batch(x0[0], A, B, tw, vw, bez, ley[:, :10], lg[:, :10],
                                   rey[:, :10], rg[:, :10], num_horizon=10)
    t = lambda a: cpu(np.asarray(a))
    got = overtake._solve_branch_batch(t(x0[0]), t(A), t(B), t(tw), t(vw), t(bez),
                                       t(ley[:, :10]), t(lg[:, :10]), t(rey[:, :10]),
                                       t(rg[:, :10]), num_horizon=10)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_corridor_sweep_matches_mesh_sweep():
    S, N = 8, 10
    jin = scaling.corridor_sweep_inputs(S, N, seed=3, dtype=jnp.float64)
    want = jmesh.corridor_sweep(jmesh.make_mesh(1), *jin, num_horizon=N)
    tin = overtake.corridor_sweep_inputs(S, N, seed=3, dtype=F64, device="cpu")
    best, X_best, costs, conv, X_all, iters = overtake.corridor_sweep(*tin, num_horizon=N)
    np.testing.assert_array_equal(best.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(X_best.numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(costs.numpy(), np.asarray(want[2]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(X_all.numpy(), np.asarray(want[4]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(want[5]))
    assert best.dtype == iters.dtype == torch.int32
