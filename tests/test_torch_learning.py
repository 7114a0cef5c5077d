"""The port's multi-lap LMPC learning against the JAX package, at float64 on
the CPU: the per-lane linearization a learning fleet carries, the lap
crossing with its in-loop promotion and freeze, the fleet, and the l_shape
learning curve.

The same numpy inputs (the committed l_shape seed and lap golden) go through
both packages.  Whole closed loops are held only as far as the reference
holds itself: the LMPC loop amplifies a difference in the last bit of a
state to about 1e-7 within three steps, before any solve stops at the
iteration cap.  The JAX rollout from the l_shape seed moves from itself by
up to 2.1e-6 over its first 11 steps when vx is one ulp off, and a lane of
its 3-lane fleet from the same lane alone by up to 6.7e-6
(``l_shape/jax_self_distance`` in ``data/goldens/lmpc_lap_spread.json``,
written by ``python -m tools.lmpc_lap_spread --learning``).  So each run is
held exactly (1e-12) where the arithmetic is the same, at 1e-10 over its
first step, at 1e-4 up to its first capped solve, and by lap steps against
the nudged JAX runs (``l_shape/jax_learning``) past it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from car_racing_tpu.models import controllers as jctrl
from car_racing_tpu.ops import dynamics as jdyn
from car_racing_tpu.ops import lmpc_learning as jlearn
from car_racing_tpu.ops import ocp as jocp
from car_racing_tpu.ops import track as jtrack
from car_racing_tpu.racing import fused as jfused
from car_racing_tpu.utils import params as jparams
from car_racing_tpu_torch.models import controllers
from car_racing_tpu_torch.ops import dynamics, lmpc_learning, ocp, track
from car_racing_tpu_torch.racing import fused
from car_racing_tpu_torch.utils import fixtures, params

F64 = torch.float64
KW = dict(device="cpu", dtype=F64)
N, K_PER = 12, 22
WHOLE_RUN_ATOL = 1e-4  # up to the first capped solve; see the module docstring


def cpu(a):
    return torch.as_tensor(np.array(a), device="cpu")


def np_seed():
    with np.load(fixtures.seed_path("l_shape")) as f:
        return {k: f[k] for k in f.files}


def golden():
    return np.loadtxt("data/goldens/lmpc_lap_l_shape.csv", delimiter=",")


def lap_length():
    return float(jtrack.load_track("l_shape", width=1.0).lap_length)


def wrap(x, L):
    return np.concatenate([x[..., :4], np.mod(x[..., 4:5], L), x[..., 5:]], axis=-1)


def appended(sd, g, k, L):
    """Lap iter-1's column after the golden lap's steps 0..k-1 were appended
    to it, as ``add_point`` appends them."""
    ss1 = sd["ss1"].copy()
    for j in range(k):
        ss1[int(sd["counter"]) + j + 1] = wrap(g[j], L) + [0, 0, 0, 0, L, 0]
    return ss1


def lanes_at(ks):
    """Per-lane inputs of one LMPC step at the golden lap's steps ``ks``: each
    lane its own state, column A (with its own appendix), linearization
    points and inputs; column B shared.  Numpy."""
    sd, g, L = np_seed(), golden(), lap_length()
    x = np.stack([wrap(g[k], L) for k in ks])
    ssA = np.stack([appended(sd, g, k, L) for k in ks])
    lin = np.stack([g[k:k + N] for k in ks])
    li = np.stack([np.tile(sd["lin_input0"][:1], (N, 1)) + 0.01 * b for b in range(len(ks))])
    ss = np.stack([np.stack([sd["ss2"], a]) for a in ssA])
    ud = np.broadcast_to(np.stack([sd["u2"], sd["u1"]]), (len(ks), 2) + sd["u1"].shape).copy()
    va = np.broadcast_to(np.stack([sd["valid2"], sd["valid1"]]),
                         (len(ks), 2) + sd["valid1"].shape).copy()
    jt = jtrack.load_track("l_shape", width=1.0)
    curv = np.stack([np.asarray(jtrack.curvature_batch(jt, jnp.asarray(np.mod(lp[:, 4], L))))
                     for lp in lin])
    return dict(x=x, ssA=ssA, qA=np.broadcast_to(sd["q1"], (len(ks),) + sd["q1"].shape).copy(),
                lin=lin, li=li, ss=ss, ud=ud, va=va, curv=curv, u_prev=li[:, 0], L=L)


KS = (0, 40, 120)  # uncapped steps of the l_shape lap, with different data


def test_per_lane_linearization_matches_jax_vmap():
    """``condense``, ``select_points``, ``regression_and_linearization`` and
    ``lmpc`` with three lanes of their own, against a JAX ``vmap`` of the
    same functions over the lanes."""
    d = lanes_at(KS)
    # the regression: rows 3..5 exactly as the kinematics give them; rows
    # 0..2 by the model they give at the linearization points (the Gram
    # matrix is singular but for its ridge, tests/test_torch_lmpc.py)
    jA, jB, jC = map(np.asarray, jax.vmap(
        lambda lp, li, ss, ud, va, c: jlearn.estimate_abc_horizon(lp, li, ss, ud, va, c,
                                                                  jnp.asarray(0.1)))(
        *map(jnp.asarray, (d["lin"], d["li"], d["ss"], d["ud"], d["va"], d["curv"]))))
    A, B, C = (t.numpy() for t in lmpc_learning.estimate_abc_horizon(
        cpu(d["lin"]), cpu(d["li"]), cpu(d["ss"]), cpu(d["ud"]), cpu(d["va"]), cpu(d["curv"]),
        torch.tensor(0.1, dtype=F64)))
    assert A.shape == (3, N, 6, 6) and B.shape == (3, N, 6, 2) and C.shape == (3, N, 6)
    np.testing.assert_allclose(A[..., 3:, :], jA[..., 3:, :], rtol=0, atol=1e-12)
    np.testing.assert_allclose(C[..., 3:], jC[..., 3:], rtol=0, atol=1e-12)
    model = lambda A, B, C: (np.einsum("bnij,bnj->bni", A[..., :3, :], d["lin"])
                             + np.einsum("bnij,bnj->bni", B[..., :3, :], d["li"]) + C[..., :3])
    np.testing.assert_allclose(model(A, B, C), model(jA, jB, jC), rtol=0, atol=1e-9)

    jp, jq = jax.vmap(lambda s, q, x: jlearn.select_points(s, q, x, K_PER))(
        *map(jnp.asarray, (d["ssA"], d["qA"], d["x"])))
    p, q = lmpc_learning.select_points(cpu(d["ssA"]), cpu(d["qA"]), cpu(d["x"]), K_PER)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))

    # the condensation and the LMPC step on the JAX package's linearization
    jphi, jG = jax.vmap(jocp.condense)(*map(jnp.asarray, (jA, jB, jC, d["x"])))
    phi, G = ocp.condense(cpu(jA), cpu(jB), cpu(jC), cpu(d["x"]))
    assert tuple(G.shape) == (3, N * 6, N * 2)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=0, atol=1e-9)
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), rtol=0, atol=1e-9)

    pts = np.concatenate([np.asarray(jp)] * 2, axis=-1)
    qs = np.concatenate([np.asarray(jq)] * 2, axis=-1)
    jlp, jsp = jparams.LMPCParam.default(), jparams.SystemParam.default()
    jU, jX, jsol = jax.vmap(lambda x, A, B, C, pt, qq, up: jctrl.lmpc(
        x, jlp, A, B, C, pt, qq, up, jsp, d["L"], 1.0, num_horizon=N))(
        *map(jnp.asarray, (d["x"], jA, jB, jC, pts, qs, d["u_prev"])))
    U, X, sol = controllers.lmpc(cpu(d["x"]), params.LMPCParam.default(**KW), cpu(jA), cpu(jB),
                                 cpu(jC), cpu(pts), cpu(qs), cpu(d["u_prev"]),
                                 params.SystemParam.default(**KW), torch.tensor(1.0, dtype=F64))
    assert np.asarray(jsol.converged).all() and bool(sol.converged.all())
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(jsol.iterations))
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=0, atol=1e-9)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-9)


def _port_step(d, shared_lane=None):
    """The port's regression, selection and LMPC solve of one step, for
    every lane at once or, with ``shared_lane=b``, for lane b alone through
    the shared-linearization calls."""
    t = (lambda a: cpu(a)) if shared_lane is None else (lambda a: cpu(a[shared_lane]))
    x = cpu(d["x"]) if shared_lane is None else cpu(d["x"][shared_lane:shared_lane + 1])
    up = (cpu(d["u_prev"]) if shared_lane is None
          else cpu(d["u_prev"][shared_lane:shared_lane + 1]))
    A, B, C = lmpc_learning.estimate_abc_horizon(t(d["lin"]), t(d["li"]), t(d["ss"]), t(d["ud"]),
                                                 t(d["va"]), t(d["curv"]),
                                                 torch.tensor(0.1, dtype=F64))
    p, q = lmpc_learning.select_points(t(d["ssA"]), t(d["qA"]), x, K_PER)
    pts, qs = torch.cat([p, p], dim=-1), torch.cat([q, q], dim=-1)
    U, X, _ = controllers.lmpc(x, params.LMPCParam.default(**KW), A, B, C, pts, qs, up,
                               params.SystemParam.default(**KW), torch.tensor(1.0, dtype=F64))
    return (A, B, C, pts, qs, U, X)


def test_per_lane_step_equals_single_lane_steps():
    """One step of three lanes at once against each lane alone (the calls a
    single lane makes): the linearization and the selection bit for bit,
    the solve to rounding."""
    d = lanes_at(KS)
    fleet = _port_step(d)
    for b in range(3):
        single = _port_step(d, shared_lane=b)
        for name, f, s in zip(("A", "B", "C", "pts", "qs"), fleet[:5], single[:5]):
            assert torch.equal(f[b], s if s.dim() < f.dim() else s[0]), name
        for f, s in zip(fleet[5:], single[5:]):
            np.testing.assert_allclose(f[b].numpy(), s[0].numpy(), rtol=0, atol=1e-12)


def test_shared_linearization_equals_identical_lanes():
    """A linearization shared by the batch and the same one given to every
    lane build the same QP."""
    d = lanes_at(KS)
    A, B, C = lmpc_learning.estimate_abc_horizon(
        cpu(d["lin"][0]), cpu(d["li"][0]), cpu(d["ss"][0]), cpu(d["ud"][0]), cpu(d["va"][0]),
        cpu(d["curv"][0]), torch.tensor(0.1, dtype=F64))
    p, q = lmpc_learning.select_points(cpu(d["ssA"][0]), cpu(d["qA"][0]), cpu(d["x"]), K_PER)
    args = (cpu(d["x"]), params.LMPCParam.default(**KW))
    rest = (torch.cat([p, p], dim=-1), torch.cat([q, q], dim=-1), cpu(d["u_prev"]),
            params.SystemParam.default(**KW), torch.tensor(1.0, dtype=F64))
    lane = lambda a: a.expand(3, *a.shape)
    shared = controllers.lmpc_qp(*args, A, B, C, *rest)
    per_lane = controllers.lmpc_qp(*args, lane(A), lane(B), lane(C), *rest)
    assert shared[3].dim() == 2 and per_lane[3].dim() == 3
    for f in ("H", "g", "C", "d", "E", "e"):
        a, b = getattr(shared[0], f), getattr(per_lane[0], f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(shared[2].numpy(), per_lane[2].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(lane(shared[3]).numpy(), per_lane[3].numpy(), rtol=0, atol=1e-12)


def _jax_args(sd):
    j = lambda k: jnp.asarray(sd[k])
    return (jtrack.load_track("l_shape", width=1.0), jdyn.BicycleParams.default(),
            jparams.LMPCParam.default(), jparams.SystemParam.default()), j


def _port_args():
    return (track.load_track("l_shape", width=1.0, **KW), dynamics.BicycleParams.default(**KW),
            params.LMPCParam.default(**KW), params.SystemParam.default(**KW))


# the crossing: a start five steps (k0 = 172) before the golden lap's end,
# with the golden's appendix in column A and its next states as the
# linearization.  All of the solves up to the crossing converge (12-17
# iterations); the lane then freezes, and its solves, which read the
# seven-row column just promoted, stop at the cap.
CROSS_K0, CROSS_STEPS, CROSS_LAP = 172, 10, 7


def test_crossing_promotes_and_freezes_as_jax():
    """``rollout_lmpc_learning`` over a lap crossing with ``n_laps = 1`` in
    both packages: the same lap length and lap count; the states and the
    inputs up to the crossing within 1e-6 (see the module docstring); the
    inputs after the freeze, from capped solves, within 1e-4.  A frozen
    lane still writes its state into column A (row T + 1) and the next
    solve reads it, in both: the first input after the freeze differs from
    the next, which repeat (a lane that stopped writing would repeat the
    first)."""
    sd, g, L = np_seed(), golden(), lap_length()
    ss1 = appended(sd, g, CROSS_K0, L)
    x0 = g[CROSS_K0]
    lp = np.concatenate([g[CROSS_K0:], np.repeat(g[-1:], N + 1 - (len(g) - CROSS_K0), axis=0)])
    li = np.tile(sd["lin_input0"][:1], (N, 1))
    jargs, j = _jax_args(sd)
    xg0 = np.asarray(jtrack.frenet_to_global_state(jargs[0], jnp.asarray(x0)))
    i32 = lambda k: jnp.asarray(int(sd[k]), jnp.int32)
    jx, ju, jsteps, jdone = map(np.asarray, jfused.rollout_lmpc_learning(
        *jargs, jnp.asarray(x0), jnp.asarray(xg0), jnp.asarray(ss1), j("q1"), j("u1"),
        i32("counter"), j("ss2"), j("q2"), j("u2"), i32("pid_lap_steps"), jnp.asarray(lp),
        jnp.asarray(li), n_laps=1, n_steps=CROSS_STEPS))
    solves = []
    x, u, steps, done = fused.rollout_lmpc_learning(
        *_port_args(), cpu(x0), cpu(xg0), cpu(ss1), cpu(sd["q1"]), cpu(sd["u1"]),
        int(sd["counter"]), cpu(sd["ss2"]), cpu(sd["q2"]), cpu(sd["u2"]),
        int(sd["pid_lap_steps"]), cpu(lp), cpu(li), n_laps=1, n_steps=CROSS_STEPS, solves=solves)
    x, u = x.numpy(), u.numpy()
    T = CROSS_LAP
    assert steps.tolist() == jsteps.tolist() == [T] and int(done) == int(jdone) == 1
    its = [int(s.iterations[0]) for s in solves]
    assert max(its[:T]) < 40 and min(its[T:]) == 40, its
    assert x[T - 1, 4] < L and 0 <= x[T, 4] < 1.0  # s wrapped at the crossing
    assert (x[T:] == x[T]).all()  # frozen
    np.testing.assert_allclose(x[:2], jx[:2], rtol=0, atol=1e-10)
    np.testing.assert_allclose(u[:1], ju[:1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(u[:T], ju[:T], rtol=0, atol=1e-6)
    np.testing.assert_allclose(u[T:], ju[T:], rtol=0, atol=1e-4)
    for us in (u, ju):
        assert np.abs(us[T] - us[T + 1]).max() > 1e-3
        assert (us[T + 1:] == us[T + 1]).all()


def _fleet_starts(sd, B):
    """The bench's fleet pattern (bench.py:530-535): the seed's start with
    ey + N(0, 0.01), numpy seed 0, and its global state broadcast."""
    pert = np.zeros((B, 6))
    pert[:, 5] = np.random.default_rng(0).normal(0, 0.01, B)
    return sd["xcurv0"] + pert, np.broadcast_to(sd["xglob0"], (B, 6)).copy()


FLEET_STEPS = 14  # lane 0's first capped solve is its step 11


def _port_fleet(sd, xc0, xg0, n_steps):
    solves = []
    out = fused.rollout_lmpc_learning_batch(
        *_port_args(), cpu(xc0), cpu(xg0), cpu(sd["ss1"]), cpu(sd["q1"]), cpu(sd["u1"]),
        int(sd["counter"]), cpu(sd["ss2"]), cpu(sd["q2"]), cpu(sd["u2"]),
        int(sd["pid_lap_steps"]), cpu(sd["lin_points0"]), cpu(sd["lin_input0"]), n_laps=1,
        n_steps=n_steps, solves=solves)
    capped = torch.stack([s.iterations >= 40 for s in solves], dim=1).numpy()  # (B, n_steps)
    first_capped = min(int(np.argmax(c)) if c.any() else n_steps for c in capped)
    return [o.numpy() for o in out], first_capped


def test_fleet_matches_jax_batch():
    """Three lanes of the learning fleet in both packages, up to the first
    capped solve of any lane: the first step within 1e-10, the rows after
    it within 1e-4 (see the module docstring)."""
    sd = np_seed()
    xc0, xg0 = _fleet_starts(sd, 3)
    (x, u, _, _), first = _port_fleet(sd, xc0, xg0, FLEET_STEPS)
    assert 5 < first < FLEET_STEPS
    jargs, j = _jax_args(sd)
    i32 = lambda k: jnp.asarray(int(sd[k]), jnp.int32)
    jx, ju, _, _ = map(np.asarray, jfused.rollout_lmpc_learning_batch(
        *jargs, jnp.asarray(xc0), jnp.asarray(xg0), j("ss1"), j("q1"), j("u1"), i32("counter"),
        j("ss2"), j("q2"), j("u2"), i32("pid_lap_steps"), j("lin_points0"), j("lin_input0"),
        n_laps=1, n_steps=FLEET_STEPS))
    assert x.shape == jx.shape == (3, FLEET_STEPS + 1, 6)
    np.testing.assert_allclose(x[:, :2], jx[:, :2], rtol=0, atol=1e-10)
    np.testing.assert_allclose(u[:, :1], ju[:, :1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(x[:, :first + 1], jx[:, :first + 1], rtol=0, atol=WHOLE_RUN_ATOL)
    np.testing.assert_allclose(u[:, :first], ju[:, :first], rtol=0, atol=WHOLE_RUN_ATOL)


def test_fleet_lanes_match_single_lane_runs():
    """Each lane of the fleet against the port's single-lane run from its
    start: the first step bit for bit (every lane's data is still the
    seed's), the rows up to its first capped solve within 1e-4."""
    sd = np_seed()
    xc0, xg0 = _fleet_starts(sd, 3)
    (x, u, _, _), _ = _port_fleet(sd, xc0, xg0, FLEET_STEPS)
    for b in range(3):
        (xs, us, _, _), first = _port_fleet(sd, xc0[b:b + 1], xg0[b:b + 1], FLEET_STEPS)
        np.testing.assert_allclose(x[b, :2], xs[0, :2], rtol=0, atol=1e-12)
        np.testing.assert_allclose(u[b, :1], us[0, :1], rtol=0, atol=1e-12)
        np.testing.assert_allclose(x[b, :first + 1], xs[0, :first + 1], rtol=0,
                                   atol=WHOLE_RUN_ATOL)


LEARN_STEPS = 480  # the longest nudged JAX run takes 230 + 144 + 102 = 476


def test_three_laps_first_is_rollout_lmpc_lap_and_curve_within_spread():
    """The port's three-lap l_shape learning run from the committed seed.
    Its first lap is ``rollout_lmpc_lap``'s lap, row for row (the same
    arithmetic; the crossing row differs by the wrap's subtraction of the
    lap length); laps 2 and 3 are no further from the unnudged JAX run's
    than the furthest of the 24 nudged JAX runs; the curve decreases
    wherever every nudged JAX run's does; the run stays on the track."""
    with open("data/goldens/lmpc_lap_spread.json") as f:
        spread = json.load(f)["l_shape/jax_learning"]
    sd = fixtures.load_lmpc_seed("l_shape", **KW)
    args = _port_args()
    x, u, steps, done = fused.rollout_lmpc_learning(
        *args, sd["xcurv0"], sd["xglob0"], sd["ss1"], sd["q1"], sd["u1"], sd["counter"],
        sd["ss2"], sd["q2"], sd["u2"], sd["pid_lap_steps"], sd["lin_points0"], sd["lin_input0"],
        n_laps=3, n_steps=LEARN_STEPS)
    steps = steps.tolist()
    assert int(done) == 3 and len(steps) == 3
    T = steps[0]
    lx, lu, _, lap_steps = fused.rollout_lmpc_lap(
        *args, sd["xcurv0"], sd["xglob0"], sd["ss1"], sd["q1"], sd["ss2"], sd["q2"], sd["u1"],
        sd["u2"], sd["valid1"], sd["valid2"], sd["counter"], sd["lin_points0"],
        sd["lin_input0"], n_steps=T + 1)
    assert lap_steps == T
    L = float(args[0].lap_length)
    np.testing.assert_allclose(x[:T].numpy(), lx[:T].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(u[:T].numpy(), lu[:T].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(x[T].numpy() + [0, 0, 0, 0, L, 0], lx[T].numpy(), rtol=0,
                               atol=1e-12)

    ref, nudged = spread["unnudged_lap_steps"], np.array(spread["nudged_lap_steps"])
    for lap in (1, 2):
        dev = int(np.abs(nudged[:, lap] - ref[lap]).max())
        assert abs(steps[lap] - ref[lap]) <= dev, (lap + 1, steps, ref, dev)
    curve = [spread["seed_lap_steps"]] + steps
    jcurves = np.concatenate([np.full((len(nudged), 1), spread["seed_lap_steps"]), nudged], 1)
    for i in range(3):
        if (jcurves[:, i] > jcurves[:, i + 1]).all():
            assert curve[i] > curve[i + 1], curve
    x = x.numpy()
    assert np.isfinite(x).all() and np.isfinite(u.numpy()).all()
    assert np.abs(x[:, 5]).max() <= 1.0
    ends = np.cumsum(steps)
    assert (x[ends, 4] < 1.0).all() and (x[ends - 1, 4] > L - 1.0).all()  # s wraps at each lap
