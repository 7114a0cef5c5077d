#!/usr/bin/env python3
"""How far the obstacle-avoidance controllers' closed loops wander from their goldens.

    python -m tools.controller_spread [--ulps 8] [--out data/goldens/controller_spread.json]

Run from the repository root.  Runs the JAX package on the CPU in float64:

- ``mpccbf_l_shape``: ``rollout_mpccbf`` as ``golden_fixtures.py`` records
  its golden (l_shape at width 1.0, two prescribed cars, 200 steps), with
  each warm solve's Newton iterations and KKT residual, and the cold first
  solve's alone;
- ``ilqr_ellipse``: ``rollout_ilqr`` cold (``warm_start=False``) on the
  ellipse behind the blocking car, 100 steps, with each solve's Levenberg
  iterations;

then the same runs with the target's vx moved by k = -ulps..-1, 1..ulps
units in the last place, each summarised by its largest distance from the
golden over all rows and the first row off it by more than 1e-6.  It also
runs the JAX bench's float32 shapes (``bench.py:239-327``) from its first
three start states: the MPC-CBF rollout (100 steps, ``default_rng(1)``)
and the iLQR rollout cold and warm (60 steps, ``default_rng(2)``), each
summarised by its Newton or Levenberg iterations.

The JSON it writes (``--out``) is what ``chip_smoke.py`` and the port's
tests (``tests/test_torch_mpccbf.py``, ``tests/test_torch_ilqr.py``) read:
the per-step iteration counts to hold the port's runs to, and the nudged
spread as the scale of the goldens' tolerance.  Rerun it when the JAX
controllers or their goldens change.  It takes about a minute.
"""

from __future__ import annotations

import argparse
import json
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from car_racing_tpu.models import controllers as jctrl  # noqa: E402
from car_racing_tpu.ops import dynamics as jdyn  # noqa: E402
from car_racing_tpu.ops import track as jtrack  # noqa: E402
from car_racing_tpu.racing import fused as jfused  # noqa: E402
from car_racing_tpu.utils import params as jparams  # noqa: E402

OFF_ATOL = 1e-6
CBF_STEPS, ILQR_STEPS = 200, 100
BENCH_CBF_STEPS, BENCH_ILQR_STEPS, BENCH_STARTS = 100, 60, 3


def cbf_scenario():
    """The ``mpccbf_l_shape`` golden's obstacles (golden_fixtures.py:64-83)."""
    n_obs = 4
    s_coef, ey_coef = np.zeros((n_obs, 2)), np.zeros((n_obs, 2))
    act = np.zeros(n_obs, bool)
    s_coef[0], ey_coef[0], act[0] = [0.2, 4.0], [0.0, 0.1], True
    s_coef[1], ey_coef[1], act[1] = [0.2, 10.0], [0.0, -0.1], True
    halfs = np.ones((n_obs, 2))
    halfs[:2] = [0.2, 0.1]
    return s_coef, ey_coef, act, halfs, np.array([0.2, 0.1])


ILQR_OBS = (np.array([0.2, 5.0]), np.array([0.0, 0.1]), np.array([0.2, 0.1]))


def nudge(x, k):
    """``x`` moved by ``k`` units in the last place of its dtype."""
    x = np.asarray(x).copy()
    for _ in range(abs(k)):
        x = np.nextafter(x, np.inf if k > 0 else -np.inf)
    return x


def cast_tree(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def run_cbf(vt, x0, dtype=jnp.float64, n_steps=CBF_STEPS, warm_iters=20):
    s_coef, ey_coef, act, halfs, agent = cbf_scenario()
    c = lambda a: jnp.asarray(a, dtype)
    xc, us, kkt, its = jfused.rollout_mpccbf(
        cast_tree(jtrack.load_track("l_shape", width=1.0), dtype),
        cast_tree(jdyn.BicycleParams.default(), dtype),
        cast_tree(jparams.MPCCBFParam.default(vt=0.8), dtype),
        cast_tree(jparams.SystemParam.default(), dtype),
        c([vt, 0, 0, 0, 0, 0]), c(x0), c(np.zeros(6)), c(s_coef), c(ey_coef),
        jnp.asarray(act), c(halfs), c(agent), n_steps=n_steps, warm_iters=warm_iters)
    return np.asarray(xc), np.asarray(us), np.asarray(kkt), np.asarray(its)


def cbf_cold_solve():
    """The rollout's first, cold solve at t = 0 (fused.py:134-150)."""
    s_coef, ey_coef, act, halfs, agent = cbf_scenario()
    tr = jtrack.load_track("l_shape", width=1.0)
    L = tr.lap_length
    N = 10
    ts = 0.1 * jnp.arange(N + 1, dtype=jnp.float64)
    pv = lambda coef: jnp.stack([jnp.polyval(jnp.asarray(c), ts) for c in coef])
    s, ey = pv(s_coef), pv(ey_coef)
    vs = pv([np.polyder(c) for c in s_coef])
    vey = pv([np.polyder(c) for c in ey_coef])
    zeros = jnp.zeros_like(s)
    obs = jnp.stack([vs, vey, zeros, zeros, s, ey], axis=2)
    x0 = jnp.zeros(6)
    gate = jctrl.obstacle_gate_mask(x0, obs[:, 0, 4], L)
    _, _, _, sol = jctrl.mpccbf(
        x0, jnp.asarray([0.8, 0, 0, 0, 0, 0.0]), jparams.MPCCBFParam.default(vt=0.8),
        jparams.SystemParam.default(), tr.width, obs, jnp.asarray(act) & gate,
        jnp.asarray(agent), jnp.asarray(halfs), L, return_traj=True, iters=40)
    return int(sol.iterations), float(sol.kkt_res)


def run_ilqr(vt, x0, dtype=jnp.float64, n_steps=ILQR_STEPS, warm_start=False):
    obs_s, obs_ey, half = ILQR_OBS
    c = lambda a: jnp.asarray(a, dtype)
    xc, us, its = jfused.rollout_ilqr(
        cast_tree(jtrack.load_track("ellipse", width=1.0), dtype),
        cast_tree(jdyn.BicycleParams.default(), dtype),
        cast_tree(jparams.ILQRParam.default(vt=0.8), dtype),
        c([vt, 0, 0, 0, 0, 0]), c(x0), c(np.zeros(6)), c(obs_s), c(obs_ey), c(half), c(half),
        n_steps=n_steps, warm_start=warm_start)
    return np.asarray(xc), np.asarray(us), np.asarray(its)


def spread(golden, runs):
    """Each nudged run's largest distance from the golden and first row off."""
    out = []
    for k, xc in runs:
        err = np.abs(xc - golden).max(axis=1)
        off = np.nonzero(err > OFF_ATOL)[0]
        out.append({"ulps": k, "max_abs_err": float(err.max()),
                    "first_row_off": int(off[0]) if len(off) else None})
    errs = [r["max_abs_err"] for r in out]
    offs = [r["first_row_off"] for r in out if r["first_row_off"] is not None]
    return {"runs": out, "max_abs_err_range": [min(errs), max(errs)],
            "first_row_off_range": [min(offs), max(offs)] if offs else None}


def bench_starts(seed, base, scale, n_draw, n):
    """The first ``n`` of the bench's ``n_draw`` start states."""
    rng = np.random.default_rng(seed)
    return (np.array(base) + scale * rng.standard_normal((n_draw, 6)))[:n]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ulps", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    ks = [k for k in range(-args.ulps, args.ulps + 1) if k]
    vt = np.float64(0.8)
    x0 = np.zeros(6)
    result = {}

    golden = np.loadtxt("data/goldens/mpccbf_l_shape.csv", delimiter=",")
    xc, _, kkt, its = run_cbf(vt, x0)
    cold_its, cold_kkt = cbf_cold_solve()
    entry = {
        "n_steps": CBF_STEPS, "cold_iters": 40, "warm_iters": 20, "off_atol": OFF_ATOL,
        "golden_atol": 1e-2, "rerun_max_abs_err": float(np.abs(xc - golden).max()),
        "cold_iterations": cold_its, "cold_kkt_res": cold_kkt,
        "warm_iterations": its.tolist(), "warm_kkt_res": kkt.tolist(),
        "warm_capped": int((its >= 20).sum()), "newton_iterations": int(its.sum()) + cold_its,
        "kkt_res_median": float(np.median(kkt)), "kkt_res_max": float(kkt.max()),
    }
    entry["nudged_target_vx"] = spread(golden, [(k, run_cbf(nudge(vt, k), x0)[0]) for k in ks])
    result["mpccbf_l_shape"] = entry
    print(json.dumps({"mpccbf_l_shape": {k: v for k, v in entry.items()
                                         if k not in ("warm_iterations", "warm_kkt_res")}}),
          flush=True)

    golden = np.loadtxt("data/goldens/ilqr_ellipse.csv", delimiter=",")
    xc, _, its = run_ilqr(vt, x0)
    entry = {
        "n_steps": ILQR_STEPS, "warm_start": False, "max_iter": 150, "off_atol": OFF_ATOL,
        "golden_atol": 1e-3, "rerun_max_abs_err": float(np.abs(xc - golden).max()),
        "levenberg_iterations": its.tolist(), "levenberg_total": int(its.sum()),
    }
    entry["nudged_target_vx"] = spread(golden, [(k, run_ilqr(nudge(vt, k), x0)[0]) for k in ks])
    result["ilqr_ellipse"] = entry
    print(json.dumps({"ilqr_ellipse": {k: v for k, v in entry.items()
                                       if k != "levenberg_iterations"}}), flush=True)

    # the JAX bench's float32 shapes, first three start states
    f32 = jnp.float32
    vt32 = np.float32(0.8)
    runs = []
    for x in bench_starts(1, [0.3, 0, 0, 0, 0, 0], 0.02, 20, BENCH_STARTS):
        xc, _, _, its = run_cbf(vt32, x.astype(np.float32), f32, BENCH_CBF_STEPS)
        runs.append({"finite": bool(np.isfinite(xc).all()), "newton_iterations": int(its.sum()),
                     "warm_capped": int((its >= 20).sum()), "max_abs_ey": float(np.abs(xc[:, 5]).max())})
    result["mpccbf_bench_f32"] = {"n_steps": BENCH_CBF_STEPS, "warm_iters": 20, "rng": 1,
                                  "starts": runs}
    runs = []
    for x in bench_starts(2, [0.1, 0, 0, 0, 0, 0], 0.02, 8, BENCH_STARTS):
        row = {}
        for warm in (False, True):
            xc, _, its = run_ilqr(vt32, x.astype(np.float32), f32, BENCH_ILQR_STEPS, warm)
            row["warm" if warm else "cold"] = {"finite": bool(np.isfinite(xc).all()),
                                               "levenberg_iterations": int(its.sum())}
        runs.append(row)
    result["ilqr_bench_f32"] = {"n_steps": BENCH_ILQR_STEPS, "rng": 2, "starts": runs}
    print(json.dumps({k: result[k] for k in ("mpccbf_bench_f32", "ilqr_bench_f32")}), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
