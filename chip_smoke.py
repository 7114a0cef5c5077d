#!/usr/bin/env python3
"""Drive the PyTorch port (car_racing_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root.  It builds the CUDA kernels from
``car_racing_tpu_torch/csrc/`` into ``build/torch_kernels/``, holds each
kernel against its plain PyTorch version on the card, drives the two paths
of the port through the entry points a user calls, and times each kernel
beside its bound:

1. build: one nvcc per source, all at once, and ptxas' registers, stack
   and spills for every kernel;
2. K1 (integrator) against its plain loop, B = 256, f32 and f64;
3. K2 (batched Cholesky solve) against its plain version, f32 and f64, at
   the sweep's n = 20 and at n = 100, 130 and 180 (dynamic shared memory
   and device memory);
4. K3 (the same with several right-hand sides) against its plain version,
   f32 and f64, at the LMPC QP's shape, a small one, and n = 100 and 180;
5. the MPC-LTI goldens of ``data/goldens/`` on the card in f64, through K1;
6. the four LMPC learning laps in f64 from the committed seeds, through K1,
   against their goldens as far as the JAX lap nudged by a few ulps holds
   them (``data/goldens/lmpc_lap_spread.json``), and the l_shape lap timed,
   per step of a 250-step call and per step of a call of the lap's own
   length, in f64 and in f32 (the f32 lap held to the nudged JAX f32 laps);
7. the LMPC learning protocol in f64, through K1: the PID loop against its
   golden (``pid_lap``); three learning laps from the l_shape seed, the
   first against phase 6's lap, the others against the nudged JAX runs
   (``learning``); ``run_learning_protocol`` from a standing start
   (``protocol``); and a learning fleet of 64 lanes (``learning_fleet``);
8. the obstacle-avoidance controllers through K1: the MPC-CBF golden
   (``mpccbf``, 200 steps) and the cold iLQR golden (``ilqr``, 100 steps,
   each step's Levenberg count equal to the JAX run's) in f64, held as
   ``data/goldens/controller_spread.json`` records the reference, and the
   JAX bench's f32 shapes timed from its first start states (three for
   ``mpccbf_time``, two for ``ilqr_time`` cold and warm, 30 steps);
9. the MPC-LTI fleet: 256 lanes x 100 control steps in f32 (K1's path);
10. the 256-QP corridor sweep in f32 (K2's path), against the same sweep
    with the plain solve;
11. 256 LMPC QPs (n = 68, 125 inequality and 7 equality rows) through
    ``ipm.solve_qp_batch`` in f64 (K3's path), against the same batch with
    the plain solve, and beside the controllers' dense-LU ``ipm.solve_qp``;
12. kernel timings at the paths' shapes, beside their bounds (K1 also at
    the racing fleets' B = 8 and 64, K2 at the racing game's corridor
    batches), and K3 with block teams of 128, 256 and 512 threads;
13. a torch.profiler trace of each path: the device's busy and idle share;
14. (run after phase 11: phase 12 times K2 at its shapes) the racing game:
    the l_shape and m_shape golden laps in f64 through K1 and K2, held as
    far as the JAX laps nudged by a few ulps hold them
    (``data/goldens/racing_game_spread.json``), with no collision
    (``racing_game``); the JAX package's recorded three-step runs from
    injected states replayed in f64, flags equal and rows within their
    bounds (``racing_game_injected``); the JAX bench's f32 lap from its
    first two starts (``racing_game_time``); and its f32 fleets of 8 and
    64 lanes (``racing_game_fleet``);
15. (run after phase 14) the offboard simulator's tracking path and the
    Riccati KKT path of MPC-LTI: TF32 switched on outside the port, the f32
    fleet and MPC-CBF bit-equal to their runs without it, and moved by it
    when the port's pin is disarmed (``tf32_pin``);
    the host PID loop against ``pid_l_shape`` (``sim_pid``) and the host
    MPC-LTI loop against the fused rollout and its golden (``sim_mpc``),
    through the simulator in f64; ``apps/control_test.tracking`` for pid,
    lqr and mpc-lti, 900 steps each, with their solve latencies, and a
    noisy PID run (``sim_tracking``); the dense, Riccati and parallel
    Riccati KKT on 256 states in f64 and f32 (``riccati_kkt``); and their
    one-state solve times by horizon (``crossover``);
then the ``kernels`` line, the card's name and power limit, and the ``ok``
line.

Every phase prints one JSON line.  A failed phase ends the script with exit
code 1 and no ``ok`` line; without a GPU, or outside a checkout of the
repository, it exits nonzero before any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores (data sheet)
LMPC_LAPS = (("l_shape", 250), ("goggle", 350), ("m_shape", 700), ("ellipse", 400))
LEARN_STEPS = 480  # the longest nudged JAX learning run takes 230 + 144 + 102 = 476
# a learning fleet lane against its single-lane run: the first step (the
# same data, rounding apart), then up to its first capped solve, as far as
# the JAX package's own fleet lanes and single-lane runs agree (up to
# 6.7e-6: l_shape/jax_self_distance in data/goldens/lmpc_lap_spread.json)
FIRST_STEP_ATOL, WHOLE_RUN_ATOL = 1e-8, 1e-4
# lanes of the 64-lane learning fleet allowed off the track (|ey| > width)
# over their lap: the JAX package's own first laps leave it too, 2 of 216
# (three 64-lane fleets and 24 nudged runs: l_shape/jax_learning_fleet and
# l_shape/jax_learning in the same file); at that rate more than 3 of 64
# has a probability under 1 %
FLEET_OFF_TRACK_LANES = 3
# the mpccbf_l_shape golden's prescribed cars (golden_fixtures.py:64-83) and
# the ilqr_ellipse golden's blocking car (golden_fixtures.py:97-109), which
# the JAX bench drives too (bench.py:239-327)
CBF_S_COEF = [[0.2, 4.0], [0.2, 10.0], [0.0, 0.0], [0.0, 0.0]]
CBF_EY_COEF = [[0.0, 0.1], [0.0, -0.1], [0.0, 0.0], [0.0, 0.0]]
CBF_ACTIVE = [True, True, False, False]
CBF_HALFS = [[0.2, 0.1], [0.2, 0.1], [1.0, 1.0], [1.0, 1.0]]
ILQR_OBS_S, ILQR_OBS_EY, HALF = [0.2, 5.0], [0.0, 0.1], [0.2, 0.1]
CONTROLLER_TARGET = [0.8, 0, 0, 0, 0, 0]
# iLQR steps of each ilqr_time rollout: the bench's 60 halved to keep the
# script inside its time limit on a slow host
ILQR_TIME_STEPS = 30
# K1's arithmetic per vehicle and substep, each libm call counted as one
# operation and the segment search at its least (one pair of compares):
# 3 (wrap) + 2 (search) + 8 (slip angles) + 12 (tire forces) + 13 (dvx, dvy,
# dwz with sin/cos of delta) + 2 (den) + 4 (sin/cos of epsi, psi) + 4 (s_dot)
# + 33 (the nine state updates)
K1_OPS_PER_SUBSTEP = 81


class SmokeFailure(Exception):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(fn, match, reps=20):
    """Mean duration on the device of the kernels named ``*match*`` over
    ``reps`` calls of ``fn``, from a torch.profiler trace: the kernel alone,
    without the host's cost of launching it, which back-to-back calls timed
    with CUDA events include once it is the longer of the two."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def device_profile(fn, wall_ms):
    """Device time of one call of ``fn`` from a torch.profiler trace: the
    union of its kernels' intervals, their count, and the largest by name.
    The idle share is taken against ``wall_ms``, the call's untraced time."""
    import torch

    from car_racing_tpu_torch.utils.profiling import device_trace

    torch.cuda.synchronize()
    with device_trace(log_dir=None) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_busy_ms": None, "idle_share": None, "device_ops": 0,
                "note": "the trace holds no device events: not measured"}
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    by_name: dict[str, float] = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
            "device_ops": len(spans), "top_ms": [[n[:80], t / 1e3] for n, t in top]}


def k1_bound_ms(B, n_seg, n_sub, itemsize):
    nbytes = itemsize * (B * (6 + 6 + 2) + 3 * n_seg + 11 + B * (6 + 6))
    ops = B * n_sub * K1_OPS_PER_SUBSTEP
    peak = PEAK_F64_OPS_PER_S if itemsize == 8 else PEAK_F32_OPS_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def solve_bound_ms(B, n, r, itemsize):
    """K2 (r = 1) and K3: one factorization and r substitutions, each type
    at its own peak."""
    factor = sum(2 + (n - j) + (n - j - 1) * (n - j) for j in range(n))
    substitute = 2 * sum(2 + 2 * (n - j - 1) for j in range(n))
    nbytes = itemsize * B * (n * n + n * r + n * r)
    ops = B * (factor + r * substitute)
    peak = PEAK_F64_OPS_PER_S if itemsize == 8 else PEAK_F32_OPS_PER_S
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def timed(fn):
    """``fn()`` and its milliseconds between CUDA events (calls may nest)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def first_capped(its):
    """Index of the first solve that stopped at the 40-iteration cap, else
    the number of solves."""
    capped = np.nonzero(np.asarray(its) >= 40)[0]
    return int(capped[0]) if len(capped) else len(its)


def learning_phases(dev, setup, lap_spread, golden, l_lap):
    """Phase 7: the LMPC learning protocol on the card, f64, each stage
    through the entry point a user calls, every control step one K1 launch.
    ``golden`` is the l_shape LMPC lap's golden and ``l_lap`` phase 6's
    l_shape lap on the card (xcurv, u, lap steps).  Returns the learning
    fleet's rollout for the profile phase."""
    import torch

    from car_racing_tpu_torch.kernels import propagate as k1
    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused, protocol
    from car_racing_tpu_torch.utils import fixtures, params

    f64 = torch.float64
    kw = dict(device=dev, dtype=f64)

    # ---- pid_lap: the protocol's first stage at the golden's scenario ----
    tr8, bike8, _, _, xtarget = setup("l_shape", 0.8, f64)
    zeros = torch.zeros(6, **kw)
    golden_pid = np.loadtxt("data/goldens/pid_l_shape.csv", delimiter=",")
    k1.launches = 0
    (xc, us), ms = timed(lambda: protocol.rollout_pid(tr8, bike8, xtarget, zeros, zeros,
                                                      n_steps=200))
    pid_k1 = k1.launches
    xc = xc.cpu().numpy()
    err = float(np.abs(xc[1:] - golden_pid).max()) if xc.shape == (201, 6) else float("nan")
    emit({"phase": "pid_lap", "dtype": "f64", "n_steps": 200, "ms_per_step": ms / 200,
          "max_abs_err_rows_1_200": err, "atol": 1e-8, "k1_launches": pid_k1})
    require(xc.shape == (201, 6) and np.isfinite(xc).all() and bool(us.isfinite().all()),
            f"pid_lap: shape {xc.shape} or non-finite values")
    require(err <= 1e-8, f"pid_lap: rows 1..200 off the golden by {err} > 1e-8")
    require(pid_k1 == 200, f"pid_lap: K1 launched {pid_k1} times, not 200")

    # ---- learning: three laps from the l_shape seed --------------------------
    sd = fixtures.load_lmpc_seed("l_shape", **kw)
    tr = track.load_track("l_shape", width=1.0, **kw)
    L = float(tr.lap_length)
    lmpc_args = (tr, dynamics.BicycleParams.default(**kw), params.LMPCParam.default(**kw),
                 params.SystemParam.default(**kw))
    columns = (sd["ss1"], sd["q1"], sd["u1"], sd["counter"], sd["ss2"], sd["q2"], sd["u2"],
               sd["pid_lap_steps"], sd["lin_points0"], sd["lin_input0"])
    solves = []
    k1.launches = 0
    (xc, us, steps, done), ms = timed(lambda: fused.rollout_lmpc_learning(
        *lmpc_args, sd["xcurv0"], sd["xglob0"], *columns, n_laps=3, n_steps=LEARN_STEPS,
        solves=solves))
    learn_k1 = k1.launches
    xc, us, steps = xc.cpu().numpy(), us.cpu().numpy(), steps.tolist()
    its = np.array([int(s.iterations[0]) for s in solves])
    active = sum(steps)
    T = steps[0]
    # lap 1 is phase 6's lap: the same arithmetic, row for row
    lap_xc, lap_us, lap_T = l_lap
    m = min(T, lap_T)
    lap1_err = max(float(np.abs(xc[:m] - lap_xc[:m]).max()),
                   float(np.abs(us[:m] - lap_us[:m]).max()),
                   float(np.abs(xc[m] + [0, 0, 0, 0, L, 0] - lap_xc[m]).max()))
    # lap 1 gated as phase 6 gates the lap; laps 2 and 3 by the nudged JAX
    # learning runs: no further from the unnudged run's lap steps than the
    # furthest nudged run, and the curve decreasing wherever theirs all do
    ref = lap_spread["l_shape/jax"]
    held = min(ref["nudged_first_row_off"])
    held_err = float(np.abs(xc[:held] - golden[:held]).max())
    lap1_dev = max(abs(n - ref["golden_lap_steps"]) for n in ref["nudged_lap_steps"])
    spread = lap_spread["l_shape/jax_learning"]
    unnudged, nudged = spread["unnudged_lap_steps"], np.array(spread["nudged_lap_steps"])
    devs = [int(np.abs(nudged[:, j] - unnudged[j]).max()) for j in range(3)]
    curve = [spread["seed_lap_steps"]] + steps
    jcurves = np.concatenate([np.full((len(nudged), 1), spread["seed_lap_steps"]), nudged], 1)
    must_fall = [bool((jcurves[:, i] > jcurves[:, i + 1]).all()) for i in range(3)]
    emit({"phase": "learning", "name": "lmpc_learning_l_shape", "dtype": "f64", "n_laps": 3,
          "n_steps": LEARN_STEPS, "lap_steps": steps, "laps_done": int(done),
          "jax_unnudged_lap_steps": unnudged, "lap_steps_dev_bounds": devs,
          "lap1_vs_lmpc_lap_max_abs": lap1_err, "lap1_lmpc_lap_steps": lap_T,
          "lap1_held_rows": held, "lap1_held_max_abs_err": held_err,
          "ms_per_step": ms / LEARN_STEPS, "ms_per_lap_step": ms / active,
          "iters_median": float(np.median(its[:active])), "iters_max": int(its[:active].max()),
          "iters_mean": float(its[:active].mean()), "capped": int((its[:active] >= 40).sum()),
          "first_capped_step": first_capped(its), "max_abs_ey": float(np.abs(xc[:, 5]).max()),
          "k1_launches": learn_k1})
    require(np.isfinite(xc).all() and np.isfinite(us).all(), "learning: non-finite states")
    require(int(done) == 3, f"learning: {int(done)} of 3 laps in {LEARN_STEPS} steps")
    require(learn_k1 == LEARN_STEPS, f"learning: K1 launched {learn_k1} times")
    require(T == lap_T and lap1_err <= 1e-12,
            f"learning: lap 1 ({T} steps) is {lap1_err} off phase 6's lap ({lap_T} steps)")
    require(held_err <= ref["atol"], f"learning: lap 1 rows 0..{held - 1} off the golden "
                                     f"by {held_err} > {ref['atol']}")
    require(abs(T - ref["golden_lap_steps"]) <= lap1_dev, f"learning: lap 1 of {T} steps")
    require(xc[T - 1, 4] < L and 0 <= xc[T, 4] < L, "learning: lap 1's end misplaced")
    for j in (1, 2):
        require(abs(steps[j] - unnudged[j]) <= devs[j],
                f"learning: lap {j + 1} of {steps[j]} steps, more than {devs[j]} from the "
                f"JAX run's {unnudged[j]}")
    for i in range(3):
        require(not must_fall[i] or curve[i] > curve[i + 1], f"learning: curve {curve} rises")
    require(float(np.abs(xc[:, 5]).max()) <= 1.0, "learning: the run leaves the track")

    # ---- protocol: zero state -> PID lap -> MPC-LTI lap -> 3 learning laps ---
    stage_ms = {}

    def staged(name, fn):
        def wrapper(*args, **kwargs):
            out, stage_ms[name] = timed(lambda: fn(*args, **kwargs))
            return out
        return wrapper

    stages = (protocol.rollout_pid, fused.rollout_mpc_tracking, fused.rollout_lmpc_learning)
    protocol.rollout_pid = staged("pid", stages[0])
    fused.rollout_mpc_tracking = staged("mpc_lti", stages[1])
    fused.rollout_lmpc_learning = staged("learning", stages[2])
    k1.launches = 0
    try:
        out, total_ms = timed(lambda: protocol.run_learning_protocol(tr, n_laps=3))
    finally:
        protocol.rollout_pid, fused.rollout_mpc_tracking, fused.rollout_lmpc_learning = stages
    proto_k1 = k1.launches
    curve = out["lap_steps"]
    n_seed = int(L / 0.7 / 0.1 * 1.8)  # run_learning_protocol's own sizing
    n_learn = 3 * curve[1] + 10
    jax_curve = lap_spread["l_shape/jax_protocol"]["lap_steps"]
    ss1, q1 = out["seed_columns"]["ss1"], out["seed_columns"]["q1"]
    T1 = curve[1]
    columns_ok = (ss1[T1, 4] >= L and bool((ss1[T1 + 1:] == protocol.SENTINEL).all())
                  and bool((q1 == (T1 - 1) - np.arange(len(q1))).all()))
    emit({"phase": "protocol", "layout": "l_shape", "width": 1.0, "dtype": "f64", "n_laps": 3,
          "lap_steps": curve, "jax_lap_steps": jax_curve, "wall_ms": total_ms,
          "stage_ms": stage_ms, "stage_steps": {"pid": n_seed, "mpc_lti": n_seed,
                                                "learning": n_learn},
          "k1_launches": proto_k1, "columns_ok": columns_ok,
          "finite": bool(np.isfinite(out["xcurv"]).all())})
    require(curve[:2] == jax_curve[:2], f"protocol: seed laps {curve[:2]} != {jax_curve[:2]}")
    require(all(a > b for a, b in zip(curve, curve[1:])), f"protocol: curve {curve} rises")
    require(curve[-1] < 100, f"protocol: last lap of {curve[-1]} steps")
    require(columns_ok, "protocol: the seed columns lose add_trajectory's structure")
    require(bool(np.isfinite(out["xcurv"]).all()), "protocol: non-finite learning states")
    require(proto_k1 == 2 * n_seed + n_learn,
            f"protocol: K1 launched {proto_k1} times, not {2 * n_seed + n_learn}")

    # ---- learning_fleet: 64 lanes, one learning lap each ---------------------
    B, n_steps = 64, 250
    pert = np.zeros((B, 6))
    pert[:, 5] = np.random.default_rng(0).normal(0, 0.01, B)
    xc0 = sd["xcurv0"] + torch.as_tensor(pert, **kw)
    xg0 = sd["xglob0"].expand(B, 6).contiguous()

    def learning_fleet(n, lanes=slice(None), solves=None):
        return fused.rollout_lmpc_learning_batch(
            *lmpc_args, xc0[lanes], xg0[lanes], *columns, n_laps=1, n_steps=n, solves=solves)

    learning_fleet(2)  # warm-up
    solves = []
    k1.launches = 0
    (xc, us, steps, done), ms = timed(lambda: learning_fleet(n_steps, solves=solves))
    fleet_k1 = k1.launches
    its = torch.stack([s.iterations for s in solves], dim=1).cpu().numpy()  # (B, n_steps)
    runs = its.max(axis=0)  # the iterations each batched solve ran
    steps = steps[:, 0].cpu().numpy()
    active = np.arange(n_steps)[None, :] < steps[:, None]
    lanes = []
    for b in (0, 1):
        alone = []
        xs, us1, _, _ = learning_fleet(20, slice(b, b + 1), alone)
        first = min(first_capped(its[b, :20]), first_capped([int(s.iterations[0]) for s in alone]))
        lanes.append({"lane": b, "first_capped_step": first,
                      "first_step_max_abs": max(float((xc[b, :2] - xs[0, :2]).abs().max()),
                                                float((us[b, :1] - us1[0, :1]).abs().max())),
                      "to_first_capped_max_abs": float((xc[b, :first + 1]
                                                        - xs[0, :first + 1]).abs().max())})
    xc = xc.cpu().numpy()
    lane_ey = np.abs(xc[..., 5]).max(axis=1)
    off_track = [{"lane": int(b), "max_abs_ey": float(lane_ey[b]), "lap_steps": int(steps[b])}
                 for b in np.nonzero(lane_ey > 1.0)[0]]
    emit({"phase": "learning_fleet", "B": B, "n_steps": n_steps, "n_laps": 1, "dtype": "f64",
          "ms_per_step": ms / n_steps, "lane_steps_per_s": B * n_steps / (ms / 1e3),
          "active_lane_steps_per_s": float(active.sum()) / (ms / 1e3),
          "lap_steps_min": int(steps.min()), "lap_steps_median": float(np.median(steps)),
          "lap_steps_max": int(steps.max()), "laps_done": int(done.sum()),
          "iters_run_mean": float(runs.mean()), "iters_run_max": int(runs.max()),
          "iters_lane_mean": float(its[active].mean()), "capped_lane_steps":
          int((its[active] >= 40).sum()), "max_abs_ey": float(lane_ey.max()),
          "lanes_off_track": off_track, "off_track_bound": FLEET_OFF_TRACK_LANES,
          "k1_launches": fleet_k1, "lanes_vs_single": lanes,
          "first_step_atol": FIRST_STEP_ATOL, "whole_run_atol": WHOLE_RUN_ATOL})
    require(np.isfinite(xc).all() and bool(us.isfinite().all()), "learning_fleet: non-finite")
    require(bool((done == 1).all()), f"learning_fleet: {int((done < 1).sum())} lanes unfinished")
    require(len(off_track) <= FLEET_OFF_TRACK_LANES,
            f"learning_fleet: {len(off_track)} lanes leave the track: {off_track}")
    require(fleet_k1 == n_steps, f"learning_fleet: K1 launched {fleet_k1} times")
    for r in lanes:
        require(r["first_step_max_abs"] <= FIRST_STEP_ATOL
                and r["to_first_capped_max_abs"] <= WHOLE_RUN_ATOL,
                f"learning_fleet: lane {r['lane']} alone differs from the fleet: {r}")
    return learning_fleet


def collides(xc, s_coefs, ey_coefs, L):
    """Whether the ego's (s, ey) rows come within the footprint gate of
    tests/test_fused.py:88-91 of a car on the prescribed polynomials."""
    t = np.arange(len(xc)) * 0.1
    for cs, ce in zip(s_coefs, ey_coefs):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        if ((ds < 0.85 * 0.4) & (dey < 0.85 * 0.2)).any():
            return True
    return False


def controller_phases(dev, spread):
    """Phase 8: the obstacle-avoidance controllers on the card, each control
    step one K1 launch: the MPC-CBF and iLQR goldens in f64 (``mpccbf``,
    ``ilqr``) and the JAX bench's f32 shapes timed from its first three
    start states (``mpccbf_time``) and first two (``ilqr_time``).  ``spread`` is
    ``data/goldens/controller_spread.json``.  Returns the K1 launches of the
    two golden runs and the two paths for the profile phase."""
    import torch

    from car_racing_tpu_torch.kernels import propagate as k1
    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import params

    f32, f64 = torch.float32, torch.float64
    setups = {}

    def setup(kind, dtype):
        """The rollout's arguments but the start state, built once a dtype so
        that no timed call reads the LTI data or copies to the card."""
        if (kind, dtype) not in setups:
            kw = dict(device=dev, dtype=dtype)
            t = lambda a: torch.as_tensor(np.asarray(a, np.float64), **kw)
            bike = dynamics.BicycleParams.default(**kw)
            if kind == "mpccbf":
                setups[kind, dtype] = (
                    (track.load_track("l_shape", width=1.0, **kw), bike,
                     params.MPCCBFParam.default(vt=0.8, **kw), params.SystemParam.default(**kw),
                     t(CONTROLLER_TARGET)),
                    (t(np.zeros(6)), t(CBF_S_COEF), t(CBF_EY_COEF),
                     torch.tensor(CBF_ACTIVE, device=dev), t(CBF_HALFS), t(HALF)))
            else:
                setups[kind, dtype] = (
                    (track.load_track("ellipse", width=1.0, **kw), bike,
                     params.ILQRParam.default(vt=0.8, **kw), t(CONTROLLER_TARGET)),
                    (t(np.zeros(6)), t(ILQR_OBS_S), t(ILQR_OBS_EY), t(HALF), t(HALF)))
        return setups[kind, dtype]

    def start(x0, dtype):
        return torch.as_tensor(np.asarray(x0, np.float64), device=dev, dtype=dtype)

    def cbf_run(x0, n_steps, solves=None):
        head, tail = setup("mpccbf", x0.dtype)
        return fused.rollout_mpccbf(*head, x0, *tail, n_steps=n_steps, warm_iters=20,
                                    solves=solves)

    def ilqr_run(x0, n_steps, warm_start):
        head, tail = setup("ilqr", x0.dtype)
        return fused.rollout_ilqr(*head, x0, *tail, n_steps=n_steps, warm_start=warm_start)

    L_cbf = float(setup("mpccbf", f64)[0][0].lap_length)
    L_ell = float(setup("ilqr", f64)[0][0].lap_length)

    # ---- mpccbf: the golden in f64, 200 steps ----------------------------------
    rec = spread["mpccbf_l_shape"]
    golden = np.loadtxt("data/goldens/mpccbf_l_shape.csv", delimiter=",")
    x0 = start(np.zeros(6), f64)
    cbf_run(x0, 2)  # warm-up
    solves = []
    k1.launches = 0
    (xc, us, kkt, its), ms = timed(lambda: cbf_run(x0, 200, solves))
    cbf_k1 = k1.launches
    xc, its, kkt = xc.cpu().numpy(), its.cpu().numpy(), kkt.cpu().numpy()
    same = xc.shape == golden.shape
    err = np.abs(xc - golden).max(axis=1) if same else np.array([np.nan])
    off = np.nonzero(err > rec["off_atol"])[0]
    held = rec["nudged_target_vx"]["first_row_off_range"][0]
    ref_its = np.array(rec["warm_iterations"])
    cold_its = int(solves[0].iterations[0])
    emit({"phase": "mpccbf", "name": "mpccbf_l_shape", "dtype": "f64", "n_steps": 200,
          "shape": list(xc.shape), "max_abs_err": float(err.max()), "atol": rec["golden_atol"],
          "first_row_off_1e-6": int(off[0]) if len(off) else None,
          "jax_nudged_max_abs_err_range": rec["nudged_target_vx"]["max_abs_err_range"],
          "jax_nudged_first_row_off_range": rec["nudged_target_vx"]["first_row_off_range"],
          "warm_capped": int((its >= 20).sum()), "jax_warm_capped": rec["warm_capped"],
          "newton_iterations": int(its.sum()) + cold_its,
          "jax_newton_iterations": rec["newton_iterations"],
          "cold_iterations": cold_its, "jax_cold_iterations": rec["cold_iterations"],
          "warm_counts_equal_to_jax": int((its == ref_its).sum()),
          "warm_counts_equal_before_row": bool((its[:held - 1] == ref_its[:held - 1]).all()),
          "kkt_res_median": float(np.median(kkt)), "kkt_res_max": float(kkt.max()),
          "ms_per_step": ms / 200, "k1_launches": cbf_k1})
    require(same, f"mpccbf: shape {xc.shape} != {golden.shape}")
    require(np.isfinite(xc).all() and bool(us.isfinite().all()), "mpccbf: non-finite values")
    require(float(err.max()) <= rec["golden_atol"],
            f"mpccbf: {float(err.max())} off the golden > {rec['golden_atol']}")
    require(cbf_k1 == 200, f"mpccbf: K1 launched {cbf_k1} times, not 200")

    # ---- ilqr: the golden in f64, cold, 100 steps --------------------------------
    rec = spread["ilqr_ellipse"]
    golden = np.loadtxt("data/goldens/ilqr_ellipse.csv", delimiter=",")
    x0 = start(np.zeros(6), f64)
    ilqr_run(x0, 2, False)  # warm-up
    k1.launches = 0
    (xc, us, its), ms = timed(lambda: ilqr_run(x0, 100, False))
    ilqr_k1 = k1.launches
    xc, its = xc.cpu().numpy(), its.cpu().numpy()
    same = xc.shape == golden.shape
    err = float(np.abs(xc - golden).max()) if same else float("nan")
    ref_its = np.array(rec["levenberg_iterations"])
    counts_equal = bool((its == ref_its).all())
    emit({"phase": "ilqr", "name": "ilqr_ellipse", "dtype": "f64", "n_steps": 100,
          "warm_start": False, "shape": list(xc.shape), "max_abs_err": err,
          "atol": rec["golden_atol"],
          "jax_nudged_max_abs_err_range": rec["nudged_target_vx"]["max_abs_err_range"],
          "levenberg_iterations": int(its.sum()), "jax_levenberg_iterations": int(ref_its.sum()),
          "counts_equal_to_jax": counts_equal,
          "steps_with_other_counts": np.nonzero(its != ref_its)[0].tolist(),
          "ms_per_step": ms / 100, "ms_per_levenberg_iteration": ms / max(int(its.sum()), 1),
          "k1_launches": ilqr_k1})
    require(same and np.isfinite(xc).all(), f"ilqr: shape {xc.shape} or non-finite values")
    require(err <= rec["golden_atol"], f"ilqr: {err} off the golden > {rec['golden_atol']}")
    require(counts_equal, "ilqr: Levenberg counts differ from the JAX run's at steps "
                          f"{np.nonzero(its != ref_its)[0].tolist()}")
    require(ilqr_k1 == 100, f"ilqr: K1 launched {ilqr_k1} times, not 100")

    # ---- mpccbf_time: the bench's f32 shapes, three starts, 100 steps each ------
    # (the script's time limit: one timed rollout a start, two iLQR starts a mode)
    bench = spread["mpccbf_bench_f32"]
    cbf_starts = (np.array([0.3, 0, 0, 0, 0, 0])
                  + 0.02 * np.random.default_rng(1).standard_normal((20, 6)))[:3]
    cbf_starts = [start(x0, f32) for x0 in cbf_starts]
    cbf_run(cbf_starts[0], 3)  # warm-up
    rows, samples = [], []
    for i, x0 in enumerate(cbf_starts):
        solves = []
        k1.launches = 0
        (xc, us, kkt, its), ms = timed(lambda: cbf_run(x0, 100, solves))
        n_k1 = k1.launches
        samples.append(ms / 100)
        xc, us, its = xc.cpu().numpy(), us.cpu().numpy(), its.cpu().numpy()
        newton = int(its.sum()) + int(solves[0].iterations[0])
        row = {"start": i, "ms_per_step": samples[-1],
               "newton_iterations": newton, "warm_iterations": int(its.sum()),
               "warm_capped": int((its >= 20).sum()),
               "newton_iters_per_s": newton / (samples[-1] * 100 / 1e3),
               "jax_f32": bench["starts"][i], "max_abs_ey": float(np.abs(xc[:, 5]).max()),
               "k1_launches": n_k1}
        rows.append(row)
        require(np.isfinite(xc).all() and np.isfinite(us).all(), f"mpccbf_time {i}: non-finite")
        require(row["max_abs_ey"] < 1.0, f"mpccbf_time {i}: leaves the track")
        require(np.abs(us[:, 0]).max() <= 0.5 + 1e-6 and np.abs(us[:, 1]).max() <= 1.0 + 1e-6,
                f"mpccbf_time {i}: inputs out of bounds")
        require(not collides(xc, CBF_S_COEF[:2], CBF_EY_COEF[:2], L_cbf),
                f"mpccbf_time {i}: collides with a prescribed car")
        require(n_k1 == 100, f"mpccbf_time {i}: K1 launched {n_k1} times")
    p50 = float(np.percentile(samples, 50))
    emit({"phase": "mpccbf_time", "dtype": "f32", "n_steps": 100, "warm_iters": 20,
          # the bench's p99 is over 20 starts x 20 runs; of n_samples rollout
          # means only the median and the largest are reported
          "starts": rows, "mpccbf_step_latency_p50_ms": p50,
          "max_ms_per_step": max(samples), "n_samples": len(samples),
          # the bench's definition: start 0's warm iterations over p50 x steps
          "cbf_newton_iters_per_s": rows[0]["warm_iterations"] / (p50 * 100 / 1e3)})

    # ---- ilqr_time: the bench's f32 shapes, two starts, cold and warm
    bench = spread["ilqr_bench_f32"]
    ilqr_starts = (np.array([0.1, 0, 0, 0, 0, 0])
                   + 0.02 * np.random.default_rng(2).standard_normal((8, 6)))[:2]
    ilqr_starts = [start(x0, f32) for x0 in ilqr_starts]
    ilqr_run(ilqr_starts[0], 2, False)  # warm-up
    out = {"phase": "ilqr_time", "dtype": "f32", "n_steps": ILQR_TIME_STEPS}
    for warm in (False, True):
        mode = "warm" if warm else "cold"
        rows, samples = [], []
        for i, x0 in enumerate(ilqr_starts):
            k1.launches = 0
            (xc, us, its), ms = timed(lambda: ilqr_run(x0, ILQR_TIME_STEPS, warm))
            n_k1 = k1.launches
            xc, its = xc.cpu().numpy(), its.cpu().numpy()
            samples.append(ms / ILQR_TIME_STEPS)
            rows.append({"start": i, "ms_per_step": ms / ILQR_TIME_STEPS,
                         "levenberg_iterations": int(its.sum()),
                         # the JAX bench's count is over its 60 steps
                         "jax_f32_levenberg_iterations_60_steps":
                             bench["starts"][i][mode]["levenberg_iterations"],
                         "ms_per_levenberg_iteration": ms / int(its.sum()),
                         "max_abs_ey": float(np.abs(xc[:, 5]).max()), "k1_launches": n_k1})
            require(np.isfinite(xc).all() and bool(us.isfinite().all()),
                    f"ilqr_time {mode} {i}: non-finite")
            require(rows[-1]["max_abs_ey"] < 1.0, f"ilqr_time {mode} {i}: leaves the track")
            require(not collides(xc, [ILQR_OBS_S], [ILQR_OBS_EY], L_ell),
                    f"ilqr_time {mode} {i}: collides with the prescribed car")
            require(n_k1 == ILQR_TIME_STEPS, f"ilqr_time {mode} {i}: K1 launched {n_k1} times")
        p50 = float(np.percentile(samples, 50))
        out[mode] = {"starts": rows, "ilqr_step_latency_p50_ms": p50,
                     "max_ms_per_step": max(samples), "n_samples": len(samples)}
        if not warm:  # the bench's definition: start 0's iterations over p50 x steps
            out["ilqr_levenberg_iters_per_s"] = (rows[0]["levenberg_iterations"]
                                                 / (p50 * ILQR_TIME_STEPS / 1e3))
    emit(out)

    paths = {"mpccbf_5_steps": lambda: cbf_run(cbf_starts[0], 5),
             "ilqr_5_steps": lambda: ilqr_run(ilqr_starts[0], 5, False)}
    return {"mpccbf": cbf_k1, "ilqr": ilqr_k1}, paths


# the racing game's goldens (golden_fixtures.py:111-126, 171-190): layout,
# steps, and the traffic's s(t) and ey(t) polynomials sorted by ey desc
RG_LAPS = {"l_shape": (300, [[0.72, 7.5], [0.7, 5.5]], [[0.0, -0.2], [0.0, -0.5]]),
           "m_shape": (700, [[0.5, 10.0], [0.48, 6.5]], [[0.0, -0.3], [0.0, -0.55]])}
# an injected run on the card against the JAX run on the CPU, where no
# solve of the run stopped at its iteration cap (a capped solve's iterate
# carries the rounding of its unfinished iterations; such runs are
# reported): the rows reached through overtake steps only within
# RG_STEP_ATOL (the card's factorizations round otherwise than LAPACK), the
# rows at or after an LMPC step within RG_AFTER_LMPC_ATOL: the LMPC step's
# regression is rank-deficient but for a 1e-10 ridge, and the JAX learning
# rollout moves from its own run by up to 1.8e-5 over its first 14 steps
# (l_shape/jax_self_distance in data/goldens/lmpc_lap_spread.json).  Read
# on such rows: 9.1e-6 on an H100, 9.4e-6 on the CPU
# (tools/racing_game_spread.py --replay-port)
RG_STEP_ATOL, RG_AFTER_LMPC_ATOL = 1e-6, 2e-5
RG_BENCH_STEPS, RG_FLEET_STEPS = 250, 100
# an f32 racing fleet's lane 0 against its single-lane run over the first
# step: the JAX bench fleet's lanes 0 and 1 leave their own runs by 2.8e-4
# and 5.6e-5 there, then by 2.3e-2 at the second step and up to 1.0 by the
# tenth, all LMPC steps (fleet_f32/lane_vs_alone_by_row in
# data/goldens/racing_game_spread.json): past the first step the distance is
# reported, not gated
RG_FLEET_FIRST_STEP_ATOL = 1e-3


def least_barrier(xc, s_coefs, ey_coefs, L):
    """The least superellipse barrier (ds/0.4)^6 + (dey/0.2)^6 between the
    ego's rows (row k at t = 0.1 k) and the cars on the prescribed
    polynomials, ds wrapped into half a lap: below 1 the footprints overlap
    (tests/test_fused.py:700-705)."""
    t = np.arange(len(xc)) * 0.1
    bars = []
    for cs, ce in zip(s_coefs, ey_coefs):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        bars.append(((ds / 0.4) ** 6 + (dey / 0.2) ** 6).min())
    return float(min(bars))


def corridor_runs(solves):
    """The IPM iterations each step's corridor batch ran (one K2 launch
    each): its slowest problem's count plus the iteration that found it
    done, at most 30."""
    return [min(int(s.corridor_iterations.max()) + 1, 30) for s in solves
            if s.corridor_iterations is not None]


def uncapped(solves, lane):
    """Per step, whether every solve of ``lane`` met its tolerance before
    its iteration cap: its LMPC or tracker solve, and its valid corridor
    branches."""
    return [not bool(s.capped[lane]) for s in solves]


def racing_game_phases(dev, spread):
    """Phase 14: the racing game on the card, every step one K1 launch and
    every overtake step one K2 launch per corridor IPM iteration: the two
    golden laps in f64 (``racing_game``), the JAX package's short runs from
    injected states replayed in f64 (``racing_game_injected``), the JAX
    bench's f32 lap from its first two starts (``racing_game_time``) and
    its f32 fleets of 8 and 64 lanes (``racing_game_fleet``).  ``spread`` is
    ``data/goldens/racing_game_spread.json``.  Returns the K1 and K2
    launches by path, the corridor batch sizes the 64-lane fleet gave K2
    (n_br x overtaking lanes), and two paths for the profile phase."""
    import torch

    from car_racing_tpu_torch.kernels import cholesky as k2, propagate as k1
    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import fixtures, params

    f32, f64 = torch.float32, torch.float64
    setups = {}

    def setup(layout, dtype, hold=0.15):
        """The rollout's arguments but the start, the linearization and
        the traffic, built once so that no timed call copies to the card."""
        if (layout, dtype, hold) not in setups:
            kw = dict(device=dev, dtype=dtype)
            sd = fixtures.load_lmpc_seed(layout, **kw)
            rg = dataclasses.replace(params.RacingGameParam.default(alpha=0.8, **kw),
                                     corridor_hold=hold)
            setups[layout, dtype, hold] = (
                (track.load_track(layout, width=1.0, **kw), dynamics.BicycleParams.default(**kw),
                 params.LMPCParam.default(**kw), rg, params.SystemParam.default(**kw)),
                (sd["ss1"], sd["q1"], sd["ss2"], sd["q2"], sd["u1"], sd["u2"], sd["valid1"],
                 sd["valid2"], sd["counter"]), sd,
                torch.as_tensor(np.genfromtxt(f"data/optimal_traj/xcurv_{layout}.csv",
                                              delimiter=","), **kw))
        return setups[layout, dtype, hold]

    def tensor(a, dtype):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev, dtype=dtype)

    def race(layout, dtype, xc0, xg0, traffic, n_steps, lin=None, hold=0.15, solves=None):
        """``rollout_racing_game`` (``rollout_racing_game_batch`` for a
        batch of starts) with the seed's columns; ``traffic`` and ``lin``
        are card tensors."""
        heads, cols, sd, opti = setup(layout, dtype, hold)
        lp, li = (sd["lin_points0"], sd["lin_input0"]) if lin is None else lin
        fn = fused.rollout_racing_game_batch if xc0.dim() == 2 else fused.rollout_racing_game
        return fn(*heads, xc0, xg0, *cols, lp, li, *traffic, opti, n_steps=n_steps,
                  solves=solves)

    k1_by, k2_by = {}, {}

    # ---- racing_game: the two golden laps, f64 ----------------------------------
    for layout, (n_steps, s_coef, ey_coef) in RG_LAPS.items():
        rec = spread["nudged"][layout]
        golden = np.loadtxt(f"data/goldens/racing_game_{layout}.csv", delimiter=",")
        _, _, sd, _ = setup(layout, f64)
        traffic = (tensor(s_coef, f64), tensor(ey_coef, f64))
        race(layout, f64, sd["xcurv0"], sd["xglob0"], traffic, 2)  # warm-up
        solves = []
        k1.launches = k2.launches = 0
        (xc, us, ot, lap_steps), ms = timed(lambda: race(layout, f64, sd["xcurv0"], sd["xglob0"],
                                                         traffic, n_steps, solves=solves))
        n_k1, n_k2 = k1.launches, k2.launches
        k1_by[f"racing_game_{layout}"], k2_by[f"racing_game_{layout}"] = n_k1, n_k2
        xc, us, ot = xc.cpu().numpy(), us.cpu().numpy(), ot.cpu().numpy()
        rows = xc[: lap_steps + 1]
        L = float(setup(layout, f64)[0][0].lap_length)
        held = rec["first_row_off_1e-2_min"]
        held_err = float(np.abs(rows[:held] - golden[:held]).max())
        m = min(len(rows), len(golden))
        err = np.abs(rows[:m] - golden[:m]).max(axis=1)
        off = np.nonzero(err > 1e-2)[0]
        runs = corridor_runs(solves)
        lo, hi = rec["lap_steps_range"]
        bar = least_barrier(rows, s_coef, ey_coef, L)
        ey = float(np.abs(rows[:, 5]).max())
        emit({"phase": "racing_game", "name": f"racing_game_{layout}", "dtype": "f64",
              "n_steps": n_steps, "lap_steps": lap_steps, "jax_nudged_lap_steps_range": [lo, hi],
              "golden_lap_steps": len(golden) - 1, "overtake_steps": int(ot[:lap_steps].sum()),
              "jax_nudged_overtake_steps_range": rec["overtake_steps_range"],
              "first_overtake": int(np.argmax(ot)) if ot.any() else None,
              "rows_held": held, "held_max_abs_err": held_err, "atol": 1e-2,
              "first_row_off_1e-2": int(off[0]) if len(off) else None,
              "least_barrier": bar, "jax_nudged_least_barrier_min": rec["least_barrier_min"],
              "max_abs_ey": ey, "max_abs_ey_bound": rec["max_abs_ey_max"] + 0.05,
              "ms": ms, "ms_per_step": ms / n_steps,
              "corridor_ipm_iterations": sum(runs), "k1_launches": n_k1, "k2_launches": n_k2,
              # a finished lap's steps are computed, as the JAX scan computes
              # them, but its state is frozen and K1 is not launched
              "k1_counts": "one launch a step while the lane is not done"})
        require(np.isfinite(rows).all() and np.isfinite(us).all(), f"racing_game {layout}: "
                "non-finite values")
        require(held_err <= 1e-2, f"racing_game {layout}: rows 0..{held - 1} off the golden by "
                                  f"{held_err} > 1e-2")
        require(lo <= lap_steps <= hi, f"racing_game {layout}: {lap_steps} lap steps outside "
                                       f"the nudged JAX laps' {lo}..{hi}")
        require(bar > 1.0, f"racing_game {layout}: collides (least barrier {bar})")
        require(ey <= rec["max_abs_ey_max"] + 0.05, f"racing_game {layout}: |ey| reaches {ey}")
        require(rows[-2, 4] < L <= rows[-1, 4], f"racing_game {layout}: lap end misplaced")
        require(n_k1 == lap_steps, f"racing_game {layout}: K1 launched {n_k1} times for "
                                   f"{lap_steps} lap steps")
        require(n_k2 == sum(runs) and (n_k2 > 0 or not ot.any()),
                f"racing_game {layout}: {n_k2} K2 launches for {sum(runs)} corridor iterations")

    # ---- racing_game_injected: the JAX package's short runs, f64 ----------------
    worst, held_runs, capped_runs, k2_runs, n_flags_equal = {}, [], [], 0, 0
    inj_ms = 0.0
    for i, r in enumerate(spread["injected"]):
        solves = []
        lin = (tensor(r["lin_points0"], f64), tensor(r["lin_input0"], f64))
        traffic = (tensor(r["s_coef"], f64), tensor(r["ey_coef"], f64))
        (xc, us, ot, _), ms = timed(lambda: race(
            r["layout"], f64, tensor(r["xcurv0"], f64), tensor(r["xglob0"], f64), traffic, 3,
            lin=lin, hold=r["corridor_hold"], solves=solves))
        inj_ms += ms
        xc, us, ot = xc.cpu().numpy(), us.cpu().numpy(), ot.cpu().numpy().astype(int)
        flags_equal = ot.tolist() == r["flags"]
        n_flags_equal += flags_equal
        k2_runs += any(s.corridor_iterations is not None for s in solves)
        err_x = np.abs(xc[1:] - np.array(r["xcurv"])[1:]).max(axis=1)
        err_u = np.abs(us - np.array(r["u"])).max(axis=1)
        conv = all(uncapped(solves, 0))
        bound = np.where(np.cumsum([len(s.lmpc_lanes) > 0 for s in solves]) > 0,
                         RG_AFTER_LMPC_ATOL, RG_STEP_ATOL)
        key = f"{r['scenario']}/{r['kind']}"
        dist = float(max(err_x.max(), err_u.max()))
        run = {"run": i, "scenario": key, "k": r["k"], "max_abs_err": dist}
        if conv:
            share = float(max((err_x / bound).max(), (err_u / bound).max()))
            w = worst.setdefault(key, {"runs": 0, "max_abs_err": 0.0, "max_share_of_bound": 0.0})
            w["runs"] += 1
            w["max_abs_err"] = max(w["max_abs_err"], dist)
            w["max_share_of_bound"] = max(w["max_share_of_bound"], share)
            held_runs.append({**run, "share_of_bound": share,
                              "max_abs_err_by_step": np.maximum(err_x, err_u).tolist(),
                              "bound_by_step": bound.tolist()})
        else:
            capped_runs.append(run)
        require(np.isfinite(xc).all() and np.isfinite(us).all(), f"racing_game_injected {i}: "
                                                                 "non-finite values")
        require(flags_equal, f"racing_game_injected {i} ({key}, k = {r['k']}): flags "
                             f"{ot.tolist()} != the JAX run's {r['flags']}")
        require(not conv or ((err_x <= bound).all() and (err_u <= bound).all()),
                f"racing_game_injected {i} ({key}, k = {r['k']}): off the JAX run by "
                f"{err_x.tolist()} / {err_u.tolist()} beyond {bound.tolist()}")
    emit({"phase": "racing_game_injected", "dtype": "f64", "runs": len(spread["injected"]),
          "flags_equal": n_flags_equal, "k2_path_runs": k2_runs, "held_by_kind": worst,
          "held_closest_to_bound": sorted(held_runs, key=lambda q: -q["share_of_bound"])[:5],
          "capped_runs": len(capped_runs),
          "capped_max_abs_err": max((q["max_abs_err"] for q in capped_runs), default=None),
          "capped_worst": sorted(capped_runs, key=lambda q: -q["max_abs_err"])[:5],
          "step_atol": RG_STEP_ATOL,
          "after_lmpc_atol": RG_AFTER_LMPC_ATOL, "ms_per_run": inj_ms / len(spread["injected"])})

    # ---- racing_game_time: the bench's f32 lap, two starts ---------------------
    bench = spread["bench_f32"]
    s_coef, ey_coef = RG_LAPS["l_shape"][1:]
    traffic32 = (tensor(s_coef, f32), tensor(ey_coef, f32))
    _, _, sd32, _ = setup("l_shape", f32)
    L = float(setup("l_shape", f32)[0][0].lap_length)
    # the first two of the bench's starts (the script's time limit)
    starts = [tensor(st["xcurv0"], f32) for st in bench["starts"][:2]]
    race("l_shape", f32, starts[0], sd32["xglob0"], traffic32, 3)  # warm-up
    rows_out, samples = [], []
    for i, x0 in enumerate(starts):
        solves = []
        k1.launches = k2.launches = 0
        (xc, us, ot, lap_steps), ms = timed(lambda: race("l_shape", f32, x0, sd32["xglob0"],
                                                         traffic32, RG_BENCH_STEPS, solves=solves))
        n_k1, n_k2 = k1.launches, k2.launches
        xc, us, ot = xc.cpu().numpy().astype(np.float64), us.cpu().numpy(), ot.cpu().numpy()
        rows = xc[: lap_steps + 1]
        samples.append(ms / RG_BENCH_STEPS)
        row = {"start": i, "ms_per_step": samples[-1], "lap_steps": lap_steps, "overtake_steps": int(ot[:lap_steps].sum()),
               "max_abs_ey": float(np.abs(rows[:, 5]).max()),
               "least_barrier": least_barrier(rows, s_coef, ey_coef, L),
               "corridor_ipm_iterations": sum(corridor_runs(solves)),
               "jax_f32": {k: bench["starts"][i][k] for k in ("lap_steps", "overtake_steps",
                                                              "max_abs_ey", "least_barrier")},
               "k1_launches": n_k1, "k2_launches": n_k2}
        rows_out.append(row)
        require(np.isfinite(rows).all() and np.isfinite(us).all(), f"racing_game_time {i}: "
                                                                   "non-finite values")
        require(0 < lap_steps < RG_BENCH_STEPS, f"racing_game_time {i}: the lap does not end "
                                                f"within {RG_BENCH_STEPS} steps")
        require(row["least_barrier"] > 1.0, f"racing_game_time {i}: collides "
                                            f"({row['least_barrier']})")
        require(row["max_abs_ey"] < bench["max_abs_ey_max"] + 0.05,
                f"racing_game_time {i}: |ey| reaches {row['max_abs_ey']}")
        require(n_k1 == lap_steps, f"racing_game_time {i}: K1 launched {n_k1} times")
    emit({"phase": "racing_game_time", "dtype": "f32", "n_steps": RG_BENCH_STEPS,
          # the bench's definition: a rollout's time over its 250 steps,
          # the steps after the lap ends computed too
          "starts": rows_out, "racing_game_step_latency_p50_fused":
          float(np.percentile(samples, 50)), "max_ms_per_step": max(samples),
          "n_samples": len(samples)})

    # ---- racing_game_fleet: the bench's f32 fleets of 8 and 64 lanes -------------
    fleet_rng = np.random.default_rng(6)
    fleet_paths, k2_shapes = {}, [3]
    for B in (8, 64):
        pert = np.zeros((B, 6))
        pert[:, 5] = fleet_rng.normal(0, 0.01, B)
        xc0 = (sd32["xcurv0"] + tensor(pert, f32)).contiguous()
        xg0 = sd32["xglob0"].expand(B, 6).contiguous()
        race("l_shape", f32, xc0, xg0, traffic32, 2)  # warm-up
        solves = []
        k1.launches = k2.launches = 0
        (xc, us, ot, lap_steps), ms = timed(lambda: race("l_shape", f32, xc0, xg0, traffic32,
                                                         RG_FLEET_STEPS, solves=solves))
        n_k1, n_k2 = k1.launches, k2.launches
        k1_by[f"racing_fleet{B}"], k2_by[f"racing_fleet{B}"] = n_k1, n_k2
        xc, ot = xc.cpu().numpy().astype(np.float64), ot.cpu().numpy()
        bars = [least_barrier(xc[b], s_coef, ey_coef, L) for b in range(B)]
        split = sum(1 for s in solves if len(s.lmpc_lanes) and len(s.overtake_lanes))
        b_ot = [len(s.overtake_lanes) for s in solves if len(s.overtake_lanes)]
        if B == 64 and b_ot:
            k2_shapes = [3 * n for n in b_ot]
        # lane 0 alone for 20 steps
        alone_solves = []
        xs, _, _, _ = race("l_shape", f32, xc0[0], xg0[0], traffic32, 20, solves=alone_solves)
        conv = [a and b for a, b in zip(uncapped(solves, 0)[:20], uncapped(alone_solves, 0))]
        first = conv.index(False) if False in conv else 20
        xs = xs.cpu().numpy().astype(np.float64)
        lane0 = np.abs(xc[0, : len(xs)] - xs[: xc.shape[1]]).max(axis=1)
        emit({"phase": "racing_game_fleet", "B": B, "n_steps": RG_FLEET_STEPS, "dtype": "f32",
              "ms": ms, "ms_per_step": ms / RG_FLEET_STEPS,
              f"racing_game_fleet{'64' if B == 64 else ''}_lane_steps_per_s":
              B * RG_FLEET_STEPS / (ms / 1e3),
              "overtake_lane_steps": int(ot.sum()), "split_step_share": split / RG_FLEET_STEPS,
              "overtaking_lanes_median": float(np.median(b_ot)) if b_ot else 0.0,
              "max_abs_ey": float(np.abs(xc[..., 5]).max()), "least_barrier_min": min(bars),
              "corridor_ipm_iterations": sum(corridor_runs(solves)),
              "lane0_first_capped_step": first, "lane0_vs_single_by_row": lane0.tolist(),
              "lane0_first_step_bound": RG_FLEET_FIRST_STEP_ATOL,
              "jax_f32_lane0_vs_single_by_row":
              spread["fleet_f32"]["lane_vs_alone_by_row"]["0"],
              "k1_launches": n_k1, "k2_launches": n_k2,
              **({"jax_f32_fleet8": {k: spread["fleet_f32"][k] for k in
                                     ("max_abs_ey", "collisions")}} if B == 8 else {})})
        require(np.isfinite(xc).all() and bool(us.isfinite().all()), f"racing_game_fleet {B}: "
                                                                     "non-finite values")
        require(min(bars) > 1.0, f"racing_game_fleet {B}: a lane collides ({min(bars)})")
        require(n_k1 == RG_FLEET_STEPS, f"racing_game_fleet {B}: K1 launched {n_k1} times")
        require(n_k2 > 0 and n_k2 == sum(corridor_runs(solves)),
                f"racing_game_fleet {B}: {n_k2} K2 launches")
        require(lane0[1] <= RG_FLEET_FIRST_STEP_ATOL,
                f"racing_game_fleet {B}: lane 0's first step differs from its single-lane "
                f"rollout's by {lane0[1]}")
        fleet_paths[B] = (xc0, xg0)

    # five steps around an overtake: the injected run at the l_shape golden's
    # first overtake, and five steps of the 64-lane fleet
    r0 = next(r for r in spread["injected"] if r["scenario"] == "l_shape"
              and r["kind"] == "overtake")
    lin0 = (tensor(r0["lin_points0"], f64), tensor(r0["lin_input0"], f64))
    traffic0 = (tensor(r0["s_coef"], f64), tensor(r0["ey_coef"], f64))
    x00, xg00 = tensor(r0["xcurv0"], f64), tensor(r0["xglob0"], f64)
    xc64, xg64 = fleet_paths[64]
    paths = {"racing_game_overtake_5_steps": lambda: race("l_shape", f64, x00, xg00, traffic0, 5,
                                                          lin=lin0),
             "racing_fleet64_5_steps": lambda: race("l_shape", f32, xc64, xg64, traffic32, 5)}
    return k1_by, k2_by, k2_shapes, paths


# the tracking simulator's gates (tests/test_sim_tracking.py): the second
# half's mean vx near the 0.8 target, |ey| inside the track, and for MPC-LTI
# |ey| small on average and the inputs inside their box
SIM_VX_TOL = {"pid": 0.1, "lqr": 0.15, "mpc-lti": 0.1}
SIM_STEPS = 900  # apps/control_test.py's sim_time of 90 s
CROSSOVER_HORIZONS, CROSSOVER_REPS = (10, 20, 50, 100, 200), (10, 10, 5, 3, 2)
# the longest horizon at which the f32 dense condensed solve converges: from
# N = 100 its KKT residual stays at 1e6 and above after 30 iterations, in the
# JAX package's solve as in the port's (tests/test_torch_riccati_kkt.py)
CROSSOVER_DENSE_F32_MAX_N = 50


def tf32_pin(dev):
    """Phase 15's ``tf32_pin``: TF32 switched on outside the port, the f32
    MPC-LTI fleet (256 lanes, 10 steps) and MPC-CBF (10 steps) must come out
    bit-equal to their runs with TF32 off.  The control: a product outside
    the port must move under TF32, and so must both rollouts when
    ``ipm._highp`` cannot set the precision; otherwise the bit-equality
    would test nothing."""
    import torch

    from car_racing_tpu_torch.models import controllers
    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import params

    f32 = torch.float32

    def fleet_run():
        fl = (track.load_track("l_shape", width=0.8, device=dev, dtype=f32),
              dynamics.BicycleParams.default(device=dev, dtype=f32),
              params.MPCParam.default(vt=0.8, device=dev, dtype=f32),
              params.SystemParam.default(device=dev, dtype=f32),
              controllers.target_state(0.8, 0.0, device=dev, dtype=f32))
        xc0 = torch.as_tensor(np.array([0.1, 0, 0, 0, 0, 0]) + 0.05 * np.random.default_rng(
            0).standard_normal((256, 6)), dtype=f32, device=dev)
        return fused.rollout_mpc_tracking_batch(*fl, xc0, torch.zeros_like(xc0), n_steps=10)

    def cbf_run():
        kw32 = dict(device=dev, dtype=f32)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), **kw32)
        x0 = t(np.array([0.3, 0, 0, 0, 0, 0])
               + 0.02 * np.random.default_rng(1).standard_normal((20, 6))[0])
        return fused.rollout_mpccbf(
            track.load_track("l_shape", width=1.0, **kw32), dynamics.BicycleParams.default(**kw32),
            params.MPCCBFParam.default(vt=0.8, **kw32), params.SystemParam.default(**kw32),
            t(CONTROLLER_TARGET), x0, t(np.zeros(6)), t(CBF_S_COEF), t(CBF_EY_COEF),
            torch.tensor(CBF_ACTIVE, device=dev), t(CBF_HALFS), t(HALF), n_steps=10,
            warm_iters=20)

    rng = np.random.default_rng(7)
    a_, b_ = (torch.as_tensor(rng.standard_normal((256, 256)), dtype=f32, device=dev)
              for _ in range(2))
    outs = {}
    for setting in ("highest", "high"):
        torch.set_float32_matmul_precision(setting)
        outs[setting] = {"matmul": a_ @ b_, "fleet": fleet_run(), "mpccbf": cbf_run()}
        after = torch.get_float32_matmul_precision()
        require(after == setting, f"tf32_pin: the port left the precision at {after}, not {setting}")
    # the control: TF32 on and the pin disarmed (``_highp`` sets the
    # precision through this function)
    set_precision = torch.set_float32_matmul_precision
    torch.set_float32_matmul_precision = lambda precision: None
    try:
        outs["unpinned"] = {"fleet": fleet_run(), "mpccbf": cbf_run()}
    finally:
        torch.set_float32_matmul_precision = set_precision
    torch.set_float32_matmul_precision("highest")

    def compare(x_outs, y_outs):
        pairs = list(zip(x_outs, y_outs))
        return {"bit_equal": all(torch.equal(x, y) for x, y in pairs),
                "max_abs_diff": max(float((x.double() - y.double()).abs().max())
                                    for x, y in pairs)}

    diffs = {name: compare(outs["highest"][name], outs["high"][name])
             for name in ("fleet", "mpccbf")}
    controls = {name: compare(outs["highest"][name], outs["unpinned"][name])
                for name in ("fleet", "mpccbf")}
    outside = float((outs["high"]["matmul"] - outs["highest"]["matmul"]).abs().max())
    emit({"phase": "tf32_pin", "fleet_B": 256, "n_steps": 10, "dtype": "f32",
          # a product outside the port: whether TF32 was really on there
          "tf32_outside_max_abs_diff": outside, **diffs,
          "unpinned_max_abs_diff": {name: d["max_abs_diff"] for name, d in controls.items()}})
    require(outside > 0, "tf32_pin: a product outside the port did not move with TF32 on")
    for name, d in diffs.items():
        require(not controls[name]["bit_equal"],
                f"tf32_pin: {name} did not move with TF32 on and the pin disarmed")
        require(d["bit_equal"], f"tf32_pin: {name} moved by {d['max_abs_diff']} with TF32 on "
                                "outside the port")


def simulator_phases(dev):
    """Phase 15: the offboard simulator's tracking path on the card, f64
    unless stated, every simulator step one K1 launch; and the Riccati KKT
    path of MPC-LTI.  :func:`tf32_pin`: TF32 on outside the port, the f32
    fleet and MPC-CBF bit-equal to their runs with TF32 off; ``sim_pid`` and
    ``sim_mpc``: the PID and MPC-LTI host loops against their goldens and
    the fused rollout; ``sim_tracking``: ``control_test.tracking`` for pid,
    lqr and mpc-lti (900 steps each) and a noisy PID run; ``riccati_kkt``:
    the three KKT paths on 256 states; ``crossover``: their solve times by
    horizon.  Returns the K1 launches by path and two paths for the
    profile phase."""
    import torch

    from car_racing_tpu_torch.apps import common, control_test
    from car_racing_tpu_torch.kernels import propagate as k1
    from car_racing_tpu_torch.models import controllers
    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.racing import fused, policies
    from car_racing_tpu_torch.utils import crossover, params
    from car_racing_tpu_torch.utils.profiling import GLOBAL_TIMER

    f32, f64 = torch.float32, torch.float64
    kw = dict(device=dev, dtype=f64)
    launches = {}

    tf32_pin(dev)

    def sim_run(policy, n_steps, zero_noise=True, seed=0):
        tr = common.build_track("l_shape", width=0.8, device=dev)
        ego = common.build_ego(tr, zero_noise=zero_noise, seed=seed)
        sim = common.build_sim(tr)
        sim.add_vehicle(ego)
        common.attach_policy(ego, sim, policy)
        sim.sim(sim_time=n_steps * 0.1)
        return sim, ego

    mpc_policy = lambda: policies.MPCTracking(params.MPCParam.default(vt=0.8, **kw),
                                              params.SystemParam.default(**kw))

    # ---- sim_pid: the host PID loop of the pid_l_shape golden ----------------
    golden = np.loadtxt("data/goldens/pid_l_shape.csv", delimiter=",")
    k1.launches = 0
    (_, ego), ms = timed(lambda: sim_run(policies.PIDTracking(vt=0.8), 200))
    launches["sim_pid"] = k1.launches
    log = np.asarray(ego.xcurv_log)
    err = float(np.abs(log - golden).max()) if log.shape == golden.shape else float("nan")
    emit({"phase": "sim_pid", "dtype": "f64", "n_steps": 200, "ms_per_step": ms / 200,
          "max_abs_err": err, "atol": 1e-8, "k1_launches": launches["sim_pid"]})
    require(err <= 1e-8, f"sim_pid: {err} off pid_l_shape")
    require(launches["sim_pid"] == 200, f"sim_pid: K1 launched {launches['sim_pid']} times")

    # ---- sim_mpc: the host MPC-LTI loop against the fused rollout ------------
    golden = np.loadtxt("data/goldens/mpc_lti_l_shape.csv", delimiter=",")
    k1.launches = 0
    (_, ego), ms = timed(lambda: sim_run(mpc_policy(), 100))
    launches["sim_mpc"] = k1.launches
    log = np.asarray(ego.xcurv_log)
    zeros = torch.zeros(6, **kw)
    xc, _ = fused.rollout_mpc_tracking(
        track.load_track("l_shape", width=0.8, **kw), dynamics.BicycleParams.default(**kw),
        params.MPCParam.default(vt=0.8, **kw), params.SystemParam.default(**kw),
        controllers.target_state(0.8, 0.0, **kw), zeros, zeros, n_steps=60)
    fused_err = float(np.abs(log[:60] - xc[1:].cpu().numpy()).max())
    golden_err = float(np.abs(log[:100] - golden[1:101]).max())
    emit({"phase": "sim_mpc", "dtype": "f64", "n_steps": 100, "ms_per_step": ms / 100,
          "fused_60_max_abs": fused_err, "fused_atol": 1e-9, "golden_100_max_abs": golden_err,
          "golden_atol": 1e-4, "k1_launches": launches["sim_mpc"]})
    require(fused_err <= 1e-9, f"sim_mpc: {fused_err} off the fused rollout")
    require(golden_err <= 1e-4, f"sim_mpc: {golden_err} off mpc_lti_l_shape")
    require(launches["sim_mpc"] == 100, f"sim_mpc: K1 launched {launches['sim_mpc']} times")

    # ---- sim_tracking: the control_test driver, 90 s of each policy -----------
    rows = []
    for policy in ("pid", "lqr", "mpc-lti"):
        GLOBAL_TIMER.samples.clear()
        k1.launches = 0
        sim, ms = timed(lambda: control_test.tracking(
            {"ctrl_policy": policy, "simulation": True, "zero_noise": True,
             "track_layout": "l_shape", "device": str(dev)}))
        n_k1 = k1.launches
        launches[f"sim_tracking_{policy}"] = n_k1
        ego = sim.vehicles["ego"]
        traj = sim.full_trajectory("ego")
        tail = traj[len(traj) // 2:]
        u = np.asarray([v for lap in ego.inputs for v in lap] + list(ego.lap_inputs))
        lat = GLOBAL_TIMER.summary()["mpc_lti" if policy == "mpc-lti" else policy]
        row = {"policy": policy, "n_steps": SIM_STEPS, "laps": ego.laps,
               "ms_per_sim_step": ms / SIM_STEPS, "solve_p50_ms": lat["p50_ms"],
               "solve_p99_ms": lat["p99_ms"], "solve_max_ms": lat["max_ms"],
               "n_samples": lat["count"], "tail_mean_vx": float(tail[:, 0].mean()),
               "tail_max_abs_ey": float(np.abs(tail[:, 5]).max()),
               "tail_mean_abs_ey": float(np.abs(tail[:, 5]).mean()),
               "max_abs_u": np.abs(u).max(axis=0).tolist(), "k1_launches": n_k1}
        rows.append(row)
        require(np.isfinite(traj).all() and np.isfinite(u).all(), f"sim_tracking {policy}: "
                "non-finite state or input")
        require(abs(row["tail_mean_vx"] - 0.8) < SIM_VX_TOL[policy],
                f"sim_tracking {policy}: tail speed {row['tail_mean_vx']}")
        require(row["tail_max_abs_ey"] < 0.8, f"sim_tracking {policy}: leaves the track")
        require(ego.laps >= 3, f"sim_tracking {policy}: {ego.laps} laps in {SIM_STEPS} steps")
        require(n_k1 == SIM_STEPS and lat["count"] == SIM_STEPS,
                f"sim_tracking {policy}: {n_k1} K1 launches, {lat['count']} solves")
        if policy == "mpc-lti":
            require(row["tail_mean_abs_ey"] < 0.15, f"sim_tracking mpc-lti: mean |ey| "
                    f"{row['tail_mean_abs_ey']}")
            require(row["max_abs_u"][0] <= 0.5 + 1e-6 and row["max_abs_u"][1] <= 1.0 + 1e-6,
                    f"sim_tracking mpc-lti: inputs {row['max_abs_u']} outside their box")

    # one noisy PID run: every noise increment inside its clip
    real_noise, incs = dynamics.process_noise, []

    def recorded(gen, xc):
        out = real_noise(gen, xc)
        incs.append((out - xc)[..., :3])
        return out

    dynamics.process_noise = recorded
    try:
        k1.launches = 0
        _, ego = sim_run(policies.PIDTracking(vt=0.8), 200, zero_noise=False, seed=0)
        launches["sim_pid_noisy"] = k1.launches
    finally:
        dynamics.process_noise = real_noise
    inc = torch.cat(incs).cpu().numpy()
    half_clip = 0.5 * np.asarray(dynamics.NOISE_CLIP)
    emit({"phase": "sim_tracking", "layout": "l_shape", "dtype": "f64", "policies": rows,
          "noisy_pid": {"seed": 0, "n_steps": 200, "draws": len(inc),
                        "max_abs_increment": np.abs(inc).max(axis=0).tolist(),
                        "half_clip": half_clip.tolist(), "increment_std": inc.std(axis=0).tolist(),
                        "final_s": float(ego.xcurv[4]), "laps": ego.laps,
                        "k1_launches": launches["sim_pid_noisy"]}})
    require(len(inc) == 200 and (np.abs(inc) <= half_clip * (1 + 1e-9)).all(),
            "sim_tracking: a noise increment leaves its clip")
    require(np.isfinite(ego.xcurv).all(), "sim_tracking: the noisy run is not finite")

    # ---- riccati_kkt: the three KKT paths on 256 states, N = 10 --------------
    x_np = (np.array([0.5, 0, 0, 0, 1, 0.1])
            + 0.1 * np.random.default_rng(1).standard_normal((256, 6)))
    kkt_rows = {}
    for dtype, name in ((f64, "f64"), (f32, "f32")):
        kd = dict(device=dev, dtype=dtype)
        p = params.MPCParam.default(vt=0.8, **kd)
        sysp = params.SystemParam.default(**kd)
        x, xt = torch.as_tensor(x_np, **kd), controllers.target_state(0.8, 0.0, **kd)
        width = torch.tensor(0.8, **kd)
        res = {}
        for kkt in ("dense", "riccati", "riccati_parallel"):
            solves = []
            (_, U, _), ms = timed(lambda: controllers.mpc_lti(
                x, xt, p, sysp, width, return_traj=True, kkt=kkt, solves=solves))
            its = solves[0].iterations.cpu().numpy()
            res[kkt] = (U.double().cpu().numpy(), solves[0].converged.cpu().numpy(), its, ms)
        conv_all = res["dense"][1] & res["riccati"][1] & res["riccati_parallel"][1]
        same_flags = all(np.array_equal(res["dense"][1], res[k][1])
                         for k in ("riccati", "riccati_parallel"))
        u_err = {k: float(np.abs(res[k][0] - res["dense"][0])[conv_all].max(initial=0.0))
                 for k in ("riccati", "riccati_parallel")}
        kkt_rows[name] = {
            "converged": {k: int(v[1].sum()) for k, v in res.items()}, "same_flags": same_flags,
            "iterations_mean": {k: float(v[2].mean()) for k, v in res.items()},
            "iterations_max": {k: int(v[2].max()) for k, v in res.items()},
            "ms": {k: v[3] for k, v in res.items()},
            "u_max_abs_vs_dense_where_converged": u_err}
        bound = 1e-6 if dtype == f64 else 1e-3
        require(same_flags, f"riccati_kkt {name}: converged flags differ from the dense solve's")
        require(all(np.isfinite(v[0]).all() for v in res.values()), f"riccati_kkt {name}: "
                "non-finite U")
        require(max(u_err.values()) <= bound, f"riccati_kkt {name}: U {u_err} off the dense "
                f"solve (bound {bound})")
    emit({"phase": "riccati_kkt", "B": 256, "N": 10, **kkt_rows})

    # ---- crossover: one-state solve times by horizon, f32 ------------------
    rows = crossover.measure(CROSSOVER_HORIZONS, CROSSOVER_REPS, device=dev)
    emit({"phase": "crossover", "dtype": "f32", "iters": 30, "rows": rows})
    for r in rows:
        gated = [k for k in crossover.KKTS if k != "dense" or r["N"] <= CROSSOVER_DENSE_F32_MAX_N]
        require(all(r[f"{k}_finite"] for k in crossover.KKTS)
                and all(r[f"{k}_converged"] == r["n_samples"] for k in gated),
                f"crossover N={r['N']}: a solve is not finite or did not converge: {r}")

    # ---- the profile phase's paths -------------------------------------------
    kd = dict(device=dev, dtype=f32)
    p50 = params.MPCParam.default(vt=0.8, **kd)
    p50 = params.MPCParam(A=p50.A, B=p50.B, Q=p50.Q, R=p50.R, vt=p50.vt, eyt=p50.eyt,
                          num_horizon=50)
    x50 = torch.as_tensor(x_np[:1], **kd)
    paths = {
        "sim_mpc_20_steps": lambda: sim_run(mpc_policy(), 20),
        "riccati_kkt_N50": lambda: controllers.mpc_lti(
            x50, controllers.target_state(0.8, 0.0, **kd), p50, params.SystemParam.default(**kd),
            torch.tensor(0.8, **kd), kkt="riccati"),
    }
    return launches, paths


def run():
    import torch

    from car_racing_tpu_torch.kernels import build, cholesky as k2, cholesky_multi as k3
    from car_racing_tpu_torch.kernels import propagate as k1
    from car_racing_tpu_torch.models import controllers
    from car_racing_tpu_torch.ops import dynamics, ipm, lmpc_learning, track
    from car_racing_tpu_torch.planning import overtake
    from car_racing_tpu_torch.racing import fused, protocol
    from car_racing_tpu_torch.utils import fixtures, params

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # full-precision float32 products outside the port too (TF32 keeps ~3
    # digits); the port's solvers and rollouts pin it themselves (tf32_pin)
    torch.set_float32_matmul_precision("highest")
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(reports),
          "ptxas": {n: build.ptxas_summary(r) for n, r in reports.items()}})

    def setup(layout, width, dtype):
        kw = dict(device=dev, dtype=dtype)
        return (track.load_track(layout, width=width, **kw),
                dynamics.BicycleParams.default(**kw),
                params.MPCParam.default(vt=0.8, **kw),
                params.SystemParam.default(**kw),
                controllers.target_state(0.8, 0.0, **kw))

    # ---- 2. K1 against its plain loop ---------------------------------------
    def period_states(rng, B, negative_vx, dtype):
        if negative_vx:
            xc = np.array([-0.15, 0.02, 0.05, 0.01, 3.0, 0.05]) + rng.standard_normal(
                (B, 6)) * np.array([0.1, 0.02, 0.05, 0.05, 2.0, 0.1])
            xc[:, 0] = -np.abs(xc[:, 0])
            u = np.tile([0.02, -0.5], (B, 1))
        else:
            xc = np.array([0.8, 0.01, 0.02, 0.01, 5.0, 0.05]) + 0.3 * rng.standard_normal(
                (B, 6)) * np.array([1, 0.1, 0.1, 0.1, 10, 1])
            u = np.array([0.05, 0.3]) + 0.1 * rng.standard_normal((B, 2))
        xg = rng.standard_normal((B, 6))
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev).contiguous()
        return t(xg), t(xc), t(u)

    k1_err = {}
    rng = np.random.default_rng(0)
    for dtype, name in ((f32, "f32"), (f64, "f64")):
        tr = track.load_track("l_shape", width=1.0, device=dev, dtype=dtype)
        bike = dynamics.BicycleParams.default(device=dev, dtype=dtype)
        # bounds: the JAX package's kernel tests (tests/test_pallas_kernels.py)
        # in f32; 1e-9 in f64
        for case, control_dt, bound in (("nominal", 0.1, 2e-6 if dtype == f32 else 1e-9),
                                        ("negative_vx", 0.02, 5e-5 if dtype == f32 else 1e-9)):
            xg, xc, u = period_states(rng, 256, case == "negative_vx", dtype)
            got = k1.propagate(tr, bike, xg, xc, u, control_dt=control_dt)
            want = k1.plain(tr, bike, xg, xc, u, control_dt=control_dt)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            finite = all(bool(g.isfinite().all()) for g in got)
            k1_err[(name, f"{case}_B256")] = err
            emit({"phase": "k1_check", "dtype": name, "case": case, "B": 256,
                  "control_dt": control_dt, "max_abs_err": err, "bound": bound})
            require(finite and err <= bound, f"K1 {name} {case}: max_abs_err {err} > {bound}")

    # ---- 3. K2 against its plain version ------------------------------------
    def spd_batch(rng, B, n, dtype):
        L = rng.standard_normal((B, n, n))
        A = L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n)
        b = rng.standard_normal((B, n))
        return (torch.as_tensor(A, dtype=dtype, device=dev),
                torch.as_tensor(b, dtype=dtype, device=dev))

    def check_solve(kernel, fn, plain, A, rhs, name, bound, errs, key):
        got, want = fn(A, rhs), plain(A, rhs)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        errs[key] = abs_err
        Bn, n = A.shape[0], A.shape[1]
        r = rhs.shape[2] if rhs.dim() == 3 else 1
        plan = k2.plan(n, r, A.element_size())
        emit({"phase": f"{kernel.lower()}_check", "dtype": name, "B": Bn, "n": n, "r": r,
              "team": plan.team, "per_block": plan.per_block,
              "memory": "shared" if plan.shared else "device", "shared_bytes": plan.shared_bytes,
              "max_abs_err": abs_err, "max_rel_err": rel, "bound_rel": bound})
        require(bool(got.isfinite().all()) and rel <= bound,
                f"{kernel} {name} B={Bn} n={n} r={r}: relative error {rel} > {bound}")

    bounds = {"f32": 1e-4, "f64": 1e-8}
    k2_err = {}
    for dtype, name in ((f32, "f32"), (f64, "f64")):
        for B in (256, 130):
            A, b = spd_batch(rng, B, 20, dtype)
            check_solve("K2", k2.solve, k2.plain, A, b, name, bounds[name], k2_err, (name, B))

    # ---- 4. K3 against its plain version (K2's bounds) ------------------------
    def spd_multi(rng, B, n, r, dtype):
        A, _ = spd_batch(rng, B, n, dtype)
        return A, torch.as_tensor(rng.standard_normal((B, n, r)), dtype=dtype, device=dev)

    k3_err = {}
    for dtype, name in ((f32, "f32"), (f64, "f64")):
        for n, r in ((68, 8), (20, 5)):
            A, Bm = spd_multi(rng, 256, n, r, dtype)
            check_solve("K3", k3.solve_multi, k3.plain, A, Bm, name, bounds[name], k3_err,
                        (name, n))

    # past the shared memory a block has without opting in (n = 100, 130) and
    # past what it can opt in to (n = 180: device memory)
    big = np.random.default_rng(10)
    for dtype, name, n in ((f64, "f64", 100), (f64, "f64", 180), (f32, "f32", 130)):
        A, b = spd_batch(big, 64, n, dtype)
        check_solve("K2", k2.solve, k2.plain, A, b, name, bounds[name], k2_err, (name, 64, n))
    for n in (100, 180):
        A, Bm = spd_multi(big, 64, n, 8, f64)
        check_solve("K3", k3.solve_multi, k3.plain, A, Bm, "f64", bounds["f64"], k3_err,
                    ("f64", n))

    # ---- 5. MPC-LTI goldens on the card, f64, through K1 -----------------------
    for layout, width, n_steps in (("l_shape", 0.8, 100), ("goggle", 1.0, 150),
                                   ("m_shape", 1.0, 150)):
        golden = np.loadtxt(f"data/goldens/mpc_lti_{layout}.csv", delimiter=",")
        zeros = torch.zeros(6, dtype=f64, device=dev)
        k1.launches = 0
        xc, _ = fused.rollout_mpc_tracking(*setup(layout, width, f64), zeros, zeros,
                                           n_steps=n_steps)
        xc = xc.cpu().numpy()
        launches = k1.launches
        err = float(np.abs(xc - golden).max()) if xc.shape == golden.shape else float("nan")
        emit({"phase": "golden", "name": f"mpc_lti_{layout}", "shape": list(xc.shape),
              "max_abs_err": err, "atol": 1e-4, "k1_launches": launches})
        require(xc.shape == golden.shape, f"{layout}: shape {xc.shape} != {golden.shape}")
        require(err <= 1e-4, f"{layout}: golden max_abs_err {err} > 1e-4")
        require(launches == n_steps, f"{layout}: K1 launched {launches} times, not {n_steps}")

    # ---- 6. LMPC learning laps, f64, through K1 --------------------------------
    def lmpc_lap(layout, n_steps, dtype, solves):
        kw = dict(device=dev, dtype=dtype)
        sd = fixtures.load_lmpc_seed(layout, **kw)
        tr = track.load_track(layout, width=1.0, **kw)
        out = fused.rollout_lmpc_lap(
            tr, dynamics.BicycleParams.default(**kw),
            params.LMPCParam.default(**kw), params.SystemParam.default(**kw),
            sd["xcurv0"], sd["xglob0"], sd["ss1"], sd["q1"], sd["ss2"], sd["q2"], sd["u1"],
            sd["u2"], sd["valid1"], sd["valid2"], sd["counter"], sd["lin_points0"],
            sd["lin_input0"], n_steps=n_steps, solves=solves)
        return out, sd["counter"], tr.lap_length.item()

    def lap_stats(solves, lap_steps):
        conv = np.array([bool(s.converged[0]) for s in solves])
        its = np.array([int(s.iterations[0]) for s in solves])
        res = np.array([float(s.kkt_res[0]) for s in solves])
        return conv, {"iters_median": float(np.median(its[:lap_steps])),
                      "iters_max": int(its[:lap_steps].max()),
                      "capped": int((its[:lap_steps] >= 40).sum()),
                      "unconverged": int((~conv[:lap_steps]).sum()),
                      "kkt_res_max": float(res[:lap_steps].max())}

    # How far the JAX lap itself leaves its golden when its initial vx is
    # nudged by 1 to 6 ulps (tools/lmpc_lap_spread.py): past its first
    # solve that stops at the iteration cap the golden is reproduced only
    # by the JAX package's own arithmetic.  The card's lap is held to the
    # golden up to the earliest row a nudged JAX lap leaves it, and its lap
    # steps to no further from the golden's than the furthest nudged lap.
    with open("data/goldens/lmpc_lap_spread.json") as f:
        lap_spread = json.load(f)
    golden_laps, lap_runs = {}, {}
    for layout, n_steps in LMPC_LAPS:
        golden = np.loadtxt(f"data/goldens/lmpc_lap_{layout}.csv", delimiter=",")
        ref = lap_spread[f"{layout}/jax"]
        golden_laps[layout] = golden
        held = min(ref["nudged_first_row_off"])
        steps_dev = max(abs(n - ref["golden_lap_steps"]) for n in ref["nudged_lap_steps"])
        solves = []
        k1.launches = 0
        (xc, us, dones, lap_steps), counter, L = lmpc_lap(layout, n_steps, f64, solves)
        xc = xc.cpu().numpy()
        lap_runs[layout] = (xc, us.cpu().numpy(), lap_steps)
        launches = k1.launches
        conv, stats = lap_stats(solves, lap_steps)
        first_capped = int(np.argmin(conv)) if not conv.all() else n_steps
        m = min(lap_steps + 1, len(golden))
        err = np.abs(xc[:m] - golden[:m]).max(axis=1)
        held_err = float(err[:held].max())
        off = np.nonzero(err > ref["atol"])[0]
        emit({"phase": "lmpc_lap", "name": f"lmpc_lap_{layout}", "dtype": "f64",
              "n_steps": n_steps, "lap_steps": lap_steps, "golden_lap_steps": len(golden) - 1,
              "same_shape": lap_steps + 1 == len(golden),
              "lap_steps_dev_bound": steps_dev,
              "max_abs_err_common_rows": float(err.max()),
              "first_row_off_golden": int(off[0]) if len(off) else None,
              "first_capped_step": first_capped, "rows_held": held,
              "held_max_abs_err": held_err, "atol": ref["atol"],
              "previous_lap_steps": counter,
              "max_abs_ey": float(np.abs(xc[:, 5]).max()), "k1_launches": launches, **stats})
        require(np.isfinite(xc).all() and bool(us.isfinite().all()),
                f"{layout}: non-finite LMPC lap")
        require(launches == n_steps, f"{layout}: K1 launched {launches} times, not {n_steps}")
        require(held_err <= ref["atol"],
                f"{layout}: rows 0..{held - 1} off the golden by {held_err} > {ref['atol']}")
        require(abs(lap_steps - ref["golden_lap_steps"]) <= steps_dev,
                f"{layout}: {lap_steps} lap steps, more than {steps_dev} from the golden's "
                f"{ref['golden_lap_steps']}")
        require(0 < lap_steps < counter,
                f"{layout}: lap of {lap_steps} steps does not beat the previous {counter}")
        require(xc[lap_steps - 1, 4] < L <= xc[lap_steps, 4], f"{layout}: lap end misplaced")
        require(float(np.abs(xc[:, 5]).max()) <= 1.0, f"{layout}: the lap leaves the track")

    # ms per control step of the l_shape lap: over a 250-step call (after
    # the lap ends, its steps repeat one frozen solve) and over a call of
    # exactly the lap's steps, counted by phase 6's lap (f64) or the
    # 250-step call (f32)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_lap(n_steps, dtype, solves):
        torch.cuda.synchronize()
        start.record()
        (xc, _, _, lap_steps), _, L = lmpc_lap("l_shape", n_steps, dtype, solves)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n_steps, xc, lap_steps, L

    f32_ref = lap_spread["l_shape/jax_f32"]
    f32_dev = max(abs(n - f32_ref["reference_lap_steps"]) for n in f32_ref["nudged_lap_steps"])
    for dtype, name in ((f64, "f64"), (f32, "f32")):
        if dtype == f64:  # phase 6's lap counted the steps
            lap_steps = lap_runs["l_shape"][2]
        else:
            lmpc_lap("l_shape", 3, dtype, None)  # warm-up
        solves = []
        ms_per_step, xc, steps_250, _ = timed_lap(250, dtype, solves)
        if dtype == f32:
            lap_steps = steps_250
        ms_per_lap_step, xc_lap, steps_lap, L = timed_lap(lap_steps, dtype, None)
        _, stats = lap_stats(solves, steps_250)
        emit({"phase": "lmpc_lap_time", "name": "lmpc_lap_l_shape", "dtype": name,
              "ms_per_step": ms_per_step, "ms_per_lap_step": ms_per_lap_step,
              "lap_steps": lap_steps, "finite": bool(xc.isfinite().all()),
              **({"jax_f32_reference_lap_steps": f32_ref["reference_lap_steps"],
                  "lap_steps_dev_bound": f32_dev} if name == "f32" else {}), **stats})
        require(steps_250 == lap_steps and steps_lap == lap_steps,
                f"l_shape {name}: lap of {steps_250} and {steps_lap} steps after {lap_steps}")
        require(float(xc_lap[-2, 4]) < L <= float(xc_lap[-1, 4]),
                f"l_shape {name}: the {lap_steps}-step call does not end the lap")
        if name == "f32":
            require(abs(lap_steps - f32_ref["reference_lap_steps"]) <= f32_dev,
                    f"l_shape f32: {lap_steps} lap steps, more than {f32_dev} from the JAX "
                    f"f32 lap's {f32_ref['reference_lap_steps']}")

    # ---- 7. the LMPC learning protocol, f64, through K1 ------------------------
    learning_fleet = learning_phases(dev, setup, lap_spread, golden_laps["l_shape"],
                                     lap_runs["l_shape"])

    # ---- 8. the obstacle-avoidance controllers, through K1 ---------------------
    with open("data/goldens/controller_spread.json") as f:
        controller_spread = json.load(f)
    controller_k1, controller_paths = controller_phases(dev, controller_spread)

    # ---- 9. MPC-LTI fleet, f32: K1's main path ------------------------------
    fleet = setup("l_shape", 0.8, f32)
    B, n_steps = 256, 100
    xc0 = torch.as_tensor(np.array([0.1, 0, 0, 0, 0, 0]) + 0.05 * np.random.default_rng(
        0).standard_normal((B, 6)), dtype=f32, device=dev)
    xg0 = torch.zeros(B, 6, dtype=f32, device=dev)
    fused.rollout_mpc_tracking_batch(*fleet, xc0, xg0, n_steps=3)  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    start.record()
    xc, us = fused.rollout_mpc_tracking_batch(*fleet, xc0, xg0, n_steps=n_steps)
    end.record()
    end.synchronize()
    fleet_k1 = k1.launches
    step_ms = start.elapsed_time(end) / n_steps
    xc1, _ = fused.rollout_mpc_tracking(*fleet, xc0[0], xg0[0], n_steps=n_steps)
    lane0 = float((xc[0] - xc1).abs().max())
    finite = bool(xc.isfinite().all() and us.isfinite().all())
    advanced = int((xc[:, -1, 4] > xc[:, 0, 4]).sum())
    emit({"phase": "fleet", "B": B, "n_steps": n_steps, "dtype": "f32",
          "step_ms": step_ms, "k1_launches": fleet_k1, "k2_launches": k2.launches,
          "lanes_advanced": advanced, "lane0_vs_single_max_abs": lane0, "lane0_bound": 1e-3,
          "s_final_min": float(xc[:, -1, 4].min()), "s_final_max": float(xc[:, -1, 4].max())})
    require(finite, "fleet: non-finite states or inputs")
    require(advanced == B, f"fleet: only {advanced} of {B} lanes advanced in s")
    require(lane0 <= 1e-3, f"fleet: lane 0 differs from its single-lane rollout by {lane0}")
    require(fleet_k1 == n_steps, f"fleet: K1 launched {fleet_k1} times, not {n_steps}")

    # ---- 10. corridor sweep, f32: K2's main path -----------------------------
    S, N = 64, 10
    inputs = overtake.corridor_sweep_inputs(S, N, seed=0, dtype=f32, device=dev)
    overtake.corridor_sweep(*inputs, num_horizon=N)  # warm-up
    torch.cuda.synchronize()
    k1.launches = k2.launches = 0
    start.record()
    out = overtake.corridor_sweep(*inputs, num_horizon=N)
    end.record()
    end.synchronize()
    sweep_k2 = k2.launches
    sweep_ms_first = start.elapsed_time(end)
    ref = overtake.corridor_sweep(*inputs, num_horizon=N, backend="plain")
    best, X_best, costs, conv, X_all, iters = out
    it = iters.flatten().cpu().numpy()
    xdiff = float((X_best - ref[1]).abs().max())
    sweep_times = []
    for _ in range(10):
        start.record()
        overtake.corridor_sweep(*inputs, num_horizon=N)
        end.record()
        end.synchronize()
        sweep_times.append(start.elapsed_time(end))
    plain_sweep_ms = cuda_ms(
        lambda: overtake.corridor_sweep(*inputs, num_horizon=N, backend="plain"), 5, 1)
    emit({"phase": "sweep", "S": S, "branches": int(conv.numel()), "n": N * 2,
          "rows": 86, "dtype": "f32", "k2_launches": sweep_k2, "k1_launches": k1.launches,
          "sweep_ms_first": sweep_ms_first, "sweep_ms_median": float(np.median(sweep_times)),
          "sweep_ms_all": sweep_times, "plain_sweep_ms": plain_sweep_ms,
          "iters_min": int(it.min()), "iters_median": float(np.median(it)),
          "iters_max": int(it.max()), "iters_hist": np.bincount(it).tolist(),
          "converged": int(conv.sum()), "best_equal": bool(torch.equal(best, ref[0])),
          "converged_equal": bool(torch.equal(conv, ref[3])), "X_best_max_abs": xdiff})
    require(tuple(X_all.shape) == (S, 4, N + 1, 6) and bool(X_all.isfinite().all()),
            "sweep: X_all has the wrong shape or non-finite values")
    require(torch.equal(best, ref[0]), "sweep: best differs from the plain solve's")
    require(torch.equal(conv, ref[3]), "sweep: converged differs from the plain solve's")
    require(xdiff <= 1e-4, f"sweep: X_best differs from the plain solve's by {xdiff}")
    require(sweep_k2 > 0, "sweep: K2 was not launched")
    require(sweep_k2 == int(it.max()) + 1 or sweep_k2 == 30,
            f"sweep: {sweep_k2} K2 launches for a slowest branch of {int(it.max())} iterations")

    # ---- 11. 256 LMPC QPs through solve_qp_batch, f64: K3's main path --------
    kw = dict(device=dev, dtype=f64)
    sd = fixtures.load_lmpc_seed("l_shape", **kw)
    tr_l = track.load_track("l_shape", width=1.0, **kw)
    lp = params.LMPCParam.default(**kw)
    K_per = lp.num_ss_points // lp.num_ss_iter
    Lq = tr_l.lap_length
    xs = sd["xcurv0"] + 0.05 * torch.as_tensor(
        np.random.default_rng(0).standard_normal((256, 6)), **kw)
    xs[:, 4] = torch.remainder(xs[:, 4], Lq)
    lin = sd["lin_points0"][:lp.num_horizon]
    A_tv, B_tv, C_tv = lmpc_learning.estimate_abc_horizon(
        lin, sd["lin_input0"], torch.stack([sd["ss2"], sd["ss1"]]),
        torch.stack([sd["u2"], sd["u1"]]), torch.stack([sd["valid2"], sd["valid1"]]),
        track.curvature(tr_l, torch.remainder(lin[:, 4], Lq)), 0.1)
    p1, q1 = lmpc_learning.select_points(sd["ss1"], sd["q1"], xs, K_per)
    p2, q2 = lmpc_learning.select_points(sd["ss2"], sd["q2"], xs, K_per)
    qp, z0, _, _ = controllers.lmpc_qp(
        xs, lp, A_tv, B_tv, C_tv, torch.cat([p1, p2], dim=-1), torch.cat([q1, q2], dim=-1),
        xs.new_zeros(256, 2), params.SystemParam.default(**kw), tr_l.width)
    n_z, m_rows, p_rows = qp.H.shape[-1], qp.C.shape[-2], qp.E.shape[-2]
    ipm.solve_qp_batch(qp, z0, iters=40)  # warm-up
    torch.cuda.synchronize()
    k2.launches = k3.launches = 0
    start.record()
    eq = ipm.solve_qp_batch(qp, z0, iters=40)
    end.record()
    end.synchronize()
    eq_k3, eq_k2 = k3.launches, k2.launches
    eq_ms = start.elapsed_time(end)
    eq_plain = ipm.solve_qp_batch(qp, z0, iters=40, backend="plain")
    eq_lu = ipm.solve_qp(qp, z0, iters=40)
    its = eq.iterations.cpu().numpy()
    runs = min(int(its.max()) + 1, 40)  # iterations the batch ran
    both = eq.converged & eq_plain.converged
    z_err = float((eq.z - eq_plain.z).abs().amax(dim=1)[both].max()) if bool(both.any()) else 0.0
    obj = lambda z: 0.5 * torch.einsum("bi,bij,bj->b", z, qp.H, z) + (qp.g * z).sum(dim=1)
    both_lu = eq.converged & eq_lu.converged
    obj_diff = (float((obj(eq.z) - obj(eq_lu.z)).abs()[both_lu].max())
                if bool(both_lu.any()) else None)
    emit({"phase": "eq_batch", "B": 256, "n": n_z, "m": m_rows, "p": p_rows, "dtype": "f64",
          "ms": eq_ms, "k3_launches": eq_k3, "k2_launches": eq_k2, "iterations_run": runs,
          "iters_min": int(its.min()), "iters_median": float(np.median(its)),
          "iters_max": int(its.max()), "converged": int(eq.converged.sum()),
          "converged_plain": int(eq_plain.converged.sum()),
          "converged_equal": bool(torch.equal(eq.converged, eq_plain.converged)),
          "z_max_abs_vs_plain": z_err, "z_bound": 1e-8,
          "lu_converged": int(eq_lu.converged.sum()),
          "lu_max_objective_diff_where_both_converged": obj_diff})
    require((n_z, m_rows, p_rows) == (68, 125, 7), f"eq_batch: QP shape {(n_z, m_rows, p_rows)}")
    require(bool(eq.z.isfinite().all()), "eq_batch: non-finite z")
    require(torch.equal(eq.converged, eq_plain.converged),
            "eq_batch: converged differs from the plain solve's")
    require(z_err <= 1e-8, f"eq_batch: z differs from the plain solve's by {z_err}")
    require(eq_k3 == runs and eq_k2 == 0,
            f"eq_batch: {eq_k3} K3 and {eq_k2} K2 launches for {runs} iterations")

    # ---- 14. the racing game (before the timings: they take its K2 shapes) ---
    with open("data/goldens/racing_game_spread.json") as f:
        racing_k1, racing_k2, racing_shapes, racing_paths = racing_game_phases(dev, json.load(f))

    # ---- 15. the offboard simulator and the Riccati KKT path ------------------
    sim_k1, sim_paths = simulator_phases(dev)

    # ---- 12. kernel timings at the paths' shapes ------------------------------
    # K1 at the fleet's B = 256, the MPC-CBF and iLQR bench's B = 1 and the
    # racing fleets' B = 8 and 64 in f32, the LMPC, controller and racing
    # goldens' B = 1 and the learning fleet's B = 64 in f64 (and 256); a
    # call is 100 dependent
    # substeps, so ns_per_substep is the time one substep takes on the
    # kernel's critical path
    tr, bike = fleet[0], fleet[1]
    gold = setup("l_shape", 0.8, f64)
    xg, xcs, u = period_states(np.random.default_rng(1), 256, False, f32)
    args64 = [a.to(f64) for a in (xg, xcs, u)]
    k1_times = {}
    for name, B, args in (("f32", 256, (tr, bike, xg, xcs, u)),
                          ("f32", 1, (tr, bike, *(a[:1].contiguous() for a in (xg, xcs, u)))),
                          *(("f32", Bf, (tr, bike, *(a[:Bf].contiguous() for a in (xg, xcs, u))))
                            for Bf in (8, 64)),
                          ("f64", 1, (gold[0], gold[1], *(a[:1].contiguous() for a in args64))),
                          ("f64", 64, (gold[0], gold[1], *(a[:64].contiguous() for a in args64))),
                          ("f64", 256, (gold[0], gold[1], *args64))):
        # each shape against the plain loop too, at k1_check's nominal bounds:
        # at B = 1 all but one lane pair of the warp take the kernel's tail branch
        got, want = k1.propagate(*args), k1.plain(*args)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        finite = all(bool(g.isfinite().all()) for g in got)
        bound = 2e-6 if name == "f32" else 1e-9
        k1_err[(name, f"B{B}")] = err
        require(finite and err <= bound, f"K1 {name} B={B}: max_abs_err {err} > {bound}")
        ms = cuda_ms(lambda: k1.propagate(*args), 50)
        device_ms = kernel_device_ms(lambda: k1.propagate(*args), "propagate_kernel")
        plain_ms = cuda_ms(lambda: k1.plain(*args), 3, 1)
        bound_ms, by, nbytes, ops = k1_bound_ms(B, tr.num_segments, 100,
                                                4 if name == "f32" else 8)
        k1_times[(name, B)] = (ms, device_ms, plain_ms, bound_ms, by)
        emit({"phase": "time_k1", "B": B, "dtype": name, "n_sub": 100, "ms": ms,
              "device_ms": device_ms,
              "ns_per_substep": None if device_ms is None else device_ms * 1e6 / 100,
              "plain_ms": plain_ms, "max_abs_err": err, "atol": bound,
              "bound_ms": bound_ms, "bound_by": by, "bytes": nbytes, "ops": ops})
    k1_ms, k1_device_ms, k1_plain_ms, k1_bound, k1_by = k1_times[("f32", 256)]

    def library(A, rhs):
        """One PyTorch call's worth of the same solve, timed and used nowhere else."""
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(rhs, L)

    A, b = spd_batch(np.random.default_rng(2), 256, 20, f32)
    k2_ms = cuda_ms(lambda: k2.solve(A, b), 200)
    k2_device_ms = kernel_device_ms(lambda: k2.solve(A, b), "cholesky_solve_kernel")
    k2_plain_ms = cuda_ms(lambda: k2.plain(A, b), 50)
    k2_lib_ms = cuda_ms(lambda: library(A, b.unsqueeze(-1)), 50)
    k2_bound, k2_by, k2_bytes, k2_ops = solve_bound_ms(256, 20, 1, 4)
    emit({"phase": "time_k2", "B": 256, "n": 20, "dtype": "f32", "ms": k2_ms,
          "device_ms": k2_device_ms, "plain_ms": k2_plain_ms, "library_ms": k2_lib_ms,
          "bound_ms": k2_bound, "bound_by": k2_by, "bytes": k2_bytes, "ops": k2_ops})
    # K2 at the racing game's shapes: one lane's corridor batch (n_br = 3) in
    # f64 and f32, and the 64-lane fleet's median batch in f32, each held
    # against its plain version before it is timed
    k2_ms_by_shape = {"f32_B256": k2_ms}
    B_fleet = int(np.median(racing_shapes))
    for dtype, name, Bk in ((f64, "f64", 3), (f32, "f32", 3), (f32, "f32", B_fleet)):
        A, b = spd_batch(np.random.default_rng(6), Bk, 20, dtype)
        check_solve("K2", k2.solve, k2.plain, A, b, name, bounds[name], k2_err,
                    (name, Bk, 20, "racing"))
        ms = cuda_ms(lambda: k2.solve(A, b), 200)
        bound, by, nbytes, ops = solve_bound_ms(Bk, 20, 1, A.element_size())
        k2_ms_by_shape[f"{name}_B{Bk}"] = ms
        emit({"phase": "time_k2", "B": Bk, "n": 20, "dtype": name, "path": "racing_game",
              "ms": ms,
              "device_ms": kernel_device_ms(lambda: k2.solve(A, b), "cholesky_solve_kernel"),
              "plain_ms": cuda_ms(lambda: k2.plain(A, b), 50),
              "library_ms": cuda_ms(lambda: library(A, b.unsqueeze(-1)), 50),
              "max_abs_err": k2_err[(name, Bk, 20, "racing")], "bound_ms": bound, "bound_by": by,
              "bytes": nbytes, "ops": ops})

    # K3 at the LMPC QP's n = 68 and at n = 100, past the old 48 KB a problem
    k3_times = {}
    for n, seed in ((68, 3), (100, 4)):
        A3, B3 = spd_multi(np.random.default_rng(seed), 256, n, 8, f64)
        ms = cuda_ms(lambda: k3.solve_multi(A3, B3), 200)
        device_ms = kernel_device_ms(lambda: k3.solve_multi(A3, B3), "cholesky_solve_kernel")
        plain_ms = cuda_ms(lambda: k3.plain(A3, B3), 50)
        lib_ms = cuda_ms(lambda: library(A3, B3), 50)
        bound, by, nbytes, ops = solve_bound_ms(256, n, 8, 8)
        k3_times[n] = (ms, device_ms, plain_ms, lib_ms, bound, by)
        emit({"phase": "time_k3", "B": 256, "n": n, "r": 8, "dtype": "f64", "ms": ms,
              "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
              "bound_by": by, "bytes": nbytes, "ops": ops})
    k3_ms, k3_device_ms, k3_plain_ms, k3_lib_ms, k3_bound, k3_by = k3_times[68]
    # the block team's size: the plan's 256 threads beside 128 and 512, on
    # the same inputs (each element's operations do not depend on the team,
    # so the outputs must agree bit for bit)
    for n, seed in ((68, 3), (100, 4)):
        A3, B3 = spd_multi(np.random.default_rng(seed), 256, n, 8, f64)
        base = k2.plan(n, 8, 8)
        want = k2.launch(A3, B3, 8, "K3", base)
        for team in (128, 256, 512):
            p = dataclasses.replace(base, team=team)
            same = bool(torch.equal(k2.launch(A3, B3, 8, "K3", p), want))
            emit({"phase": "k3_team", "B": 256, "n": n, "r": 8, "dtype": "f64", "team": team,
                  "planned": team == base.team, "bit_equal_to_plan": same,
                  "device_ms": kernel_device_ms(lambda: k2.launch(A3, B3, 8, "K3", p),
                                                "cholesky_solve_kernel")})
            require(same, f"K3 n={n}: a team of {team} threads changes the result")
    # one LMPC problem alone: the latency of its 3n dependent steps
    A1, B1 = spd_multi(np.random.default_rng(5), 1, 68, 8, f64)
    emit({"phase": "time_k3", "B": 1, "n": 68, "r": 8, "dtype": "f64",
          "device_ms": kernel_device_ms(lambda: k3.solve_multi(A1, B1), "cholesky_solve_kernel")})

    # ---- 13. where the time goes: device busy share under torch.profiler ----
    paths = {
        "fleet_5_steps": lambda: fused.rollout_mpc_tracking_batch(*fleet, xc0, xg0, n_steps=5),
        "sweep": lambda: overtake.corridor_sweep(*inputs, num_horizon=N),
        "lmpc_lap_5_steps": lambda: lmpc_lap("l_shape", 5, f64, None),
        "eq_batch": lambda: ipm.solve_qp_batch(qp, z0, iters=40),
        "learning_fleet_5_steps": lambda: learning_fleet(5),
        **controller_paths,
        **racing_paths,
        **sim_paths,
    }
    # both untraced times before any trace: a sweep timed right after the
    # fleet's trace read twice its phase-6 time on the H100
    walls = {name: cuda_ms(fn, 3, 1) for name, fn in paths.items()}
    for name, fn in paths.items():
        emit({"phase": "profile", "name": name, "wall_ms": walls[name],
              **device_profile(fn, walls[name])})

    emit({"kernels": [
        {"name": "propagate", "route": "cuda",
         "source": "car_racing_tpu_torch/csrc/propagate.cu",
         "replaces": "car_racing_tpu/ops/pallas_kernels.py:436",
         "launches": (fleet_k1 + sum(controller_k1.values()) + sum(racing_k1.values())
                      + sum(sim_k1.values())),
         "launches_by_path": {"mpc_lti_fleet": fleet_k1, **controller_k1, **racing_k1,
                              **sim_k1},
         # the worst of every K1 comparison in this run; by shape below
         "max_abs_err": max(k1_err.values()),
         "max_abs_err_by_shape": {f"{d}_{c}": e for (d, c), e in k1_err.items()},
         "ms_by_shape": {f"{d}_B{B}": v[0] for (d, B), v in k1_times.items()},
         "ms": k1_ms, "device_ms": k1_device_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "cholesky_solve", "route": "cuda",
         "source": "car_racing_tpu_torch/csrc/cholesky_solve.cu",
         "replaces": "car_racing_tpu/ops/pallas_kernels.py:108",
         "launches": sweep_k2 + sum(racing_k2.values()),
         "launches_by_path": {"sweep": sweep_k2, **racing_k2},
         "max_abs_err": k2_err[("f32", 256)],
         "max_abs_err_by_shape": {"_".join(map(str, k)): e for k, e in k2_err.items()},
         "ms_by_shape": k2_ms_by_shape, "ms": k2_ms, "device_ms": k2_device_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms},
        {"name": "cholesky_solve_multi", "route": "cuda",
         "source": "car_racing_tpu_torch/csrc/cholesky_solve.cu",
         "replaces": "car_racing_tpu/ops/pallas_kernels.py:202", "launches": eq_k3,
         "max_abs_err": k3_err[("f64", 68)], "ms": k3_ms, "device_ms": k3_device_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib_ms},
    ]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    try:
        import car_racing_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2
    try:
        result = run()
    except Exception as exc:  # report the failure, print no result
        import traceback

        traceback.print_exc()
        emit({"phase": "failed", "error": f"{type(exc).__name__}: {exc}"})
        return 1
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
