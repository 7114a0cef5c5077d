#!/usr/bin/env python3
"""Drive the PyTorch port (car_racing_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the repository root.  It builds the CUDA kernels from
``car_racing_tpu_torch/csrc/`` into ``build/torch_kernels/``, holds each
kernel against its plain PyTorch version on the card, drives the two paths
of the port through the entry points a user calls, and times each kernel
beside its bound:

1. build: one nvcc per source, all at once;
2. K1 (integrator) against its plain loop, B = 256, f32 and f64;
3. K2 (batched Cholesky solve) against its plain version, f32 and f64;
4. the MPC-LTI goldens of ``data/goldens/`` on the card in f64, through K1;
5. the MPC-LTI fleet: 256 lanes x 100 control steps in f32 (K1's path);
6. the 256-QP corridor sweep in f32 (K2's path), against the same sweep
   with the plain solve;
7. kernel timings at the paths' shapes, beside their bounds;
8. a torch.profiler trace of each path: the device's busy and idle share;
then the ``kernels`` line, the card's name and power limit, and the ``ok``
line.

Every phase prints one JSON line.  A failed phase ends the script with exit
code 1 and no ``ok`` line; without a GPU, or outside a checkout of the
repository, it exits nonzero before any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
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


def device_profile(fn, wall_ms):
    """Device time of one call of ``fn`` from a torch.profiler trace: the
    union of its kernels' intervals, their count, and the largest by name.
    The idle share is taken against ``wall_ms``, the call's untraced time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k2_bound_ms(B, n, itemsize):
    factor = sum(2 + (n - j) + (n - j - 1) * (n - j) for j in range(n))
    substitute = 2 * sum(2 + 2 * (n - j - 1) for j in range(n))
    nbytes = itemsize * B * (n * n + n + n)
    ops = B * (factor + substitute)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def run():
    import torch

    from car_racing_tpu_torch.kernels import build, cholesky as k2, propagate as k1
    from car_racing_tpu_torch.models import controllers
    from car_racing_tpu_torch.ops import dynamics, track
    from car_racing_tpu_torch.planning import overtake
    from car_racing_tpu_torch.racing import fused
    from car_racing_tpu_torch.utils import params

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # full-precision float32 products everywhere (TF32 keeps ~3 digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    ptxas = {n: [ln.strip() for ln in r.splitlines() if "Used" in ln or "spill" in ln]
             for n, r in reports.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "built": sorted(reports),
          "ptxas": ptxas})

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
            k1_err[(name, case)] = err
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

    k2_err = {}
    for dtype, name, bound in ((f32, "f32", 1e-4), (f64, "f64", 1e-8)):
        for B in (256, 130):
            A, b = spd_batch(rng, B, 20, dtype)
            got, want = k2.solve(A, b), k2.plain(A, b)
            torch.cuda.synchronize()
            abs_err = float((got - want).abs().max())
            rel = abs_err / float(want.abs().max())
            k2_err[(name, B)] = abs_err
            emit({"phase": "k2_check", "dtype": name, "B": B, "n": 20, "max_abs_err": abs_err,
                  "max_rel_err": rel, "bound_rel": bound})
            require(bool(got.isfinite().all()) and rel <= bound,
                    f"K2 {name} B={B}: relative error {rel} > {bound}")

    # ---- 4. MPC-LTI goldens on the card, f64, through K1 -----------------------
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

    # ---- 5. MPC-LTI fleet, f32: K1's main path ------------------------------
    fleet = setup("l_shape", 0.8, f32)
    B, n_steps = 256, 100
    xc0 = torch.as_tensor(np.array([0.1, 0, 0, 0, 0, 0]) + 0.05 * np.random.default_rng(
        0).standard_normal((B, 6)), dtype=f32, device=dev)
    xg0 = torch.zeros(B, 6, dtype=f32, device=dev)
    fused.rollout_mpc_tracking_batch(*fleet, xc0, xg0, n_steps=3)  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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

    # ---- 6. corridor sweep, f32: K2's main path -----------------------------
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

    # ---- 7. kernel timings at the paths' shapes -------------------------------
    tr = fleet[0]
    bike = fleet[1]
    xg, xcs, u = period_states(np.random.default_rng(1), 256, False, f32)
    k1_ms = cuda_ms(lambda: k1.propagate(tr, bike, xg, xcs, u), 50)
    k1_plain_ms = cuda_ms(lambda: k1.plain(tr, bike, xg, xcs, u), 3, 1)
    k1_bound, k1_by, k1_bytes, k1_ops = k1_bound_ms(256, tr.num_segments, 100, 4)
    gold = setup("l_shape", 0.8, f64)
    args64 = [a.to(f64) for a in (xg, xcs, u)]
    k1_ms_f64 = cuda_ms(lambda: k1.propagate(gold[0], gold[1], *args64), 50)
    emit({"phase": "time_k1", "B": 256, "dtype": "f32", "n_sub": 100, "ms": k1_ms,
          "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
          "bytes": k1_bytes, "ops": k1_ops, "ms_f64": k1_ms_f64})

    A, b = spd_batch(np.random.default_rng(2), 256, 20, f32)

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b.unsqueeze(-1), L)

    k2_ms = cuda_ms(lambda: k2.solve(A, b), 200)
    k2_plain_ms = cuda_ms(lambda: k2.plain(A, b), 50)
    k2_lib_ms = cuda_ms(library, 50)
    k2_bound, k2_by, k2_bytes, k2_ops = k2_bound_ms(256, 20, 4)
    emit({"phase": "time_k2", "B": 256, "n": 20, "dtype": "f32", "ms": k2_ms,
          "plain_ms": k2_plain_ms, "library_ms": k2_lib_ms, "bound_ms": k2_bound,
          "bound_by": k2_by, "bytes": k2_bytes, "ops": k2_ops})

    # ---- 8. where the time goes: device busy share under torch.profiler ----
    paths = {
        "fleet_5_steps": lambda: fused.rollout_mpc_tracking_batch(*fleet, xc0, xg0, n_steps=5),
        "sweep": lambda: overtake.corridor_sweep(*inputs, num_horizon=N),
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
         "replaces": "car_racing_tpu/ops/pallas_kernels.py:436", "launches": fleet_k1,
         "max_abs_err": k1_err[("f32", "nominal")], "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "cholesky_solve", "route": "cuda",
         "source": "car_racing_tpu_torch/csrc/cholesky_solve.cu",
         "replaces": "car_racing_tpu/ops/pallas_kernels.py:108", "launches": sweep_k2,
         "max_abs_err": k2_err[("f32", 256)], "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": k2_lib_ms},
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
