"""K3: batched SPD solve with several right-hand sides, ``A X = Brhs``
(``csrc/cholesky_solve.cu``, sharing K2's factorization).

Replaces ``cholesky_solve_multi_batched`` of
car_racing_tpu/ops/pallas_kernels.py:215 (``pl.pallas_call`` at :202,
dispatched by ``solve_multi_batched`` at :243).  :func:`solve_multi`
launches the kernel for CUDA tensors and runs :func:`plain` for CPU
tensors; ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def plain(A: torch.Tensor, Brhs: torch.Tensor) -> torch.Tensor:
    """What the JAX package runs off the TPU (``jnp.linalg.cholesky`` +
    ``cho_solve``): a problem whose matrix is not positive definite comes
    back as NaN, as ``jnp.linalg.cholesky`` makes it."""
    L, info = torch.linalg.cholesky_ex(A)
    X = torch.cholesky_solve(Brhs, L)
    return torch.where((info == 0)[:, None, None], X, torch.nan)


def solve_multi(A: torch.Tensor, Brhs: torch.Tensor) -> torch.Tensor:
    """Solve ``A[i] X[i] = Brhs[i]`` for ``A (B, n, n)`` SPD and
    ``Brhs (B, n, r)``; returns ``X (B, n, r)``."""
    if A.device.type == "cpu":
        return plain(A, Brhs)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    return _launch(A, Brhs)


def _launch(A, Brhs):
    global launches
    dtype, dev = A.dtype, A.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K3 takes float32 or float64, got {dtype}")
    if (A.dim() != 3 or A.shape[1] != A.shape[2] or Brhs.dim() != 3
            or tuple(Brhs.shape[:2]) != tuple(A.shape[:2])):
        raise ValueError(
            f"K3 takes A (B, n, n) and Brhs (B, n, r), got {tuple(A.shape)}, {tuple(Brhs.shape)}")
    if Brhs.device != dev or Brhs.dtype != dtype:
        raise ValueError(f"Brhs is {Brhs.dtype} on {Brhs.device}; K3 needs {dtype} on {dev}")
    if not (A.is_contiguous() and Brhs.is_contiguous()):
        raise ValueError("K3 takes contiguous A and Brhs")
    Bn, n, r = Brhs.shape
    lib = build.load("cholesky_solve")
    lib.cholesky_solve_multi_fits.argtypes = [ctypes.c_int] * 3
    if not lib.cholesky_solve_multi_fits(n, r, A.element_size()):
        raise ValueError(
            f"K3 holds one matrix and its right-hand sides per warp in 48 KB of shared memory: "
            f"n = {n}, r = {r} in {dtype} does not fit")
    X = torch.empty_like(Brhs)
    if Bn == 0:
        return X
    fn = lib.cholesky_solve_multi_f32 if dtype == torch.float32 else lib.cholesky_solve_multi_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(A.data_ptr(), Brhs.data_ptr(), X.data_ptr(), Bn, n, r,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "cholesky_solve_multi")
    launches += 1
    return X
