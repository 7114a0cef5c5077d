"""K2: batched SPD solve ``A x = b`` (``csrc/cholesky_solve.cu``).

Replaces ``cholesky_solve_batched`` of car_racing_tpu/ops/pallas_kernels.py:121
(``pl.pallas_call`` at :108, dispatched by ``solve_batched`` at :156).
:func:`solve` launches the kernel for CUDA tensors and runs :func:`plain`
for CPU tensors; ``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """What the JAX package runs off the TPU (``jnp.linalg.cholesky`` +
    ``cho_solve``): a problem whose matrix is not positive definite comes
    back as NaN, as ``jnp.linalg.cholesky`` makes it."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.where((info == 0).unsqueeze(-1), x, torch.nan)


def solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A[i] x[i] = b[i]`` for ``A (B, n, n)`` SPD, ``b (B, n)``."""
    if A.device.type == "cpu":
        return plain(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    return _launch(A, b)


def _launch(A, b):
    global launches
    dtype, dev = A.dtype, A.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"K2 takes float32 or float64, got {dtype}")
    if A.dim() != 3 or A.shape[1] != A.shape[2] or tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"K2 takes A (B, n, n) and b (B, n), got {tuple(A.shape)}, {tuple(b.shape)}")
    if b.device != dev or b.dtype != dtype:
        raise ValueError(f"b is {b.dtype} on {b.device}; K2 needs {dtype} on {dev}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("K2 takes contiguous A and b")
    Bn, n = A.shape[0], A.shape[1]
    lib = build.load("cholesky_solve")
    lib.cholesky_solve_max_n.argtypes = [ctypes.c_int]
    max_n = lib.cholesky_solve_max_n(A.element_size())
    if n > max_n:
        raise ValueError(f"K2 holds one matrix per warp in shared memory: n <= {max_n}, got {n}")
    x = torch.empty_like(b)
    if Bn == 0:
        return x
    fn = lib.cholesky_solve_f32 if dtype == torch.float32 else lib.cholesky_solve_f64
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        code = fn(A.data_ptr(), b.data_ptr(), x.data_ptr(), Bn, n,
                  torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, code, "cholesky_solve")
    launches += 1
    return x
