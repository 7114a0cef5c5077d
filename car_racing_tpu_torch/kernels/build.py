"""Build ``csrc/*.cu`` with nvcc into shared libraries and load them with ctypes.

Each source has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  The libraries go to ``build/torch_kernels/`` at the repository
root, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  :func:`build_all` starts one nvcc
per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("propagate", "cholesky_solve")

# --fmad=false: each product and sum rounds on its own, as in the plain
# PyTorch versions, so a kernel and its plain version differ only by the
# libm results they share on the card.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc")
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` that is not built yet, all nvcc
    processes running together.  Returns ptxas' report for each one built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs[name] = (proc, tmp, out)
    reports, errors = {}, []
    for name, (proc, tmp, out) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            reports[name] = err
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{err}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/{name}.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {code} ({msg})")
