"""Build ``csrc/*.cu`` with nvcc into shared libraries and load them with ctypes.

Each source has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  The libraries go to ``build/torch_kernels/`` at the repository
root, named by a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is reused.  :func:`build_all` starts one nvcc
per source at once and waits for all of them; :func:`ptxas_summary` reads
the registers, stack and spills that ptxas reports for each kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    """The loaded library of ``csrc/{name}.cu``, built first if needed.
    The first call hashes the source; later calls are a dictionary lookup."""
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


_KERNEL = re.compile(r"([a-z][a-z_]*_kernel)I([fd])((?:Lb[01]E)*)E")


def _kernel_label(mangled: str) -> str:
    """``cholesky_solve_kernel<double, true, false>`` for the mangled name of
    an instantiation of one of ``csrc/``'s kernel templates."""
    m = _KERNEL.search(mangled)
    if not m:
        return mangled
    args = ["float" if m.group(2) == "f" else "double"]
    args += ["true" if b == "1" else "false" for b in re.findall(r"Lb([01])E", m.group(3))]
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_summary(report: str) -> list[dict]:
    """One entry per kernel that ptxas compiled (``-Xptxas -v`` output):
    its registers, stack frame, spill stores and loads, and static shared
    memory, in bytes."""
    props: dict[str, dict] = {}
    entries: list[str] = []
    current = None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            current = m.group(1)
            entries.append(current)
        elif m := re.search(r"Function properties for (\S+)", line):
            current = m.group(1)
        elif current and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                line)):
            props.setdefault(current, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            props.setdefault(current, {}).update(
                registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    return [{"kernel": _kernel_label(e), **props.get(e, {})} for e in entries]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch function returned a nonzero ``cudaError_t``."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: cudaError {code} ({msg})")
