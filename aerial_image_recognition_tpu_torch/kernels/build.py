"""Build the port's CUDA kernels with nvcc into ctypes libraries.

Each ``csrc/<name>.cu`` exposes a plain C entry point and compiles on its
own into ``<repo>/build/lib<name>-<hash>.so`` at first use (``nvcc`` takes
seconds for such a file; including PyTorch's headers would take minutes).
The hash covers the source and the flags, so an edited kernel is rebuilt
and a stale library is never loaded. Nothing is built at import time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` — the kernels
reproduce the reference's f32 arithmetic bit for bit, and nvcc's default
FMA contraction would round ``a*b + c`` once instead of twice. No
``--use_fast_math``: divisions must stay IEEE. ``-Xptxas -v`` makes ptxas
report each kernel's registers, shared memory and spills; the report is
kept beside the library as ``lib<name>-<hash>.log`` (``build_log``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built from source at first "
                           "use")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp, cmd)


def _finish(name: str, target: Path, job) -> None:
    if job is None:
        return
    proc, tmp, cmd = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({' '.join(cmd)}):\n"
                           f"{out}")
    target.with_suffix(".log").write_text(out)
    os.replace(tmp, target)          # atomic: concurrent builds agree


def build_all(names: Iterable[str]) -> None:
    """Compile every named kernel source, all nvcc processes at once."""
    with _lock:
        jobs = [(n, *_start(n)) for n in names if n not in _libs]
        try:
            for name, target, job in jobs:
                _finish(name, target, job)
        finally:
            for _, _, job in jobs:
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        for name, target, _ in jobs:
            _libs[name] = ctypes.CDLL(str(target))


def build_log(name: str) -> str:
    """What nvcc and ptxas printed when ``csrc/<name>.cu`` was built."""
    load(name)
    return _target(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib
