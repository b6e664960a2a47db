"""Environment diagnostic — the reference's check_gpu.py parity slot.

Counterpart of ``aerial_image_recognition_tpu/runtime/doctor.py``. Reports
the card the way x_arch/check_gpu.py:73-104 reported CUDA: the torch and
CUDA versions, the devices, their memory, the power limit nvidia-smi
reads, a bf16 matmul smoke test on the card, the CUDA compiler and the
three hand-written kernels it builds (``kernels/build.py``), the native
host helpers, and fetch-plane availability. Exposed as
``python -m aerial_image_recognition_tpu_torch doctor``.

A diagnostic reports, it does not recover: every probe that fails leaves
its error in a field of the report, and nothing falls back to another
device.
"""

import json
import shutil
import subprocess
import time
from typing import Dict

KERNELS = ("nms_suppress", "clahe_apply", "int8_epilogue")


def _devices_with_timeout(torch, timeout_s: float):
    """The CUDA device names, probed from a daemon thread.

    The first CUDA call initialises the driver, and a wedged driver can
    hang it instead of failing. A diagnostic that hangs is worse than none,
    so the probe gives up loudly after ``timeout_s`` (its thread leaks if
    the call never returns — acceptable in a short-lived doctor process).
    No CUDA is an empty list, not an error."""
    import threading

    box: list = []

    def probe():
        try:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            box.append([torch.cuda.get_device_name(i) for i in range(n)])
        except Exception as e:        # surfaced as cuda_error by the caller
            box.append(e)

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if not box:
        raise TimeoutError(
            f"torch.cuda did not answer within {timeout_s:.0f}s — the CUDA "
            "driver is likely wedged (its initialisation never completes); "
            "retry later or check the driver")
    if isinstance(box[0], Exception):
        raise box[0]
    return box[0]


def _nvidia_smi() -> Dict:
    """Name and power limit of each card as nvidia-smi reads them."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return {"nvidia_smi": None}
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi_error": str(e)[:200]}
    return {"nvidia_smi": [line.strip() for line in out.splitlines()
                           if line.strip()]}


def _kernels() -> Dict:
    """Whether nvcc is found and each kernel of ``csrc/`` builds and loads
    (built into ``build/`` at first use, so a later run finds them)."""
    from aerial_image_recognition_tpu_torch.kernels import build
    out: Dict = {}
    try:
        out["nvcc"] = build._nvcc()
    except RuntimeError as e:
        out["nvcc"] = None
        out["nvcc_error"] = str(e)[:200]
    built = {}
    for name in KERNELS:
        try:
            build.load(name)
            built[name] = True
        except Exception as e:       # each kernel's failure is a field
            built[name] = repr(e)[:300]
    out["kernels_built"] = built
    return out


def diagnose(compile_check: bool = True,
             device_timeout_s: float = 60.0) -> Dict:
    out: Dict = {}
    try:
        import torch
        out["torch_version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda
        devices = _devices_with_timeout(torch, device_timeout_s)
        out["backend"] = "cuda" if devices else "cpu"
        out["devices"] = devices
        if devices:
            try:
                free, total = torch.cuda.mem_get_info(0)
                out["memory_total_gb"] = round(total / 1e9, 2)
                out["memory_used_gb"] = round((total - free) / 1e9, 3)
            except Exception as e:
                out["memory_stats_error"] = str(e)[:100]
            if compile_check:
                t0 = time.time()
                x = torch.ones((256, 256), dtype=torch.bfloat16,
                               device="cuda")
                y = (x @ x).sum()
                out["matmul_smoke_test"] = {
                    "ok": bool(torch.isfinite(y)),
                    "seconds": round(time.time() - t0, 2),
                }
    except Exception as e:
        out["cuda_error"] = repr(e)
    out.update(_nvidia_smi())
    out.update(_kernels())

    from aerial_image_recognition_tpu_torch.utils.native import native_paths
    out["native"] = native_paths()
    out["native_fastgeo"] = out["native"]["fastgeo"]

    try:
        import requests  # noqa: F401
        from PIL import Image  # noqa: F401
        out["fetch_plane"] = True
    except Exception:
        out["fetch_plane"] = False
    return out


def main() -> int:
    print(json.dumps(diagnose(), indent=2))
    return 0
