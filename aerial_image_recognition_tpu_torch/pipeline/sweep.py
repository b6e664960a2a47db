"""Resolution sweep harness — test_configurations.py parity.

Counterpart of ``aerial_image_recognition_tpu/pipeline/sweep.py``. Runs
the full detection pipeline (the port's ``CarDetector``) at several ground
resolutions and reports detection counts per configuration (reference
test_configurations.py:5-92: 100/64/51.2/25/20 m tiles ↔
15.6/10/8/3.9/3.1 cm/px with a 640-px model input). Each configuration
gets its own output prefix and a forced restart.
"""

import time
from typing import Dict, List, Optional, Sequence

from aerial_image_recognition_tpu_torch.pipeline.detector import CarDetector
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device


def run_sweep(base_dir: str, overrides: Optional[Dict],
              tile_sizes: Sequence[float] = (100.0, 64.0, 51.2, 25.0, 20.0),
              model_px: int = 640, fetcher=None, detect_step=None,
              device=None) -> List[Dict]:
    """fetcher/detect_step injection mirrors CarDetector's (hermetic
    tests). Without a step, each configuration's ``CarDetector`` builds its
    own on ``device`` (default ``cuda``): the device is resolved once, up
    front, so a machine without CUDA raises here instead of recording the
    same error for every configuration. An exception inside one
    configuration is recorded in its entry (``error``) and the sweep goes
    on, as the reference's does."""
    if detect_step is None:
        device = resolve_device(device)
    results = []
    for size in tile_sizes:
        cfg = dict(overrides or {})
        cfg["tile_size_meters"] = float(size)
        cfg["output_prefix"] = (cfg.get("output_prefix", "detections")
                                + f"_{size:g}m")
        cm_per_px = 100.0 * size / model_px
        print(f"\n=== sweep: {size:g} m tiles ({cm_per_px:.1f} cm/px) ===")
        t0 = time.time()
        det = CarDetector(base_dir, cfg, fetcher=fetcher,
                          detect_step=detect_step, device=device)
        try:
            out = det.detect(interactive=False, force_restart=True)
            results.append({
                "tile_size_m": size,
                "cm_per_px": round(cm_per_px, 2),
                "detections": out.get("detections"),
                "tiles": out.get("tiles"),
                "wall_s": round(time.time() - t0, 1),
            })
        except Exception as e:       # one bad config doesn't kill the sweep
            results.append({"tile_size_m": size, "error": repr(e)})
    return results
