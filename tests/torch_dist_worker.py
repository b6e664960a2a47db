"""A process of the port's multi-process tests (tests/test_torch_distributed.py).

    python torch_dist_worker.py scan <coordinator> <rank> <n> <out.json> \
        <tile_server_url> <frame.geojson>
    python torch_dist_worker.py train <coordinator> <rank> <n> <out.npz>

Each joins one gloo process group through
``parallel.distributed.initialize`` and runs the port on the CPU. ``scan``:
a ``CarDetector`` scan of its stripe of the global tile grid (the
``tile_filter`` hook), as tests/multihost_worker.py does for the JAX
package, with the counts crossing ``process_allgather``. ``train``: three
data-parallel XUnet steps (frozen BN) and one yolov8n step in ``batch`` BN
mode over a mesh that spans the processes, each process passing its own
rows of the global batch; it writes its parameters and statistics.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "yolov7_tiny_fakeworld.npz")
V8_FIXTURE = os.path.join(HERE, "fixtures", "yolov8n_fakeworld.npz")
SIZE = 64
BATCH = 4                 # the global batch of the training runs
XUNET_STEPS = 3


def stripe_filter(frame_path, pid, nproc):
    import numpy as np
    from aerial_image_recognition_tpu_torch.gio.geojson import read_geojson
    ring = np.asarray(read_geojson(frame_path)["features"][0]["geometry"]
                      ["coordinates"][0], np.float64)
    edges = np.linspace(ring[:, 0].min(), ring[:, 0].max(), nproc + 1)

    def keep(tiles):
        centers = (tiles[:, 0] + tiles[:, 2]) / 2.0
        mask = (centers >= edges[pid]) & (centers < edges[pid + 1])
        if pid == nproc - 1:
            mask |= centers >= edges[pid + 1]   # the east edge on the last
        return mask
    return keep, edges


def scan(base, server_url, frame_path, tile_filter=None):
    """A CarDetector scan (the trained fixture, 96 px, f32 on the CPU,
    ``data_parallel: true``: one CPU shard, whose mesh spans the processes
    under a process group) of the frame; its records."""
    from aerial_image_recognition_tpu_torch.fetch.wms import WMSFetcher
    from aerial_image_recognition_tpu_torch.gio.geojson import (
        feature_collection_to_detections, read_geojson)
    from aerial_image_recognition_tpu_torch.pipeline.detector import (
        CarDetector)
    fetcher = WMSFetcher(server_url + "/wms", layer="fake", size=(96, 96),
                         num_workers=8, submit_spacing=0.0)
    det = CarDetector(base, {
        "frame_path": frame_path, "tile_size_meters": 48.0,
        "tile_overlap": 0.25, "confidence_threshold": 0.4,
        "nms_iou_threshold": 0.45, "params_path": FIXTURE,
        "dtype": "float32", "model_input_size": (96, 96),
        "duplicate_distance": 0.0, "batch_size": 32, "device_batch": 16,
        "checkpoint_interval": 10**9, "data_parallel": True,
    }, fetcher=fetcher, tile_filter=tile_filter, device="cpu")
    summary = det.detect(interactive=False, force_restart=True)
    import torch
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = det.last_step.mesh
    if mesh.devices != (torch.device("cpu"),) or mesh.size != world:
        raise AssertionError(f"the scan ran over {mesh}")
    recs = feature_collection_to_detections(read_geojson(summary["output"]))
    return summary, recs


def xunet_batch(t):
    """The global batch of step t (the same on every process)."""
    import numpy as np
    rng = np.random.default_rng(1000 + t)
    imgs = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    masks = np.zeros((BATCH, SIZE, SIZE, 1), np.float32)
    for b in range(BATCH):
        cy, cx = rng.integers(8, SIZE - 8, 2)
        r = rng.integers(4, 12)
        masks[b, :, :, 0] = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r)
    return imgs, masks


def v8_batch():
    import numpy as np
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 255, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    imgs[BATCH // 2:] //= 4                    # the second process's rows
    t = np.full((BATCH, 4, 5), -1.0, np.float32)
    t[:, 0] = [0, 30, 30, 9, 5]
    t[1, 1] = t[3, 1] = [1, 12, 50, 20, 10]
    return imgs, t


def train(mesh=None, rows=slice(None)):
    """Three XUnet steps (frozen BN, lr 1e-3) then one yolov8n step
    (``batch`` BN), each process on ``rows`` of every global batch →
    (xunet losses, {name: numpy} of both final states)."""
    import numpy as np
    import torch
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model)
    from aerial_image_recognition_tpu_torch.pipeline.train import (
        init_train_state, make_optimizer, make_train_step)
    torch.manual_seed(0)
    out, losses = {}, []
    bundle = create_model("xunet_256", dtype=torch.float32, device="cpu")
    tx = make_optimizer(lr=1e-3, weight_decay=0.0)
    step = make_train_step(bundle, tx, mesh=mesh, bn_mode="frozen")
    state = init_train_state(bundle, tx)
    for t in range(XUNET_STEPS):
        imgs, masks = xunet_batch(t)
        state, metrics = step(state, imgs[rows], masks[rows])
        losses.append(float(metrics["loss"]))
    out.update({f"xunet:{k}": v.numpy() for k, v in state["params"].items()})
    v8 = create_model("yolov8n", dtype=torch.float32, params_path=V8_FIXTURE,
                      device="cpu")
    tx = make_optimizer(lr=1e-3)
    step = make_train_step(v8, tx, mesh=mesh, bn_mode="batch")
    imgs, targets = v8_batch()
    state, metrics = step(init_train_state(v8, tx), imgs[rows],
                          targets[rows])
    out.update({f"v8:{k}": v.numpy() for k, v in state["params"].items()})
    out.update({f"v8stats:{k}": v.numpy()
                for k, v in state["batch_stats"].items()})
    out["v8:loss"] = np.float32(metrics["loss"])
    return losses, out


def main() -> int:
    import numpy as np
    import torch
    torch.set_num_threads(2)
    from aerial_image_recognition_tpu_torch.parallel.distributed import (
        initialize, process_allgather, shutdown)
    mode, coord, pid, nproc, out_path = (sys.argv[1], sys.argv[2],
                                         int(sys.argv[3]), int(sys.argv[4]),
                                         sys.argv[5])
    ctx = initialize(coord, nproc, pid, backend="gloo")
    assert ctx.process_count == nproc and ctx.process_index == pid, ctx
    # the transport is set up while every process is at the same point
    process_allgather(np.zeros(1, np.int32))
    try:
        if mode == "scan":
            server_url, frame = sys.argv[6], sys.argv[7]
            keep, edges = stripe_filter(frame, pid, nproc)
            summary, recs = scan(os.path.join(os.path.dirname(out_path),
                                              f"scan{pid}"),
                                 server_url, frame, keep)
            counts = process_allgather(np.asarray([len(recs)], np.int32))
            with open(out_path, "w") as f:
                json.dump({"process_index": ctx.process_index,
                           "process_count": ctx.process_count,
                           "global_devices": ctx.global_devices,
                           "stripe_lon": [float(edges[pid]),
                                          float(edges[pid + 1])],
                           "tiles_scanned": summary["tiles"],
                           "counts_allgather": counts.reshape(-1).tolist(),
                           "records": recs}, f)
        else:
            from aerial_image_recognition_tpu_torch.parallel.mesh import (
                mesh_from_flag)
            # one device a process: any data-parallel count gives this
            # process's one device, and the mesh spans the processes
            assert (ctx.local_devices, ctx.global_devices) == (1, nproc), ctx
            for dp in (True, 1, 4):
                mesh = mesh_from_flag(dp, "cpu")
                assert mesh.local_size == 1 and mesh.size == nproc \
                    and mesh.process_index == pid and mesh.group is not None
            per = BATCH // nproc
            losses, state = train(mesh, slice(pid * per, (pid + 1) * per))
            sums = process_allgather(np.asarray([float(np.abs(v).sum())
                                                 for v in state.values()]))
            np.savez(out_path, losses=np.asarray(losses),
                     sums_allgather=sums, **state)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
