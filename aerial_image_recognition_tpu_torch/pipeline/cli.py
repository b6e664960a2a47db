"""Command-line interface of the PyTorch port.

Counterpart of ``aerial_image_recognition_tpu/pipeline/cli.py``: the same
verbs, flags and defaults (so ``_overrides`` gives the same config dict for
the same argv), plus one flag of the port's own, ``--device``, on every
verb that builds a model. Without it the model runs on ``cuda``, and a
machine without CUDA makes the verb exit non-zero before it reads or
fetches anything; ``--device cpu`` runs on the CPU explicitly.

Ported verbs: detect, sweep, doctor, train, geotiff, serve (with
``/segment`` under ``--segment-params``), automask, predict, val,
import-weights, export, calibrate; ``--data-parallel [N]`` on detect,
sweep and serve shards the device batch over every (or N) card, or over N
CPU shards with ``--device cpu``. Parsed, then refused with
NotImplementedError naming what brings it: bench (the port's benchmark).
``train`` has no ``--data-parallel``, as the reference's verb has none:
argparse refuses it.

Usage:
  python -m aerial_image_recognition_tpu_torch detect --frame warsaw.shp \\
      --xyz-url "http://mt{s}.google.com/vt/lyrs=s&x={x}&y={y}&z={z}" --use-xyz
  python -m aerial_image_recognition_tpu_torch detect --frame aoi.geojson \\
      --device cpu
"""

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np


def _add_device(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="device to run the model on (default: cuda, and "
                        "an error without CUDA); e.g. cpu")


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--base-dir", default=".")
    p.add_argument("--frame", dest="frame_path",
                   help="AOI frame (.shp or .geojson)")
    p.add_argument("--model", dest="model_path", default="yolov7_itcvd")
    p.add_argument("--wms-url", dest="wms_url")
    p.add_argument("--wms-layer", dest="wms_layer")
    p.add_argument("--xyz-url", dest="xyz_url")
    p.add_argument("--use-xyz", dest="use_xyz", action="store_true",
                   default=None)
    p.add_argument("--zoom", type=int)
    p.add_argument("--tile-size-meters", dest="tile_size_meters", type=float)
    p.add_argument("--tile-overlap", dest="tile_overlap", type=float)
    p.add_argument("--confidence-threshold", dest="confidence_threshold",
                   type=float)
    p.add_argument("--batch-size", dest="batch_size", type=int)
    p.add_argument("--device-batch", dest="device_batch", type=int)
    p.add_argument("--checkpoint-interval", dest="checkpoint_interval",
                   type=int)
    p.add_argument("--duplicate-distance", dest="duplicate_distance",
                   type=float)
    p.add_argument("--num-workers", dest="num_workers", type=int)
    p.add_argument("--output-prefix", dest="output_prefix")
    p.add_argument("--event-log", dest="event_log")
    p.add_argument("--params", dest="params_path",
                   help="model parameter checkpoint (.npz)")
    p.add_argument("--tta", action="store_true", default=None,
                   help="lighting TTA variation stack (gpu_handler parity)")
    p.add_argument("--multiscale", default=None,
                   help="comma-separated inference scales, e.g. 0.85,1,1.15")
    p.add_argument("--heatmap-hex", dest="heatmap_hex_m", type=float,
                   help="emit hex-density heatmap with this hex size (m)")
    p.add_argument("--enhance-shadows", dest="enhance_shadows",
                   action="store_true", default=None)
    p.add_argument("--data-parallel", dest="data_parallel", nargs="?",
                   const=True, type=int, default=None, metavar="N",
                   help="shard the device batch over all (or N) cards "
                        "(N CPU shards with --device cpu)")
    p.add_argument("--quantize", choices=["int8"], default=None,
                   help="int8-PTQ the detector trunk (models/int8.py). "
                        "Without --quantize-calib it self-calibrates on "
                        "the scan's own first batches, parity-gated with "
                        "automatic bf16 fallback")
    p.add_argument("--quantize-calib", dest="quantize_calib", default=None,
                   help="optional calibration JSON from the `calibrate` "
                        "verb (skips self-calibration)")
    _add_device(p)


def _overrides(args) -> Dict:
    skip = {"base_dir", "command", "force_restart", "interactive", "device"}
    out = {k: v for k, v in vars(args).items()
           if v is not None and k not in skip}
    if isinstance(out.get("multiscale"), str):
        out["multiscale"] = [float(s) for s in out["multiscale"].split(",")]
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="aerial_image_recognition_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    pd = sub.add_parser("detect", help="run a city scan")
    _add_common(pd)
    pd.add_argument("--force-restart", action="store_true")
    pd.add_argument("--interactive", action="store_true")

    ps = sub.add_parser("sweep", help="resolution sweep "
                        "(test_configurations.py parity)")
    _add_common(ps)
    ps.add_argument("--tile-sizes", default="100,64,51.2,25,20",
                    help="comma-separated tile sizes in meters")

    pb = sub.add_parser("bench", help="throughput benchmark (arrives with "
                        "the port's benchmark)")
    pb.add_argument("--batch", type=int, default=128)

    sub.add_parser("doctor", help="environment diagnostic "
                   "(check_gpu.py parity)")

    pt = sub.add_parser("train", help="train a detector from COCO labels "
                        "(01_train_tokyo.ipynb workflow)")
    pt.add_argument("--coco", required=True, help="COCO instances json")
    pt.add_argument("--images", required=True, help="image directory")
    pt.add_argument("--model", default="yolov8_tokyo")
    pt.add_argument("--epochs", type=int, default=300)
    pt.add_argument("--imgsz", type=int, default=768)
    pt.add_argument("--batch", type=int, default=8)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--n-train", type=int, default=80)
    pt.add_argument("--params", default=None,
                    help="start from an existing .npz checkpoint instead "
                         "of random init")
    pt.add_argument("--bn-mode", default="auto",
                    choices=["auto", "batch", "frozen"])
    pt.add_argument("--lr-schedule", default="constant",
                    choices=["constant", "cosine", "linear"])
    pt.add_argument("--warmup-epochs", type=float, default=0.0)
    pt.add_argument("--freeze", default=None,
                    help="comma list of upstream yaml layer indices and/or "
                         "module prefixes to freeze")
    pt.add_argument("--copy-paste", dest="copy_paste", type=float,
                    default=0.0, help="copy-paste augmentation probability")
    pt.add_argument("--fliplr", type=float, default=0.0,
                    help="horizontal-flip probability")
    pt.add_argument("--flipud", type=float, default=0.0)
    pt.add_argument("--close-mosaic", dest="close_mosaic", type=int,
                    default=0, help="disable mosaic/mixup/copy-paste for "
                    "the last N epochs")
    pt.add_argument("--scale", type=float, default=0.0,
                    help="random affine scale range")
    pt.add_argument("--translate", type=float, default=0.0,
                    help="random affine translate range")
    pt.add_argument("--patience", type=int, default=0,
                    help="early stopping: epochs without fitness "
                         "improvement; 0 disables")
    pt.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="EMA weight averaging, e.g. 0.9999")
    pt.add_argument("--out", required=True, help="output checkpoint (.npz)")
    _add_device(pt)

    pg = sub.add_parser("geotiff", help="sliding-window detection over a "
                        "GeoTIFF (02_analyze_images workflow)")
    pg.add_argument("path")
    pg.add_argument("--model", default="yolov8_tokyo")
    pg.add_argument("--params")
    pg.add_argument("--window", type=int, default=1200)
    pg.add_argument("--stride", type=int, default=600)
    pg.add_argument("--confidence", type=float, default=0.4)
    pg.add_argument("--out", help="output geojson")
    pg.add_argument("--quantize", choices=["int8"], default=None)
    pg.add_argument("--quantize-calib", dest="quantize_calib", default=None)
    _add_device(pg)

    pv = sub.add_parser("serve", help="HTTP detection service with dynamic "
                        "batching")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--model", dest="model_path", default="yolov7_itcvd")
    pv.add_argument("--params", dest="params_path")
    pv.add_argument("--batch", type=int, default=64)
    pv.add_argument("--confidence-threshold", type=float, default=0.3)
    pv.add_argument("--max-wait-ms", type=float, default=10.0)
    pv.add_argument("--data-parallel", dest="data_parallel", nargs="?",
                    const=True, type=int, default=None, metavar="N",
                    help="shard the serving batch over all (or N) cards "
                         "(N CPU shards with --device cpu)")
    pv.add_argument("--quantize", choices=["int8"], default=None)
    pv.add_argument("--quantize-calib", dest="quantize_calib", default=None)
    pv.add_argument("--segment-params", dest="segment_params", default=None,
                    help="XUnet-256 checkpoint (.npz) — also serve "
                    "POST /segment building-segmentation requests")
    pv.add_argument("--segment-batch", dest="segment_batch", type=int,
                    default=16)
    _add_device(pv)

    pm = sub.add_parser("automask", help="automatic instance masks over a "
                        "GeoTIFF (SAM2 workflow parity)")
    pm.add_argument("path")
    pm.add_argument("--params")
    pm.add_argument("--window", type=int, default=256)
    pm.add_argument("--min-area", type=int, default=20)
    pm.add_argument("--stability", type=float, default=0.6)
    pm.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8-PTQ the XUnet trunk (self-calibrates on "
                         "the raster's own windows)")
    pm.add_argument("--stride", type=int, default=None,
                    help="window stride; < window overlap-averages the "
                         "stitched probabilities (seam mitigation)")
    pm.add_argument("--out-mask")
    pm.add_argument("--out-polygons")
    _add_device(pm)

    pp = sub.add_parser("predict", help="detect on image files of any "
                        "size (the notebook's cells 27-29 spot-check; "
                        "boxes in original pixels, optional annotated "
                        "copies)")
    pp.add_argument("images", nargs="+", help="image files")
    pp.add_argument("--model", default="yolov7_itcvd")
    pp.add_argument("--params", default=None)
    pp.add_argument("--confidence", type=float, default=0.25)
    pp.add_argument("--imgsz", type=int, default=None,
                    help="inference resolution (default: the model's "
                         "registry input size)")
    pp.add_argument("--annotate", metavar="DIR", default=None,
                    help="write box-annotated copies into this directory")
    _add_device(pp)

    pl = sub.add_parser("val", help="evaluate a checkpoint's mAP on a "
                        "COCO-labeled set (notebook cell 22)")
    pl.add_argument("--coco", required=True)
    pl.add_argument("--images", required=True)
    pl.add_argument("--model", default="yolov8_tokyo")
    pl.add_argument("--params", default=None)
    pl.add_argument("--imgsz", type=int, default=640)
    pl.add_argument("--batch", type=int, default=8)
    pl.add_argument("--confidence", type=float, default=0.25)
    _add_device(pl)

    pe = sub.add_parser("export", help="export a trained checkpoint as a "
                        "reference-format .onnx initializer blob (torch "
                        "state-dict names, deploy-fused IDetect)")
    pe.add_argument("params", help="framework .npz checkpoint")
    pe.add_argument("out", help="output .onnx path")
    pe.add_argument("--model", default="yolov7_itcvd")
    _add_device(pe)

    pi = sub.add_parser("import-weights", help="turnkey weight drop: a "
                        "reference .onnx blob (torch state-dict initializer "
                        "names) or ultralytics .pt checkpoint → framework "
                        ".npz checkpoint, shape-validated against the "
                        "chosen registry model")
    pi.add_argument("onnx", help="reference blob: .onnx or .pt/.pth")
    pi.add_argument("--model", default="yolov7_itcvd",
                    help="registry model the blob belongs to "
                         "(yolov7_itcvd, yolov7_base, yolov8_tokyo, "
                         "yolov8n..x)")
    pi.add_argument("--out", required=True, help="output .npz checkpoint")
    _add_device(pi)

    pq = sub.add_parser("calibrate", help="record int8 activation scales "
                        "from representative imagery (a GeoTIFF); feed the "
                        "result to detect/serve via --quantize-calib")
    pq.add_argument("path", help="representative GeoTIFF")
    pq.add_argument("--model", default="yolov7_itcvd")
    pq.add_argument("--params")
    pq.add_argument("--window", type=int, default=640)
    pq.add_argument("--max-windows", type=int, default=64)
    pq.add_argument("--model-size", type=int, default=None,
                    help="calibration resolution (defaults to --window — "
                         "activation scales are resolution-dependent, so "
                         "match the deployment model_size)")
    pq.add_argument("--out", required=True, help="output calibration JSON")
    _add_device(pq)
    return parser


# what brings each verb or flag the port parses but does not run yet
_LATER = {
    "bench": "the bench verb arrives with the port's own benchmark; until "
             "then chip_smoke.py measures the port on the card",
}


def _f32_tree(tree):
    return {k: _f32_tree(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def _coco_samples(args):
    import dataclasses
    import os

    from aerial_image_recognition_tpu_torch.pipeline.data import (
        TOKYO_CLASS_REMAP, coco_to_yolo)
    remap = TOKYO_CLASS_REMAP if "tokyo" in args.model else None
    samples = coco_to_yolo(args.coco, class_remap=remap)
    return [dataclasses.replace(
        s, image_path=os.path.join(args.images,
                                   os.path.basename(s.image_path)))
        for s in samples]


def _train_or_val(args) -> int:
    """The train and val verbs: the reference's, on ``--device``."""
    import torch
    from aerial_image_recognition_tpu_torch.models.registry import (
        create_model, save_params)
    from aerial_image_recognition_tpu_torch.models.weights import (
        state_from_flax)
    from aerial_image_recognition_tpu_torch.pipeline.data import (
        DetectionLoader, LoaderConfig, train_val_split)
    from aerial_image_recognition_tpu_torch.pipeline.train import (
        evaluate, fit)
    from aerial_image_recognition_tpu_torch.runtime.device import (
        resolve_device)
    # without CUDA and without --device this raises before any read
    device = resolve_device(args.device)
    samples = _coco_samples(args)
    vcfg = LoaderConfig(image_size=args.imgsz, batch_size=args.batch,
                        mosaic=0.0, mixup=0.0, hsv=0.0)
    if args.command == "val":
        loader = DetectionLoader(samples, vcfg, train=False)
        bundle = create_model(args.model, dtype=torch.float32,
                              params_path=args.params, device=device)
        metrics = evaluate(bundle,
                           state_from_flax(bundle.variables, device),
                           loader, conf_threshold=args.confidence)
        print(json.dumps({"model": args.model, "params": args.params,
                          "n_images": len(samples), **metrics}))
        return 0

    train_s, val_s = train_val_split(samples, args.n_train)
    lcfg = LoaderConfig(image_size=args.imgsz, batch_size=args.batch,
                        copy_paste=args.copy_paste,
                        fliplr=args.fliplr, flipud=args.flipud,
                        close_mosaic=args.close_mosaic,
                        scale=args.scale, translate=args.translate)
    freeze = ([s.strip() for s in args.freeze.split(",") if s.strip()]
              if args.freeze else None)
    # checkpoints may carry bf16 inference weights: the reader widens them
    # to f32, which the optimizer needs
    bundle = create_model(args.model, dtype=torch.float32,
                          params_path=args.params, device=device)
    state = fit(bundle, DetectionLoader(train_s, lcfg),
                epochs=args.epochs, lr=args.lr,
                eval_loader=DetectionLoader(val_s, vcfg, train=False),
                eval_every=max(1, args.epochs // 10),
                bn_mode=args.bn_mode, lr_schedule=args.lr_schedule,
                warmup_epochs=args.warmup_epochs, ema_decay=args.ema,
                freeze=freeze, patience=args.patience or None)
    history = state.pop("history")
    # the weights to deploy: the best-fitness epoch when eval tracked one
    # (ultralytics best.pt), else the final (EMA when enabled) weights
    best = state.get("best")
    if best is not None:
        save_params({"params": best["params"],
                     "batch_stats": best["batch_stats"]}, args.out)
    else:
        save_params({"params": state.get("ema_params", state["params"]),
                     "batch_stats": state["batch_stats"]}, args.out)
    out = {"checkpoint": args.out, "final": history[-1]}
    if best is not None:
        out["best"] = {"epoch": best["epoch"], "fitness": best["fitness"]}
    print(json.dumps(out))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command in _LATER:
        raise NotImplementedError(_LATER[args.command])

    if args.command == "calibrate":
        import torch
        from aerial_image_recognition_tpu_torch.gio.geotiff import (
            read_geotiff)
        from aerial_image_recognition_tpu_torch.models.int8 import (
            calibrate_absmax, save_absmax)
        from aerial_image_recognition_tpu_torch.models.registry import (
            create_model)
        from aerial_image_recognition_tpu_torch.pipeline.rasters import (
            _extract, iter_windows)
        bundle = create_model(args.model, dtype=torch.float32,
                              params_path=args.params, device=args.device,
                              fold_bn=True)
        gt = read_geotiff(args.path)
        h, w = gt.data.shape[:2]
        corners = list(iter_windows(h, w, args.window, args.window))
        corners = corners[:args.max_windows]
        # chunked batches (absmax is a running max) — one capture-all
        # forward over 64 full-res windows would hold every intermediate
        # activation at once
        batches = [np.stack([_extract(gt.data, r, c, args.window)
                             for r, c in corners[i:i + 8]])
                   for i in range(0, len(corners), 8)]
        absmax = calibrate_absmax(bundle, batches,
                                  model_size=args.model_size or args.window)
        save_absmax(args.out, absmax)
        print(json.dumps({"out": args.out, "model": args.model,
                          "windows": len(corners),
                          "records": len(absmax)}))
        return 0

    if args.command == "import-weights":
        import torch
        from aerial_image_recognition_tpu_torch.models.import_torch import (
            validate_variable_shapes, variables_from_torch_state)
        from aerial_image_recognition_tpu_torch.models.onnx_lite import (
            load_onnx_initializers)
        from aerial_image_recognition_tpu_torch.models.registry import (
            create_model, save_params)
        # the registry model whose shapes the import must match, first:
        # without CUDA and without --device this raises before any read
        ref = create_model(args.model, dtype=torch.float32,
                           device=args.device)
        if args.onnx.endswith((".pt", ".pth")):
            from aerial_image_recognition_tpu_torch.models.torch_pt import (
                load_checkpoint_state)
            sd = load_checkpoint_state(args.onnx)
        else:
            sd = load_onnx_initializers(args.onnx)
        if not sd:
            raise SystemExit(f"no initializer tensors found in {args.onnx!r}")
        variables = variables_from_torch_state(sd, args.model)
        validate_variable_shapes(variables, ref.variables)
        save_params(variables, args.out)
        print(json.dumps({"out": args.out, "model": args.model,
                          "initializers": len(sd)}))
        return 0

    if args.command == "export":
        import torch
        from aerial_image_recognition_tpu_torch.models.import_torch import (
            torch_state_from_variables)
        from aerial_image_recognition_tpu_torch.models.onnx_lite import (
            write_minimal_onnx)
        from aerial_image_recognition_tpu_torch.models.registry import (
            create_model)
        bundle = create_model(args.model, dtype=torch.float32,
                              params_path=args.params, device=args.device)
        if bundle.spec.family not in ("yolov7", "yolov8"):
            raise SystemExit("export supports the detection families "
                             "(yolov7 tiny/base, yolov8 n..x/tokyo); the "
                             "reference's XUnet blob has no upstream torch "
                             "naming to export to")
        tensors = torch_state_from_variables(_f32_tree(bundle.variables),
                                             bundle.spec.name)
        write_minimal_onnx(args.out, tensors)
        print(json.dumps({"out": args.out, "tensors": len(tensors)}))
        return 0

    if args.command in ("train", "val"):
        return _train_or_val(args)

    if args.command == "doctor":
        from aerial_image_recognition_tpu_torch.runtime.doctor import (
            main as doc)
        return doc()

    if args.command == "detect":
        from aerial_image_recognition_tpu_torch.pipeline.detector import (
            CarDetector)
        det = CarDetector(args.base_dir, _overrides(args), device=args.device)
        out = det.detect(interactive=args.interactive,
                         force_restart=args.force_restart)
        print(json.dumps(out, default=str))
        return 0

    if args.command == "sweep":
        from aerial_image_recognition_tpu_torch.pipeline.sweep import (
            run_sweep)
        sizes = [float(s) for s in args.tile_sizes.split(",")]
        out = run_sweep(args.base_dir, _overrides(args), sizes,
                        device=args.device)
        print(json.dumps(out, indent=2, default=str))
        return 0

    if args.command == "predict":
        import os

        from aerial_image_recognition_tpu_torch.pipeline.predict import (
            draw_predictions, predict_images)
        preds = predict_images(args.images, model=args.model,
                               params=args.params,
                               confidence=args.confidence,
                               imgsz=args.imgsz, device=args.device)
        if args.annotate:
            os.makedirs(args.annotate, exist_ok=True)
            for p in preds:
                draw_predictions(p, os.path.join(
                    args.annotate, os.path.basename(p.path)))
        print(json.dumps({"images": [p.to_json() for p in preds]}))
        return 0

    if args.command == "geotiff":
        from aerial_image_recognition_tpu_torch.pipeline.rasters import (
            detect_geotiff)
        recs = detect_geotiff(
            args.path, window=args.window, stride=args.stride,
            confidence=args.confidence, model=args.model,
            params=args.params, quantize=args.quantize,
            quantize_calib=args.quantize_calib, output_geojson=args.out,
            device=args.device)
        print(json.dumps({"detections": len(recs), "output": args.out}))
        return 0

    if args.command == "serve":
        import time as _time

        from aerial_image_recognition_tpu_torch.pipeline.serve import (
            DetectionServer)
        srv = DetectionServer(
            {"model_path": args.model_path, "params_path": args.params_path,
             "device_batch": args.batch,
             "confidence_threshold": args.confidence_threshold,
             "data_parallel": args.data_parallel,
             "quantize": args.quantize,
             "quantize_calib": args.quantize_calib},
            host=args.host, port=args.port,
            max_wait_ms=args.max_wait_ms,
            segment_params=args.segment_params,
            segment_batch=args.segment_batch, device=args.device).start()
        # flushed: a supervising process reads the address from the pipe
        print(json.dumps({"serving": srv.url,
                          "model": srv.step.bundle.spec.name}), flush=True)
        try:
            while True:
                _time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
        return 0

    if args.command == "automask":
        from aerial_image_recognition_tpu_torch.pipeline.automask import (
            automask_geotiff)
        inst = automask_geotiff(
            args.path, window=args.window, params=args.params,
            quantize=args.quantize, stride=args.stride,
            min_area_px=args.min_area, stability_min=args.stability,
            output_mask=args.out_mask, output_polygons=args.out_polygons,
            device=args.device)
        print(json.dumps({"instances": len(inst)}))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
