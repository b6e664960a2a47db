"""CarDetector — the end-to-end city-scan orchestrator.

Counterpart of ``aerial_image_recognition_tpu/pipeline/detector.py``, with
the same constructor, ``detect()`` and outputs. Public API mirrors the
reference (_script/detector.py:18-237): ``CarDetector(base_dir,
custom_config).detect(interactive=False, force_restart=False)`` — load AOI
frame, generate the deterministic metric tile grid, stream imagery through
the fetch plane, run the batched fused detection step on the CUDA card,
georeference, periodically dedup + checkpoint, and emit GeoJSON/shapefile
results.

Differences from the reference: one step call handles
preprocess→detect→NMS→lon/lat for a whole batch on the card (vs per-image
ONNX calls), fetch/H2D/compute are pipelined (ingest.pipeline: a pinned
upload ring on its own copy stream), and dedup is the grid-bucketed version
(post.dedup, native fastgeo where it builds) instead of a python rtree loop.
Without an injected step, ``detect()`` builds one on ``device`` (default
``cuda``; it raises without CUDA before touching the frame or the network).
"""

import os
import signal
import time
from typing import Dict, Optional

from aerial_image_recognition_tpu_torch.fetch.wms import WMSFetcher
from aerial_image_recognition_tpu_torch.fetch.xyz import XYZFetcher
from aerial_image_recognition_tpu_torch.geo.polygon import polygon_bounds
from aerial_image_recognition_tpu_torch.geo.tiles import generate_tiles
from aerial_image_recognition_tpu_torch.gio.geojson import read_polygons
from aerial_image_recognition_tpu_torch.gio.shapefile import read_polygons_shp
from aerial_image_recognition_tpu_torch.ingest.pipeline import (
    ThreadedPrefetcher, assemble_batches, run_pipeline,
)
from aerial_image_recognition_tpu_torch.pipeline.inference import build_detect_step
from aerial_image_recognition_tpu_torch.post.georef import detections_to_records
from aerial_image_recognition_tpu_torch.post.results import ResultsManager
from aerial_image_recognition_tpu_torch.runtime.checkpoint import (
    CheckpointManager, CheckpointState, grid_fingerprint,
)
from aerial_image_recognition_tpu_torch.runtime.config import DetectorConfig
from aerial_image_recognition_tpu_torch.runtime.device import resolve_device
from aerial_image_recognition_tpu_torch.runtime.observability import (
    DeviceMonitor, EventLog, PhaseTimer,
)


class CarDetector:
    def __init__(self, base_dir: str = ".",
                 custom_config: Optional[Dict] = None,
                 fetcher=None, detect_step=None, tile_filter=None,
                 device=None):
        """fetcher/detect_step injection keeps integration tests hermetic
        (fake server + tiny model) without patching.

        device: where ``detect()`` builds its step when none is injected
        (``build_detect_step(device=)``: None → ``cuda``, raising without
        CUDA; ``"cpu"`` runs on the CPU explicitly).

        tile_filter: optional (tiles [N,4] w/s/e/n) → boolean mask / index
        array selecting the subset THIS process scans (dtype is the
        contract: bool → per-tile mask, integer → tile indices). The multi-host
        fetch-plane sharding hook (SURVEY §2.3 DCN row): every host
        generates the identical GLOBAL grid (deterministic — resume and
        cross-host merge depend on it) and scans only its own stripe's
        tiles; per-tile results are then bitwise-identical to a
        single-host scan and a radius dedup merges the stripe outputs
        exactly (parallel/distributed.merge_host_detections)."""
        self.base_dir = base_dir
        self.config = DetectorConfig().merged(custom_config or {})
        self.timers = PhaseTimer()
        self.events = EventLog(self.config.event_log)
        self._paths()
        self._fetcher = fetcher
        self._detect_step = detect_step
        self._tile_filter = tile_filter
        self._device = device
        self._interrupted = False

    # ------------------------------------------------------------ setup

    def _paths(self):
        c = self.config
        self.frame_path = (c.frame_path if os.path.isabs(c.frame_path)
                           else os.path.join(self.base_dir, "gis", "frames",
                                             c.frame_path))
        if not os.path.exists(self.frame_path):
            self.frame_path = os.path.join(self.base_dir, c.frame_path)
        self.output_dir = os.path.join(self.base_dir, "output")
        self.checkpoint_dir = os.path.join(self.output_dir, "checkpoints")

    def _load_frame(self):
        if self.frame_path.lower().endswith((".geojson", ".json")):
            polys = read_polygons(self.frame_path)
        else:
            polys = read_polygons_shp(self.frame_path)
        if not polys:
            raise ValueError(f"no polygons in frame {self.frame_path}")
        all_rings = [r for p in polys for r in p]
        return polys, polygon_bounds(all_rings)

    def _make_fetcher(self, center_lat: float):
        c = self.config
        if self._fetcher is not None:
            return self._fetcher
        if c.wmts_url:
            from aerial_image_recognition_tpu_torch.fetch.wmts import WMTSFetcher
            return WMTSFetcher(c.wmts_url, c.wmts_layer or "",
                               matrix_set=c.extra.get("wmts_matrix_set",
                                                      "EPSG:2180"),
                               crs=int(c.extra.get("wmts_crs", 2180)),
                               num_workers=c.num_workers,
                               timeout=c.fetch_timeout,
                               retries=c.fetch_retries)
        if c.use_xyz:
            if not c.xyz_url:
                raise ValueError("use_xyz=True requires xyz_url")
            return XYZFetcher(c.xyz_url, zoom=c.zoom,
                              target_size_m=c.tile_size_meters,
                              num_workers=c.num_workers,
                              timeout=c.fetch_timeout,
                              retries=c.fetch_retries)
        with self.timers.phase("fetch_pool_start"):   # its processes
            return WMSFetcher(c.wms_url, c.wms_layer, srs=c.wms_srs,
                              size=c.wms_size, image_format=c.wms_format,
                              num_workers=c.num_workers,
                              timeout=c.fetch_timeout,
                              retries=c.fetch_retries,
                              submit_spacing=float(
                                  c.extra.get("submit_spacing", 0.05)))

    # ------------------------------------------------------------ detect

    def detect(self, interactive: bool = False,
               force_restart: bool = False) -> Dict:
        c = self.config
        t_start = time.time()
        device = (getattr(self._detect_step, "device", None)
                  if self._detect_step is not None
                  else resolve_device(self._device))   # fail fast, no fetch

        with self.timers.phase("setup"):
            polys, bounds = self._load_frame()

        with self.timers.phase("grid_creation"):
            tiles = generate_tiles(bounds, c.tile_size_meters, c.tile_overlap)
            if self._tile_filter is not None:
                import numpy as _np
                sel = _np.asarray(self._tile_filter(_np.asarray(tiles)))
                # dtype is the contract: bool → per-tile mask, integer →
                # tile indices. (A value-based 0/1 heuristic misread a
                # genuine index array [0, 1] over a 2-tile grid as a mask,
                # and a wrong-length mask zip-truncated silently.)
                if sel.dtype == bool:
                    if sel.shape != (len(tiles),):
                        raise ValueError(
                            f"tile_filter mask shape {sel.shape} != "
                            f"({len(tiles)},)")
                    keep = sel
                else:
                    if sel.ndim != 1 or (len(sel) and
                                         (sel.min() < 0
                                          or sel.max() >= len(tiles))):
                        raise ValueError(
                            "tile_filter index array out of range "
                            f"[0, {len(tiles)}): {sel!r}")
                    keep = _np.isin(_np.arange(len(tiles)), sel)
                tiles = [t for t, k in zip(tiles, keep) if k]
        self.events.emit("grid", tiles=len(tiles), bounds=list(bounds))
        fingerprint = grid_fingerprint(bounds, c.tile_size_meters,
                                       c.tile_overlap, len(tiles))

        ckpt = CheckpointManager(self.checkpoint_dir, prefix=c.output_prefix)
        results = ResultsManager(
            self.output_dir, prefix=c.output_prefix,
            duplicate_distance=c.duplicate_distance,
            heatmap_hex_m=float(c.extra.get("heatmap_hex_m", 0.0)))
        start_index = 0
        if not force_restart:
            state = ckpt.load()
            if state is not None:
                if state.grid_fingerprint not in (None, fingerprint):
                    raise RuntimeError(
                        "checkpoint grid mismatch — AOI/tile config changed; "
                        "pass force_restart=True to discard it")
                if interactive:
                    ans = input(f"Resume from tile {state.processed_count}"
                                f"/{state.total_tiles}? (y/n): ")
                    if ans.strip().lower() != "y":
                        state = None
                if state is not None:
                    start_index = state.processed_count
                    results.add(state.detections)
                    print(f"Resuming from tile {start_index}/{len(tiles)} "
                          f"with {len(state.detections)} detections")

        fetcher = self._make_fetcher(center_lat=(bounds[1] + bounds[3]) / 2)
        try:
            if c.extra.get("validate_capabilities", True) \
                    and hasattr(fetcher, "validate"):
                # startup service negotiation (reference
                # wms_handler.py:83-90 opened an owslib connection before
                # any GetMap): a typo'd layer/SRS/format fails HERE, not
                # per-tile for the whole scan
                with self.timers.phase("setup"):
                    caps = fetcher.validate()
                if caps is not None:
                    self.events.emit("capabilities_ok",
                                     layers=len(caps.get("layers", ())))
            # a non-default model_input_size overrides the network input
            # edge (fully-convolutional models; reduced-resolution scans
            # and fixture-scale tests) — the 640 default defers to the
            # model spec
            ms = c.model_input_size[0]
            step = self._detect_step or build_detect_step(
                self._step_config(), batch=c.device_batch,
                src_size=self._src_size(fetcher, bounds),
                model_size=ms if ms != 640 else None,
                mesh=self._make_mesh(), device=device)
        except BaseException:
            if self._fetcher is None:     # its worker processes with it
                fetcher.close()
            raise
        self.last_step = step             # observability (int8 state, tests)

        # without an event log the samples would go nowhere
        monitor = DeviceMonitor(interval=c.monitor_interval,
                                event_log=self.events, print_line=False,
                                device=device).start() \
            if c.event_log else None
        prev_sig = signal.getsignal(signal.SIGINT)
        signal.signal(signal.SIGINT, self._on_interrupt)

        processed = start_index
        since_ckpt = 0
        exc: Optional[BaseException] = None
        prefetch: Optional[ThreadedPrefetcher] = None
        ingest_stats: Dict = {}

        # tile/batch progress display (reference detector.py:188-193 tqdm;
        # the inner fetch counter is its :128-133 bar). extra['progress']:
        # None → auto (tty), True/False → force
        from aerial_image_recognition_tpu_torch.runtime.observability import (
            ProgressBar, _FetchProgress)
        pbar = ProgressBar(len(tiles), desc="tiles", initial=start_index,
                           enabled=c.extra.get("progress"))
        self._fetch_progress = _FetchProgress(pbar)

        def on_result(pbatch, pout):
            nonlocal processed, since_ckpt
            recs, covs = self._collect(pbatch, pout, step)
            results.add(recs, covs)
            done = pbatch.n_valid + len(pbatch.failed_indices)
            processed += done
            since_ckpt += done
            pbar.set_postfix(det=len(results.detections))
            pbar.update(done)
            if since_ckpt >= c.checkpoint_interval:
                self._checkpoint(ckpt, results, processed,
                                 len(tiles), fingerprint, tiles=tiles)
                since_ckpt = 0
            if self._interrupted:
                raise KeyboardInterrupt

        fetch_stats = getattr(getattr(fetcher, "http", None), "stats", None)
        if fetch_stats is not None:
            request_s0, decode_s0 = fetch_stats.request_s, fetch_stats.decode_s
        try:
            with self.timers.phase("processing"):
                gen = self._tile_stream(fetcher, tiles, start_index, step)
                prefetch = ThreadedPrefetcher(gen, depth=c.prefetch_batches)
                # one-batch pipelining (ingest.run_pipeline): upload N+1
                # and dispatch N before reading back N-1, so fetch, H2D and
                # the card's compute overlap with host postprocess
                ingest_stats = run_pipeline(prefetch, step, on_result,
                                            timers=self.timers)
        except BaseException as e:        # checkpoint on ANY failure
            exc = e
        finally:
            pbar.close()
            signal.signal(signal.SIGINT, prev_sig)
            if monitor is not None:
                monitor.stop()
            # stop the producer BEFORE tearing down the fetcher it reads
            # from — otherwise the daemon thread keeps fetching into a
            # closing pool (noisy interrupt at city scale)
            if prefetch is not None:
                prefetch.close()
            if fetch_stats is not None:
                # thread-seconds summed over the fetch workers, not wall
                self.timers.add("tile_request",
                                fetch_stats.request_s - request_s0)
                self.timers.add("tile_decode",
                                fetch_stats.decode_s - decode_s0)
            if exc is not None:
                self._checkpoint(ckpt, results, processed, len(tiles),
                                 fingerprint, tiles=tiles)
                self.events.emit("aborted", processed=processed,
                                 error=repr(exc))
                if self._fetcher is None:
                    fetcher.close()
                if isinstance(exc, KeyboardInterrupt):
                    print(f"\nInterrupted at tile {processed}; "
                          "checkpoint saved.")
                    return {"interrupted": True, "processed": processed}
                raise exc

        with self.timers.phase("duplicate_removal"):
            results.remove_duplicates()
        with self.timers.phase("saving"):
            stats = (fetcher.http.stats.summary()
                     if hasattr(fetcher, "http") else {})
            out_path = results.process_results(metadata={
                "config": {"tile_size_meters": c.tile_size_meters,
                           "tile_overlap": c.tile_overlap,
                           "confidence_threshold": c.confidence_threshold,
                           "model": c.model_path},
                "fetch_stats": stats,
                "ingest_stats": ingest_stats,
                "phase_timings": self.timers.report(),
                "wall_clock_s": round(time.time() - t_start, 2),
            })
        ckpt.clear()                      # success → checkpoint removed
        if self._fetcher is None:
            fetcher.close()
        print(self.timers.format_report())
        self.events.emit("done", detections=len(results.detections),
                         tiles=len(tiles))
        return {"detections": len(results.detections),
                "tiles": len(tiles), "output": out_path,
                "timings": self.timers.report()}

    # ---------------------------------------------------------- helpers

    def _make_mesh(self):
        """Data-parallel inference mesh when configured.

        ``data_parallel: True`` shards the device batch over every visible
        card; an int limits the mesh to that many (``mesh_from_flag``).
        With ``device="cpu"`` the mesh is that many shards of the CPU. The
        reference is single-GPU by construction (gpu_handler.py:42)."""
        from aerial_image_recognition_tpu_torch.parallel.mesh import (
            mesh_from_flag)
        return mesh_from_flag(self.config.extra.get("data_parallel"),
                              self._device)

    def _step_config(self):
        """Detection-step config with slot counts scaled to the tile
        footprint: the 64-slot / 256-candidate defaults were tuned for
        64 m tiles (BASELINE.md NMS A/B); bigger tiles see proportionally
        more cars, so when the user left the defaults in place they scale
        with tile area (capped at 256 slots and 1024 candidates, the
        reference's caps; the NMS kernel takes K ≤ 1024). Explicit values
        are respected as-is."""
        import dataclasses
        import math

        c = self.config
        area = (c.tile_size_meters / 64.0) ** 2
        if area <= 1.0:
            return c
        out = c
        if c.max_detections_per_tile == 64:   # class default → auto-scale
            out = dataclasses.replace(
                out, max_detections_per_tile=min(
                    256, 64 * 2 ** math.ceil(math.log2(area))))
        if "nms_pre_topk" not in c.extra:
            out = dataclasses.replace(out, extra=dict(
                c.extra, nms_pre_topk=min(
                    1024, 256 * 2 ** math.ceil(math.log2(area)))))
        return out

    def _src_size(self, fetcher, bounds) -> int:
        if isinstance(fetcher, XYZFetcher):
            return fetcher.window_px((bounds[1] + bounds[3]) / 2,
                                     self.config.tile_size_meters)
        if isinstance(fetcher, WMSFetcher):
            return fetcher.size[0]
        if hasattr(fetcher, "window_px"):     # WMTS and duck-typed fetchers
            return fetcher.window_px()
        return self.config.model_input_size[0]

    def _tile_stream(self, fetcher, tiles, start_index, step):
        """Fetch tiles (chunked, parallel inside the fetcher; a WMS
        fetcher's next chunk already in flight) and stream (index,
        TileImage) pairs into fixed-shape device batches."""
        c = self.config
        src = step.input_size

        def tile_iter():
            chunk = max(c.batch_size, 1)
            groups = [list(range(i0, min(i0 + chunk, len(tiles))))
                      for i0 in range(start_index, len(tiles), chunk)]
            chunks = ([tuple(tiles[i]) for i in idxs] for idxs in groups)
            prog = getattr(self, "_fetch_progress", None)
            if isinstance(fetcher, WMSFetcher):
                # the next chunk's requests go out while this one is
                # waited for and packed
                fetched = fetcher.fetch_chunks(chunks, progress=prog)
            elif isinstance(fetcher, XYZFetcher):
                fetched = (fetcher.fetch_batch(b, window_px=src,
                                               progress=prog)
                           for b in chunks)
            else:
                fetched = (fetcher.fetch_batch(b, progress=prog)
                           for b in chunks)
            for idxs in groups:
                with self.timers.phase("tile_fetching"):
                    imgs = next(fetched)
                yield from zip(idxs, imgs)

        return assemble_batches(tile_iter(), batch_size=step.batch,
                                src_size=src, layout=step.input_layout,
                                timers=self.timers)

    def _collect(self, batch, out, step):
        det, lon, lat = out
        recs = detections_to_records(
            det, batch.bounds, model_size=step.model_size,
            class_names=step.bundle.spec.class_names)
        kept = []
        for r in recs:
            gidx = int(batch.indices[r.pop("tile_index")])
            if gidx >= 0:                  # drop padding rows
                r["tile"] = gidx
                kept.append(r)
        covs = [tuple(float(v) for v in batch.bounds[i])
                for i in range(batch.n_valid)]
        return kept, covs

    def _checkpoint(self, ckpt, results, processed, total, fingerprint,
                    tiles=None):
        with self.timers.phase("checkpointing"):
            if tiles is not None and processed < len(tiles):
                # frontier-aware compaction: destroying a suppressed record
                # is only safe once nothing near it can still arrive —
                # keeps the final detection set independent of WHERE
                # checkpoints/interrupts land (results.compact docstring)
                import numpy as np
                rem = np.asarray(tiles[processed:], dtype=np.float64)
                active = (float(rem[:, 0].min()), float(rem[:, 1].min()),
                          float(rem[:, 2].max()), float(rem[:, 3].max()))
                results.compact(active)
            else:
                results.compact(None)
            ckpt.save(CheckpointState(
                processed_count=processed, total_tiles=total,
                detections=results.detections,
                grid_fingerprint=fingerprint))
        self.events.emit("checkpoint", processed=processed,
                         detections=len(results.detections))

    def _on_interrupt(self, signum, frame):
        self._interrupted = True
