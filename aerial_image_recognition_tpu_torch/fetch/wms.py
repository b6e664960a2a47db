"""WMS GetMap fetcher.

A copy of ``aerial_image_recognition_tpu/fetch/wms.py``, but for where
``fetch_batch`` runs its requests: in worker processes
(``fetch/workers.py``), not in threads of the calling process.

Functional equivalent of the reference WMSHandler (_script/wms_handler.py):
parallel GetMap requests with retry/backoff (there via owslib + requests
Retry, here via fetch.http.TileHTTP), submit-spacing rate limiting
(wms_handler.py:214: 0.05 s between submissions), a failed-tile re-retry
sweep at increasing delays (wms_handler.py:236-243), fetch stats, and a
tile-preview GeoJSON emitter (wms_handler.py:264-345). owslib is replaced by
direct GetMap 1.1.1 KVP construction — no capabilities round-trip needed for
fixed layer/SRS configs.
"""

import concurrent.futures as cf
import itertools
import time
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

from aerial_image_recognition_tpu_torch.fetch.http import TileHTTP
from aerial_image_recognition_tpu_torch.fetch.workers import FetchPool
from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage


def parse_wms_capabilities(xml_bytes: bytes) -> Dict:
    """Extract {layers, srs, formats} from a WMS capabilities document.

    Namespace-agnostic (matches on local tag names — 1.1.1 documents are
    unnamespaced, 1.3.0 uses the wms namespace) and inheritance-aware for
    SRS/CRS: WMS §7.2.4.6.7 says a child layer inherits every CRS of its
    ancestors, so the set here is the union over the document (sufficient
    for a does-the-service-speak-it check)."""
    import xml.etree.ElementTree as ET
    root = ET.fromstring(xml_bytes)

    def local(tag: str) -> str:
        return tag.rsplit("}", 1)[-1]

    if local(root.tag) not in ("WMT_MS_Capabilities", "WMS_Capabilities"):
        raise ValueError(f"not a WMS capabilities document: {root.tag}")
    layers, srs, formats = set(), set(), set()
    getmap = False
    for el in root.iter():
        tag = local(el.tag)
        if tag == "Layer":
            name = next((c.text for c in el if local(c.tag) == "Name"
                         and c.text), None)
            if name:
                layers.add(name.strip())
        elif tag in ("SRS", "CRS") and el.text:
            # 1.1.1 allows space-separated SRS lists in one element
            srs.update(s.upper() for s in el.text.split())
        elif tag == "GetMap":
            getmap = True
            for f in el.iter():
                if local(f.tag) == "Format" and f.text:
                    formats.add(f.text.strip())
    if not getmap and not layers:
        raise ValueError("capabilities document advertises no GetMap/layers")
    return {"layers": layers, "srs": srs, "formats": formats}


class WMSFetcher:
    """GetMap tiles of one layer. The constructor starts the worker
    processes of ``fetch_batch`` and ``fetch_chunks`` (``fetch/workers.py``)
    and ``close()`` ends them."""

    def __init__(self, url: str, layer: str, *, srs: str = "EPSG:4326",
                 size: Tuple[int, int] = (1280, 1280),
                 image_format: str = "image/jpeg",
                 num_workers: int = 25, timeout: float = 10.0,
                 retries: int = 5, submit_spacing: float = 0.05,
                 version: str = "1.1.1", styles: str = ""):
        self.url = url
        self.layer = layer
        self.srs = srs
        self.size = size
        self.image_format = image_format
        self.num_workers = num_workers
        self.submit_spacing = submit_spacing
        self.version = version
        self.styles = styles
        self.http = TileHTTP(timeout=timeout, retries=retries)
        # ``num_workers`` requests in flight in worker processes, each
        # tile's pixels back through a slot of a shared ring
        self._pool = FetchPool(self.http, num_workers,
                               size[0] * size[1] * 3)

    @property
    def pooled_tiles(self) -> int:
        """Tiles ``fetch_batch`` got through the worker processes."""
        return self._pool.tiles

    def getmap_params(self, bbox) -> Dict[str, str]:
        # WMS 1.3.0 axis order for geographic CRS is lat,lon; 1.1.1 is lon,lat.
        if self.version == "1.3.0" and self.srs.upper() == "EPSG:4326":
            bbox_str = f"{bbox[1]},{bbox[0]},{bbox[3]},{bbox[2]}"
        else:
            bbox_str = f"{bbox[0]},{bbox[1]},{bbox[2]},{bbox[3]}"
        srs_key = "CRS" if self.version == "1.3.0" else "SRS"
        return {
            "SERVICE": "WMS", "VERSION": self.version, "REQUEST": "GetMap",
            "LAYERS": self.layer, "STYLES": self.styles,
            srs_key: self.srs, "BBOX": bbox_str,
            "WIDTH": str(self.size[0]), "HEIGHT": str(self.size[1]),
            "FORMAT": self.image_format,
        }

    def get_capabilities(self) -> Optional[bytes]:
        """GetCapabilities round-trip (one request, startup-time only)."""
        return self.http.get(self.url, params={
            "SERVICE": "WMS", "REQUEST": "GetCapabilities",
            "VERSION": self.version})

    def validate(self) -> Optional[Dict]:
        """Startup service negotiation — the owslib connection the reference
        opens before any GetMap (_script/wms_handler.py:83-90): fetch
        capabilities and check the configured layer(s), SRS and format are
        actually advertised, so a typo'd layer fails HERE with the
        available options listed instead of per-tile for the whole scan.

        Tolerant by design: if the capabilities request itself fails (no
        endpoint support, transient network, fault injection in tests) we
        return None and let the scan proceed — only a RETRIEVED document
        that genuinely lacks the layer/SRS/format raises. Returns the
        parsed {layers, srs, formats} dict when a document was checked.
        """
        body = self.get_capabilities()
        if not body:
            return None
        try:
            caps = parse_wms_capabilities(body)
        except Exception:
            return None                  # not a WMS capabilities document
        if caps["layers"]:
            for name in self.layer.split(","):
                if name and name not in caps["layers"]:
                    raise ValueError(
                        f"WMS layer {name!r} not advertised by {self.url} "
                        f"— available: {sorted(caps['layers'])[:20]}")
        if caps["srs"] and self.srs.upper() not in caps["srs"]:
            raise ValueError(
                f"SRS {self.srs!r} not advertised by {self.url} — "
                f"available: {sorted(caps['srs'])[:20]}")
        if caps["formats"] and self.image_format not in caps["formats"]:
            raise ValueError(
                f"image format {self.image_format!r} not advertised by "
                f"{self.url} — available: {sorted(caps['formats'])}")
        return caps

    def get_single_image(self, bbox) -> Optional[TileImage]:
        """One tile, fetched and decoded in this process."""
        return _tile(bbox, self.http.get_rgb(self.url,
                                             self.getmap_params(bbox)))

    def fetch_batch(self, bboxes: Sequence, progress=None,
                    retry_delays: Sequence[float] = (2.0, 4.0, 8.0)
                    ) -> List[Optional[TileImage]]:
        """Parallel fetch in the worker processes with paced submission,
        then a re-retry sweep over failures at increasing delays; the
        tiles in the order of ``bboxes``, None where a tile failed."""
        return next(self.fetch_chunks([bboxes], progress, retry_delays))

    def fetch_chunks(self, chunks: Iterable[Sequence], progress=None,
                     retry_delays: Sequence[float] = (2.0, 4.0, 8.0)
                     ) -> Iterator[List[Optional[TileImage]]]:
        """``fetch_batch`` of each chunk in turn, each chunk's tiles
        submitted before the one before it is waited for. The worker
        processes' requests then stay in flight across a chunk's end: its
        slowest tile does not leave the other slots idle, and the next
        chunk does not open all its connections at once (a burst that
        overflows a small listen backlog and costs a dropped SYN's second)."""
        ahead = None
        for bboxes in itertools.chain(chunks, [None]):
            submitted = None if bboxes is None else (
                bboxes, self._submit(bboxes, range(len(bboxes))))
            if ahead is not None:
                yield self._finish(*ahead, progress, retry_delays)
            ahead = submitted

    def _submit(self, bboxes: Sequence, indices) -> Dict[cf.Future, int]:
        futs = {}
        for i in indices:
            futs[self._pool.submit(self.url,
                                   self.getmap_params(bboxes[i]))] = i
            if self.submit_spacing:
                time.sleep(self.submit_spacing)
        return futs

    def _finish(self, bboxes: Sequence, futs: Dict[cf.Future, int],
                progress, retry_delays: Sequence[float]
                ) -> List[Optional[TileImage]]:
        results: List[Optional[TileImage]] = [None] * len(bboxes)

        def collect(futs):
            for fut in cf.as_completed(futs):
                i = futs[fut]
                results[i] = _tile(bboxes[i], fut.result())
                if progress is not None and results[i] is not None:
                    progress.update(1)

        collect(futs)
        for delay in retry_delays:
            failed = [i for i, r in enumerate(results) if r is None]
            if not failed:
                break
            time.sleep(delay)
            collect(self._submit(bboxes, failed))
        return results

    def preview_geojson(self, bboxes: Sequence) -> Dict:
        """Tile-grid preview FeatureCollection (wms_handler.py:264-345)."""
        feats = []
        for i, b in enumerate(bboxes):
            feats.append({
                "type": "Feature",
                "geometry": {"type": "Polygon", "coordinates": [[
                    [b[0], b[1]], [b[2], b[1]], [b[2], b[3]],
                    [b[0], b[3]], [b[0], b[1]]]]},
                "properties": {"tile_index": i},
            })
        return {"type": "FeatureCollection", "features": feats,
                "properties": {"count": len(feats),
                               "stats": self.http.stats.summary()}}

    def close(self):
        self._pool.close()
        self.http.close()


def _tile(bbox, arr) -> Optional[TileImage]:
    if arr is None:
        return None
    return TileImage(pixels=arr, bounds=tuple(bbox), meta={"source": "wms"})
