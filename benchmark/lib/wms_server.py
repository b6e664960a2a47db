"""The scan cell's WMS server, a process of its own.

Run as ``python wms_server.py '<json>'`` with the world's parameters
(seed, lon0, lat0, extent_m, cars_per_km2, jpeg_quality, render_workers);
it prints ``PORT <n>`` on its first line and serves on 127.0.0.1, with
an accept queue of 1024, until it is sent SIGTERM:

* ``GetCapabilities``: a WMS 1.1.1 document with the one layer ``aerial``
  in EPSG:4326 as image/jpeg;
* ``GetMap``: the bbox rendered by ``tiles.World`` at the requested size
  and JPEG-encoded, each distinct request once, by a pool of ``spawn``
  processes; after that from memory;
* ``/served``: JSON {"bboxes": [[w, s, e, n], ...], "renders": n,
  "requests": n}, the distinct GetMap bboxes in the order first asked.

It imports neither torch nor the program.
"""

import json
import multiprocessing as mp
import os
import signal
import sys
import threading
from concurrent.futures import ProcessPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.lib import tiles  # noqa: E402

CAPABILITIES = b"""<?xml version="1.0" encoding="UTF-8"?>
<WMT_MS_Capabilities version="1.1.1">
  <Capability>
    <Request><GetMap><Format>image/jpeg</Format></GetMap></Request>
    <Layer>
      <Title>benchmark world</Title>
      <SRS>EPSG:4326</SRS>
      <Layer queryable="0"><Name>aerial</Name><Title>aerial</Title></Layer>
    </Layer>
  </Capability>
</WMT_MS_Capabilities>"""

_world = None


def _init(params):
    global _world
    _world = tiles.World(params["seed"], params["lon0"], params["lat0"],
                         params["extent_m"], params["cars_per_km2"])


def _render(bbox, width, height, quality):
    return tiles.jpeg(_world.render(bbox, width, height), quality)


class Store:
    """Each distinct GetMap rendered once by the pool, then served from
    memory."""

    def __init__(self, params):
        self.quality = int(params["jpeg_quality"])
        self.pool = ProcessPoolExecutor(
            int(params["render_workers"]), mp.get_context("spawn"),
            initializer=_init, initargs=(params,))
        self.lock = threading.Lock()
        self.futures = {}
        self.order = []
        self.requests = 0

    def get(self, bbox_text: str, width: int, height: int) -> bytes:
        key = (bbox_text, width, height)
        with self.lock:
            self.requests += 1
            fut = self.futures.get(key)
            if fut is None:
                bbox = tuple(float(v) for v in bbox_text.split(","))
                fut = self.pool.submit(_render, bbox, width, height,
                                       self.quality)
                self.futures[key] = fut
                self.order.append(bbox)
        return fut.result()

    def served(self) -> bytes:
        with self.lock:
            return json.dumps({"bboxes": self.order,
                               "renders": len(self.futures),
                               "requests": self.requests}).encode()


class Server(ThreadingHTTPServer):
    """A production server's accept queue: at socketserver's default of 5
    the scan's parallel connections overflow it, and each dropped SYN
    holds its request for a 1-s or 3-s retransmit."""
    daemon_threads = True
    request_queue_size = 1024


def serve(params):
    store = Store(params)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def reply(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/served":
                return self.reply(store.served(), "application/json")
            q = {k.upper(): v[0] for k, v in parse_qs(url.query).items()}
            req = q.get("REQUEST", "")
            if req == "GetCapabilities":
                return self.reply(CAPABILITIES, "text/xml")
            if req == "GetMap" and q.get("LAYERS") == "aerial":
                return self.reply(store.get(q["BBOX"], int(q["WIDTH"]),
                                            int(q["HEIGHT"])), "image/jpeg")
            self.send_response(404)
            self.end_headers()

    httpd = Server(("127.0.0.1", 0), Handler)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    print(f"PORT {httpd.server_address[1]}", flush=True)
    while not stop.wait(0.5):
        pass
    httpd.shutdown()
    httpd.server_close()
    store.pool.shutdown(wait=True, cancel_futures=True)


if __name__ == "__main__":
    serve(json.loads(sys.argv[1]))
