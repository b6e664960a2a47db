"""Pure-Python ESRI shapefile I/O (Point + Polygon), no GDAL/fiona.

A copy of ``aerial_image_recognition_tpu/gio/shapefile.py``.

The reference reads its AOI frames with geopandas (gpd.read_file at
simple_detector.py:763, _script/detector.py:163) and writes shapefile point
layers for QGIS. This environment has neither geopandas nor GDAL, so the
format is implemented directly: .shp (geometry), .shx (index), .dbf
(attributes, dBASE III), .prj (WGS84), .cpg (UTF-8).

Format reference: ESRI Shapefile Technical Description (July 1998).
"""

import datetime
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SHP_POINT = 1
SHP_POLYGON = 5
SHP_NULL = 0

WGS84_WKT = ('GEOGCS["GCS_WGS_1984",DATUM["D_WGS_1984",'
             'SPHEROID["WGS_1984",6378137.0,298.257223563]],'
             'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]]')


@dataclass
class ShapeRecord:
    shape_type: int
    points: np.ndarray                      # [N,2] (x, y)
    parts: List[int] = field(default_factory=list)   # ring start indices
    attributes: Dict[str, object] = field(default_factory=dict)

    def rings(self) -> List[np.ndarray]:
        if self.shape_type != SHP_POLYGON:
            return []
        starts = list(self.parts) + [len(self.points)]
        return [self.points[a:b] for a, b in zip(starts[:-1], starts[1:])]


# ----------------------------------------------------------------- read

def read_shapefile(path: str) -> List[ShapeRecord]:
    """Read .shp (+ .dbf attributes if present). Path may omit extension."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    with open(base + ".shp", "rb") as f:
        data = f.read()
    code = struct.unpack(">i", data[:4])[0]
    if code != 9994:
        raise ValueError(f"not a shapefile (magic {code})")
    records: List[ShapeRecord] = []
    off = 100
    while off + 8 <= len(data):
        _, content_len = struct.unpack(">ii", data[off:off + 8])
        off += 8
        end = off + content_len * 2
        shape_type = struct.unpack("<i", data[off:off + 4])[0]
        if shape_type == SHP_POINT:
            x, y = struct.unpack("<2d", data[off + 4:off + 20])
            records.append(ShapeRecord(SHP_POINT,
                                       np.array([[x, y]], dtype=np.float64)))
        elif shape_type == SHP_POLYGON:
            nparts, npoints = struct.unpack("<2i", data[off + 36:off + 44])
            p0 = off + 44
            parts = list(struct.unpack(f"<{nparts}i",
                                       data[p0:p0 + 4 * nparts]))
            q0 = p0 + 4 * nparts
            pts = np.frombuffer(data[q0:q0 + 16 * npoints],
                                dtype="<f8").reshape(npoints, 2).copy()
            records.append(ShapeRecord(SHP_POLYGON, pts, parts))
        elif shape_type == SHP_NULL:
            records.append(ShapeRecord(SHP_NULL, np.zeros((0, 2))))
        else:
            raise NotImplementedError(f"shape type {shape_type}")
        off = end
    # attach attributes
    dbf_path = base + ".dbf"
    if os.path.exists(dbf_path):
        for rec, attrs in zip(records, read_dbf(dbf_path)):
            rec.attributes = attrs
    return records


def read_polygons_shp(path: str) -> List[List[np.ndarray]]:
    """Shapefile → list of polygons as ring-lists (for geo.points_in_polygon)."""
    return [r.rings() for r in read_shapefile(path)
            if r.shape_type == SHP_POLYGON]


def read_dbf(path: str) -> List[Dict[str, object]]:
    with open(path, "rb") as f:
        data = f.read()
    n_records = struct.unpack("<i", data[4:8])[0]
    header_size, record_size = struct.unpack("<2h", data[8:12])
    fields = []
    off = 32
    while data[off] != 0x0D:
        name = data[off:off + 11].split(b"\x00")[0].decode("ascii")
        ftype = chr(data[off + 11])
        length = data[off + 16]
        decimals = data[off + 17]
        fields.append((name, ftype, length, decimals))
        off += 32
    out = []
    off = header_size
    for _ in range(n_records):
        rec = {}
        p = off + 1          # skip deletion flag
        for name, ftype, length, decimals in fields:
            raw = data[p:p + length]
            p += length
            txt = raw.decode("utf-8", "replace").strip()
            if ftype in ("N", "F"):
                if txt == "":
                    rec[name] = None
                elif decimals or ftype == "F" or "." in txt:
                    rec[name] = float(txt)
                else:
                    rec[name] = int(txt)
            elif ftype == "L":
                rec[name] = txt.upper() in ("T", "Y")
            else:
                rec[name] = txt
        out.append(rec)
        off += record_size
    return out


# ---------------------------------------------------------------- write

def _ring_cw(ring: np.ndarray) -> np.ndarray:
    """Shapefile outer rings must be clockwise (negative shoelace area)."""
    x, y = ring[:, 0], ring[:, 1]
    area = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    return ring[::-1] if area > 0 else ring


def write_shapefile(path: str, records: Sequence[ShapeRecord],
                    fields: Optional[List[Tuple[str, str, int, int]]] = None
                    ) -> None:
    """Write .shp/.shx/.dbf/.prj/.cpg. fields: (name, type, len, decimals);
    inferred from the first record's attributes if omitted."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    os.makedirs(os.path.dirname(os.path.abspath(base + ".shp")), exist_ok=True)

    shape_type = next((r.shape_type for r in records
                       if r.shape_type != SHP_NULL), SHP_POINT)
    contents = []
    for i, rec in enumerate(records):
        if rec.shape_type == SHP_POINT:
            body = struct.pack("<i2d", SHP_POINT,
                               float(rec.points[0, 0]), float(rec.points[0, 1]))
        elif rec.shape_type == SHP_POLYGON:
            rings = [np.asarray(_ring_cw(_close(r)), dtype=np.float64)
                     for r in rec.rings()] or [np.asarray(_close(rec.points))]
            pts = np.concatenate(rings, axis=0)
            parts, acc = [], 0
            for r in rings:
                parts.append(acc)
                acc += len(r)
            body = struct.pack("<i4d2i", SHP_POLYGON,
                               pts[:, 0].min(), pts[:, 1].min(),
                               pts[:, 0].max(), pts[:, 1].max(),
                               len(parts), len(pts))
            body += struct.pack(f"<{len(parts)}i", *parts)
            body += pts.astype("<f8").tobytes()
        else:
            body = struct.pack("<i", SHP_NULL)
        contents.append(body)

    all_pts = np.concatenate([r.points for r in records
                              if len(r.points)], axis=0) if records else np.zeros((1, 2))
    bbox = (all_pts[:, 0].min(), all_pts[:, 1].min(),
            all_pts[:, 0].max(), all_pts[:, 1].max())

    def header(total_words: int) -> bytes:
        return (struct.pack(">i5i i", 9994, 0, 0, 0, 0, 0, total_words)
                + struct.pack("<2i", 1000, shape_type)
                + struct.pack("<8d", bbox[0], bbox[1], bbox[2], bbox[3],
                              0, 0, 0, 0))

    shp_len = 100 + sum(8 + len(c) for c in contents)
    with open(base + ".shp", "wb") as f:
        f.write(header(shp_len // 2))
        for i, c in enumerate(contents):
            f.write(struct.pack(">2i", i + 1, len(c) // 2))
            f.write(c)

    shx_len = 100 + 8 * len(contents)
    with open(base + ".shx", "wb") as f:
        f.write(header(shx_len // 2))
        off = 100
        for c in contents:
            f.write(struct.pack(">2i", off // 2, len(c) // 2))
            off += 8 + len(c)

    write_dbf(base + ".dbf", [r.attributes for r in records], fields)
    with open(base + ".prj", "w") as f:
        f.write(WGS84_WKT)
    with open(base + ".cpg", "w") as f:
        f.write("UTF-8")


def _close(ring: np.ndarray) -> np.ndarray:
    ring = np.asarray(ring, dtype=np.float64)
    if len(ring) and not np.array_equal(ring[0], ring[-1]):
        ring = np.concatenate([ring, ring[:1]], axis=0)
    return ring


def write_dbf(path: str, rows: Sequence[Dict[str, object]],
              fields: Optional[List[Tuple[str, str, int, int]]] = None) -> None:
    if fields is None:
        fields = []
        sample = rows[0] if rows else {}
        for k, v in sample.items():
            if isinstance(v, bool):
                fields.append((k, "L", 1, 0))
            elif isinstance(v, int):
                fields.append((k, "N", 18, 0))
            elif isinstance(v, float):
                fields.append((k, "N", 19, 8))
            else:
                fields.append((k, "C", 64, 0))
        if not fields:
            fields = [("FID", "N", 9, 0)]
            rows = [{"FID": i} for i in range(len(rows))]

    record_size = 1 + sum(f[2] for f in fields)
    header_size = 32 + 32 * len(fields) + 1
    now = datetime.date.today()
    with open(path, "wb") as f:
        f.write(struct.pack("<4B i 2h 20x", 0x03, now.year - 1900, now.month,
                            now.day, len(rows), header_size, record_size))
        for name, ftype, length, dec in fields:
            f.write(struct.pack("<11s c 4x 2B 14x",
                                name.encode("ascii")[:11],
                                ftype.encode("ascii"), length, dec))
        f.write(b"\x0d")
        for row in rows:
            f.write(b" ")
            for name, ftype, length, dec in fields:
                v = row.get(name)
                if ftype == "N":
                    s = ("" if v is None else
                         (f"{v:.{dec}f}" if dec else str(int(v))))
                    f.write(s.rjust(length)[:length].encode("ascii"))
                elif ftype == "L":
                    f.write(b"T" if v else b"F")
                else:
                    s = "" if v is None else str(v)
                    f.write(s.ljust(length)[:length].encode("utf-8")[:length]
                            .ljust(length, b" "))
        f.write(b"\x1a")


def detections_to_shapefile(path: str, records: Sequence[dict]) -> None:
    """Detection dicts → point shapefile (QGIS-consumable output layer)."""
    shp_records = [
        ShapeRecord(SHP_POINT,
                    np.array([[r["lon"], r["lat"]]], dtype=np.float64),
                    attributes={"CONF": float(r["confidence"]),
                                "CLASS": r.get("class", "car")})
        for r in records]
    write_shapefile(path, shp_records,
                    fields=[("CONF", "N", 19, 8), ("CLASS", "C", 16, 0)])
