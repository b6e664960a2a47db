"""Minimal first-party GeoPackage (OGC GPKG 1.2) vector feature IO.

A copy of ``aerial_image_recognition_tpu/gio/geopackage.py``.

The reference ships its hex heatmap as a GeoPackage
(`output/warsaw/hex_heatmap_output.gpkg`) and the SamGeo2 workflow
vectorizes masks to GPKG (`x_arch/car_recognition_on_tiff.py`); both were
written through GDAL/OGR, which the package does not depend on. This
module is a from-scratch writer/reader over stdlib sqlite3: the three
mandatory tables (`gpkg_spatial_ref_sys`, `gpkg_contents`,
`gpkg_geometry_columns`) with the same rows the reference artifact
carries (verified against it: srs entries -1/NONE, 0/NONE, 4326/EPSG;
contents data_type 'features'; geometry_columns z=0 m=0), a feature
table `fid INTEGER PRIMARY KEY` + GPKG-binary `geom` + typed attribute
columns, and little-endian WKB for Point / LineString / Polygon /
MultiPolygon. Readable by GDAL/QGIS; optional extras the reference file
has (rtree index, gpkg_ogr_contents) are GDAL-specific and omitted.
"""

import os
import sqlite3
import struct
from typing import Dict, List, Optional, Sequence

_WKB_TYPE = {"Point": 1, "LineString": 2, "Polygon": 3, "MultiPolygon": 6}
_TYPE_WKB = {v: k for k, v in _WKB_TYPE.items()}


# ------------------------------------------------------------------ WKB

def _wkb_coords(coords) -> bytes:
    return struct.pack("<2d", float(coords[0]), float(coords[1]))


def _wkb_ring(ring) -> bytes:
    return struct.pack("<I", len(ring)) + b"".join(
        _wkb_coords(c) for c in ring)


def encode_wkb(geometry: Dict) -> bytes:
    """GeoJSON-style geometry dict → little-endian WKB."""
    gtype = geometry["type"]
    coords = geometry["coordinates"]
    head = struct.pack("<BI", 1, _WKB_TYPE[gtype])
    if gtype == "Point":
        return head + _wkb_coords(coords)
    if gtype == "LineString":
        return head + _wkb_ring(coords)
    if gtype == "Polygon":
        return (head + struct.pack("<I", len(coords))
                + b"".join(_wkb_ring(r) for r in coords))
    if gtype == "MultiPolygon":
        return (head + struct.pack("<I", len(coords))
                + b"".join(encode_wkb({"type": "Polygon",
                                       "coordinates": p}) for p in coords))
    raise ValueError(f"unsupported geometry type {gtype!r}")


def decode_wkb(buf: bytes, off: int = 0):
    """WKB → (GeoJSON-style geometry dict, bytes consumed)."""
    order = buf[off]
    endian = "<" if order == 1 else ">"
    (wtype,) = struct.unpack_from(endian + "I", buf, off + 1)
    gtype = _TYPE_WKB.get(wtype & 0xFF)
    if gtype is None:
        raise ValueError(f"unsupported WKB geometry type {wtype}")
    pos = off + 5

    def rd_coords():
        nonlocal pos
        x, y = struct.unpack_from(endian + "2d", buf, pos)
        pos += 16
        return [x, y]

    def rd_ring():
        nonlocal pos
        (n,) = struct.unpack_from(endian + "I", buf, pos)
        pos += 4
        return [rd_coords() for _ in range(n)]

    if gtype == "Point":
        coords = rd_coords()
    elif gtype == "LineString":
        coords = rd_ring()
    elif gtype == "Polygon":
        (n,) = struct.unpack_from(endian + "I", buf, pos)
        pos += 4
        coords = [rd_ring() for _ in range(n)]
    else:                                   # MultiPolygon
        (n,) = struct.unpack_from(endian + "I", buf, pos)
        pos += 4
        coords = []
        for _ in range(n):
            g, used = decode_wkb(buf, pos)
            pos += used
            coords.append(g["coordinates"])
    return {"type": gtype, "coordinates": coords}, pos - off


def _gpkg_blob(geometry: Dict, srs_id: int) -> bytes:
    # GP magic, version 0, flags 0x01 (little-endian header, no envelope)
    return (b"GP" + bytes([0, 0x01]) + struct.pack("<i", srs_id)
            + encode_wkb(geometry))


def _gpkg_parse(blob: bytes) -> Dict:
    if blob[:2] != b"GP":
        raise ValueError("not a GeoPackage geometry blob")
    flags = blob[3]
    env_len = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}[(flags >> 1) & 7]
    return decode_wkb(blob, 8 + env_len)[0]


# ---------------------------------------------------------------- tables

_SRS_ROWS = [
    # the exact rows the reference artifact carries
    ("Undefined cartesian SRS", -1, "NONE", -1, "undefined", None),
    ("Undefined geographic SRS", 0, "NONE", 0, "undefined", None),
    ("WGS 84 geodetic", 4326, "EPSG", 4326,
     'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
     '298.257223563]],PRIMEM["Greenwich",0],UNIT["degree",'
     '0.0174532925199433],AUTHORITY["EPSG","4326"]]', None),
]


def _sql_type(v) -> str:
    if isinstance(v, bool):
        return "BOOLEAN"
    if isinstance(v, int):
        return "INTEGER"
    if isinstance(v, float):
        return "REAL"
    return "TEXT"


def write_gpkg(path: str, features: Sequence[Dict], *, layer: str,
               geometry_type: str = "POLYGON", srs_id: int = 4326) -> None:
    """Write GeoJSON-style features to a GeoPackage feature layer.

    features: [{'type':'Feature','properties':{...},'geometry':{...}}]
    (a FeatureCollection dict's 'features' list works directly).
    Attribute columns are the union over all features' properties; each
    column's SQL type comes from its first non-None value.
    """
    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        cur.execute("PRAGMA application_id = 1196444487")   # 'GPKG'
        cur.execute("PRAGMA user_version = 10200")          # spec 1.2
        cur.execute(
            "CREATE TABLE gpkg_spatial_ref_sys (srs_name TEXT NOT NULL, "
            "srs_id INTEGER PRIMARY KEY, organization TEXT NOT NULL, "
            "organization_coordsys_id INTEGER NOT NULL, "
            "definition TEXT NOT NULL, description TEXT)")
        cur.executemany(
            "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            _SRS_ROWS)
        if srs_id not in {r[1] for r in _SRS_ROWS}:
            # any other raster CRS: register the EPSG code; consumers
            # resolve the definition from their own EPSG registry
            cur.execute(
                "INSERT INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
                (f"EPSG:{srs_id}", srs_id, "EPSG", srs_id,
                 f"EPSG:{srs_id}", None))
        cur.execute(
            "CREATE TABLE gpkg_contents (table_name TEXT NOT NULL PRIMARY "
            "KEY, data_type TEXT NOT NULL, identifier TEXT UNIQUE, "
            "description TEXT DEFAULT '', last_change DATETIME DEFAULT "
            "(strftime('%Y-%m-%dT%H:%M:%fZ','now')), min_x DOUBLE, "
            "min_y DOUBLE, max_x DOUBLE, max_y DOUBLE, srs_id INTEGER)")
        cur.execute(
            "CREATE TABLE gpkg_geometry_columns (table_name TEXT NOT NULL,"
            " column_name TEXT NOT NULL, geometry_type_name TEXT NOT NULL,"
            " srs_id INTEGER NOT NULL, z TINYINT NOT NULL, "
            "m TINYINT NOT NULL, CONSTRAINT pk_geom_cols PRIMARY KEY "
            "(table_name, column_name))")

        # column set = union over all features (insertion-ordered); column
        # type = first NON-None value per key, so a leading None can't
        # demote a numeric column to TEXT (sqlite TEXT affinity would then
        # corrupt 0.7 into the string '0.7' on read-back)
        col_types: Dict[str, str] = {}
        seen_real: Dict[str, bool] = {}
        for f in features:
            for k, v in (f.get("properties") or {}).items():
                if v is not None and not seen_real.get(k):
                    col_types[k] = _sql_type(v)
                    seen_real[k] = True
                else:
                    col_types.setdefault(k, "TEXT")
        cols = list(col_types.items())
        col_sql = "".join(f', "{k}" {t}' for k, t in cols)
        cur.execute(f'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY '
                    f"AUTOINCREMENT, geom BLOB{col_sql})")

        xs, ys = [], []
        for f in features:
            blob = _gpkg_blob(f["geometry"], srs_id)
            props = f.get("properties") or {}
            vals = [props.get(k) for k, _t in cols]
            ph = ",".join("?" * (1 + len(cols)))
            cur.execute(f'INSERT INTO "{layer}" (geom'
                        + "".join(f', "{k}"' for k, _t in cols)
                        + f") VALUES ({ph})", [blob] + vals)

            def walk(c):
                if isinstance(c[0], (int, float)):
                    xs.append(float(c[0]))
                    ys.append(float(c[1]))
                else:
                    for sub in c:
                        walk(sub)

            walk(f["geometry"]["coordinates"])
        cur.execute(
            "INSERT INTO gpkg_contents (table_name, data_type, identifier,"
            " min_x, min_y, max_x, max_y, srs_id) VALUES "
            "(?,?,?,?,?,?,?,?)",
            (layer, "features", layer,
             min(xs) if xs else None, min(ys) if ys else None,
             max(xs) if xs else None, max(ys) if ys else None, srs_id))
        cur.execute(
            "INSERT INTO gpkg_geometry_columns VALUES (?,?,?,?,0,0)",
            (layer, "geom", geometry_type, srs_id))
        con.commit()
    finally:
        con.close()


def read_gpkg(path: str, layer: Optional[str] = None) -> Dict:
    """Read a GeoPackage feature layer back as a FeatureCollection dict."""
    con = sqlite3.connect(path)
    try:
        cur = con.cursor()
        if layer is None:
            row = cur.execute("SELECT table_name FROM gpkg_contents WHERE "
                              "data_type='features'").fetchone()
            if row is None:
                raise ValueError(f"no feature layer in {path!r}")
            layer = row[0]
        decl = {r[1]: (r[2] or "").upper() for r in
                cur.execute(f'PRAGMA table_info("{layer}")').fetchall()}
        cur.execute(f'SELECT * FROM "{layer}"')
        names = [d[0] for d in cur.description]
        gi = names.index("geom")
        feats: List[Dict] = []
        for row in cur.fetchall():
            props = {n: (bool(v) if decl.get(n) == "BOOLEAN"
                         and v is not None else v)
                     for i, (n, v) in enumerate(zip(names, row))
                     if i != gi and n != "fid"}
            geom = _gpkg_parse(row[gi]) if row[gi] is not None else None
            feats.append({"type": "Feature", "properties": props,
                          "geometry": geom})
        return {"type": "FeatureCollection", "features": feats,
                "layer": layer}
    finally:
        con.close()
