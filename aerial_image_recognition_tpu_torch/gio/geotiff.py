"""Pure-Python GeoTIFF read/write (no GDAL/rasterio dependency).

A copy of ``aerial_image_recognition_tpu/gio/geotiff.py``.

Covers the raster workflows the reference ran through GDAL
(x_arch/02_analyze_images cell 6: GeoTIFF read + affine geotransform;
x_arch/car_recognition_on_tiff.py: mask GeoTIFF output): classic TIFF,
stripped or tiled, uint8 samples, compression none/LZW/deflate/packbits,
predictor 1/2 (horizontal differencing — GDAL's usual companion to
LZW/deflate), with the GeoTIFF tags needed for georeferencing
(ModelPixelScale + ModelTiepoint or ModelTransformation, and the EPSG code
from the GeoKey directory).

The affine geotransform follows the GDAL convention:
  x_geo = gt[0] + col·gt[1] + row·gt[2]
  y_geo = gt[3] + col·gt[4] + row·gt[5]
"""

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

# TIFF tags
_TAGS = {
    256: "width", 257: "height", 258: "bits_per_sample",
    259: "compression", 262: "photometric", 273: "strip_offsets",
    277: "samples_per_pixel", 278: "rows_per_strip",
    279: "strip_byte_counts", 282: "x_res", 283: "y_res",
    284: "planar_config", 317: "predictor",
    322: "tile_width", 323: "tile_height",
    324: "tile_offsets", 325: "tile_byte_counts",
    338: "extra_samples", 339: "sample_format",
    33550: "model_pixel_scale", 33922: "model_tiepoint",
    34264: "model_transformation", 34735: "geo_key_directory",
    34736: "geo_double_params", 34737: "geo_ascii_params",
}
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
              10: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}


@dataclass
class GeoTiff:
    data: np.ndarray                      # [H, W, C] uint8
    transform: Tuple[float, float, float, float, float, float]
    epsg: Optional[int] = None

    def pixel_to_geo(self, col, row):
        """Affine pixel→geo (x_arch/02 cell 6 pixel_to_geo parity);
        accepts scalars or arrays."""
        gt = self.transform
        x = gt[0] + np.asarray(col) * gt[1] + np.asarray(row) * gt[2]
        y = gt[3] + np.asarray(col) * gt[4] + np.asarray(row) * gt[5]
        return x, y


def _read_entries(data: bytes, off: int, endian: str) -> Dict:
    (n,) = struct.unpack_from(endian + "H", data, off)
    entries = {}
    for i in range(n):
        tag, typ, count = struct.unpack_from(endian + "HHI",
                                             data, off + 2 + i * 12)
        voff = off + 2 + i * 12 + 8
        size = _TYPE_SIZE.get(typ, 1) * count
        if size > 4:
            (voff,) = struct.unpack_from(endian + "I", data, voff)
        fmt = _TYPE_FMT.get(typ)
        if fmt is None and typ not in (2, 5):
            continue        # unhandled exotic type (2/5 have own branches)
        if typ == 2:   # ascii
            vals = data[voff:voff + count].split(b"\0")[0].decode("latin1")
        elif typ == 5:  # rational
            nums = struct.unpack_from(endian + f"{2 * count}I", data, voff)
            vals = tuple(nums[2 * i] / max(nums[2 * i + 1], 1)
                         for i in range(count))
        else:
            vals = struct.unpack_from(endian + f"{count}{fmt}", data, voff)
        entries[tag] = vals if len(vals) > 1 else (vals if typ == 2 else vals[0])
    (nxt,) = struct.unpack_from(endian + "I", data,
                                off + 2 + n * 12)
    return entries, nxt


def _lzw_decode(raw: bytes, expected: int) -> bytes:
    """TIFF-variant LZW (clear=256, EOI=257, MSB-first bit packing, and the
    TIFF 5.0 "early change": code width grows one code earlier than in
    standard LZW — at table sizes 511/1023/2047). Validated against
    libtiff-written files in tests/test_geotiff_rasters.py."""
    out = bytearray()
    table: List[bytes] = []
    bitbuf = 0
    nbits = 0
    width = 9
    prev = b""
    for byte in raw:
        bitbuf = (bitbuf << 8) | byte
        nbits += 8
        while nbits >= width:
            code = (bitbuf >> (nbits - width)) & ((1 << width) - 1)
            nbits -= width
            if code == 256:                     # clear
                table = [bytes([i]) for i in range(256)] + [b"", b""]
                width = 9
                prev = b""
                continue
            if code == 257:                     # end of information
                return bytes(out)
            if prev:
                if code < len(table):
                    entry = table[code]
                    table.append(prev + entry[:1])
                else:                           # KwKwK case
                    entry = prev + prev[:1]
                    table.append(entry)
                n = len(table)
                if n == 511:
                    width = 10
                elif n == 1023:
                    width = 11
                elif n == 2047:
                    width = 12
            else:
                entry = table[code]
            out += entry
            prev = entry
            if len(out) >= expected:
                return bytes(out)
    return bytes(out)


def _decompress(raw: bytes, compression: int, expected: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:              # LZW
        return _lzw_decode(raw, expected)
    if compression in (8, 32946):     # deflate / zlib
        return zlib.decompress(raw)
    if compression == 32773:          # packbits
        out = bytearray()
        i = 0
        while i < len(raw) and len(out) < expected:
            n = raw[i]
            i += 1
            if n < 128:
                out += raw[i:i + n + 1]
                i += n + 1
            elif n > 128:
                out += raw[i:i + 1] * (257 - n)
                i += 1
        return bytes(out)
    raise NotImplementedError(f"TIFF compression {compression} unsupported "
                              "(supported: none, LZW, deflate, packbits)")


def read_geotiff(path: str) -> GeoTiff:
    with open(path, "rb") as f:
        data = f.read()
    bom = data[:2]
    endian = "<" if bom == b"II" else ">"
    magic, ifd_off = struct.unpack_from(endian + "HI", data, 2)
    if magic != 42:
        raise ValueError("not a classic TIFF (BigTIFF unsupported)")
    entries, _ = _read_entries(data, ifd_off, endian)
    t = {(_TAGS.get(k) or k): v for k, v in entries.items()}

    w, h = int(t["width"]), int(t["height"])
    spp = int(t.get("samples_per_pixel", 1))
    comp = int(t.get("compression", 1))
    bps = t.get("bits_per_sample", 8)
    if isinstance(bps, tuple):
        bps = bps[0]
    if bps != 8:
        raise NotImplementedError("only 8-bit GeoTIFFs supported")
    if int(t.get("planar_config", 1)) != 1:
        raise NotImplementedError("planar_config=2 (separate sample planes) "
                                  "unsupported")
    predictor = int(t.get("predictor", 1))
    if predictor not in (1, 2):
        raise NotImplementedError(f"TIFF predictor {predictor} unsupported "
                                  "(supported: 1 none, 2 horizontal)")

    def undiff(arr: np.ndarray) -> np.ndarray:
        # predictor 2: each sample stores the delta to the pixel on its
        # left; invert with a wrapping per-row prefix sum (per sample).
        if predictor == 2:
            return np.cumsum(arr, axis=1, dtype=np.uint8)
        return arr

    img = np.zeros((h, w, spp), dtype=np.uint8)
    as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
    if "tile_offsets" in t:
        tw, th = int(t["tile_width"]), int(t["tile_height"])
        offs = as_tuple(t["tile_offsets"])
        cnts = as_tuple(t["tile_byte_counts"])
        tiles_x = (w + tw - 1) // tw
        for ti, (o, c) in enumerate(zip(offs, cnts)):
            buf = _decompress(data[o:o + c], comp, tw * th * spp)
            arr = undiff(np.frombuffer(buf, np.uint8,
                                       count=tw * th * spp).reshape(th, tw, spp))
            r0 = (ti // tiles_x) * th
            c0 = (ti % tiles_x) * tw
            img[r0:min(r0 + th, h), c0:min(c0 + tw, w)] = \
                arr[:min(th, h - r0), :min(tw, w - c0)]
    else:
        rps = int(t.get("rows_per_strip", h))
        offs = as_tuple(t["strip_offsets"])
        cnts = as_tuple(t["strip_byte_counts"])
        for si, (o, c) in enumerate(zip(offs, cnts)):
            r0 = si * rps
            rows = min(rps, h - r0)
            buf = _decompress(data[o:o + c], comp, rows * w * spp)
            img[r0:r0 + rows] = undiff(np.frombuffer(
                buf, np.uint8, count=rows * w * spp).reshape(rows, w, spp))

    # georeferencing
    if "model_transformation" in t:
        m = t["model_transformation"]
        transform = (m[3], m[0], m[1], m[7], m[4], m[5])
    elif "model_pixel_scale" in t and "model_tiepoint" in t:
        sx, sy = t["model_pixel_scale"][0], t["model_pixel_scale"][1]
        tp = t["model_tiepoint"]
        # tiepoint: (i, j, k, x, y, z) — pixel (i,j) maps to geo (x,y)
        transform = (tp[3] - tp[0] * sx, sx, 0.0,
                     tp[4] + tp[1] * sy, 0.0, -sy)
    else:
        transform = (0.0, 1.0, 0.0, 0.0, 0.0, -1.0)

    epsg = None
    gk = t.get("geo_key_directory")
    if gk:
        keys = as_tuple(gk)
        for i in range(4, len(keys), 4):
            key_id, loc, cnt, val = keys[i:i + 4]
            if key_id in (3072, 2048) and loc == 0:   # Projected / Geographic
                epsg = int(val)
                if key_id == 3072:
                    break
    return GeoTiff(img, transform, epsg)


def write_geotiff(path: str, data: np.ndarray,
                  transform: Tuple[float, ...], epsg: Optional[int] = None
                  ) -> None:
    """Write uint8 [H,W] or [H,W,C] as a stripped deflate GeoTIFF."""
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    payload = zlib.compress(np.ascontiguousarray(data).tobytes(), 6)

    tags: List[Tuple[int, int, int, bytes]] = []   # (tag, type, count, value)
    extra: List[bytes] = []

    def add(tag, typ, values):
        if not isinstance(values, (tuple, list)):
            values = (values,)
        fmt = _TYPE_FMT[typ]
        raw = struct.pack(f"<{len(values)}{fmt}", *values)
        tags.append((tag, typ, len(values), raw))

    add(256, 4, w)
    add(257, 4, h)
    add(258, 3, tuple([8] * c))
    add(259, 3, 8)                      # deflate
    add(262, 3, 2 if c >= 3 else 1)     # RGB / gray
    add(277, 3, c)
    add(278, 4, h)                      # one strip
    add(279, 4, len(payload))
    add(284, 3, 1)
    gt = transform
    add(33550, 12, (gt[1], -gt[5], 0.0))              # pixel scale
    add(33922, 12, (0.0, 0.0, 0.0, gt[0], gt[3], 0.0))  # tiepoint
    if epsg is not None:
        # minimal geokey dir: version, rev, minor, nkeys + one key
        is_proj = epsg not in (4326, 4258, 4269)
        key_id = 3072 if is_proj else 2048
        add(34735, 3, (1, 1, 0, 2,
                       1024, 0, 1, 1 if is_proj else 2,   # ModelType
                       key_id, 0, 1, epsg))
    add(273, 4, 0)                      # strip offset placeholder (patched)

    tags.sort(key=lambda t_: t_[0])
    n = len(tags)
    header_size = 8
    ifd_size = 2 + n * 12 + 4
    data_area = header_size + ifd_size
    # lay out out-of-line values
    blobs = []
    offsets = {}
    cursor = data_area
    for tag, typ, count, raw in tags:
        if len(raw) > 4:
            offsets[tag] = cursor
            blobs.append(raw)
            cursor += len(raw) + (len(raw) % 2)
    strip_offset = cursor

    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, 8)
    out += struct.pack("<H", n)
    for tag, typ, count, raw in tags:
        if tag == 273:
            raw = struct.pack("<I", strip_offset)
        if len(raw) > 4:
            out += struct.pack("<HHII", tag, typ, count, offsets[tag])
        else:
            out += struct.pack("<HHI", tag, typ, count) + raw.ljust(4, b"\0")
    out += struct.pack("<I", 0)
    for raw in blobs:
        out += raw
        if len(raw) % 2:
            out += b"\0"
    out += payload
    with open(path, "wb") as f:
        f.write(bytes(out))
