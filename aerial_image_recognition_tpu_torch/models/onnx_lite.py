"""Minimal ONNX weight extraction — no `onnx` package required.

Copy of ``aerial_image_recognition_tpu/models/onnx_lite.py``.

The reference ships its models as ONNX blobs
(car_aerial_detection_yolo7_ITCVD_deepness.onnx etc.), and this module
reads them without `onnx`/`onnxruntime`. ONNX files are protobufs, and extracting weights only needs the initializer tensors, so
this module walks the protobuf wire format directly:

  ModelProto.graph (field 7) → GraphProto.initializer (field 5, repeated
  TensorProto) → TensorProto {dims=1, data_type=2, float_data=4, name=8,
  raw_data=9, int64_data=7}.

Torch-exported ONNX keeps state-dict-style initializer names, so the
extracted {name: array} dict feeds models.import_torch's mapping to load
real reference weights the moment the blobs are available.
"""

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# TensorProto.DataType → numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16,
           5: np.int16, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64, 12: np.uint32, 13: np.uint64}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:
            yield field, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            yield field, wt, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")


def _parse_tensor(buf: bytes) -> Tuple[Optional[str], Optional[np.ndarray]]:
    dims: List[int] = []
    dtype = 1
    name = None
    raw = None
    floats: List[bytes] = []
    int64s: List[int] = []
    for field, wt, val in _fields(buf):
        if field == 1:                      # dims
            if wt == 0:
                dims.append(val)
            else:                           # packed
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    dims.append(v)
        elif field == 2 and wt == 0:
            dtype = val
        elif field == 4:                    # float_data (packed or single)
            floats.append(val if wt == 2 else val)
        elif field == 7:                    # int64_data
            if wt == 0:
                int64s.append(val)
            else:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    int64s.append(v)
        elif field == 8 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif field == 9 and wt == 2:
            raw = val
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        return name, None
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.frombuffer(b"".join(floats), dtype=np.float32)
    elif int64s:
        arr = np.asarray(int64s, dtype=np.int64)
    else:
        arr = np.zeros(0, np_dtype)
    try:
        return name, arr.reshape(dims) if dims else arr
    except ValueError:
        return name, arr


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """ONNX file → {initializer name: numpy array}."""
    with open(path, "rb") as f:
        model = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, wt, graph in _fields(model):
        if field == 7 and wt == 2:          # ModelProto.graph
            for gf, gwt, val in _fields(graph):
                if gf == 5 and gwt == 2:    # GraphProto.initializer
                    name, arr = _parse_tensor(val)
                    if name is not None and arr is not None:
                        out[name] = arr
    return out


# ------------------------------------------------------- writer (tests)

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wt: int) -> bytes:
    return _varint((field << 3) | wt)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def write_minimal_onnx(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Emit a minimal valid-enough ModelProto holding only initializers
    (used by tests; also handy for fabricating fixtures)."""
    inits = b""
    rev = {v: k for k, v in _DTYPES.items()}
    for name, arr in tensors.items():
        t = b""
        for d in arr.shape:
            t += _tag(1, 0) + _varint(d)
        t += _tag(2, 0) + _varint(rev[arr.dtype.type])
        t += _ld(8, name.encode())
        t += _ld(9, np.ascontiguousarray(arr).tobytes())
        inits += _ld(5, t)
    graph = inits + _ld(2, b"g")            # GraphProto.name
    model = _tag(1, 0) + _varint(8)         # ir_version
    model += _ld(7, graph)
    with open(path, "wb") as f:
        f.write(model)
