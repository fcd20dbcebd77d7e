"""Minimal ONNX initializer reader (protobuf wire format, no onnx package).

The port's own copy of `imagdressing_tpu/convert/onnx_reader.py` (the port
imports nothing of the JAX package). The SCHP human-parsing weights ship as
ONNX graphs (`ckpt/humanparsing/parsing_atr.onnx` / `parsing_lip.onnx`);
neither onnx nor onnxruntime is needed, because the weights are named
tensors inside the protobuf:

  ModelProto.graph (field 7) -> GraphProto.initializer (field 5, repeated
  TensorProto) -> {dims: field 1, data_type: field 2, name: field 8,
  raw_data: field 9, float_data: field 4}.

`read_onnx_initializers` returns {name: np.ndarray}. torch.onnx exports
keep the state-dict names for initializers, so
`preprocess.parsing.model.load_schp_state_dict` takes the result as it is.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, Tuple

import numpy as np

# ONNX TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


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
    """Yield (field_number, wire_type, payload) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def _parse_tensor(buf: bytes):
    dims = []
    dtype = 1
    name = ""
    raw = None
    float_data = []
    int64_data = []
    int32_data = []
    for field, wire, val in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(val)
        elif field == 1 and wire == 2:  # packed dims
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                dims.append(d)
        elif field == 2 and wire == 0:
            dtype = val
        elif field == 4 and wire == 2:  # packed float_data
            float_data.extend(
                struct.unpack(f"<{len(val) // 4}f", val)
            )
        elif field == 4 and wire == 5:
            float_data.append(struct.unpack("<f", val)[0])
        elif field == 5 and wire == 2:  # packed int32_data
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                if d >= 1 << 31:  # proto int32: two's complement in varint
                    d -= 1 << 64
                int32_data.append(d)
        elif field == 5 and wire == 0:
            int32_data.append(val - (1 << 64) if val >= 1 << 31 else val)
        elif field == 7 and wire == 2:  # packed int64_data
            pos = 0
            while pos < len(val):
                d, pos = _read_varint(val, pos)
                if d >= 1 << 63:  # negative int64: two's complement
                    d -= 1 << 64
                int64_data.append(d)
        elif field == 7 and wire == 0:
            int64_data.append(val - (1 << 64) if val >= 1 << 63 else val)
        elif field == 8 and wire == 2:
            name = val.decode("utf-8", "replace")
        elif field == 9 and wire == 2:
            raw = val
    np_dtype = _DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64)
    elif int32_data:
        arr = np.asarray(int32_data, np.int32).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    if dims:
        arr = arr.reshape(dims)
    return name, arr


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        model = f.read()
    graph = None
    for field, wire, val in _fields(model):
        if field == 7 and wire == 2:  # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX model?)")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:  # GraphProto.initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out


def write_minimal_onnx(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a minimal ModelProto containing only initializers — used by the
    round-trip test (and for re-exporting converted weights)."""

    def varint(v: int) -> bytes:
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def field_bytes(num: int, payload: bytes) -> bytes:
        return varint((num << 3) | 2) + varint(len(payload)) + payload

    def field_varint(num: int, val: int) -> bytes:
        return varint(num << 3) + varint(val)

    dtype_ids = {np.dtype(v): k for k, v in _DTYPES.items()}

    graph = b""
    for name, arr in tensors.items():
        t = b""
        for d in arr.shape:
            t += field_varint(1, int(d))
        t += field_varint(2, dtype_ids[arr.dtype])
        t += field_bytes(8, name.encode())
        t += field_bytes(9, np.ascontiguousarray(arr).tobytes())
        graph += field_bytes(5, t)
    model = field_bytes(7, graph)
    with open(path, "wb") as f:
        f.write(model)
