"""MindSpore `.ckpt` reader and writer, without MindSpore.

The port's own copy of the JAX package's `tools/ms_ckpt.py`. The reference
evaluates and resumes from MindSpore checkpoints (reference
eval_image.py:163-165, train_image.py:374-377); a MindSpore checkpoint is a
proto2 message (mindspore `checkpoint.proto`):

    message Checkpoint {
      message Value {
        required string tag = 1;
        required TensorProto tensor = 2;
      }
      repeated Value value = 1;
    }
    message TensorProto {
      repeated int64 dims = 1;          // [0] encodes a scalar
      required string tensor_type = 2;  // "Float32", "Int64", ...
      required bytes tensor_content = 3;
    }

which this module reads and writes with the protobuf wire format by hand
(varints and length-delimited fields). Truncated or malformed input raises
ValueError. numpy has no bfloat16: "BFloat16" tensors load as float32 (the
widening is exact), and a torch.bfloat16 tensor (or a numpy array of a
dtype named bfloat16) is written as "BFloat16".

The JAX package's and the port's own checkpoints use the `.ckpt` suffix
too, as pickles (starting with 0x80); `is_ms_checkpoint` tells them apart
by content: a Checkpoint starts with the field-1 length-delimited header
0x0a.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_DTYPES = {
    "Float64": np.float64, "Float32": np.float32, "Float16": np.float16,
    "Int64": np.int64, "Int32": np.int32, "Int16": np.int16, "Int8": np.int8,
    "UInt64": np.uint64, "UInt32": np.uint32, "UInt16": np.uint16,
    "UInt8": np.uint8, "Bool": np.bool_,
}


def _type_name(dtype) -> str:
    dtype = np.dtype(dtype)
    for name, np_t in _DTYPES.items():
        if np.dtype(np_t) == dtype:
            return name
    raise ValueError(f"unsupported dtype {dtype} for MindSpore checkpoint")


def _decode(content: bytes, tensor_type: str) -> np.ndarray:
    if tensor_type == "BFloat16":
        if len(content) % 2:
            raise ValueError("BFloat16 content of odd length")
        bits = np.frombuffer(content, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    if tensor_type not in _DTYPES:
        raise ValueError(f"unsupported MindSpore tensor_type {tensor_type!r}")
    dtype = np.dtype(_DTYPES[tensor_type])
    if len(content) % dtype.itemsize:
        raise ValueError(f"{tensor_type} content of {len(content)} bytes")
    return np.frombuffer(content, dtype)


def _encode(value) -> Tuple[str, bytes, Tuple[int, ...]]:
    """(tensor_type, content, shape) of an array or tensor."""
    if torch.is_tensor(value):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return ("BFloat16", t.view(torch.int16).numpy().tobytes(),
                    tuple(t.shape))
        value = t.numpy()
    arr = np.ascontiguousarray(value)
    name = "BFloat16" if arr.dtype.name == "bfloat16" else \
        _type_name(arr.dtype)
    return name, arr.tobytes(), arr.shape


# ---- protobuf wire helpers -------------------------------------------------

def _read_varint(buf: bytes, i: int):
    val, shift = 0, 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _write_varint(out: bytearray, val: int) -> None:
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _fields(buf: bytes):
    """Yield (field_number, value): an int for varint fields, bytes for
    length-delimited and fixed-width ones."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 0x7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire in (1, 2, 5):
            if wire == 2:
                n, i = _read_varint(buf, i)
            else:
                n = 8 if wire == 1 else 4
            if i + n > len(buf):
                # a short slice would parse a truncated checkpoint with
                # its last parameters dropped
                raise ValueError(f"truncated field {field}: needs {n} "
                                 f"bytes, {len(buf) - i} remain")
            val, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, val


def _ld(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    out += payload


# ---- public API ------------------------------------------------------------

def is_ms_checkpoint(path: str) -> bool:
    """True if the file starts as a Checkpoint message does (0x0a)."""
    with open(path, "rb") as f:
        return f.read(1) == b"\x0a"


def _parse_tensor(buf: bytes) -> np.ndarray:
    dims, tensor_type, content = [], None, b""
    for field, val in _fields(buf):
        if field == 1:
            if isinstance(val, int):
                dims.append(val)
            else:  # packed encoding (proto3-style writers)
                i = 0
                while i < len(val):
                    d, i = _read_varint(val, i)
                    dims.append(d)
        elif field == 2:
            tensor_type = val.decode("utf-8")
        elif field == 3:
            content = val
    if tensor_type is None:
        raise ValueError("TensorProto without tensor_type")
    arr = _decode(content, tensor_type)
    if dims == [0]:  # MindSpore's scalar encoding
        return arr.reshape(())
    return arr.reshape(dims)


def load_ms_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A MindSpore .ckpt as {parameter name: array} (what
    `mindspore.load_checkpoint` gives)."""
    with open(path, "rb") as f:
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, val in _fields(buf):
        if field != 1:
            continue
        tag, tensor = None, None
        for f2, v2 in _fields(val):
            if f2 == 1:
                tag = v2.decode("utf-8")
            elif f2 == 2:
                tensor = _parse_tensor(v2)
        if tag is not None and tensor is not None:
            out[tag] = tensor
    return out


def save_ms_checkpoint(tensors, path: str) -> None:
    """Write {name: array or tensor} as a MindSpore .ckpt (what
    `mindspore.save_checkpoint` writes for a parameter list)."""
    out = bytearray()
    for tag, value in tensors.items():
        tensor_type, content, shape = _encode(value)
        tp = bytearray()
        for d in (list(shape) if shape else [0]):  # proto2: unpacked
            _write_varint(tp, (1 << 3) | 0)
            _write_varint(tp, int(d))
        _ld(tp, 2, tensor_type.encode("utf-8"))
        _ld(tp, 3, content)
        value_msg = bytearray()
        _ld(value_msg, 1, tag.encode("utf-8"))
        _ld(value_msg, 2, bytes(tp))
        _ld(out, 1, bytes(value_msg))
    with open(path, "wb") as f:
        f.write(bytes(out))
