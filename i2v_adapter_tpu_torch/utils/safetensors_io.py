"""Reader and writer of the ``.safetensors`` format, with no third-party
package.

The format: an 8-byte little-endian header length N, N bytes of JSON
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` (an
optional ``"__metadata__"`` entry of strings), then the tensors' raw
little-endian bytes, offsets relative to the end of the header.

Supported dtypes: F32, F16, BF16, I64, I32.  numpy has no bfloat16, so
``load_file`` returns BF16 tensors widened to float32 (exact: every bf16
value is a float32 value) through torch's ``bfloat16``; ``save_file``
writes torch ``bfloat16`` tensors (and numpy arrays whose dtype is named
``bfloat16``) as BF16.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

_NUMPY = {"F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32}
_CODES = {np.dtype(v): k for k, v in _NUMPY.items()}
# a header larger than this is not a weight file (the reference format's
# own limit is 100 MB)
_MAX_HEADER = 100 * 1024 * 1024

Array = Union[np.ndarray, torch.Tensor]


def _from_bytes(code: str, raw: memoryview, shape) -> np.ndarray:
    if code == "BF16":
        bits = torch.from_numpy(np.frombuffer(raw, dtype="<i2").copy())
        return bits.view(torch.bfloat16).float().numpy().reshape(shape)
    if code not in _NUMPY:
        raise ValueError(f"unsupported safetensors dtype {code!r} (F32, F16, BF16, I64, I32)")
    return np.frombuffer(raw, dtype=np.dtype(_NUMPY[code]).newbyteorder("<")).reshape(shape)


def load_file(path: Union[str, os.PathLike]) -> Dict[str, np.ndarray]:
    """All tensors of a ``.safetensors`` file as numpy arrays (BF16 as
    float32), in the file's order.  The arrays share one writable buffer
    holding the file's data."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: truncated")
    view = memoryview(data)
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        begin, end = spec["data_offsets"]
        shape = tuple(int(s) for s in spec["shape"])
        width = 2 if spec["dtype"] == "BF16" else np.dtype(_NUMPY.get(spec["dtype"], np.uint8)).itemsize
        if not 0 <= begin <= end <= len(data) or end - begin != width * int(np.prod(shape)):
            raise ValueError(f"{path}: {name!r} has offsets {begin, end} for {spec['dtype']} {shape}")
        out[name] = _from_bytes(spec["dtype"], view[begin:end], shape)
    return out


def _raw(value: Array):
    """(dtype code, shape, C-contiguous little-endian bytes view)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            return "BF16", tuple(value.shape), value.contiguous().view(torch.int16).numpy()
        value = value.numpy()
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":
        return "BF16", value.shape, np.ascontiguousarray(value).view(np.int16)
    code = _CODES.get(value.dtype.newbyteorder("="))
    if code is None:
        raise ValueError(f"unsupported dtype {value.dtype} (float32, float16, bfloat16, int64, int32)")
    return code, value.shape, np.ascontiguousarray(value, dtype=value.dtype.newbyteorder("<"))


def save_file(tensors: Mapping[str, Array], path: Union[str, os.PathLike],
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (numpy arrays or torch tensors) in their order;
    returns the bytes written."""
    header, parts, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, value in tensors.items():
        code, shape, arr = _raw(value)
        header[name] = {"dtype": code, "shape": list(shape), "data_offsets": [offset, offset + arr.nbytes]}
        parts.append(arr)
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in parts:
            f.write(arr.reshape(-1).view(np.uint8).data)
    return 8 + len(blob) + offset
