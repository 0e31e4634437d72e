"""Minimal safetensors reader and writer (numpy + mmap, no package).

Port of ``quintnet_tpu/utils/safetensors_io.py``: the same format (an
8-byte little-endian header length, a JSON header of dtype / shape /
data_offsets, then the raw row-major payload, keys sorted), so a file
written by either package loads in the other. Tensors go in as torch
tensors or numpy arrays and come out as CPU torch tensors. bf16, which
numpy lacks, travels as its 16-bit pattern (an int16 view) and is
viewed back as ``torch.bfloat16`` on load.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

_NUMPY = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "I64": np.dtype("<i8"), "I32": np.dtype("<i4"), "I16": np.dtype("<i2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("bool"),
}


def _as_numpy(x) -> tuple:
    """``(dtype name, contiguous numpy array of the stored bytes)``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", t.view(torch.int16).numpy()
        x = t.numpy()
    # (np.ascontiguousarray would turn a 0-d array into shape [1])
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    for name, ref in _NUMPY.items():
        if arr.dtype == ref:
            return name, arr
    raise ValueError(f"unsupported dtype {arr.dtype}")


def save_file(tensors: Mapping[str, Any], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a safetensors file (sorted keys, contiguous payload)."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset, arrays = 0, {}
    for name in sorted(tensors):
        dtype, arr = _as_numpy(tensors[name])
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        arrays[name] = arr
        offset += arr.nbytes
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(arrays):
            f.write(arrays[name].tobytes())


class SafeTensorFile:
    """Lazy reader over one private (copy-on-write) mmap: ``f[name]`` is a
    zero-copy CPU tensor view of the file's bytes. A file shorter than its
    header says raises ``ValueError`` on open (a torn write)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            size = os.fstat(self._f.fileno()).st_size
            if size < 8:
                raise ValueError(f"{path}: {size} bytes, no header")
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_COPY)
            (hlen,) = struct.unpack("<Q", self._mm[:8])
            if 8 + hlen > size:
                raise ValueError(f"{path}: header of {hlen} bytes runs past "
                                 f"the end of a {size}-byte file")
            self.header: Dict[str, Any] = json.loads(
                self._mm[8:8 + hlen].decode("utf-8"))
        except BaseException:
            self.close()
            raise
        self.metadata = self.header.pop("__metadata__", {})
        self._data_start = 8 + hlen
        end = max((v["data_offsets"][1] for v in self.header.values()),
                  default=0)
        if self._data_start + end > size:
            self.close()
            raise ValueError(f"{path}: payload ends at byte "
                             f"{self._data_start + end} of a {size}-byte "
                             f"file (truncated)")

    def keys(self) -> Iterable[str]:
        return self.header.keys()

    def __getitem__(self, name: str) -> torch.Tensor:
        info = self.header[name]
        s, e = info["data_offsets"]
        bf16 = info["dtype"] == "BF16"
        dt = np.dtype("<i2") if bf16 else _NUMPY[info["dtype"]]
        arr = np.frombuffer(self._mm, dtype=dt, count=(e - s) // dt.itemsize,
                            offset=self._data_start + s)
        t = torch.from_numpy(arr).reshape(info["shape"])
        return t.view(torch.bfloat16) if bf16 else t

    def tensor(self, name: str) -> torch.Tensor:
        """A materialised copy (owns its memory)."""
        return self[name].clone()

    def close(self):
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str) -> Dict[str, torch.Tensor]:
    with SafeTensorFile(path) as f:
        return {k: f.tensor(k) for k in f.keys()}


def load_metadata(path: str) -> Dict[str, str]:
    with SafeTensorFile(path) as f:
        return dict(f.metadata)
