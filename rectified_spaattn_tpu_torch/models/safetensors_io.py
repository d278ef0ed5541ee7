"""The safetensors format, read and written in torch without the
``safetensors`` package (the I/O under models/weights.py::
load_safetensors_dir).

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus an
optional ``"__metadata__"`` map of strings), then the tensors' raw
little-endian bytes, offsets counted from the end of the header.

The reader maps the file (copy-on-write) and returns tensors that view the
mapping in the file's own dtype, so a bf16 checkpoint is never widened and
only the pages a caller touches are read.  The writer streams one tensor at
a time (device tensors are copied to the host one by one) into a temporary
file that replaces ``path`` when complete.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def read_header(f) -> tuple[dict, int]:
    """(header dict, byte offset of the data) of an open file."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str, use_mmap: bool = True) -> dict[str, torch.Tensor]:
    """Every tensor of one file, by name (safetensors' ``keys()`` order),
    on the host.  With
    ``use_mmap`` the tensors view a private mapping of the file (the
    mapping lives as long as any of them); without it the file is read
    into memory once."""
    with open(path, "rb") as f:
        header, start = read_header(f)
        if use_mmap and os.fstat(f.fileno()).st_size > start:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        else:
            f.seek(0)
            buf = bytearray(f.read())
    out = {}
    for name in sorted(header):
        if name == "__metadata__":
            continue
        info = header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']!r}, "
                             f"not one of {sorted(DTYPES)}")
        dtype, shape = DTYPES[info["dtype"]], info["shape"]
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * itemsize:
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, "
                             f"its shape {shape} needs {numel * itemsize}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                               offset=start + begin)
        if (start + begin) % itemsize:       # unaligned: copy out first
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> str:
    """Write ``tensors`` (any device) to ``path``; returns the path."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)          # 8-byte aligned data start
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(blob)))
            f.write(blob)
            for t in tensors.values():
                if t.numel():
                    host = t.detach().to("cpu").contiguous().reshape(-1)
                    f.write(host.view(torch.uint8).numpy().data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load_safetensors_dir(path: str, pattern: str = r".*\.safetensors$",
                         use_mmap: bool = True) -> dict[str, torch.Tensor]:
    """Every tensor of every shard in ``path`` whose file name matches
    ``pattern``, shards in sorted order (a later shard's key replaces an
    earlier one's, as the JAX reader's dict does)."""
    out = {}
    for fname in sorted(os.listdir(path)):
        if re.match(pattern, fname):
            out.update(load_file(os.path.join(path, fname), use_mmap))
    return out
