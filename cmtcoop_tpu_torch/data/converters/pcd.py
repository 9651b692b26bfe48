"""Minimal PCD reader (pypcd replacement for the converters; a copy of
cmtcoop_tpu/data/converters/pcd.py).

Supports ascii and binary PCD v0.7 with the x/y/z/intensity(+extras) layout
TUMTraf uses. The reference shells out to pypcd (a9coop_converter.py:359-374)
and writes .bin rows (x, y, z, intensity/256, 0).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_TYPEMAP = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def lzf_decompress(data: bytes, expected_length: int) -> bytes:
    """Pure-python LZF decompression (the liblzf stream format pypcd's
    `lzf` module decodes; a9coop_converter.py:359-374 reads
    binary_compressed PCDs through it).

    Stream grammar: a control byte < 0x20 means a literal run of
    (ctrl+1) bytes; otherwise the top 3 bits are a match length
    (7 -> one extension byte follows) and the remaining 13 bits (5 low
    control bits << 8 | next byte) are the back-reference distance - 1.
    Matches copy (length + 2) bytes and may self-overlap.
    """
    out = bytearray(expected_length)
    o = 0
    i = 0
    n = len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 0x20:
            run = ctrl + 1
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("corrupt LZF stream: back-ref before start")
            for _ in range(length + 2):  # may overlap itself; copy bytewise
                out[o] = out[ref]
                o += 1
                ref += 1
    if o != expected_length:
        raise ValueError(
            f"corrupt LZF stream: wrote {o} bytes, expected {expected_length}")
    return bytes(out)


def lzf_compress_literal(data: bytes) -> bytes:
    """Encode `data` as an all-literal LZF stream (no back-references).

    Valid input for any LZF decoder; used by tests and by our fixture
    writer — the real TUMTraf archives are compressed by liblzf, which
    `lzf_decompress` handles including back-references.
    """
    out = bytearray()
    for i in range(0, len(data), 32):
        chunk = data[i:i + 32]
        out.append(len(chunk) - 1)
        out += chunk
    return bytes(out)


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Returns {field_name: (N,) array}."""
    with open(path, "rb") as f:
        header: Dict[str, List[str]] = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, *vals = line.split()
            header[key.upper()] = vals
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(x) for x in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(x) for x in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        fmt = header["DATA"][0].lower()

        dtype_fields = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _TYPEMAP[(t, s)]
            if c == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (c,)))
        dt = np.dtype(dtype_fields)

        if fmt == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            out = {}
            col = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                out[name] = raw[:, col].astype(_TYPEMAP[(t, s)])
                col += c
            return out
        elif fmt == "binary":
            raw = np.frombuffer(f.read(dt.itemsize * n), dtype=dt, count=n)
            return {name: np.asarray(raw[name]) for name in fields}
        elif fmt == "binary_compressed":
            # 8-byte prefix: uint32 compressed size, uint32 uncompressed
            # size, then an LZF stream of the field-major (SoA) data: each
            # dtype field's whole column stored contiguously (pypcd layout).
            comp_n, uncomp_n = np.frombuffer(f.read(8), np.uint32)
            buf = lzf_decompress(f.read(int(comp_n)), int(uncomp_n))
            out = {}
            ix = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                nbytes = s * c * n
                col = np.frombuffer(buf[ix:ix + nbytes], _TYPEMAP[(t, s)])
                out[name] = col if c == 1 else col.reshape(n, c)
                ix += nbytes
            return out
        raise ValueError(f"unknown PCD data format {fmt}")


def pcd_to_bin(pcd_path: str, bin_path: str) -> np.ndarray:
    """PCD -> (N, 5) float32 .bin rows (x, y, z, intensity/256, 0), the
    reference's save_lidar layout (a9coop_converter.py:359-374)."""
    data = read_pcd(pcd_path)
    n = len(data["x"])
    inten = data.get("intensity", np.zeros(n))
    out = np.stack([
        data["x"].astype(np.float32),
        data["y"].astype(np.float32),
        data["z"].astype(np.float32),
        (inten.astype(np.float32)) / 256.0,
        np.zeros(n, np.float32),
    ], axis=-1)
    out.astype(np.float32).tofile(bin_path)
    return out
