"""Build, load and count the port's hand-written CUDA kernels.

The sources in `csrc/` compile with `nvcc` into one shared library with a
plain C interface, loaded with `ctypes`. The library is cached under
`<repo>/build/` by a hash of the sources and flags, so only a changed source
rebuilds. Nothing here runs at import: the first wrapper that launches a
kernel on a CUDA tensor calls `lib()`, which builds if needed.

Every wrapper adds one to its entry of `launch_counts` where it launches its
kernel, and nowhere else, so a run can show which kernels its path reached.
A wrapper may also name the shape it launched at (the pillar convs, the
3x3 conv, the OSA aggregate and the flash attention kernels, (Nq, Nk,
heads, Dh), do):
`launch_shapes` then counts the launches per (kernel, shape).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset (kernels 1 to 10 of the port;
# kernel 8 is two launches, counted apart)
KERNELS = ("pillar_conv_kb9", "pillar_conv_kb1", "flash_attention_packed",
           "conv3x3_bn_relu", "conv3x3_bn_relu_resid", "osa_aggregate",
           "flash_train_fwd", "flash_train_bwd_dq", "flash_train_bwd_dkv",
           "sorted_lookup", "rows_copy")
launch_counts = dict.fromkeys(KERNELS, 0)
launch_shapes: Counter = Counter()  # (kernel name, shape) -> launches

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "cmt_pillar_conv_f32": [_I] + [_P] * 9 + [_I] * 10 + [_P],
    "cmt_pillar_tc_weight_map": [_P, _I, _I, _I, _P],
    "cmt_pillar_conv_tc": [_I] + [_P] * 9 + [_I] * 12 + [_P],
    "cmt_pillar_occ_fold": [_P] * 3 + [_I] * 8 + [_P],
    "cmt_flash_attention_packed": [_I] + [_P] * 5 + [_I] * 5 + [_F, _P],
    "cmt_wgmma_selftest": [_I] + [_P] * 6,
    "cmt_conv3x3_bn_relu_f32": [_P] * 6 + [_I] * 7 + [_P],
    "cmt_conv3x3_tc_weight_map": [_P, _I, _I, _I, _P],
    "cmt_conv3x3_bn_relu_tc": [_P] * 6 + [_I] * 11 + [_P],
    "cmt_osa_aggregate_f32": [_I] + [_P] * 6 + [_I] * 6 + [_P, _I]
    + [_P] * 4 + [_I] * 3 + [_P],
    "cmt_osa_agg_tc_weight_map": [_P, _I, _I, _I, _P],
    "cmt_osa_aggregate_tc": [_I] + [_P] * 6 + [_I] * 6 + [_P] * 5
    + [_I] * 7 + [_P],
    # kernels 7 and 8 take a pointer to one argument block and the stream
    "cmt_flash_train_fwd": [_P, _P],
    "cmt_flash_train_bwd_dq": [_P, _P],
    "cmt_flash_train_bwd_dkv": [_P, _P],
    "cmt_sorted_lookup": [_P, _I, _P, _I, _I, _P, _P, _P],
    "cmt_rows_copy": [_P, _P, _L, _L, _P],
}

_lib: Optional[ctypes.CDLL] = None


def reset_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    launch_shapes.clear()


def count(name: str, shape: Optional[tuple] = None) -> None:
    launch_counts[name] += 1
    if shape is not None:
        launch_shapes[name, shape] += 1


def sources() -> Sequence[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcmtcoop_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile `csrc/*.cu` into the cached shared library; returns its path.
    One nvcc per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus = [p for p in sources() if p.suffix == ".cu"]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    tmp_dir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in cus:
            cmd = [nvcc_path(), *compile_flags, "-c", "-I", str(CSRC), "-o",
                   str(tmp_dir / (src.stem + ".o")), str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        outputs = [(cmd, proc.communicate()[0], proc.returncode)
                   for cmd, proc in jobs]
        link = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp_dir / out.name),
                *(str(tmp_dir / (src.stem + ".o")) for src in cus)]
        if all(rc == 0 for _, _, rc in outputs):
            res = subprocess.run(link, capture_output=True, text=True)
            outputs.append((link, res.stdout + res.stderr, res.returncode))
        for cmd, text, rc in outputs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n"
                                   f"{text}")
        os.replace(tmp_dir / out.name, out)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
