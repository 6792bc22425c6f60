"""Build and load the port's CUDA kernel libraries.

Every kernel source under ``csrc/`` is compiled by hand with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with
a plain C interface, under ``build/kernels/`` of the checkout
(git-ignored), named by a hash of the source and the headers it includes;
the op modules load them with ctypes. :func:`build` starts one nvcc
process per missing library, all at once, and waits for them: the first
kernel launch of a process builds every library, so a fresh checkout
pays the build once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
#: every kernel library: name -> (source, headers it includes), under csrc/
LIBRARIES = {
    "gn_nk_fwd": ("fused_gnblock_nk.cu", ("gn_nk_common.cuh",)),
    "gn_nk_bwd": ("fused_gnblock_nk_bwd.cu",
                  ("gn_nk_common.cuh", "gn_bwd_common.cuh", "gn_bwd_passes.cuh")),
    "edge_attention_nk": ("fused_edge_attention_nk.cu", ("ea_nk_common.cuh",)),
    "edge_attention_nk_bwd": ("fused_edge_attention_nk_bwd.cu", ("ea_nk_common.cuh",)),
    "ffn": ("fused_ffn.cu", ("ffn_common.cuh",)),
    "ffn_bwd": ("fused_ffn_bwd.cu", ("ffn_common.cuh",)),
    "gn_csr_fwd": ("fused_gnblock_csr.cu", ("gn_nk_common.cuh",)),
    "gn_csr_bwd": ("fused_gnblock_csr_bwd.cu",
                   ("gn_nk_common.cuh", "gn_bwd_common.cuh", "gn_bwd_passes.cuh")),
    "edge_attention_csr": ("fused_edge_attention_csr.cu", ("ea_nk_common.cuh",)),
    "edge_attention_csr_bwd": ("fused_edge_attention_csr_bwd.cu", ("ea_nk_common.cuh",)),
    "gumbel": ("gumbel.cu", ()),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    src, headers = LIBRARIES[name]
    data = b"".join((CSRC / f).read_bytes() for f in (src, *headers))
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def build() -> str:
    """Compile the libraries that are not built yet, one nvcc process per
    source, all at once; returns nvcc's output (ptxas register and
    shared-memory reports), empty when all are cached."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, (src, _) in LIBRARIES.items():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((proc, tmp, out))
    logs, failed = [], []
    for proc, tmp, out in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) for {out.name}:\n{text}")
            continue
        os.replace(tmp, out)
        logs.append(text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def load(name: str, argtypes: Dict[str, list]) -> ctypes.CDLL:
    """The library ``name``, built first if needed, with ``argtypes``
    ({function: [ctypes types]}) set on its functions, which return int."""
    if name not in _libs:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
