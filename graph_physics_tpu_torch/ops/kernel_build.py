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
#: the headers of the edge-attention forward and backward, either layout
_EA_FWD = ("ea_fwd.cuh", "ea_common.cuh", "gn_rows.cuh")
_EA_BWD = ("ea_bwd_passes.cuh", "ea_common.cuh", "gn_rows.cuh")
#: the headers of the GraphNetBlock forward and backward at hidden 32 and
#: below, either layout
_GN_FWD = ("gn_fwd.cuh", "gn_rows.cuh", "gn_tile.cuh", "gn_nk_common.cuh", "act_common.cuh",
           "mma_common.cuh")
_GN_BWD = ("gn_nk_common.cuh", "gn_bwd_common.cuh", "gn_bwd_passes.cuh", "gn_rows.cuh",
           "gn_tile.cuh", "act_common.cuh", "mma_common.cuh")
_FFN = ("ffn_common.cuh", "act_common.cuh", "mma_common.cuh")
#: every kernel library: name -> (source, every header it includes, directly or
#: through another header), under csrc/
LIBRARIES = {
    "gn_nk_fwd": ("fused_gnblock_nk.cu", _GN_FWD),
    "gn_nk_bwd": ("fused_gnblock_nk_bwd.cu", _GN_BWD),
    "edge_attention_nk": ("fused_edge_attention_nk.cu", _EA_FWD),
    "edge_attention_nk_bwd": ("fused_edge_attention_nk_bwd.cu", _EA_BWD),
    "ffn": ("fused_ffn.cu", _FFN),
    "ffn_bwd": ("fused_ffn_bwd.cu", _FFN),
    "ffn128": ("fused_ffn128.cu", ("ffn_wide.cuh", "wgmma_common.cuh", *_FFN)),
    "ffn128_bwd": ("fused_ffn128_bwd.cu", ("ffn_wide.cuh", "wgmma_common.cuh", *_FFN)),
    "gn_csr_fwd": ("fused_gnblock_csr.cu", _GN_FWD),
    "gn_csr_bwd": ("fused_gnblock_csr_bwd.cu", _GN_BWD),
    "edge_attention_csr": ("fused_edge_attention_csr.cu", _EA_FWD),
    "edge_attention_csr_bwd": ("fused_edge_attention_csr_bwd.cu", _EA_BWD),
    "gumbel": ("gumbel.cu", ()),
}
#: nvcc flags of a library beyond NVCC_FLAGS (part of its cache key)
FLAGS = {}
#: the GraphNetBlock kernels below hidden 32 (rows 1-4 at the small
#: widths): the hidden-32 sources compiled for each width, one library per
#: (kernel, width), named as the hidden-32 library with the width appended
GN_SMALL_HIDDENS = (1, 2, 4, 8, 16)
for _h in GN_SMALL_HIDDENS:
    for _name in ("gn_nk_fwd", "gn_nk_bwd", "gn_csr_fwd", "gn_csr_bwd"):
        LIBRARIES[f"{_name}{_h}"] = LIBRARIES[_name]
        FLAGS[f"{_name}{_h}"] = (f"-DGN_SMALL_H={_h}",)
#: the GraphNetBlock kernels at hidden 64 and 128 (rows 1-4 at the wide
#: widths): one library per (kernel, width), each source compiled for its
#: width
_GN_WIDE = ("gn_wide.cuh", "gn_nk_common.cuh", "gn_rows.cuh", "act_common.cuh",
            "mma_common.cuh", "wgmma_common.cuh")
for _h in (64, 128):
    for _name, _src, _body in (("gn_nk_fwd", "fused_gnblock_wide_nk.cu", "gn_wide_fwd.cuh"),
                               ("gn_nk_bwd", "fused_gnblock_wide_nk_bwd.cu", "gn_wide_bwd.cuh"),
                               ("gn_csr_fwd", "fused_gnblock_wide_csr.cu", "gn_wide_fwd.cuh"),
                               ("gn_csr_bwd", "fused_gnblock_wide_csr_bwd.cu",
                                "gn_wide_bwd.cuh")):
        LIBRARIES[f"{_name}{_h}"] = (_src, (_body, *_GN_WIDE))
        FLAGS[f"{_name}{_h}"] = (f"-DGN_WIDE_H={_h}",)
#: the gated-FFN kernels at hidden 32 and below (rows 9/10 at the small
#: widths): one library per (kernel, width), each source compiled for its
#: width
FFN_SMALL_HIDDENS = (1, 2, 4, 8, 16, 32)
for _h in FFN_SMALL_HIDDENS:
    for _name, _src in (("ffn_small", "fused_ffn_small.cu"),
                        ("ffn_small_bwd", "fused_ffn_small_bwd.cu")):
        LIBRARIES[f"{_name}{_h}"] = (_src, ("ffn_small.cuh", *_FFN))
        FLAGS[f"{_name}{_h}"] = (f"-DFFN_SMALL_H={_h}",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str, source=None) -> Path:
    src, headers = source or LIBRARIES[name]
    data = b"".join((CSRC / f).read_bytes() for f in (src, *headers))
    data += " ".join(FLAGS.get(name, ())).encode()
    digest = hashlib.sha256(data).hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def build(libraries=None) -> str:
    """Compile the libraries (``LIBRARIES`` unless given another {name:
    (source, headers)}) that are not built yet, one nvcc process per
    source, all at once; returns nvcc's output (ptxas register and
    shared-memory reports), empty when all are cached. A source outside
    csrc/ is given by its path and includes headers under csrc/."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, spec in (libraries or LIBRARIES).items():
        out = library_path(name, spec)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC / spec[0]
        includes = () if src.parent == CSRC else ("-I", str(CSRC))
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, *FLAGS.get(name, ()), *includes, "-o",
                                 str(tmp), str(src)],
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


def load(name: str, argtypes: Dict[str, list], source=None) -> ctypes.CDLL:
    """The library ``name``, built first if needed, with ``argtypes``
    ({function: [ctypes types]}) set on its functions, which return int.
    ``source`` = (a source's path, its headers under csrc/) names a
    library outside ``LIBRARIES`` (a test's own), built alone."""
    if name not in _libs:
        build(None if source is None else {name: source})
        lib = ctypes.CDLL(str(library_path(name, source)))
        for fn, types in argtypes.items():
            getattr(lib, fn).argtypes = types
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]
