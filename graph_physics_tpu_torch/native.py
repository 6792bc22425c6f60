"""The loader's host mesh library: ``csrc/meshops.cc`` through ctypes.

Counterpart of graph_physics_tpu/native/__init__.py (:42-98 for the
bindings). The C++ source is a copy of graph_physics_tpu/native/meshops.cc;
:func:`load` builds it with g++ into ``build/native/`` of the checkout
(git-ignored) the first time a process calls one of its functions, under a
name keyed by a hash of the source and the flags, compiled to a file of
its own and renamed into place, so that processes building at once do not
race. A failed build raises with the compiler's output: nothing falls back
to numpy.

Each library function has its plain version here, in numpy
(``faces_to_edges_plain`` and so on, gathered in :data:`PLAIN`): the numpy
branches that the JAX package's callers take without the library, and for
``rcb_partition`` the library's own recursion (the split axis from fp32
positions, ties by node id, the cut at ``llround``). The tests hold the
library to them. The port's callers (core/mesh.py, training/packed.py,
dataset/preprocessing.py, dataset/partition.py) call the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Sequence

import numpy as np
import scipy.sparse as sp

SOURCE = Path(__file__).resolve().parent / "csrc" / "meshops.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC")

#: copy threads of the packed-batch assembly (native/__init__.py:_PACK_THREADS)
PACK_THREADS = max(1, min(8, (os.cpu_count() or 2) - 1))
#: below this output size one thread copies (native/__init__.py:_PACK_MIN_BYTES)
PACK_MIN_BYTES = 1 << 20

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmeshops_{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises RuntimeError with
    g++'s output when the compiler fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"meshops: {' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"meshops: g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built first if needed, with its argument types set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
        types = {
            "faces_to_edges": (i64, [i32p, i64, i32, i64, i32p, i32p, i64]),
            "k_hop": (i64, [i32p, i32p, i64, i64, i32, i32p, i32p, i64]),
            "radius_pairs": (i64, [f32p, i64, i32, ctypes.c_float, i32p, i32p, i64]),
            "radius_cross_pairs": (i64, [f32p, i64, f32p, i64, i32, ctypes.c_float, i32p,
                                         i32p, i64]),
            "rcb_partition": (None, [f32p, i64, i32, i32, i32p]),
            "pack_rows": (None, [ctypes.POINTER(vp), i64, i64, i64, vp, i32]),
            "repeat_rows": (None, [vp, i64, i64, i64, vp, i32]),
            "pack_block": (None, [vp, i64, i64, i64, i64, i64, vp, i64, i64, i32]),
        }
        for name, (restype, argtypes) in types.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def _with_budget(call, budget: int):
    """Call ``call(budget)`` -> (count, outputs); when the count comes back
    negated (the budget was short), call again with the budget it asks for."""
    count, outs = call(budget)
    if count < 0:
        count, outs = call(-count)
    if count < 0:
        raise RuntimeError("meshops: the output budget it asked for was short")
    return count, outs


def _pair_buffers(budget):
    return np.empty(budget, np.int32), np.empty(budget, np.int32)


# ----------------------------------------------------------------------
# the library's functions
# ----------------------------------------------------------------------

def faces_to_edges(faces: np.ndarray, num_nodes: int) -> np.ndarray:
    """Unique undirected edges (both directions) of [C, 3] triangles or
    [C, 4] tetrahedra, int32 [2, E] sorted by receiver then sender
    (native/__init__.py:faces_to_edges)."""
    faces = np.ascontiguousarray(faces, dtype=np.int32)
    if faces.ndim != 2 or faces.shape[-1] not in (3, 4):
        raise ValueError(f"cells must be [C,3] or [C,4], got {faces.shape}")
    nv = faces.shape[1]
    lib = load()

    def call(budget):
        s, r = _pair_buffers(budget)
        return lib.faces_to_edges(faces, faces.shape[0], nv, num_nodes, s, r, budget), (s, r)

    e, (s, r) = _with_budget(call, faces.shape[0] * (6 if nv == 3 else 12) + 8)
    return np.stack([s[:e], r[:e]])


def k_hop(edge_index: np.ndarray, num_nodes: int, k: int) -> np.ndarray:
    """Pairs within graph distance ``k``, no self-loops, int32 [2, E]
    sorted by receiver then sender (native/__init__.py:k_hop); ``k`` <= 1
    gives the edges back, as core/mesh.py:k_hop_edges does."""
    if k <= 1:
        return np.asarray(edge_index).astype(np.int32)
    s = np.ascontiguousarray(edge_index[0], np.int32)
    r = np.ascontiguousarray(edge_index[1], np.int32)
    lib = load()

    def call(budget):
        os_, or_ = _pair_buffers(budget)
        return lib.k_hop(s, r, s.shape[0], num_nodes, k, os_, or_, budget), (os_, or_)

    e, (os_, or_) = _with_budget(call, max(s.shape[0] * (4 ** min(k, 4)), 1024))
    return np.stack([os_[:e], or_[:e]])


def radius_pairs(pos: np.ndarray, radius: float) -> np.ndarray:
    """Every unordered pair (i < j) with |pos_i - pos_j| <= radius, int32
    [M, 2], in the library's grid order (native/__init__.py:radius_pairs)."""
    pos = np.ascontiguousarray(pos, np.float32)
    n, dim = pos.shape
    lib = load()

    def call(budget):
        a, b = _pair_buffers(budget)
        return lib.radius_pairs(pos, n, dim, radius, a, b, budget), (a, b)

    c, (a, b) = _with_budget(call, max(n * 32, 1024))
    return np.stack([a[:c], b[:c]], axis=1)


def radius_cross_pairs(pos_a: np.ndarray, pos_b: np.ndarray, radius: float) -> np.ndarray:
    """Every (i, j) with |pos_a[i] - pos_b[j]| <= radius, int32 [M, 2] of
    (A-local, B-local) indices (native/__init__.py:radius_cross_pairs)."""
    pos_a = np.ascontiguousarray(pos_a, np.float32)
    pos_b = np.ascontiguousarray(pos_b, np.float32)
    na, dim = pos_a.shape
    nb = pos_b.shape[0]
    lib = load()

    def call(budget):
        a, b = _pair_buffers(budget)
        return lib.radius_cross_pairs(pos_a, na, pos_b, nb, dim, radius, a, b, budget), (a, b)

    c, (a, b) = _with_budget(call, max((na + nb) * 16, 1024))
    return np.stack([a[:c], b[:c]], axis=1)


def rcb_labels(pos: np.ndarray, num_parts: int) -> np.ndarray:
    """Each node's part, int32 [N], by recursive coordinate bisection of
    its fp32 position (native/__init__.py:rcb_labels)."""
    pos = np.ascontiguousarray(pos, np.float32)
    if pos.ndim != 2 or not 1 <= pos.shape[1] <= 3:
        raise ValueError(f"positions must be [N, 1-3], got {pos.shape}")
    labels = np.empty(pos.shape[0], np.int32)
    load().rcb_partition(pos, pos.shape[0], pos.shape[1], num_parts, labels)
    return labels


def _threads(nbytes: int) -> int:
    return PACK_THREADS if nbytes >= PACK_MIN_BYTES else 1


def pack_rows(vals: Sequence[np.ndarray]) -> np.ndarray:
    """[B x (N, F...)] frame leaves of one shape and dtype -> one [N, B,
    F...] array (native/__init__.py:pack_rows; training/packed.pack_frames)."""
    vals = [np.ascontiguousarray(v) for v in vals]
    v0 = vals[0]
    if any(v.shape != v0.shape or v.dtype != v0.dtype for v in vals[1:]):
        raise ValueError("pack_rows: the leaves differ in shape or dtype")
    num_b, num_n = len(vals), v0.shape[0]
    row_bytes = int(np.prod(v0.shape[1:], dtype=np.int64)) * v0.itemsize
    out = np.empty((num_n, num_b) + v0.shape[1:], v0.dtype)
    ptrs = (ctypes.c_void_p * num_b)(*[v.ctypes.data for v in vals])
    load().pack_rows(ptrs, num_b, num_n, row_bytes, out.ctypes.data, _threads(out.nbytes))
    return out


def repeat_rows(val: np.ndarray, num_b: int) -> np.ndarray:
    """One shared (N, F...) leaf -> [N, B, F...], B identical copies
    (native/__init__.py:repeat_rows)."""
    val = np.ascontiguousarray(val)
    num_n = val.shape[0]
    row_bytes = int(np.prod(val.shape[1:], dtype=np.int64)) * val.itemsize
    out = np.empty((num_n, num_b) + val.shape[1:], val.dtype)
    load().repeat_rows(val.ctypes.data, num_b, num_n, row_bytes, out.ctypes.data,
                       _threads(out.nbytes))
    return out


def pack_block(src: np.ndarray, out: np.ndarray, col: int) -> None:
    """Write one contiguous [B, N, w] block into ``out[:N, :, col:col+w]``
    of the contiguous [N', B, F] batch of the same dtype
    (native/__init__.py:pack_block; preprocessing.py:FrameBuilder.build_packed)."""
    if (src.dtype != out.dtype or not src.flags["C_CONTIGUOUS"]
            or not out.flags["C_CONTIGUOUS"] or src.ndim != 3 or out.ndim != 3):
        raise ValueError("pack_block: src and out must be contiguous 3-D arrays of one dtype")
    num_b, num_n, w = src.shape
    if out.shape[1] != num_b or out.shape[0] < num_n or col + w > out.shape[2]:
        raise ValueError(f"pack_block: {src.shape} does not fit {out.shape} at column {col}")
    it = src.itemsize
    row_bytes = w * it
    load().pack_block(src.ctypes.data, num_b, num_n, row_bytes, num_n * row_bytes, row_bytes,
                      out.ctypes.data + col * it, out.strides[0], out.strides[1],
                      _threads(src.nbytes))


# ----------------------------------------------------------------------
# the plain versions, numpy only
# ----------------------------------------------------------------------

def faces_to_edges_plain(faces: np.ndarray, num_nodes: int) -> np.ndarray:
    """:func:`faces_to_edges` in numpy (core/mesh.py:faces_to_edges without
    the library: tetrahedra as their four faces, unique keys, lexsort)."""
    faces = np.asarray(faces, dtype=np.int64)
    if faces.shape[-1] not in (3, 4):
        raise ValueError(f"cells must be [C,3] or [C,4], got {faces.shape}")
    if faces.shape[-1] == 4:
        faces = np.concatenate([faces[:, [0, 1, 2]], faces[:, [0, 1, 3]], faces[:, [0, 2, 3]],
                                faces[:, [1, 2, 3]]], axis=0)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    lo = np.minimum(e[:, 0], e[:, 1])
    hi = np.maximum(e[:, 0], e[:, 1])
    keep = lo != hi
    lo, hi = lo[keep], hi[keep]
    _, first = np.unique(lo * num_nodes + hi, return_index=True)
    lo, hi = lo[first], hi[first]
    send = np.concatenate([lo, hi])
    recv = np.concatenate([hi, lo])
    order = np.lexsort((send, recv))
    return np.stack([send[order], recv[order]]).astype(np.int32)


def k_hop_plain(edge_index: np.ndarray, num_nodes: int, k: int) -> np.ndarray:
    """:func:`k_hop` by sparse boolean matrix powers (core/mesh.py:
    k_hop_edges without the library)."""
    if k <= 1:
        return np.asarray(edge_index).astype(np.int32)
    send, recv = edge_index
    a = sp.csr_matrix((np.ones(len(send), dtype=bool), (send, recv)),
                      shape=(num_nodes, num_nodes))
    acc = a.copy()
    p = a.copy()
    for _ in range(k - 1):
        p = (p @ a).astype(bool)
        acc = (acc + p).astype(bool)
    acc.setdiag(False)
    acc.eliminate_zeros()
    coo = acc.tocoo()
    order = np.lexsort((coo.row, coo.col))
    return np.stack([coo.row[order], coo.col[order]]).astype(np.int32)


def radius_pairs_plain(pos: np.ndarray, radius: float) -> np.ndarray:
    """:func:`radius_pairs` by scipy's cKDTree (core/mesh.py:
    radius_world_edges without the library); the same pairs, sorted by
    (i, j) where the library gives its grid order."""
    from scipy.spatial import cKDTree

    pairs = cKDTree(np.asarray(pos, np.float32)).query_pairs(radius, output_type="ndarray")
    return pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))].astype(np.int32).reshape(-1, 2)


def radius_cross_pairs_plain(pos_a: np.ndarray, pos_b: np.ndarray,
                             radius: float) -> np.ndarray:
    """:func:`radius_cross_pairs` by scipy's cKDTree, sorted by (i, j)."""
    from scipy.spatial import cKDTree

    hits = cKDTree(np.asarray(pos_b, np.float32)).query_ball_point(
        np.asarray(pos_a, np.float32), radius)
    a = np.repeat(np.arange(len(hits)), [len(h) for h in hits])
    b = np.concatenate([np.sort(np.asarray(h, np.int64)) for h in hits] or [np.zeros(0)])
    return np.stack([a, b], axis=1).astype(np.int32).reshape(-1, 2)


def rcb_labels_plain(pos: np.ndarray, num_parts: int) -> np.ndarray:
    """:func:`rcb_labels` in numpy, the library's recursion step for step:
    a task of ``parts`` > 1 and more than one node splits on the first of
    its widest fp32 axes; its left set is the first ``cut`` nodes in
    (coordinate, node id) order, ``cut = floor(n·left_parts/parts + 0.5)``
    (``llround``), with ``left_parts = parts // 2``; labels count up from
    the task's base, left before right."""
    pos = np.asarray(pos, np.float32)
    labels = np.zeros(pos.shape[0], np.int32)
    tasks: List = [(np.arange(pos.shape[0]), int(num_parts), 0)]
    while tasks:
        ids, parts, base = tasks.pop()
        if parts <= 1 or len(ids) <= 1:
            labels[ids] = base
            continue
        p = pos[ids]
        axis = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        left_parts = parts // 2
        cut = int(np.floor(len(ids) * left_parts / parts + 0.5))
        order = ids[np.lexsort((ids, p[:, axis]))]
        tasks.append((order[:cut], left_parts, base))
        tasks.append((order[cut:], parts - left_parts, base + left_parts))
    return labels


def pack_rows_plain(vals: Sequence[np.ndarray]) -> np.ndarray:
    """:func:`pack_rows` as a [B, N, F] stack, then one transpose (the
    numpy branch of training/packed.py:pack_frames)."""
    return np.ascontiguousarray(np.stack(vals, axis=0).swapaxes(0, 1))


def repeat_rows_plain(val: np.ndarray, num_b: int) -> np.ndarray:
    """:func:`repeat_rows` by ``np.repeat``."""
    return np.repeat(np.asarray(val)[:, None], num_b, axis=1)


def pack_block_plain(src: np.ndarray, out: np.ndarray, col: int) -> None:
    """:func:`pack_block` as numpy's transposed assignment."""
    num_b, num_n, w = src.shape
    out[:num_n, :, col:col + w] = src.transpose(1, 0, 2)


#: each library function's plain version
PLAIN = {
    "faces_to_edges": faces_to_edges_plain,
    "k_hop": k_hop_plain,
    "radius_pairs": radius_pairs_plain,
    "radius_cross_pairs": radius_cross_pairs_plain,
    "rcb_labels": rcb_labels_plain,
    "pack_rows": pack_rows_plain,
    "repeat_rows": repeat_rows_plain,
    "pack_block": pack_block_plain,
}
