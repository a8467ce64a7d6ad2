"""Native (C++) runtime components, loaded via ctypes.

The reference offloads min-cost perfect matching to an external C++ binary
(blossom5) over file IPC; here the native solver is part of the framework:
``native/blossom.cpp`` is compiled once into ``_native.so`` and called
in-process.  The build is a plain g++ invocation cached next to the
package (no toolchain at runtime -> ImportError with a clear message).
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = Path(__file__).resolve().parent / "_native.so"
_HASH_PATH = Path(__file__).resolve().parent / "_native.so.srchash"
_SOURCES = [
    "blossom.cpp",
    "blossom_sparse.cpp",
    "extract.cpp",
    "graphwalk.cpp",
    "radix.cpp",
    "tigs.cpp",
]

_CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
              "-pthread"]

_lib: ctypes.CDLL | None = None
_load_error: Exception | None = None


def _host_isa() -> str:
    """The host CPU's instruction-set flags: what ``-march=native``
    compiles for.  A library built on another CPU may use instructions
    this one lacks (SIGILL), so they are part of the build hash."""
    import platform

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return platform.machine() + " " + platform.processor()


def _src_hash() -> str:
    """Hash of everything the built library depends on: the sources,
    the compiler flags and the host CPU's instruction set."""
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update(s.encode())
        h.update((_SRC_DIR / s).read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    h.update(_host_isa().encode())
    return h.hexdigest()


def _build() -> None:
    import os

    srcs = [str(_SRC_DIR / s) for s in _SOURCES]
    tmp = _LIB_PATH.with_suffix(f".so.build{os.getpid()}")
    cmd = ["g++", *_CXX_FLAGS, "-o", str(tmp), *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ImportError(
            f"native build failed: {proc.stderr[-2000:]}"
        )
    os.replace(tmp, _LIB_PATH)  # atomic: concurrent builders never corrupt
    _HASH_PATH.write_text(_src_hash())


def _needs_rebuild() -> bool:
    # Content-hash trigger, not mtimes: a fresh checkout gives sources and a
    # (foreign, possibly -march=native-incompatible) .so identical mtimes;
    # the hash also covers the flags and the host CPU's instruction set.
    if not _LIB_PATH.exists() or not _HASH_PATH.exists():
        return True
    return _HASH_PATH.read_text().strip() != _src_hash()


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:  # don't retry a failed build every call
        raise _load_error
    try:
        if _needs_rebuild():
            _build()
    except Exception as e:
        _load_error = e if isinstance(e, ImportError) else ImportError(str(e))
        raise _load_error from None
    lib = ctypes.CDLL(str(_LIB_PATH))
    ll = ctypes.c_longlong
    llp = ctypes.POINTER(ll)
    lib.mwm_dense.restype = ll
    lib.mwm_dense.argtypes = [
        ctypes.c_int,
        llp,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mwm_sparse.restype = ll
    lib.mwm_sparse.argtypes = [
        ll, ll, llp, llp, llp, ctypes.POINTER(ctypes.c_int),
    ]
    lib.mwm_sparse_batch.restype = ll
    lib.mwm_sparse_batch.argtypes = [
        ll, llp, llp, llp, llp, llp, ctypes.POINTER(ctypes.c_int), ll, ll,
    ]
    lib.follow_chains.restype = ll
    lib.follow_chains.argtypes = [ll, llp, ll, llp, llp, llp]
    lib.euler_decompose.restype = ll
    lib.euler_decompose.argtypes = [ll, ll] + [llp] * 7
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.euler_decompose_pairing.restype = ll
    lib.euler_decompose_pairing.argtypes = [
        ll, ll, i32p, i32p, llp, i32p, ll, llp, llp,
    ]
    lib.euler_decompose_splice.restype = ll
    lib.euler_decompose_splice.argtypes = [
        ll, ll, i32p, i32p, llp, i32p, ll, llp, llp,
    ]
    lib.euler_decompose_parsplice.restype = ll
    lib.euler_decompose_parsplice.argtypes = [
        ll, ll, i32p, i32p, llp, i32p, ll, llp, llp,
    ]
    lib.euler_decompose_parsplice_gids.restype = ll
    lib.euler_decompose_parsplice_gids.argtypes = [
        ll, ll, i32p, i32p, llp, i32p, ll, llp, llp, llp, llp,
    ]
    i8p_ = ctypes.POINTER(ctypes.c_byte)
    lib.wcc_labels.restype = ll
    lib.wcc_labels.argtypes = [ll, ll, i32p, i32p, i32p]
    lib.break_cycles_flat.restype = ll
    lib.break_cycles_flat.argtypes = [
        ll, llp, llp, llp, i8p_, ll, llp, llp,
    ]
    lib.break_cycles_flat_cyc.restype = ll
    lib.break_cycles_flat_cyc.argtypes = [
        ll, llp, llp, llp, i8p_, ll, llp, llp, llp,
    ]
    lib.break_cycles_flat_mt.restype = ll
    lib.break_cycles_flat_mt.argtypes = [
        ll, llp, llp, llp, i8p_, ll, ll, llp, llp, llp, ll,
    ]
    lib.biwalk_cover.restype = ll
    lib.biwalk_cover.argtypes = [ll, ll] + [llp] * 8
    lib.balance_breaking_edges.restype = ll
    lib.balance_breaking_edges.argtypes = [ll, llp, llp, llp, ll]
    i8p = ctypes.POINTER(ctypes.c_byte)
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.greedy_accept_scan_perm.restype = ll
    lib.greedy_accept_scan_perm.argtypes = [
        ll, llp, llp, llp, llp, llp, llp, i8p, llp,
    ]
    lib.greedy_accept_scan_mt.restype = ll
    lib.greedy_accept_scan_mt.argtypes = [
        ll, llp, llp, llp, llp, llp, i8p, llp, ll, ll,
    ]
    lib.fill_padded_adj.restype = ll
    lib.fill_padded_adj.argtypes = [
        ll, ll, i32p, i32p, llp, ll, ll, ll, i32p, i32p,
    ]
    lib.accept_sort_packed.restype = ll
    lib.accept_sort_packed.argtypes = [ll, llp, llp, llp, ll]
    lib.radix_sort_i64.restype = ll
    lib.radix_sort_i64.argtypes = [ll, llp, ll]
    llpp_ = ctypes.POINTER(llp)
    lib.accept_sort_packed_chunks.restype = ll
    lib.accept_sort_packed_chunks.argtypes = [
        ll, llpp_, llpp_, llpp_, llp, llp, llp, llp, ll,
    ]
    u64p = ctypes.POINTER(ctypes.c_ulonglong)
    lib.greedy_accept_scan_packed_mt.restype = ll
    lib.greedy_accept_scan_packed_mt.argtypes = [
        ll, u64p, llp, llp, i8p, llp, llp, llp, ll, ll, ll,
    ]
    lib.accept_chunks_scan_packed.restype = ll
    lib.accept_chunks_scan_packed.argtypes = [
        ll, llpp_, llpp_, llpp_, llp, llp, llp, i8p,
        llp, llp, llp, ll, ll, ll,
    ]
    lib.collapse_expand_count.restype = ll
    lib.collapse_expand_count.argtypes = [ll, llp, llp, llp, ll]
    lib.copy_i64_populated.restype = None
    lib.copy_i64_populated.argtypes = [llp, llp, ll, ll]
    lib.collapse_dedup_unpack.restype = ll
    lib.collapse_dedup_unpack.argtypes = [
        ll, llp, ll, ll, llp, llp, llp, i8p, i8p, i8p,
    ]
    lib.collapse_expand_pack.restype = ll
    lib.collapse_expand_pack.argtypes = [
        ll, llp, llp, llp, llp, llp,
        ctypes.POINTER(ctypes.c_byte), ll, ll, llp,
    ]
    lib.spell_walks_packed.restype = ll
    lib.spell_walks_packed.argtypes = [
        llp, llp, ll, llp, llp, i8p, i8p, u8p, llp, ll, u8p, llp,
    ]
    lib.spell_walks_packed_mt.restype = ll
    lib.spell_walks_packed_mt.argtypes = [
        llp, llp, ll, llp, llp, i8p, i8p, u8p, llp, ll, u8p, llp, llp, ll,
    ]
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bounded_dijkstra_candidates.restype = ll
    lib.bounded_dijkstra_candidates.argtypes = [
        ll, ll, ip, ip, ll, llp, ll, i8p, ll, llp, llp, llp,
    ]
    lib.bounded_dijkstra_candidates_mt.restype = ll
    lib.bounded_dijkstra_candidates_mt.argtypes = [
        ll, ll, ip, ip, ll, llp, ll, i8p, ll, llp, llp, llp, ll, llp,
    ]
    llpp = ctypes.POINTER(llp)
    lib.bounded_dijkstra_candidates_auto.restype = ll
    lib.bounded_dijkstra_candidates_auto.argtypes = [
        ll, ll, ip, ip, ll, llp, ll, i8p, ll, llpp,
    ]
    lib.reference_dijkstra_candidates.restype = ll
    lib.reference_dijkstra_candidates.argtypes = [
        ll, ll, ip, ip, ll, llp, ll, i8p, ll, llpp,
    ]
    lib.free_i64_buffer.restype = None
    lib.free_i64_buffer.argtypes = [llp]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.unique_u64_inverse.restype = ll
    lib.unique_u64_inverse.argtypes = [ll, u64p, u64p, i32p, ll]
    lib.stable_order_i32.restype = None
    lib.stable_order_i32.argtypes = [ll, i32p, ll, llp, ll]
    lib.extract_packed_triples.restype = ll
    lib.extract_packed_triples.argtypes = [
        ll, ll, i32p, i32p, i8p, i8p, i32p, ll, ll, llpp,
    ]
    lib.pair_dedup_min_dist.restype = ll
    lib.pair_dedup_min_dist.argtypes = [ll, llp, llp, llp, ll, ll, ll, llpp]
    lib.collapse_dedup_resolve.restype = ll
    lib.collapse_dedup_resolve.argtypes = [
        ll, llp, ll, llp, llp, ll, llp, llp, llp, llp, llp,
    ]
    lib.gather_edges_cc_i64.restype = None
    lib.gather_edges_cc_i64.argtypes = [ll, llp, llp, llp, llp, llp, llp, llp, ll]
    _lib = lib
    return lib


def as_ll_ptr(a):
    """int64 numpy array -> c_longlong pointer (no copy)."""
    import numpy as np

    assert a.dtype == np.int64 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def as_i8_ptr(a):
    """int8 numpy array -> c_byte pointer (no copy)."""
    import numpy as np

    assert a.dtype == np.int8 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_byte))


def as_u8_ptr(a):
    """uint8 numpy array -> c_ubyte pointer (no copy)."""
    import numpy as np

    assert a.dtype == np.uint8 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def as_i32_ptr(a):
    """int32 numpy array -> c_int pointer (no copy)."""
    import numpy as np

    assert a.dtype == np.int32 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def as_u64_ptr(a):
    """uint64 numpy array -> c_uint64 pointer (no copy)."""
    import numpy as np

    assert a.dtype == np.uint64 and a.flags.c_contiguous
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
