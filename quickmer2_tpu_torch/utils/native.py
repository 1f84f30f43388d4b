"""ctypes binding to the native host runtime (native/qm2core.c).

The C source is shared with the JAX package; this port compiles its
own copy with the system gcc into quickmer2_tpu_torch/_build/native/,
named by a hash of the source, so it never writes the JAX package's
native/build/ and concurrent builders (test workers) cannot tear one
.so: each compiles to a process-unique file and renames it into place.
Every entry point has a pure-Python fallback elsewhere in the port;
`available()` gates the fast paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "qm2core.c")
_BUILD_DIR = os.path.join(_PKG, "_build", "native")
_CFLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lib_error: str | None = None


class ParseState(ctypes.Structure):
    _fields_ = [
        ("mode", ctypes.c_int32),
        ("state", ctypes.c_int32),
        ("seq_len", ctypes.c_int64),
        ("qual_left", ctypes.c_int64),
        ("emitted_sep", ctypes.c_int32),
    ]


def _compile() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(_CFLAGS).encode()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libqm2core-{tag}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        subprocess.run(["gcc", *_CFLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return so


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def get_lib():
    global _lib, _lib_error
    if _lib is None and _lib_error is None:
        try:
            lib = ctypes.CDLL(_compile())
            lib.qm2_chain_walk.restype = ctypes.c_int64
            lib.qm2_parse_chunk.restype = ctypes.c_int64
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            _lib_error = str(e)
    return _lib


def available() -> bool:
    return get_lib() is not None


def chain_walk(chain: np.ndarray, first: int, cap: int) -> np.ndarray:
    lib = get_lib()
    chain = np.ascontiguousarray(chain, dtype=np.uint32)
    out = np.empty(cap, dtype=np.int64)
    n = lib.qm2_chain_walk(_u32p(chain), ctypes.c_uint64(first), _i64p(out),
                           ctypes.c_int64(cap))
    return out[:n]


def insert_keys(table: np.ndarray, keys: np.ndarray,
                return_slots: bool = False):
    lib = get_lib()
    assert table.dtype == np.uint64 and table.flags.c_contiguous
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    slots = np.empty(len(keys), dtype=np.int64) if return_slots else None
    lib.qm2_insert_keys(_u64p(table), ctypes.c_uint64(len(table)),
                        _u64p(keys), ctypes.c_int64(len(keys)),
                        _i64p(slots) if return_slots else None)
    return slots


def lookup_keys(table: np.ndarray, keys: np.ndarray):
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    table = np.ascontiguousarray(table, dtype=np.uint64)
    slots = np.empty(len(keys), dtype=np.int64)
    found = np.empty(len(keys), dtype=np.uint8)
    lib.qm2_lookup_keys(_u64p(table), ctypes.c_uint64(len(table)),
                        _u64p(keys), ctypes.c_int64(len(keys)),
                        _i64p(slots), _u8p(found))
    return slots, found.astype(bool)


def sliding_canon(codes: np.ndarray, k: int):
    """Host bulk kmerize via C (qm2_sliding_canon): returns
    (canon u64[N], valid bool[N], is_fwd bool[N]), N = len(codes)-k+1 —
    same values as codec.sliding_kmers_np + an is-forward-strand flag."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.uint8)
    n = len(codes) - k + 1
    canon = np.empty(max(n, 0), np.uint64)
    flags = np.empty(max(n, 0), np.uint8)
    if n > 0:
        lib.qm2_sliding_canon(_u8p(codes), ctypes.c_int64(len(codes)),
                              ctypes.c_int32(k), _u64p(canon), _u8p(flags))
    return canon, (flags & 1) != 0, (flags & 2) != 0


def thin_hits(bp: np.ndarray, thin: int) -> np.ndarray:
    """`sparse` thinning (qm2_thin_hits): keep[i] iff bp[i] - the last
    kept bp >= thin, the last kept starting at 0."""
    lib = get_lib()
    bp = np.ascontiguousarray(bp, dtype=np.uint32)
    keep = np.empty(len(bp), dtype=np.uint8)
    lib.qm2_thin_hits(_u32p(bp), ctypes.c_int64(len(bp)),
                      ctypes.c_uint32(thin), _u8p(keep))
    return keep.astype(bool)


def insert_keys_dup(table: np.ndarray, keys: np.ndarray,
                    return_slots: bool = False):
    """`index` insertion (qm2_insert_keys_dup): each key goes to the
    first empty slot of its scan, even past a copy of itself."""
    lib = get_lib()
    assert table.dtype == np.uint64 and table.flags.c_contiguous
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    slots = np.empty(len(keys), dtype=np.int64) if return_slots else None
    lib.qm2_insert_keys_dup(_u64p(table), ctypes.c_uint64(len(table)),
                            _u64p(keys), ctypes.c_int64(len(keys)),
                            _i64p(slots) if return_slots else None)
    return slots


class StreamPacker:
    """Streaming FASTA/FASTQ → 2-bit code stream (separator = 4).

    mode: "fasta-lines" (count semantics: separator at every line end,
    SURVEY.md Q4), "fastq", or "fasta-record" (search semantics: state
    persists across sequence lines within a record).
    """

    MODES = {"fasta-lines": 0, "fastq": 1, "fasta-record": 2}

    def __init__(self, mode: str):
        self._st = ParseState()
        get_lib().qm2_parse_init(ctypes.byref(self._st), self.MODES[mode])

    def feed(self, data: bytes) -> np.ndarray:
        lib = get_lib()
        buf = np.frombuffer(data, dtype=np.uint8)
        out = np.empty(len(buf) + 1, dtype=np.uint8)
        n = lib.qm2_parse_chunk(ctypes.byref(self._st), _u8p(buf),
                                ctypes.c_int64(len(buf)), _u8p(out))
        return out[:n]

    def get_state(self) -> dict:
        s = self._st
        return {"mode": s.mode, "state": s.state, "seq_len": s.seq_len,
                "qual_left": s.qual_left, "emitted_sep": s.emitted_sep}

    def set_state(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self._st, k, v)
