"""Intra-phase checkpoint/resume for the count phase.

Port of quickmer2_tpu/utils/checkpoint.py, with the same format and
MAGIC, so a checkpoint written by either package resumes in the other.
The reference's only "checkpointing" is phase-level file persistence (a
count job that dies near the end of a 30x genome restarts from zero).
Here every counter's state round-trips as a dict of host arrays plus
JSON metadata (pipelines.count.StreamCounter.snapshot), so a checkpoint
is: (stream byte offset, parser state, state arrays). Works for flat
and anchored counters, and for non-seekable stdin streams (resume
re-reads and discards the consumed prefix, so the upstream pipe just
replays). Snapshots are atomic (write-temp + rename + fsync).

Format: 8-byte little-endian header length, JSON header {magic,
byte_offset, arrays: {name: {dtype, shape}}, meta}, then each array's
raw bytes in header order.
"""

from __future__ import annotations

import json
import os

import numpy as np

MAGIC = "qm2tpu-count-ckpt-v2"


def save(path: str, byte_offset: int, arrays: dict, meta: dict) -> None:
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    header = {"magic": MAGIC, "byte_offset": int(byte_offset),
              "arrays": {k: {"dtype": str(v.dtype), "shape": list(v.shape)}
                         for k, v in arrays.items()},
              "meta": meta}
    blob = json.dumps(header).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for v in arrays.values():
            v.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str):
    """Returns (byte_offset, arrays, meta) or None if absent."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
        if header.get("magic") != MAGIC:
            raise ValueError(f"{path}: not a count checkpoint "
                             f"(magic {header.get('magic')!r})")
        arrays = {}
        for k, spec in header["arrays"].items():
            n = int(np.prod(spec["shape"])) if spec["shape"] else 1
            arrays[k] = np.fromfile(f, dtype=np.dtype(spec["dtype"]),
                                    count=n).reshape(spec["shape"])
    return header["byte_offset"], arrays, header["meta"]
