"""The system under test: quickmer2_tpu_torch's count, as run_count drives
it (pipelines/count.py: make_packer(fmt).feed(chunk) ->
StreamCounter.feed_codes(codes), then StreamCounter.finish()).

This is the benchmark's only module that imports the program. It takes
the program's entry, its counters (StreamCounter.stats) and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

# the CUDA sources the flat count launches (kernels/build.py builds each
# into a library of its own at first use; set-up builds them first)
SOURCES = ("count_mono",)


class Count:
    """One sample's count: the dictionary, its mono table, the
    StreamCounter the window feeds, and the FASTQ packer."""

    def __init__(self, cfg: dict, world, device: torch.device, spans,
                 log=print):
        from quickmer2_tpu_torch.dictionary import Dictionary
        from quickmer2_tpu_torch.pipelines.count import (
            StreamCounter, make_packer)
        from quickmer2_tpu_torch.ops.monotable import MonoTable
        if (cfg["mode"], cfg["engine"]) != ("flat", "mono"):
            raise ValueError(f"{cfg['mode']} / {cfg['engine']}: the benchmark "
                             "drives the flat mono count alone")
        if device.type == "cuda":
            from quickmer2_tpu_torch.kernels import build
            with spans("kernel_build"):
                build.build_all(SOURCES)
        k = int(cfg["k"])
        n = len(world.keys)
        hash_size = 1 << int(np.ceil(np.log2(2 * n)))
        with spans("dictionary"):
            dic = Dictionary.from_kmers_in_order(world.keys, hash_size, k)
        with spans("table_build"):
            table = MonoTable.from_dictionary(dic)
            kw = dict(mode="flat", engine="mono", packed_table=table,
                      batch_bases=int(cfg["batch_bases"]), device=device)
            self.counter = StreamCounter(dic, **kw)
        self._new_counter = lambda: StreamCounter(dic, **kw)
        self._new_packer = lambda: make_packer("fastq")
        self.packer = self._new_packer()
        log(f"dictionary of {n} keys, hash size {hash_size}; mono table "
            f"of {table.n_buckets} buckets, load "
            f"{n / table.n_slots:.4f}; flat counter built")

    def warm_up(self, chunk: np.ndarray) -> None:
        """Run a counter of its own over `chunk` to its finish, so every
        kernel and host path of the count has built, loaded and run once
        before the window."""
        c = self._new_counter()
        c.feed_codes(self._new_packer().feed(chunk))
        c.finish()
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def feed_bytes(self, chunk: np.ndarray) -> np.ndarray:
        return self.packer.feed(chunk)

    def feed_codes(self, codes: np.ndarray) -> None:
        self.counter.feed_codes(codes)

    def finish(self) -> np.ndarray:
        """The depth vector, u32[n_keys] in rank order."""
        return self.counter.finish()

    def stats(self) -> dict:
        return dict(self.counter.stats)
