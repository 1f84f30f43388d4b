"""Cohort batching: count + est many samples against one dictionary.

Port of quickmer2_tpu/pipelines/cohort.py. The reference
processes samples one binary invocation at a time; a cohort pays the
dictionary load and the device structures once: the dictionary, the
mono table (flat mode) and the anchored index (anchored mode, its .qai
built or loaded once) are shared, and each sample streams through a
pipelines.count.StreamCounter, the object run_count feeds, so its
outputs are byte-identical to a single-sample count.
"""

from __future__ import annotations

import os
import time

import numpy as np

from quickmer2_tpu_torch.config import EstConfig
from quickmer2_tpu_torch.device import resolve_device
from quickmer2_tpu_torch.dictionary import Dictionary
from quickmer2_tpu_torch.io import formats
from quickmer2_tpu_torch.pipelines.count import (
    StreamCounter, _companion, gc_curve_from_depth, make_packer)
from quickmer2_tpu_torch.pipelines.est import run_est


def run_cohort(qm_path: str, samples: list[tuple[str, str]],
               batch_bases: int = 1 << 24, mode: str = "flat",
               ref_fasta: str | None = None, read_len: int | None = None,
               est_cfg: EstConfig | None = None, cn_suffix: str = ".CN.bed",
               chunk_bytes: int = 1 << 24, verbose: bool = True,
               data_devices: int | None = None,
               dict_devices: int | None = None,
               device: str = "cuda") -> list[dict]:
    """samples: list of (sample_path, out_prefix). Returns per-sample
    stats. Writes <out>.bin/.txt and <out><cn_suffix> per sample (the
    last two when the dictionary's .qgc companion exists).

    data_devices / dict_devices shard each sample's count over a data x
    dict mesh (pipelines.count.run_count's options). device: "cuda" (default; raises without a card) or "cpu"."""
    dev = resolve_device(device)
    dictionary = Dictionary.from_qm(qm_path)
    index = None
    packed_table = None
    if mode == "anchored":
        from quickmer2_tpu_torch.ops.anchored import AnchoredIndex
        if ref_fasta is None:
            ref_fasta = _companion(qm_path, "")
        index = AnchoredIndex.from_dictionary_and_fasta(
            dictionary, ref_fasta, cache_path=ref_fasta + ".qai",
            place_rows=(dict_devices or 1) == 1, device=dev)
    elif (data_devices or 1) == 1 and (dict_devices or 1) == 1:
        from quickmer2_tpu_torch.ops.monotable import MonoTable
        packed_table = MonoTable.from_dictionary(dictionary)

    qgc_path = _companion(qm_path, ".qgc")
    if not os.path.exists(qgc_path):
        qgc_path = qm_path + ".qgc"
    qgc = (formats.read_u16(qgc_path)[: dictionary.n_kmers]
           if os.path.exists(qgc_path) else None)
    bed_prefix = _companion(qm_path, "")

    out_stats = []
    for sample_path, out_prefix in samples:
        t_sample = time.time()
        sc = StreamCounter(dictionary, mode=mode, index=index,
                           batch_bases=batch_bases, read_len=read_len,
                           packed_table=packed_table,
                           data_devices=data_devices,
                           dict_devices=dict_devices, device=dev)
        with open(sample_path, "rb") as f:
            data = f.read(chunk_bytes)
            fmt = "fastq" if data[:1] == b"@" else "fasta-lines"
            packer = make_packer(fmt)
            while data:
                sc.feed_codes(packer.feed(data))
                data = f.read(chunk_bytes)
        depth = sc.finish()
        depth_u16 = (depth & 0xFFFF).astype(np.uint16)
        formats.write_u16(out_prefix + ".bin", depth_u16)
        stats = {"sample": sample_path, "n_kmers": dictionary.n_kmers,
                 **sc.stats}
        if qgc is not None:
            mean, count, var, mean_depth = gc_curve_from_depth(depth_u16, qgc)
            formats.write_gc_curve(out_prefix + ".txt", mean, count, var)
            stats["mean_depth"] = mean_depth
            res = run_est(bed_prefix, out_prefix, out_prefix + cn_suffix,
                          cfg=est_cfg, verbose=verbose, device=dev)
            stats["n_windows"] = res["n_windows"]
        stats["elapsed_s"] = round(time.time() - t_sample, 3)
        out_stats.append(stats)
        if verbose:
            print(f"cohort: {sample_path} done "
                  f"(mean depth {stats.get('mean_depth', float('nan')):.2f})")
    return out_stats
