"""A configuration's reference: its genome and its dictionary's keys.

A deployment has one reference, so each configuration fixes its genome
by the seed, length and segmental duplication in its file
(genome.make_genome) and its dictionary as the genome's single-copy
canonical k-mers in genome order. Both are made by the first run of a
configuration in a checkout and kept in qmbench/.cache/<configuration>/
(genome.npy, keys.npy, and meta.json naming what made them). Later runs
read them.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from qmbench import genome, reference

CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".cache")


@dataclasses.dataclass
class World:
    genome: np.ndarray      # u8 codes, A0 C1 T2 G3
    keys: np.ndarray        # u64 canonical k-mers, rank (genome) order


def world_params(cfg: dict) -> dict:
    """What fixes a configuration's reference (checked against the
    cache's meta.json)."""
    return {key: cfg.get(key, 0) for key in
            ("genome_bases", "genome_seed", "dup_len", "dup_copies", "k")}


def load_world(cfg: dict, cache_dir: str = CACHE_DIR,
               device: torch.device | None = None, log=print) -> World:
    """The configuration's genome and keys, from its cache or made (and
    cached) when the cache lacks them or was made otherwise."""
    d = os.path.join(cache_dir, cfg["name"])
    g_path, keys_path = (os.path.join(d, "genome.npy"),
                         os.path.join(d, "keys.npy"))
    meta_path = os.path.join(d, "meta.json")
    params = world_params(cfg)
    try:
        with open(meta_path) as f:
            fresh = json.load(f)["params"] == params
    except (OSError, ValueError, KeyError):
        fresh = False
    if fresh:
        return World(np.load(g_path), np.load(keys_path))
    log(f"making the reference of {cfg['name']} in {d}")
    os.makedirs(d, exist_ok=True)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    rng = np.random.default_rng(int(params["genome_seed"]))
    g, _, _ = genome.make_genome(rng, int(params["genome_bases"]),
                                 int(params["dup_len"]),
                                 int(params["dup_copies"]))
    keys = single_copy_kmers(g, int(cfg["k"]), device or torch.device("cpu"))
    _atomic(g_path, lambda p: np.save(p, g))
    _atomic(keys_path, lambda p: np.save(p, keys))
    _atomic(meta_path, lambda p: _write_json(
        p, {"params": params, "n_bases": int(len(g)),
            "n_keys": int(len(keys))}))
    return World(g, keys)


def _atomic(path: str, write) -> None:
    tmp = path + ".part"
    if path.endswith(".npy"):
        tmp = path[:-4] + ".part.npy"      # np.save appends .npy
    write(tmp)
    os.replace(tmp, path)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def single_copy_kmers(g: np.ndarray, k: int,
                      device: torch.device) -> np.ndarray:
    """The canonical k-mers that occur once in g (both strands counted),
    but the all-A one, in genome order: u64."""
    codes = torch.from_numpy(g).to(device).to(torch.int64)[None]
    km, valid = reference.kmers(codes, k)
    km = km[0][valid[0]]
    _, inverse, counts = torch.unique(km, return_inverse=True,
                                      return_counts=True)
    keep = (counts[inverse] == 1) & (km != 0)
    return km[keep].cpu().numpy().view(np.uint64)
