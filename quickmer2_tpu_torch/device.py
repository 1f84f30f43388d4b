"""Device choice and the u32-word convention shared by the port.

Every entry point runs on the CUDA card unless the caller asks for the
CPU, and never falls back from one to the other.

u32 words (k-mer code halves, table rows, depth counters) travel as:
  * int64 tensors holding values in [0, 2^32) on the CPU — CPU torch
    has no shifts, compares, adds or scatter-adds on uint32;
  * int32 tensors on the card, which the CUDA kernels read as unsigned.
Plain PyTorch code widens either form with `u32()` before doing
arithmetic and narrows results back with `store()`.
"""

from __future__ import annotations

import numpy as np
import torch

U32 = 0xFFFFFFFF


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for "cuda" or "cpu"; raises when "cuda" is asked
    for and no card is present (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(CLI: --device cpu) to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}: "
                         "use 'cuda' or 'cpu'")
    return dev


def word_dtype(device: torch.device) -> torch.dtype:
    return torch.int64 if device.type == "cpu" else torch.int32


def words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """u32 numpy array → word tensor on `device`."""
    a = np.ascontiguousarray(a, np.uint32)
    if device.type == "cpu":
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.view(np.int32)).to(device)


def u32(t: torch.Tensor) -> torch.Tensor:
    """Word tensor (int32 or int64) → int64 holding the u32 value."""
    return t.to(torch.int64) & U32


def store(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 tensor of u32 values (taken mod 2^32) → word storage dtype."""
    x = x & U32
    if dtype == torch.int64:
        return x
    return (x - ((x >> 31) << 32)).to(dtype)


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """Word tensor → host u32 numpy array (values taken mod 2^32)."""
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def start_fetch(t: torch.Tensor) -> tuple:
    """Start t's device-to-host copy into pinned memory behind the work
    that writes it; `fetched` waits on that copy alone, not on later
    launches."""
    if t.device.type == "cpu":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def fetched(handle: tuple) -> torch.Tensor:
    """The host tensor of a start_fetch handle, once its copy is done."""
    host, done = handle
    if done is not None:
        done.synchronize()
    return host


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 tensors holding u32 values (torch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & U32) >> 24
