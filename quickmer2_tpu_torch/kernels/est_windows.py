"""est's GC-corrected window sums: the CUDA kernel csrc/est_windows.cu
(K11) and its plain PyTorch version.

`window_sums` replaces quickmer2_tpu/ops/est_device.py::
corrected_window_sums: for each window [kstart, kend) of k-mers, the f32
sum of the f32 products factors[qgc & 0x1FF] * depth (a GC bin past the
last factor takes the last one, as the JAX gather clamps). depth and
qgc are the u16 arrays of the .bin and .qgc files, carried as int16
tensors; a window's range is clamped to [0, n).

The sum's order is fixed: lane l of 32 adds the k-mers kstart + l,
kstart + l + 32, ... in turn, then the 32 lane sums are added by the
tree of a warp shuffle (offsets 16, 8, 4, 2, 1). The kernel and
`window_sums_plain` both take that order, so they agree bit for bit, and
a launch gives the same bits every time.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel, or raises. The wrapper counts its own launches.
"""

from __future__ import annotations

import ctypes

import torch

from quickmer2_tpu_torch.kernels import build

LANES = 32
MAX_FACTORS = 512

_ARGTYPES = {"qm2t_window_sums": [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
    ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p]}


def window_sums_plain(depth, qgc, factors, kstarts, kends) -> torch.Tensor:
    """Plain PyTorch version, in the kernel's order: a step of 32 k-mers
    a window at a time, each lane's sum in turn, then the tree."""
    n = depth.numel()
    dev = depth.device
    fac = factors.to(torch.float32)
    ks = kstarts.to(torch.int64).clamp(min=0)
    ke = kends.to(torch.int64).clamp(max=n)
    acc = torch.zeros((len(ks), LANES), dtype=torch.float32, device=dev)
    if len(ks):
        lane = torch.arange(LANES, device=dev)
        steps = -(-int((ke - ks).clamp(min=0).max()) // LANES)
        for s in range(steps):
            i = ks[:, None] + s * LANES + lane
            live = i < ke[:, None]
            i = torch.where(live, i, 0)
            gc = (qgc[i].to(torch.int64) & 0x1FF).clamp(max=len(fac) - 1)
            d = (depth[i].to(torch.int64) & 0xFFFF).to(torch.float32)
            acc = torch.where(live, acc + fac[gc] * d, acc)
    off = LANES // 2
    while off:
        acc = acc[:, :off] + acc[:, off:2 * off]
        off //= 2
    return acc[:, 0]


def window_sums(depth: torch.Tensor, qgc: torch.Tensor,
                factors: torch.Tensor, kstarts: torch.Tensor,
                kends: torch.Tensor) -> torch.Tensor:
    """f32[W] window sums of depth (u16 as int16[n]), qgc (int16[n]),
    factors (f32[<= 512]) over kstarts / kends (int32[W])."""
    if depth.device.type == "cpu":
        return window_sums_plain(depth, qgc, factors, kstarts, kends)
    n, w = depth.numel(), kstarts.numel()
    build.check_tensors("window_sums", depth.device, [
        ("depth", depth, torch.int16, (n,)),
        ("qgc", qgc, torch.int16, (n,)),
        ("factors", factors, torch.float32, (factors.numel(),)),
        ("kstarts", kstarts, torch.int32, (w,)),
        ("kends", kends, torch.int32, (w,))])
    if not 1 <= factors.numel() <= MAX_FACTORS:
        raise ValueError(f"window_sums: {factors.numel()} factors, at most "
                         f"{MAX_FACTORS} taken")
    sums = torch.empty(w, dtype=torch.float32, device=depth.device)
    lib = build.load("est_windows", _ARGTYPES)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.qm2t_window_sums(
            depth.data_ptr(), qgc.data_ptr(), factors.data_ptr(),
            factors.numel(), kstarts.data_ptr(), kends.data_ptr(),
            sums.data_ptr(), n, w, stream)
    build.check(lib, rc, "window_sums")
    window_sums.launches += 1
    return sums


window_sums.launches = 0
