"""Device grid of the multi-device count, the port of
quickmer2_tpu/parallel/mesh.py.

Two axes:
  "data" — each device of a row counts a disjoint shard of the read
           stream; the partials merge by an integer sum at finish;
  "dict" — each device of a column holds one contiguous bucket block of
           the packed table (the escape for tables larger than one
           card's memory); every device of a row sees the row's reads.

A Mesh is a data x dict grid of torch.devices. On "cuda" it holds cards
cuda:0 .. cuda:n-1 and raises when the box has too few; on "cpu" it is n
copies of the CPU device (the JAX tests' virtual host devices). An
explicit device list wins, and may name one device several times (all
shards of a grid on cuda:0).
"""

from __future__ import annotations

import dataclasses

import torch

from quickmer2_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple          # rows of the data axis, each a tuple over dict

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "dict": len(self.devices[0])}

    def __getitem__(self, ij) -> torch.device:
        i, j = ij
        return self.devices[i][j]

    def distinct(self) -> list:
        """The grid's devices, each once, in grid order."""
        out = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out


def make_mesh(data: int | None = None, dict_: int = 1, devices=None,
              device: str | torch.device = "cuda") -> Mesh:
    """A data x dict_ grid over `devices` (default: every card of the box
    for "cuda", or data * dict_ copies of the CPU device for "cpu";
    data defaults to all the devices over dict_)."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * ((data or 1) * dict_)
    devices = [torch.device(d) for d in devices]
    for d in set(devices):
        resolve_device(d)
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise ValueError(f"{d}: the box has "
                             f"{torch.cuda.device_count()} cards")
    if data is None:
        data = len(devices) // dict_
    n = data * dict_
    if data < 1 or dict_ < 1:
        raise ValueError(f"a mesh needs data >= 1 and dict >= 1, got "
                         f"{data} x {dict_}")
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[i * dict_ + j] for j in range(dict_))
                      for i in range(data)))
