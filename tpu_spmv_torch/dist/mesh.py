"""Meshes: which device holds each shard.

Counterpart of ``tpu_spmv/dist/mesh.py``.  The port keeps the reference's
single-controller model: one process drives every shard.  A :class:`Mesh`
is a tuple of torch devices, one per shard, and a device may repeat — all
shards on one card (or on the CPU) are the counterpart of JAX's virtual
devices, and run every halo exchange for real as a copy between shards'
buffers.  Collectives become copies (to a neighbour's device) and sums in
shard order, so results are deterministic.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Mesh", "make_mesh", "device_count"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``s`` lives on ``devices[s]``."""

    devices: tuple[torch.device, ...]

    @property
    def ndev(self) -> int:
        return len(self.devices)


def device_count() -> int:
    """The number of CUDA cards."""
    return torch.cuda.device_count()


def make_mesh(ndev: int | None = None, *, device=None) -> Mesh:
    """A mesh of ``ndev`` shards.

    With ``device=None`` (or ``"cuda"`` with no index), one shard on each
    of the first ``ndev`` CUDA cards (default: all); more shards than cards
    raises.  With a device that names one card (``"cuda:0"``) or the CPU,
    all ``ndev`` shards (default 1) on that device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        n = device_count()
        ndev = n if ndev is None else ndev
        if ndev > n:
            raise ValueError(f"requested {ndev} devices, only {n} available "
                             f"(pass device='cuda:0' to put several shards "
                             f"on one card)")
        devices = tuple(torch.device("cuda", i) for i in range(ndev))
    else:
        devices = (dev,) * (1 if ndev is None else ndev)
    if not devices:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(devices)
