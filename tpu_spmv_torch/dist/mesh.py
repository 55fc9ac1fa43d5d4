"""Meshes: which device holds each shard, and the exchanges between shards.

Counterpart of ``tpu_spmv/dist/mesh.py``.  Two kinds of mesh run the same
distributed code:

- :class:`Mesh`, the single controller: one process drives every shard.  A
  mesh is a tuple of torch devices, one per shard, and a device may repeat
  — all shards on one card (or on the CPU) are the counterpart of JAX's
  virtual devices.  Its exchanges are copies to a shard's device and its
  sums add the shards' partials in shard order.
- :class:`ProcessMesh`, one process a shard over ``torch.distributed``
  (:func:`init_multihost`, then :func:`make_mesh` with no shard count).
  Shard ``s`` is the process of rank ``s`` in the group; the process holds
  only its own shard, and the other shards' tensors are placeholders on
  the ``meta`` device (their shapes, no storage).  Its exchanges are
  collectives: the halo exchanges one ``all_to_all_single`` each, the
  gathers ``all_gather``.  A sum all-gathers the partials and adds them in
  shard order on every rank, so every rank holds the same bits, and they
  are the single controller's (``all_reduce`` fixes no order).

The exchanges are the only code that differs between the two.  Each takes
and returns lists over the mesh's *local* shards (:attr:`Mesh.local`: every
shard on the single controller, the own one on a process mesh):

- :meth:`Mesh.ring` — each shard's neighbours' slivers (the two
  ``ppermute``\\ s of the reference's halo);
- :meth:`Mesh.shift` — the previous shard's chunk (one ring step);
- :meth:`Mesh.neighbors` — the chunks of shards ``s + d``;
- :meth:`Mesh.all_gather`, :meth:`Mesh.psum`, :meth:`Mesh.reduce_scatter`.

Gloo takes only CPU tensors for these collectives: on a process mesh on a
card over Gloo (ranks sharing a card) each exchange stages its buffers
through host memory, and :data:`STAGED` counts the staged calls by
exchange.  The products stay on the card.  NCCL needs one card a rank;
:func:`make_mesh` refuses two ranks on one card with a ``ValueError``
before any NCCL call.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
from datetime import timedelta

import torch

__all__ = ["Mesh", "ProcessMesh", "make_mesh", "device_count",
           "init_multihost", "STAGED"]

#: exchanges of a process mesh staged through host memory (Gloo on CUDA
#: tensors), by exchange; zeroed by whoever reads it
STAGED = {"ring": 0, "shift": 0, "neighbors": 0, "all_gather": 0, "psum": 0,
          "reduce_scatter": 0}

_META = torch.device("meta")
_SIDE = {}          # the Gloo side group of an NCCL run (make_mesh's check)


def sum_in_order(partials):
    """The partials (one tensor each, any shape) added in shard order on
    the first one's device."""
    dev = partials[0].device
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(dev)
    return total


def _tail(t: torch.Tensor, h: int) -> torch.Tensor:
    return t[t.shape[0] - h:]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh driven by one process: shard ``s`` lives on
    ``devices[s]``."""

    devices: tuple[torch.device, ...]

    @property
    def ndev(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> tuple[int, ...]:
        """The shards this process runs: all of them."""
        return tuple(range(self.ndev))

    @property
    def is_process(self) -> bool:
        return False

    def shards(self, local) -> tuple:
        """A per-shard tuple from a list over :attr:`local`."""
        return tuple(local)

    def ring(self, tails, heads, h: int) -> list:
        """For each shard ``s``: ``(last h rows of tails[s - 1], first h
        rows of heads[s + 1])`` on ``s``'s device, around the ring (at one
        shard, both are the shard's own)."""
        n = self.ndev
        return [(_tail(tails[(s - 1) % n], h).to(dev),
                 heads[(s + 1) % n][:h].to(dev))
                for s, dev in enumerate(self.devices)]

    def shift(self, chunks) -> list:
        """For each shard ``s``: ``chunks[s - 1]`` on ``s``'s device."""
        n = self.ndev
        return [chunks[(s - 1) % n].to(dev)
                for s, dev in enumerate(self.devices)]

    def neighbors(self, chunks, offsets, spans=None) -> list:
        """For each shard ``s``: ``[chunks[s + d] for d in offsets]`` (ring
        deltas) on ``s``'s device.  ``spans[s][i]``, the ``[lo, hi)`` that
        shard ``s`` reads of the chunk of ``s + offsets[i]``, lets a process
        mesh send only that span (the window's other rows are zero); the
        single controller copies whole chunks."""
        n = self.ndev
        return [[chunks[(s + d) % n].to(dev) for d in offsets]
                for s, dev in enumerate(self.devices)]

    def all_gather(self, chunks) -> list:
        """For each shard: every shard's chunk, in shard order, on its
        device."""
        return [[c.to(dev) for c in chunks] for dev in self.devices]

    def psum(self, partials) -> torch.Tensor:
        """The shards' partials added in shard order, on shard 0's
        device."""
        return sum_in_order(partials)

    def reduce_scatter(self, parts, R: int) -> list:
        """For each shard ``s``: the sum in shard order of every part's rows
        ``[s*R, (s+1)*R)``, on ``s``'s device (parts ``[ndev * R]``)."""
        return [sum_in_order([p[s * R:(s + 1) * R].to(dev) for p in parts])
                for s, dev in enumerate(self.devices)]


@dataclasses.dataclass(frozen=True)
class ProcessMesh(Mesh):
    """A 1-D mesh of one process a shard: shard ``s`` is rank ``s`` of
    ``group`` (``None``: the default group).  ``devices[rank]`` is this
    process's device; every other entry is ``meta``, so :func:`.spmv.place`
    keeps only the own shard's tensors."""

    rank: int = 0
    group: object = dataclasses.field(default=None, compare=False)

    @property
    def local(self) -> tuple[int, ...]:
        return (self.rank,)

    @property
    def is_process(self) -> bool:
        return True

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    def shards(self, local) -> tuple:
        """A per-shard tuple from the own shard's value: the others are
        ``meta`` placeholders of its shape."""
        (own,) = local
        ph = own.to(_META)
        return tuple(own if s == self.rank else ph for s in range(self.ndev))

    # -- transport ------------------------------------------------------------

    def _staged(self, name: str) -> bool:
        import torch.distributed as tdist

        if (self.device.type == "cuda"
                and tdist.get_backend(self.group) == "gloo"):
            STAGED[name] += 1
            return True
        return False

    def _exchange(self, name: str, send, recv_shapes, like):
        """One ``all_to_all_single``: ``send[q]`` (a list of tensors) goes
        to rank ``q``; returns, for each rank ``p``, the tensors it sent
        here, of the shapes ``recv_shapes[p]`` (type and device of
        ``like``)."""
        import torch.distributed as tdist

        staged = self._staged(name)
        buf_dev = torch.device("cpu") if staged else self.device
        flat = [t.reshape(-1) for ts in send for t in ts]
        inp = (torch.cat(flat) if flat
               else like.new_empty(0)).to(buf_dev).contiguous()
        out_sizes = [sum(math.prod(s) for s in shapes)
                     for shapes in recv_shapes]
        out = torch.empty(sum(out_sizes), dtype=like.dtype, device=buf_dev)
        tdist.all_to_all_single(
            out, inp, output_split_sizes=out_sizes,
            input_split_sizes=[sum(t.numel() for t in ts) for ts in send],
            group=self.group)
        out = out.to(self.device)
        got, at = [], 0
        for shapes in recv_shapes:
            mine = []
            for s in shapes:
                k = math.prod(s)
                mine.append(out[at:at + k].reshape(s))
                at += k
            got.append(mine)
        return got

    def _gather(self, name: str, t: torch.Tensor) -> list:
        """``all_gather`` of one tensor a rank, in rank order, on this
        process's device."""
        import torch.distributed as tdist

        staged = self._staged(name)
        src = (t.cpu() if staged else t).contiguous().reshape(-1)
        out = [torch.empty_like(src) for _ in range(self.ndev)]
        tdist.all_gather(out, src, group=self.group)
        return [o.to(self.device).reshape(t.shape) for o in out]

    # -- the exchanges --------------------------------------------------------

    def ring(self, tails, heads, h: int) -> list:
        (tail,), (head,) = tails, heads
        n, r = self.ndev, self.rank
        prv, nxt = (r - 1) % n, (r + 1) % n
        mine_t, mine_h = _tail(tail, h), head[:h]
        # to the previous rank my head, to the next my tail: head first
        # where both go to one rank (two ranks, or one)
        send = [[t for t, to in ((mine_h, prv), (mine_t, nxt)) if q == to]
                for q in range(n)]
        shapes = [[tuple(x.shape) for x, frm in ((mine_h, nxt), (mine_t, prv))
                   if p == frm] for p in range(n)]
        got = self._exchange("ring", send, shapes, tail)
        right = got[nxt][0]                 # the next rank's head
        left = got[prv][-1]                 # the previous rank's tail
        return [(left, right)]

    def shift(self, chunks) -> list:
        (own,) = chunks
        n, r = self.ndev, self.rank
        send = [[own] if q == (r + 1) % n else [] for q in range(n)]
        shapes = [[tuple(own.shape)] if p == (r - 1) % n else []
                  for p in range(n)]
        return [self._exchange("shift", send, shapes, own)[(r - 1) % n][0]]

    def neighbors(self, chunks, offsets, spans=None) -> list:
        (own,) = chunks
        n, r = self.ndev, self.rank
        offs = [int(d) % n for d in offsets]

        def span(s, d):                 # what shard s reads of s + d's chunk
            return ((0, own.shape[0]) if spans is None
                    else spans[s][offs.index(d)])

        def rows(lo, hi):
            return (hi - lo,) + tuple(own.shape[1:])

        # rank q reads my chunk at d = r - q; I read rank p's at d = p - r
        send = [[own[slice(*span(q, (r - q) % n))]] if (r - q) % n in offs
                else [] for q in range(n)]
        shapes = [[rows(*span(r, (p - r) % n))] if (p - r) % n in offs
                  else [] for p in range(n)]
        got = self._exchange("neighbors", send, shapes, own)
        if spans is None:
            return [[got[(r + d) % n][0] for d in offs]]
        win = []
        for d in offs:
            lo, hi = span(r, d)
            w = own.new_zeros(own.shape)
            w[lo:hi] = got[(r + d) % n][0]
            win.append(w)
        return [win]

    def all_gather(self, chunks) -> list:
        (own,) = chunks
        return [self._gather("all_gather", own)]

    def psum(self, partials) -> torch.Tensor:
        (own,) = partials
        return sum_in_order(self._gather("psum", own))

    def reduce_scatter(self, parts, R: int) -> list:
        (own,) = parts
        n = self.ndev
        send = [[own[q * R:(q + 1) * R]] for q in range(n)]
        shapes = [[(R,) + tuple(own.shape[1:])] for _ in range(n)]
        got = self._exchange("reduce_scatter", send, shapes, own)
        return [sum_in_order([g[0] for g in got])]


def device_count() -> int:
    """The number of CUDA cards."""
    return torch.cuda.device_count()


def _initialized() -> bool:
    import torch.distributed as tdist

    return tdist.is_available() and tdist.is_initialized()


def make_mesh(ndev: int | None = None, *, device=None, group=None) -> Mesh:
    """A mesh of ``ndev`` shards.

    After :func:`init_multihost` (any initialized process group) and with
    ``ndev=None``: the :class:`ProcessMesh` of ``group`` (default: every
    process), this process's shard on ``device`` — by default
    ``cuda:{LOCAL_RANK}`` where there is a card, else the CPU.  Called by
    every process of the group.

    Otherwise the single controller's :class:`Mesh`: with ``device=None``
    (or ``"cuda"`` with no index), one shard on each of the first ``ndev``
    CUDA cards (default: all); more shards than cards raises.  With a
    device that names one card (``"cuda:0"``) or the CPU, all ``ndev``
    shards (default 1) on that device."""
    if ndev is None and _initialized():
        return _process_mesh(device, group)
    if group is not None:
        raise ValueError("group= needs an initialized process group and "
                         "ndev=None (init_multihost)")
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


def _process_mesh(device, group) -> ProcessMesh:
    import torch.distributed as tdist

    rank = tdist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the group")
    world = tdist.get_world_size(group)
    local_rank = int(os.environ.get("LOCAL_RANK", tdist.get_rank()))
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        if dev.index >= device_count():
            raise ValueError(f"rank {rank} asks for {dev}, this host has "
                             f"{device_count()} cards")
        torch.cuda.set_device(dev)
    if tdist.get_backend(group) == "nccl":
        if dev.type != "cuda":
            raise ValueError("an NCCL process group needs a CUDA device a "
                             "rank (on the CPU: init_multihost(backend="
                             "'gloo'))")
        _check_one_card_a_rank(dev, group)
    return ProcessMesh(devices=tuple(dev if s == rank else _META
                                     for s in range(world)),
                       rank=rank, group=group)


def _check_one_card_a_rank(dev: torch.device, group) -> None:
    """NCCL refuses two ranks on one card (at its first collective, where
    it may also hang): compare every rank's card over the Gloo side group
    first and raise on all of them alike."""
    import torch.distributed as tdist

    if "group" not in _SIDE:
        if group is not None:
            raise ValueError("an NCCL subgroup mesh needs the side group "
                             "that init_multihost makes")
        _SIDE["group"] = tdist.new_group(backend="gloo")
    props = torch.cuda.get_device_properties(dev)
    card = (socket.gethostname(), str(getattr(props, "uuid", dev.index)))
    cards = [None] * tdist.get_world_size()
    tdist.all_gather_object(cards, card, group=_SIDE["group"])
    members = (range(tdist.get_world_size()) if group is None
               else tdist.get_process_group_ranks(group))
    seen = {}
    for r in members:
        if cards[r] in seen:
            raise ValueError(
                f"NCCL needs one card a rank: ranks {seen[cards[r]]} and {r} "
                f"are both on card {cards[r][1]} of host {cards[r][0]} "
                f"({dev} here); pass backend='gloo' to init_multihost to "
                f"let ranks share a card")
        seen[cards[r]] = r


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   backend: str | None = None,
                   timeout: float | None = None) -> None:
    """Join this process to a ``torch.distributed`` process group (no-op if
    one exists, or with no arguments and nothing in the environment).

    ``coordinator_address`` ``"host:port"`` becomes ``tcp://host:port``
    with ``num_processes`` ranks, this one ``process_id``; with no address
    the group reads torchrun's ``env://`` variables (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  ``backend=None`` takes
    NCCL where there is a card (one card a rank: more local ranks than
    cards raises here, two ranks on one card at :func:`make_mesh`) and Gloo
    on the CPU; Gloo on a card, ranks sharing it, only when asked for.
    ``timeout`` (seconds) bounds every collective of the group.  After
    this, :func:`make_mesh` with no shard count spans the processes."""
    import torch.distributed as tdist

    if _initialized():
        return
    env = os.environ
    if coordinator_address is None:
        if not {"MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"} <= env.keys():
            return                  # a single process, nothing to join
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", -1)))
    rank = process_id if process_id is not None else int(env.get("RANK", -1))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        local_world = int(env.get("LOCAL_WORLD_SIZE", 1))
        if backend == "nccl" and local_world > device_count():
            raise ValueError(
                f"{local_world} ranks on this host, {device_count()} cards: "
                f"NCCL needs one card a rank (backend='gloo' lets ranks "
                f"share a card)")
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    _SIDE.clear()
    tdist.init_process_group(backend=backend, init_method=init_method,
                             world_size=world, rank=rank, **kw)
    if backend == "nccl":
        _SIDE["group"] = tdist.new_group(backend="gloo", **kw)
