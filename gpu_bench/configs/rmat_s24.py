"""PageRank's transition matrix of a Graph500 Kronecker (R-MAT) graph.

The edge list follows the Graph500 generator: ``edgefactor * 2**scale``
edges, each bit of the source and destination drawn from the initiator
``[A, B, C, D]``, then Graph500's random relabelling of the vertices.
Both are drawn from ``instance_seed``, not from ``--seed``: the labels
set where each gather lands, and runs on relabelled graphs spread by
about 1% where runs of one graph spread by 0.1%, so every run multiplies
the same graph.  As Graph500's Kernel 1 and GAP's ``kron`` build it, the
graph is undirected: each edge stands in both directions, duplicates
merge and self loops go.  ``A[u, v] = 1 / deg(v)`` for each edge, so the
pattern is symmetric and every nonempty column sums to 1."""

from __future__ import annotations

import hashlib

import torch

from gpu_bench.reference.products import HostCSR


def _generator(device, *parts) -> torch.Generator:
    digest = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
    return torch.Generator(device).manual_seed(
        int.from_bytes(digest[:8], "little") >> 1)


def build(cfg: dict, seed: int, device) -> tuple[HostCSR, dict]:
    """The host CSR (float64 values), drawn on ``device``."""
    scale = cfg["scale"]
    n = 1 << scale
    m = cfg["edgefactor"] * n
    a, b, c, _ = cfg["initiator"]
    g = _generator(device, "rmat", cfg["instance_seed"])
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    for bit in range(scale):
        down = torch.rand(m, generator=g, device=device) > a + b
        right = torch.rand(m, generator=g, device=device) > torch.where(
            down, c / (1 - a - b), a / (a + b))
        src |= down.long() << bit
        dst |= right.long() << bit
        del down, right
    label = torch.randperm(
        n, generator=_generator(device, "relabel", cfg["instance_seed"]),
        device=device)
    u, v = label[src], label[dst]
    del src, dst, label
    loop = u == v
    u, v = u[~loop], v[~loop]
    key = torch.unique(torch.cat([u * n + v, v * n + u]))  # sorted: CSR
    del u, v, loop
    rows, cols = key // n, key % n
    del key
    deg = torch.bincount(rows, minlength=n)
    data = 1.0 / deg[cols].double()
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(deg, 0)
    return (HostCSR(indptr.cpu().numpy(), cols.int().cpu().numpy(),
                    data.cpu().numpy(), (n, n)), {})


def bytes_moved(cfg: dict, A: HostCSR, nrhs: int) -> int:
    """The CSR's float32 values and int32 column indices once, its row
    pointers once, X read once and Y written once."""
    n = A.shape[0]
    return 8 * A.nnz + 4 * (n + 1) + 8 * n * nrhs
