"""The probe kernels and the probe path: bandwidth, launch cost, the
width-8 lane sum and in-tile gathers.

Counterpart of the Pallas probes outside ``tpu_spmv/``: K9, the bandwidth
probe of ``bench.py`` (``_pallas_copy``), and the ``tools/`` probes T1
(``profile_gpr.py``'s minimal launch), T2 (``profile_reduce.py``), T3
(``profile_sublane.py``) and T4 (``prof_tgtg_mxu.py``).  Each kernel lives
in ``csrc/probes.cu``:

- :func:`copy_scale` (K9): ``y = x * 0.9999999`` in float32;
  :func:`copy_bandwidths` times it and torch's ``copy_`` over 256 MiB, and
  the roofline's peak is the higher of the two
  (:func:`..bench.roofline.measured_copy_gbps`);
- :func:`launch_probe` (T1): one ``[128, 128]`` float32 copy, timed once
  and four in a row: the fixed cost of a launch;
- :func:`segsum8` (T2): ``[..., 128] -> [..., 16]``, each output the sum
  of 8 neighbouring lanes added left to right;
- :func:`tile_permute` (T3, T4): a :class:`TileProgram` of gathers along
  axis 0 (``S``), axis 1 (``G``) and transposes (``T``) on ``[128, 128]``
  tiles, loaded directly or through a row index, with an optional product
  and width-8 sum (:func:`tile_variants` builds the probes' variants).

:func:`run_probes` is the probe path: it times every kernel at the probes'
shapes on the card.  On a CUDA tensor the wrappers launch the kernels and
count the launch in :data:`LAUNCHES`; on a CPU tensor they run the plain
versions (``*_ref``).  Every plain version fixes the kernel's order of
operations, so kernel and plain version agree bitwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import re
import statistics

import numpy as np
import torch

from ..kernels import _build

__all__ = ["Q", "SCALE", "LAUNCHES", "copy_scale", "copy_scale_ref",
           "launch_probe", "launch_probe_ref", "segsum8", "segsum8_ref",
           "TileProgram", "plan_tile_program", "tile_permute",
           "tile_permute_ref", "t2_operand", "t3_operands", "t4_operands",
           "tile_variants", "copy_bandwidths", "run_probes"]

#: the tile edge of the probes
Q = 128
#: K9's factor; torch multiplies a float32 tensor by it in float32
SCALE = 0.9999999
#: kernel launches by the wrappers on CUDA tensors (plain-version calls on
#: CPU tensors are not counted)
LAUNCHES = {"copy_scale": 0, "launch_probe": 0, "segsum8": 0,
            "tile_permute": 0}
_OPS = {"S": 1, "G": 2, "T": 3}
_TILE = (Q, Q)
#: T1's, T2's and T3/T4's launches, resolved once (the library loads at
#: first call)
_LAUNCH_PROBE = _build.launcher("launch_probe")
_SEGSUM8 = _build.launcher("segsum8")
_TILE_PERMUTE = _build.launcher("tile_permute")


def _on_cpu(name: str, x: torch.Tensor) -> bool:
    """Raise unless ``x`` is float32; True on the CPU (the plain version
    runs), False elsewhere (the launch raises off a CUDA device)."""
    if x.dtype is not torch.float32:
        raise TypeError(f"{name}: needs float32, got {x.dtype}")
    return x.is_cpu


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous at a 16-byte address (the kernels load float4)."""
    x = x.contiguous()
    return x if not x.data_ptr() & 15 else x.clone()


def _call(name: str, x: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on ``x``'s card and count it."""
    _build.launcher(name)(x, *args)
    LAUNCHES[name] += 1


# -- K9: copy_scale ---------------------------------------------------------

def copy_scale_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: ``x * 0.9999999`` (float32 multiply)."""
    return x * SCALE


def copy_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 0.9999999`` in float32.  CUDA tensor: launches ``copy_scale``
    (``csrc/probes.cu``); CPU tensor: :func:`copy_scale_ref`."""
    if _on_cpu("copy_scale", x):
        return copy_scale_ref(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    _call("copy_scale", x, x.data_ptr(), out.data_ptr(), x.numel())
    return out


# -- T1: launch_probe -------------------------------------------------------

def launch_probe_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of T1: a copy of the tile."""
    return x.clone()


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """A copy of one ``[128, 128]`` float32 tile.  CUDA tensor: launches
    ``launch_probe``; CPU tensor: :func:`launch_probe_ref`."""
    if x.shape != _TILE:
        raise ValueError(f"launch_probe: needs a [{Q}, {Q}] tile, got "
                         f"{tuple(x.shape)}")
    if x.dtype is not torch.float32:
        raise TypeError(f"launch_probe: needs float32, got {x.dtype}")
    if x.is_cpu:
        return launch_probe_ref(x)
    if x.data_ptr() & 15 or not x.is_contiguous():
        x = _aligned(x)
    out = torch.empty_like(x)
    _LAUNCH_PROBE(x, x.data_ptr(), out.data_ptr())
    LAUNCHES["launch_probe"] += 1
    return out


# -- T2: segsum8 ------------------------------------------------------------

def segsum8_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of T2: ``[..., 128] -> [..., 16]``, lanes ``8j ..
    8j + 7`` added left to right (the kernel's order)."""
    xs = x.reshape(*x.shape[:-1], Q // 8, 8)
    s = xs[..., 0]
    for k in range(1, 8):
        s = s + xs[..., k]
    return s.contiguous()


def segsum8(x: torch.Tensor) -> torch.Tensor:
    """The width-8 segmented lane sum ``[..., 128] -> [..., 16]``.  CUDA
    tensor: launches ``segsum8``; CPU tensor: :func:`segsum8_ref`."""
    shape = x.shape
    if not shape or shape[-1] != Q:
        raise ValueError(f"segsum8: the last axis must have {Q} lanes, got "
                         f"{tuple(shape)}")
    if x.dtype is not torch.float32:
        raise TypeError(f"segsum8: needs float32, got {x.dtype}")
    if x.is_cpu:
        return segsum8_ref(x)
    if x.data_ptr() & 15 or not x.is_contiguous():
        x = _aligned(x)
    out = x.new_empty(shape[:-1] + (Q // 8,))
    _SEGSUM8(x, x.data_ptr(), out.data_ptr(), x.numel() >> 3)
    LAUNCHES["segsum8"] += 1
    return out


# -- T3 / T4: tile_permute --------------------------------------------------

class _TileArgs(ctypes.Structure):
    """A program's launch arguments as the kernel's launcher reads them
    (``TileArgs`` in ``csrc/probes.cu``)."""

    _fields_ = [("rowsrc", ctypes.c_void_p), ("lidx", ctypes.c_void_p),
                ("nload", ctypes.c_int), ("idx", ctypes.c_void_p),
                ("idx_tiles", ctypes.c_int), ("steps", ctypes.c_uint32),
                ("nsteps", ctypes.c_int), ("staged", ctypes.c_uint32),
                ("mode", ctypes.c_int)]


#: what a block of the kernel can reach of its tile (``TileMode`` in
#: ``csrc/probes.cu``): all of it, a slab of 32 rows (a G-only program),
#: a slab of 32 columns (an S-only program)
FULL_TILE, ROW_SLABS, COL_SLABS = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TileProgram:
    """Steps on ``[128, 128]`` tiles and their index tiles.

    ``steps`` is a tuple of ``(op, slot)``: ``op`` ``"S"`` (gather along
    axis 0), ``"G"`` (along axis 1) or ``"T"`` (transpose), ``slot`` the
    index tile ``idx[slot]`` the gather reads.  ``idx`` is ``[K, Ti, 128,
    128]`` int8 (every index lies in ``[0, 128)``, so one byte holds it
    whatever the input's type; ``Ti`` is 1 when every tile shares its
    index tiles).  With ``rowsrc`` the tiles are loaded row by row: row
    ``r < nload`` of tile ``t`` is ``src[rowsrc[t * nload + r]]``,
    lane-gathered by ``lidx[t * nload + r]`` (int8) when given; the other
    rows are zero.

    The kernel's launch arguments are made once, with the program:
    ``code`` (the steps, 4 bits each), ``mode`` (what a block can reach:
    :data:`COL_SLABS` for an S-only program without lane gathers, whose
    output column ``j`` comes from column ``j``; :data:`ROW_SLABS` for a
    G-only one; :data:`FULL_TILE` else), ``staged`` (a bit per index slot
    that a gather reads: the kernel stages those in shared memory), ``args``
    (those and the program's tensors as the launch takes them) and
    ``device_index`` (the tensors' card, -1 on the CPU)."""

    steps: tuple[tuple[str, int], ...]
    idx: torch.Tensor
    rowsrc: torch.Tensor | None = None     # [T * nload] int32
    lidx: torch.Tensor | None = None       # [T * nload, 128] int8
    nload: int = Q
    src_rows: int = 0                      # rows of src that rowsrc reads
    code: int = dataclasses.field(init=False)
    mode: int = dataclasses.field(init=False)
    staged: int = dataclasses.field(init=False)
    idx_tiles: int = dataclasses.field(init=False)
    ntiles: int | None = dataclasses.field(init=False)
    device_index: int = dataclasses.field(init=False)
    args: tuple = dataclasses.field(init=False, repr=False)
    _launch: _TileArgs = dataclasses.field(init=False, repr=False,
                                           compare=False)
    _launch_at: int = dataclasses.field(init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        ops = {op for op, _ in self.steps}
        derived = {
            "code": sum((_OPS[op] | slot << 2) << (4 * s)
                        for s, (op, slot) in enumerate(self.steps)),
            # a lane gather can reach any column of a loaded row
            "mode": (COL_SLABS if ops == {"S"} and self.lidx is None else
                     ROW_SLABS if ops == {"G"} else FULL_TILE),
            "staged": sum({1 << k for op, k in self.steps if op != "T"}),
            "idx_tiles": int(self.idx.shape[1]),
            # tiles of a row-loaded program (None: one per tile of src)
            "ntiles": (None if self.rowsrc is None
                       else int(self.rowsrc.shape[0]) // self.nload),
            "device_index": self.idx.get_device()}
        for name, value in derived.items():
            object.__setattr__(self, name, value)

        def ptr(t):
            return t.data_ptr() if t is not None else None

        args = (ptr(self.rowsrc), ptr(self.lidx), self.nload,
                self.idx.data_ptr(), self.idx_tiles, self.code,
                len(self.steps), self.staged, self.mode)
        object.__setattr__(self, "args", args)
        # the launch reads them through one pointer (the structure lives
        # as long as the program, which holds the tensors)
        object.__setattr__(self, "_launch", _TileArgs(*args))
        object.__setattr__(self, "_launch_at",
                           ctypes.addressof(self._launch))


def _parse_steps(steps: str) -> tuple[tuple[str, int], ...]:
    parts = re.findall(r"([SGT])([0-3]?)", steps)
    if "".join(a + b for a, b in parts) != steps:
        raise ValueError(f"bad step string {steps!r} (S, G or T, a gather "
                         f"optionally followed by its index slot 0-3)")
    if not 1 <= len(parts) <= 8:
        raise ValueError(f"a program has 1 to 8 steps, got {len(parts)}")
    return tuple((op, int(slot or 0)) for op, slot in parts)


def _index_array(a, name: str) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype not in (np.int8, np.int32):
        raise TypeError(f"{name} must be int8 or int32, got {a.dtype}")
    if a.size and (a.min() < 0 or a.max() >= Q):
        raise ValueError(f"{name} entries must lie in [0, {Q})")
    return a


def plan_tile_program(steps: str, idx, *, rowsrc=None, lidx=None,
                      nload: int = Q, device="cuda") -> TileProgram:
    """A :class:`TileProgram` from host arrays, checked on the host.

    ``steps`` is a string such as ``"S"``, ``"GSG"`` or ``"TG0TG1"`` (a
    digit after ``S``/``G`` names the index slot, default 0); ``idx`` is
    ``[128, 128]``, ``[Ti, 128, 128]`` or ``[K, Ti, 128, 128]``, int8 or
    int32 (``lidx`` of the same type); both are stored as int8."""
    parsed = _parse_steps(steps)
    ix = _index_array(idx, "idx")
    if ix.shape[-2:] != (Q, Q) or not 2 <= ix.ndim <= 4:
        raise ValueError(f"idx must be [[K,] [Ti,] {Q}, {Q}], got {ix.shape}")
    ix = ix.reshape((1,) * (4 - ix.ndim) + ix.shape)
    if max((s for op, s in parsed if op != "T"), default=0) >= ix.shape[0]:
        raise ValueError(f"a step names an index slot past idx's "
                         f"{ix.shape[0]}")
    rs = ls = None
    src_rows = 0
    if rowsrc is not None:
        rows = np.asarray(rowsrc)
        if not 1 <= nload <= Q or rows.ndim != 1 or rows.size % nload:
            raise ValueError(f"rowsrc needs whole tiles of nload = {nload} "
                             f"(<= {Q}) rows, got {rows.shape}")
        if rows.size and rows.min() < 0:
            raise ValueError("rowsrc entries must be >= 0")
        src_rows = int(rows.max()) + 1 if rows.size else 0
        rs = torch.from_numpy(rows.astype(np.int32)).to(device)
        if lidx is not None:
            la = _index_array(lidx, "lidx")
            if la.dtype != ix.dtype or la.shape != (rows.size, Q):
                raise ValueError(f"lidx must be [{rows.size}, {Q}] of "
                                 f"idx's dtype {ix.dtype}")
            ls = torch.from_numpy(la.astype(np.int8)).to(device)
    elif lidx is not None:
        raise ValueError("lidx needs rowsrc")
    return TileProgram(steps=parsed,
                       idx=torch.from_numpy(ix.astype(np.int8)).to(device),
                       rowsrc=rs, lidx=ls, nload=nload, src_rows=src_rows)


def _tiles(prog: TileProgram, src: torch.Tensor) -> int:
    """The tile count, after checking ``src`` against the program."""
    if prog.rowsrc is None:
        if src.dim() < 2 or src.size(-1) != Q or src.size(-2) != Q:
            raise ValueError(f"tile_permute: src must be [..., {Q}, {Q}], "
                             f"got {tuple(src.shape)}")
        T = src.numel() >> 14
    else:
        if src.dim() != 2 or src.size(1) != Q or src.size(0) < prog.src_rows:
            raise ValueError(f"tile_permute: src must be [>= "
                             f"{prog.src_rows}, {Q}], got {tuple(src.shape)}")
        T = prog.ntiles
    if prog.idx_tiles != 1 and prog.idx_tiles != T:
        raise ValueError(f"tile_permute: idx has {prog.idx_tiles} tiles "
                         f"per slot, the program {T}")
    return T


def _out_shape(prog: TileProgram, src: torch.Tensor, T: int, psum8: bool):
    lead = tuple(src.shape[:-2]) if prog.rowsrc is None else (T,)
    return lead + (Q, Q // 8 if psum8 else Q)


def tile_permute_ref(prog: TileProgram, src: torch.Tensor,
                     mul: torch.Tensor | None = None,
                     psum8: bool = False) -> torch.Tensor:
    """Plain version of T3/T4: ``take_along_dim`` and ``transpose`` per
    step, then ``* mul`` and :func:`segsum8_ref`."""
    T = _tiles(prog, src)
    if prog.rowsrc is None:
        z = src.reshape(T, Q, Q)
    else:
        rows = src[prog.rowsrc.long()]
        if prog.lidx is not None:
            rows = torch.take_along_dim(rows, prog.lidx.long(), dim=1)
        z = torch.cat([rows.reshape(T, prog.nload, Q),
                       rows.new_zeros(T, Q - prog.nload, Q)], dim=1)
    for op, slot in prog.steps:
        if op == "T":
            z = z.transpose(1, 2)
        else:
            ix = prog.idx[slot].long().expand(T, Q, Q)
            z = torch.take_along_dim(z, ix, dim=1 if op == "S" else 2)
    if mul is not None:
        z = z * mul.reshape(T, Q, Q)
    out = segsum8_ref(z) if psum8 else z.contiguous()
    return out.reshape(_out_shape(prog, src, T, psum8))


def tile_permute(prog: TileProgram, src: torch.Tensor,
                 mul: torch.Tensor | None = None,
                 psum8: bool = False) -> torch.Tensor:
    """Run ``prog`` on every tile of ``src`` in one launch; ``mul`` (the
    output's tiles) multiplies the result and ``psum8`` sums it 8 lanes at
    a time (``[..., 128, 16]``).

    CUDA tensor: launches ``tile_permute`` with the program's launch
    arguments (:class:`TileProgram`); CPU tensor: :func:`tile_permute_ref`."""
    if src.dtype is not torch.float32:
        raise TypeError(f"tile_permute: needs float32, got {src.dtype}")
    T = _tiles(prog, src)
    if mul is not None and (mul.dtype is not torch.float32
                            or mul.numel() != T * Q * Q
                            or mul.device != src.device):
        raise ValueError(f"tile_permute: mul must be {T} float32 tiles on "
                         f"{src.device}")
    if src.get_device() != prog.device_index:
        raise ValueError(f"tile_permute: program on {prog.idx.device}, src "
                         f"on {src.device}")
    if src.is_cpu:
        return tile_permute_ref(prog, src, mul, psum8)
    # the kernel loads 16 bytes at a time
    p = src.data_ptr()
    if p & 15 or not src.is_contiguous():
        src = _aligned(src)
        p = src.data_ptr()
    m = None
    if mul is not None:
        m = mul.data_ptr()
        if m & 15 or not mul.is_contiguous():
            mul = _aligned(mul)
            m = mul.data_ptr()
    if prog.rowsrc is None and not psum8:
        out = torch.empty_like(src)
    else:
        out = torch.empty(_out_shape(prog, src, T, psum8),
                          dtype=torch.float32, device=src.device)
    _TILE_PERMUTE(src, p, prog._launch_at, m, psum8, out.data_ptr(), T)
    LAUNCHES["tile_permute"] += 1
    return out


# -- the probes' operands ---------------------------------------------------

def t2_operand(seed: int = 0) -> np.ndarray:
    """T2's ``[16, 512, 128]`` float32 values (``profile_reduce.py``)."""
    return np.random.default_rng(seed).random((16, 512, Q)).astype(
        np.float32)


def t3_operands(seed: int = 0, T: int = 91) -> dict:
    """T3's operands, drawn in ``profile_sublane.py``'s order: ``z [T,
    128, 128]`` float32, ``rowsrc [T*128]`` int32, ``g [T, 128, 128]`` int8
    (a permutation per row), ``x2d [800, 128]``, ``gseg [T*88]`` int32 and
    ``glidx [T*88, 128]`` int8."""
    rng = np.random.default_rng(seed)
    z = rng.random((T, Q, Q)).astype(np.float32)
    rowsrc = rng.permutation(T * Q).astype(np.int32)
    g = np.stack([np.stack([rng.permutation(Q) for _ in range(Q)])
                  for _ in range(T)]).astype(np.int8)
    x2d = rng.random((800, Q)).astype(np.float32)
    gseg = rng.integers(0, 800, T * 88).astype(np.int32)
    glidx = rng.integers(0, Q, (T * 88, Q)).astype(np.int8)
    return {"z": z, "rowsrc": rowsrc, "g": g, "x2d": x2d, "gseg": gseg,
            "glidx": glidx}


def t4_operands(seed: int = 0, T: int = 100, QB: int = 5) -> dict:
    """T4's operands, drawn in ``prof_tgtg_mxu.py``'s order: shared int32
    index tiles ``g2``, ``g3`` and ``Z [T, QB, 128, 128]`` float32."""
    rng = np.random.default_rng(seed)
    g2 = rng.integers(0, Q, (Q, Q)).astype(np.int32)
    g3 = rng.integers(0, Q, (Q, Q)).astype(np.int32)
    Z = rng.random((T, QB, Q, Q)).astype(np.float32)
    return {"g2": g2, "g3": g3, "Z": Z}


def tile_variants(t3: dict, t4: dict, device) -> dict:
    """The probes' ``tile_permute`` variants: name -> ``(program, src, mul,
    psum8)``, the tensors on ``device``."""
    def dev(a):
        return torch.from_numpy(a).to(device)

    T = t3["z"].shape[0]
    z, g = dev(t3["z"]), t3["g"]
    return {
        # profile_sublane.py k_sub1 and k_gsg: per-tile index tiles
        "S": (plan_tile_program("S", g, device=device), z, None, False),
        "G-S-G": (plan_tile_program("GSG", g, device=device), z, None,
                  False),
        # k_exch_sg and k_exch_sg_red: rows through rowsrc from z2d
        "exchange + S-G": (plan_tile_program(
            "SG", g, rowsrc=t3["rowsrc"], device=device),
            z.reshape(T * Q, Q), None, False),
        "exchange + S-G + psum8": (plan_tile_program(
            "SG", g, rowsrc=t3["rowsrc"], device=device),
            z.reshape(T * Q, Q), z, True),
        # k_s1v2: 88 rows from x2d through gseg, lane-gathered by glidx
        "s1v2": (plan_tile_program(
            "SG", g, rowsrc=t3["gseg"], lidx=t3["glidx"], nload=88,
            device=device), dev(t3["x2d"]), None, False),
        # prof_tgtg_mxu.py: transpose, gather g2, transpose, gather g3
        "TGTG": (plan_tile_program("TG0TG1", np.stack([t4["g2"], t4["g3"]])[
            :, None], device=device), dev(t4["Z"]), None, False),
    }


# -- the probe path ---------------------------------------------------------

def _event_ms(fn, iters: int, repeats: int = 10) -> float:
    """Median ms per call of ``fn()`` over ``repeats`` runs of ``iters``
    calls, CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """ms per call of ``fn()`` replayed from one CUDA graph of ``calls``
    calls: the device's time with no host work between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _event_ms(graph.replay, 1, replays) / calls


def _require_card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probes measure a CUDA device, not {device}")
    return device


@functools.cache
def copy_bandwidths(device) -> dict:
    """GB/s of the two bandwidth probes over 2^26 float32 values (256 MiB,
    far past the 50 MB L2), ``2·bytes / t``: ``"copy_scale"`` (K9's kernel)
    and ``"copy_"`` (torch's device-to-device copy), each the median of 10
    runs of 20 calls after warm-up."""
    device = _require_card(device)
    src = torch.rand(1 << 26, device=device)
    dst = torch.empty_like(src)
    nbytes = 2 * src.numel() * src.element_size()
    out = {}
    for name, fn in (("copy_scale", lambda: copy_scale(src)),
                     ("copy_", lambda: dst.copy_(src))):
        out[name] = nbytes / (_event_ms(fn, 20) * 1e-3) / 1e9
    return out


def run_probes(device="cuda", *, seed: int = 0) -> dict:
    """The probe path: every probe kernel at its probe's shapes on the
    card, ms per call (CUDA events, median).  Keys: ``copy_scale`` (and
    its GB/s and torch ``copy_``'s), ``launch_probe`` (one launch) and
    ``launch_probe_x4`` (four in a row), ``segsum8``, and
    ``tile_permute:<variant>`` for each of :func:`tile_variants`; each
    also as ``<key>:graph``, replayed from a CUDA graph, so the wrapper's
    host work drops out and the device's own time is left, and as
    ``<key>:launches``, the kernel launches its timing made (the graph's
    capture counts; its replays launch no wrapper)."""
    device = _require_card(device)
    out = {}
    bw = copy_bandwidths(device)
    out["copy_scale_gbps"], out["copy__gbps"] = bw["copy_scale"], bw["copy_"]
    x = torch.rand(1 << 26, device=device)
    tile = torch.rand(Q, Q, device=device)
    v = torch.from_numpy(t2_operand(seed)).to(device)
    timed = {"copy_scale": (lambda: copy_scale(x), 20),
             "launch_probe": (lambda: launch_probe(tile), 400),
             "launch_probe_x4": (lambda: launch_probe(launch_probe(
                 launch_probe(launch_probe(tile)))), 400),
             "segsum8": (lambda: segsum8(v), 300)}
    for name, (prog, src, mul, psum8) in tile_variants(
            t3_operands(seed), t4_operands(seed), device).items():
        timed[f"tile_permute:{name}"] = (
            functools.partial(tile_permute, prog, src, mul, psum8), 100)
    for key, (fn, iters) in timed.items():
        before = dict(LAUNCHES)
        out[key] = _event_ms(fn, iters)
        out[f"{key}:graph"] = _graph_ms(fn)
        out[f"{key}:launches"] = sum(LAUNCHES[k] - before[k]
                                     for k in LAUNCHES)
    return out
