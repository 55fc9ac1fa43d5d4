"""Save and load converted and packed sparse matrices (one ``.npz`` each).

Counterpart of ``tpu_spmv/io/checkpoint.py`` and its design: the array
leaves of a format or a pack go into one ``.npz``, and a JSON spec holds
each dataclass's class name, its static fields and the nesting (a
:class:`~..kernels.ell_packed.PackedELL` holds its side COO, a
:class:`~..kernels.permute.PermutationPlan` its optional two-pass tables).
Every port format and pack round-trips: COO, CSR, CSC, ELL, DIA, BSR, BDIA,
``SDIA`` and ``PSDIA`` (bf16 data included), ``GPCSR``, ``PackedELL`` and
``PermutationPlan``.  Host planning and packing cost seconds at the main
path's sizes, so the CLI's ``--cache DIR`` pays them once.

- Each tensor is stored with its torch type; a bfloat16 tensor as its
  ``uint16`` words (numpy has no bf16), so a reloaded pack holds the same
  bits.
- State that a kernel wrapper derives at first use (K2's walk plans, K3's
  window plans, the offsets on the card) is cached by the pack's static
  fields, not stored in the pack, so a reloaded pack rebuilds the same
  plans and its product is bitwise the original's.
- A field that the class no longer has raises ``ValueError("stale
  checkpoint ...")``, which the CLI takes as "re-pack".
- The files are the port's own: the reference's npz packs (with their Clos
  planes and TPU tile layouts) are not read.  Arrays are stored
  uncompressed, so a reload costs about a disk read.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

__all__ = ["save_matrix", "load_matrix", "save_vector", "load_vector"]


def _classes() -> dict:
    """Name -> class of every dataclass a checkpoint may hold (imported
    here: the kernels' modules import the formats)."""
    from .. import formats
    from ..kernels.dia_stream import PSDIA, SDIA
    from ..kernels.ell_packed import PackedELL
    from ..kernels.gpr import GPCSR
    from ..kernels.permute import PermutationPlan

    out = {cls.__name__: cls for cls in formats.FORMATS.values()}
    for cls in (SDIA, PSDIA, GPCSR, PackedELL, PermutationPlan):
        out[cls.__name__] = cls
    return out


def _is_leaf_tree(v) -> bool:
    """Whether ``v`` holds tensors or dataclasses (stored in the npz and
    the spec's fields) rather than static metadata."""
    if isinstance(v, torch.Tensor) or v is None:
        return True
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return True
    return isinstance(v, (tuple, list)) and any(_is_leaf_tree(o) for o in v
                                                if o is not None)


def _serialize(obj, arrays: dict, classes: dict):
    """Object -> JSON-able spec; tensors are added to ``arrays``."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        key = f"a{len(arrays)}"
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arrays[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[key] = t.numpy()
        return {"__array__": key, "dtype": str(t.dtype).split(".")[-1]}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if classes.get(name) is not type(obj):
            raise TypeError(f"not a serializable tpu_spmv_torch format: "
                            f"{name}")
        static, fields = {}, {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if _is_leaf_tree(v):
                fields[f.name] = _serialize(v, arrays, classes)
            else:
                static[f.name] = v
        return {"__class__": name, "static": static, "fields": fields}
    if isinstance(obj, (tuple, list)):
        return {"__tuple__": [_serialize(o, arrays, classes) for o in obj]}
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _deep_tuple(v):
    """JSON turns tuples into lists; restore them, recursively."""
    if isinstance(v, list):
        return tuple(_deep_tuple(x) for x in v)
    return v


def _deserialize(spec, z, classes: dict, device):
    if spec is None:
        return None
    if "__array__" in spec:
        arr = np.ascontiguousarray(z[spec["__array__"]])
        dtype = getattr(torch, spec["dtype"])
        if dtype == torch.bfloat16:
            return torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)
    if "__tuple__" in spec:
        return tuple(_deserialize(s, z, classes, device)
                     for s in spec["__tuple__"])
    name = spec["__class__"]
    if name not in classes:
        raise ValueError(f"stale checkpoint: unknown class {name!r} — "
                         f"delete and re-pack")
    cls = classes[name]
    kwargs = {k: _deep_tuple(v) for k, v in spec["static"].items()}
    for field, sub in spec["fields"].items():
        kwargs[field] = _deserialize(sub, z, classes, device)
    # a checkpoint written by another revision may carry fields the class
    # no longer has: they cannot be applied, so the checkpoint is stale
    stale = set(kwargs) - {f.name for f in dataclasses.fields(cls)}
    if stale:
        raise ValueError(f"stale checkpoint: {name} no longer has "
                         f"field(s) {sorted(stale)} — delete and re-pack")
    return cls(**kwargs)


def save_matrix(path, mat, *, extra: dict | None = None) -> None:
    """Write any port format or pack to one ``.npz`` at ``path``.

    ``extra`` attaches a small JSON-able dict (the CLI stores the planner's
    strategy there), returned by ``load_matrix(path, with_extra=True)``."""
    arrays: dict = {}
    spec = _serialize(mat, arrays, _classes())
    meta = json.dumps({"spec": spec, "extra": extra or {}}).encode()
    np.savez(path, __meta__=np.frombuffer(meta, dtype=np.uint8), **arrays)


def load_matrix(path, *, with_extra: bool = False, device="cuda"):
    """Load a matrix written by :func:`save_matrix` with its tensors on
    ``device`` (default: the card); with ``with_extra``, ``(matrix,
    extra)``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        mat = _deserialize(meta["spec"], z, _classes(), torch.device(device))
    if with_extra:
        return mat, meta.get("extra", {})
    return mat


def save_vector(path, vec) -> None:
    """Write one tensor (its type kept; bf16 as its words) or host array
    to ``path``."""
    if not isinstance(vec, torch.Tensor):
        vec = torch.from_numpy(np.ascontiguousarray(vec))
    arrays: dict = {}
    spec = _serialize(vec, arrays, {})
    np.savez(path, __meta__=np.frombuffer(json.dumps(spec).encode(),
                                          dtype=np.uint8), **arrays)


def load_vector(path, *, device="cuda") -> torch.Tensor:
    """The tensor written by :func:`save_vector`, on ``device``."""
    with np.load(path) as z:
        spec = json.loads(bytes(z["__meta__"].tobytes()).decode())
        return _deserialize(spec, z, {}, torch.device(device))
