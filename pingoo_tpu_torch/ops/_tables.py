"""Table dataclasses holding tensors, and the port's uint32 convention.

The JAX package keeps its bit-parallel words as uint32 arrays. PyTorch
has no uint32 arithmetic on every op and device, so the port holds them
two ways, chosen per field:

  * `U32`: the same 32 bits in an int32 tensor. The CUDA kernels read
    these buffers as `uint32_t*`; the plain versions widen them to
    int64 (`widen`) before shifting or adding, and narrow back.
  * `U32_WIDE`: the value in an int64 tensor (IP words, sorted keys,
    bitsets) — code with no kernel that needs unsigned order.

Every table is a frozen dataclass whose array fields are tensors and
whose other fields are static metadata. `from_numpy` builds one from
numpy arrays (made by the table-building functions, or taken from the
JAX package's plan), `numpy_arrays` gives them back in the reference's
dtypes, and `to` moves every tensor to a device.
"""

from __future__ import annotations

import dataclasses
import weakref
from dataclasses import field

import numpy as np
import torch

U32 = "u32"
U32_WIDE = "u32_wide"
MASK32 = 0xFFFFFFFF


def arr(kind: str | None = None, optional: bool = False):
    """Declare a tensor field of a table dataclass (`kind` U32 or
    U32_WIDE for uint32 data; None keeps the numpy dtype)."""
    meta = {"array": kind}
    if optional:
        return field(default=None, metadata=meta)
    return field(metadata=meta)


def to_tensor(a, kind: str | None = None) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if kind == U32:
        return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy())
    if kind == U32_WIDE:
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor, kind: str | None = None) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if kind == U32:
        return a.view(np.uint32)
    if kind == U32_WIDE:
        return a.astype(np.uint32)
    return a


_DERIVED: dict[tuple[int, str], tuple[weakref.ref, object]] = {}


def derived(source: torch.Tensor, key: str, build):
    """`build()`, made once per table tensor `source` and kept while
    `source` lives: a kernel's own layout of a table, which is no field
    of the table dataclass."""
    k = (id(source), key)
    hit = _DERIVED.get(k)
    if hit is not None and hit[0]() is source:
        return hit[1]
    value = build()
    _DERIVED[k] = (weakref.ref(source), value)
    weakref.finalize(source, _DERIVED.pop, k, None)
    return value


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32-held uint32 bits -> their int64 value in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bits in int32."""
    return torch.where(t >= (1 << 31), t - (1 << 32), t).to(torch.int32)


class TensorTable:
    """Mixin for frozen dataclasses of tensors plus static metadata.
    Nested tables (a V4PrefixBuckets' aux CidrTable) are tensor fields
    too: they move and flatten with their parent."""

    @classmethod
    def array_fields(cls) -> list[dataclasses.Field]:
        return [f for f in dataclasses.fields(cls) if "array" in f.metadata]

    @classmethod
    def from_numpy(cls, **values):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            v = values[f.name]
            if "array" in f.metadata and v is not None \
                    and not isinstance(v, (TensorTable, torch.Tensor)):
                v = to_tensor(v, f.metadata["array"])
            kw[f.name] = v
        return cls(**kw)

    def to(self, device) -> "TensorTable":
        kw = {}
        for f in self.array_fields():
            v = getattr(self, f.name)
            if v is not None:
                kw[f.name] = v.to(device)
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        for f in self.array_fields():
            v = getattr(self, f.name)
            if v is not None:
                return v.device
        return torch.device("cpu")

    def numpy_arrays(self, prefix: str = "") -> dict[str, np.ndarray]:
        """Every array field in the reference's dtype, nested tables
        flattened as `parent.child`."""
        out: dict[str, np.ndarray] = {}
        for f in self.array_fields():
            v = getattr(self, f.name)
            if v is None:
                continue
            if isinstance(v, TensorTable):
                out.update(v.numpy_arrays(f"{prefix}{f.name}."))
            else:
                out[f"{prefix}{f.name}"] = to_numpy(v, f.metadata["array"])
        return out

    def meta(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if "array" not in f.metadata}
