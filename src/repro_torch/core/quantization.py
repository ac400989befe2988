"""Reduced-precision value representations (paper §III-B / §IV-C, Table II).

Host-side copy of ``repro.core.quantization`` for the PyTorch port.  The
formats, their stream codes and the fixed-point rules are identical; the one
difference is how bf16 lives on the host.  numpy has no bfloat16 dtype, so a
bf16 stream is kept as its raw ``uint16`` bit patterns.  Fusing views the
same bytes as int32 words, so the fused word stream is byte-for-byte the
reference's.  Rounding to bf16 goes through ``torch`` (round to nearest
even, as in jnp).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ValueFormat:
    """Describes how matrix values are stored in the BS-CSR stream."""

    name: str
    storage_dtype: str      # "float32" | "bfloat16" | "int8" | "int16"
    frac_bits: int = 0      # Q-format fractional bits (fixed point only)
    code: int = -1          # stream-header tag for mixed-precision snapshots

    @property
    def is_fixed_point(self) -> bool:
        return self.storage_dtype in ("int8", "int16")

    @property
    def bytes_per_value(self) -> float:
        return {"float32": 4, "bfloat16": 2, "int8": 1, "int16": 2}[self.storage_dtype]

    @property
    def np_dtype(self) -> np.dtype:
        """Host-side numpy dtype of the stored values (bf16 as uint16 bits)."""
        if self.storage_dtype == "bfloat16":
            return np.dtype(np.uint16)
        return np.dtype(self.storage_dtype)

    @property
    def scale(self) -> float:
        """Multiplier turning stored integers back into real values."""
        return 2.0 ** (-self.frac_bits) if self.is_fixed_point else 1.0


F32 = ValueFormat("F32", "float32", code=0)
BF16 = ValueFormat("BF16", "bfloat16", code=1)
Q15 = ValueFormat("Q15", "int16", frac_bits=15, code=2)
Q7 = ValueFormat("Q7", "int8", frac_bits=7, code=3)

FORMATS = {f.name: f for f in (F32, BF16, Q15, Q7)}
FORMAT_BY_CODE = {f.code: f for f in FORMATS.values()}


@dataclasses.dataclass(frozen=True)
class TaggedFormatClass:
    """A storage-width class of a heterogeneous (mixed-precision) stream.

    Partitions of a mixed-precision snapshot are grouped by value storage
    width; within a class the per-packet header tag selects the member format.
    """

    name: str
    bytes_per_value: int
    members: Tuple[str, ...]  # ValueFormat names sharing this storage width

    @property
    def member_formats(self) -> Tuple[ValueFormat, ...]:
        return tuple(FORMATS[m] for m in self.members)


TAG4 = TaggedFormatClass("TAG4", 4, ("F32",))
TAG2 = TaggedFormatClass("TAG2", 2, ("BF16", "Q15"))
TAG1 = TaggedFormatClass("TAG1", 1, ("Q7",))

WIDTH_CLASSES = {c.name: c for c in (TAG4, TAG2, TAG1)}


def width_class_of(fmt: ValueFormat) -> TaggedFormatClass:
    """The tagged stream class a value format is dispatched under."""
    for cls in WIDTH_CLASSES.values():
        if fmt.name in cls.members:
            return cls
    raise KeyError(fmt.name)


# Every ``fmt_name`` the kernel front-end resolves: plain homogeneous formats
# plus the tagged width classes used by heterogeneous fused streams.
STREAM_FORMATS: dict = {**FORMATS, **WIDTH_CLASSES}


def quantize(values, fmt: ValueFormat) -> np.ndarray:
    """Encode real values into the storage dtype of ``fmt`` (numpy, host side).

    bf16 comes back as ``uint16`` bit patterns (see the module docstring).
    """
    values = np.asarray(values, dtype=np.float32)
    if fmt.storage_dtype == "float32":
        return values
    if fmt.storage_dtype == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(values)).to(torch.bfloat16)
        return bits.view(torch.int16).numpy().view(np.uint16)
    # Fixed point: saturating round-to-nearest.
    info = np.iinfo(fmt.storage_dtype)
    q = np.round(values * (2.0 ** fmt.frac_bits))
    q = np.clip(q, info.min, info.max)
    return q.astype(fmt.storage_dtype)


def host_dequantize(stored: np.ndarray, fmt: ValueFormat) -> np.ndarray:
    """Decode stored values back to float32 on the host (numpy, bit-exact)."""
    x = np.asarray(stored)
    if fmt.storage_dtype == "bfloat16":
        bits = x.view(np.uint16).astype(np.uint32) << np.uint32(16)
        return bits.view(np.float32)
    if fmt.is_fixed_point:
        return x.astype(np.float32) * np.float32(fmt.scale)
    return x.astype(np.float32)


def dequantize(stored: torch.Tensor, fmt: ValueFormat) -> torch.Tensor:
    """Decode a stored-value tensor to float32 (bf16 arrives as int16 bits)."""
    if fmt.storage_dtype == "bfloat16":
        return stored.view(torch.bfloat16).float()
    if fmt.is_fixed_point:
        return stored.float() * fmt.scale
    return stored.float()
