"""Windowed literal matcher — serial-free `contains`/`matches` for
fixed-shape patterns, as one correlation per field.

A window matches pattern p at offset o iff the weighted sum of squared
NIBBLE differences is zero:

    ssd[b, o, p] = sum_j w[p,j] * ((hi[b,o+j] - hip[p,j])^2
                                   + (lo[b,o+j] - lop[p,j])^2)

with hi = byte >> 4, lo = byte & 15. Expanding the squares leaves one
correlation of four streams per case channel (hi^2, lo^2, hi, lo) against
per-pattern kernels, plus a per-pattern constant. Every stream value is
at most 225 and every kernel value at most 30 in magnitude, so each
product and every partial sum is an integer well below 2^24: the
correlation is exact in float32, and also in TF32, which keeps 11
significant bits — enough for every operand. Eight input channels carry
the raw and ASCII-lowercased streams; each pattern position weights one
case channel (or none, for any-byte positions). Which patterns qualify
is the compiler's call (compiler/repat.py to_window).

The correlation is `torch.nn.functional.conv1d` (the JAX package leaves
it to XLA's convolution, outside any kernel of its own).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ._tables import TensorTable, arr
from .match_ops import fold_lower

RAW, FOLD, ANY = 0, 1, 2  # per-position channel codes (ANY: no channel)


class WindowPattern(NamedTuple):
    """One fixed-length window pattern: per-position (channel, byte)."""

    positions: tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class WindowTable(TensorTable):
    kernel: torch.Tensor = arr()  # [P, 8, M] f32
    const: torch.Tensor = arr()  # [P] f32: sum of w * (hip^2 + lop^2)
    min_len: torch.Tensor = arr()  # [P] int32 pattern length


def build_window_table(patterns: list[WindowPattern]) -> WindowTable:
    P = max(len(patterns), 1)
    M = max((len(p.positions) for p in patterns), default=1)
    M = max(M, 1)
    kernel = np.zeros((P, 8, M), dtype=np.float32)
    const = np.zeros(P, dtype=np.float32)
    min_len = np.zeros(P, dtype=np.int32)
    if not patterns:
        # Dead table: an impossible min_len keeps the pad pattern from
        # ever matching.
        min_len[0] = 1 << 20
    for i, pat in enumerate(patterns):
        min_len[i] = len(pat.positions)
        for j, (chan, b) in enumerate(pat.positions):
            if chan == ANY:
                continue
            hp, lp = b >> 4, b & 15
            base = 4 * chan
            kernel[i, base + 0, j] = 1.0  # x hi^2
            kernel[i, base + 1, j] = 1.0  # x lo^2
            kernel[i, base + 2, j] = -2.0 * hp  # x hi
            kernel[i, base + 3, j] = -2.0 * lp  # x lo
            const[i] += float(hp * hp + lp * lp)
    return WindowTable.from_numpy(kernel=kernel, const=const,
                                  min_len=min_len)


def window_hits(table: WindowTable, data: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """data [B, L] uint8 (zero-padded), lengths [B] -> hits [B, P] bool.

    hit[b, p] = exists o: data[b, o : o + m_p] matches pattern p and
    o + m_p <= lengths[b]."""
    P, _, M = table.kernel.shape

    def nibble_streams(d):
        hi = (d >> 4).to(torch.float32)
        lo = (d & 15).to(torch.float32)
        return [hi * hi, lo * lo, hi, lo]

    x = torch.stack(nibble_streams(data) + nibble_streams(fold_lower(data)),
                    dim=1)  # [B, 8, L]
    x = F.pad(x, (0, M))  # windows may start at L-1
    ssd = F.conv1d(x, table.kernel) + table.const[None, :, None]  # [B, P, O]
    O = ssd.shape[2]
    offs = torch.arange(O, dtype=torch.int32, device=data.device)
    fits = (offs[None, None, :] + table.min_len[None, :, None]
            <= lengths.to(torch.int32)[:, None, None])
    # The exact sum is a non-negative integer, so "< 0.5" is "== 0" for
    # any summation order the convolution picks.
    return ((ssd < 0.5) & fits).any(dim=2)
