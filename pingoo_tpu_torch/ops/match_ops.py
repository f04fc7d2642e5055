"""Byte-tensor string predicates: eq / prefix / suffix.

All patterns of one (field, kind) group live in one padded table, so a
single broadcast compare scores every (request, pattern) pair:
[B, L] x [P, Lp] -> [B, P]. Comparisons are masked past each pattern's
length, so the op is exact on zero-padded fields.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ._tables import TensorTable, arr


@dataclass(frozen=True)
class PatternTable(TensorTable):
    """Padded pattern bytes for one (field, kind) group."""

    bytes: torch.Tensor = arr()  # [P, Lp] uint8
    lengths: torch.Tensor = arr()  # [P] int32
    ci: torch.Tensor = arr()  # [P] bool — case-insensitive compare


def build_pattern_table(patterns: list[tuple[bytes, bool]]) -> PatternTable:
    """patterns: list of (bytes, case_insensitive)."""
    P = len(patterns)
    Lp = max((len(p) for p, _ in patterns), default=1)
    Lp = max(Lp, 1)
    data = np.zeros((P, Lp), dtype=np.uint8)
    lens = np.zeros(P, dtype=np.int32)
    ci = np.zeros(P, dtype=bool)
    for i, (p, fold) in enumerate(patterns):
        data[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
        ci[i] = fold
    return PatternTable.from_numpy(bytes=data, lengths=lens, ci=ci)


def build_suffix_table(patterns: list[tuple[bytes, bool]]) -> PatternTable:
    """Right-aligned pattern table for suffix_match."""
    P = len(patterns)
    M = max((len(p) for p, _ in patterns), default=1)
    M = max(M, 1)
    data = np.zeros((P, M), dtype=np.uint8)
    lens = np.zeros(P, dtype=np.int32)
    ci = np.zeros(P, dtype=bool)
    for i, (p, fold) in enumerate(patterns):
        if p:
            data[i, M - len(p):] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
        ci[i] = fold
    return PatternTable.from_numpy(bytes=data, lengths=lens, ci=ci)


def fold_lower(x: torch.Tensor) -> torch.Tensor:
    """ASCII-lowercase a uint8 tensor."""
    is_upper = (x >= 0x41) & (x <= 0x5A)
    return torch.where(is_upper, x + 0x20, x)


def _cmp(d: torch.Tensor, p: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """[B, 1, n] vs [1, P, n] -> per-position equality [B, P, n], folded
    where the pattern is case-insensitive."""
    folded = fold_lower(d) == fold_lower(p)
    return torch.where(ci[None, :, None], folded, d == p)


def _masked_eq(data: torch.Tensor, table: PatternTable) -> torch.Tensor:
    """All positions up to each pattern's length equal: [B, P]. A pattern
    longer than L is rejected by the callers' length checks."""
    L = data.shape[1]
    Lp = table.bytes.shape[1]
    take = min(L, Lp)
    cmp = _cmp(data[:, None, :take], table.bytes[None, :, :take], table.ci)
    pos = torch.arange(take, dtype=torch.int32, device=data.device)
    pos_ok = pos[None, None, :] >= table.lengths[None, :, None]
    return torch.all(cmp | pos_ok, dim=2)


def prefix_match(data: torch.Tensor, lengths: torch.Tensor,
                 table: PatternTable) -> torch.Tensor:
    """starts_with: [B, P] bool."""
    fits = lengths[:, None] >= table.lengths[None, :]
    return _masked_eq(data, table) & fits


def eq_match(data: torch.Tensor, lengths: torch.Tensor,
             table: PatternTable) -> torch.Tensor:
    """string equality: [B, P] bool."""
    same_len = lengths[:, None] == table.lengths[None, :]
    return _masked_eq(data, table) & same_len


def row_tails(data: torch.Tensor, lengths: torch.Tensor,
              M: int) -> torch.Tensor:
    """Last M bytes of each row, right-aligned: tail[b, M-1] is the byte
    at lengths[b]-1, zero-filled left of short rows."""
    L = data.shape[1]
    idx = lengths.long()[:, None] - M + torch.arange(
        M, device=data.device)[None, :]  # [B, M]
    valid = (idx >= 0) & (idx < L)
    got = data.gather(1, idx.clamp(0, max(L - 1, 0))) if L else \
        torch.zeros_like(idx, dtype=torch.uint8)
    return torch.where(valid, got, torch.zeros_like(got))


def suffix_match(data: torch.Tensor, lengths: torch.Tensor,
                 table: PatternTable) -> torch.Tensor:
    """ends_with: [B, P] bool over RIGHT-aligned patterns
    (build_suffix_table), masking positions left of each pattern."""
    P, M = table.bytes.shape
    tail = row_tails(data, lengths, M)  # [B, M]
    cmp = _cmp(tail[:, None, :], table.bytes[None, :, :], table.ci)
    pos = torch.arange(M, dtype=torch.int32, device=data.device)
    pos_pad = pos[None, None, :] < (M - table.lengths[None, :, None])
    ok = torch.all(cmp | pos_pad, dim=2)
    fits = lengths[:, None] >= table.lengths[None, :]
    return ok & fits
