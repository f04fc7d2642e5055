"""Packed multi-literal shift-AND prefilter — Stage A of the verdict.

Each byte field is scanned once per batch against every necessary
literal factor the compiler extracted (compiler/repat.necessary_factor);
the [B, F] hit bitmap gates the exact NFA/DFA/window banks in
engine/verdict.py, which skip a bank when no request of the batch holds
any of its factors. Factors never span words and carry no guard bits:
bit 0 of every factor is re-armed by `init` each step. Per step, with S
the in-progress positions and H the sticky hit accumulator:

    S' = ((S << 1) | init) & tab[byte]
    H' = H | S'

`prefilter_scan_chunk_plain` is the plain PyTorch version;
`fused_prefilter_chunk` launches csrc/prefilter.cu (one thread per
(row, word)) and takes CUDA tensors only. `prefilter_scan_chunk` sends a
CUDA tensor to the kernel and a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ._build import Kernel, ptr, register, require_cuda, stream_of
from ._tables import MASK32, U32, TensorTable, arr, narrow, widen
from .nfa_scan import row_offsets

WORD_BITS = 32


@dataclass
class PrefilterBank:
    """Host build product: factors packed first-fit into uint32 words;
    factor f occupies width(f) consecutive bits of one word and accepts
    at its top bit."""

    num_words: int
    num_factors: int
    byte_table: np.ndarray  # [256, Wp] uint32 class masks
    init: np.ndarray  # [Wp] uint32: bit0 of every factor
    accept_word: np.ndarray  # [F] int32
    accept_mask: np.ndarray  # [F] uint32


@dataclass(frozen=True)
class PrefilterTables(TensorTable):
    byte_table: torch.Tensor = arr(U32)  # [256, Wp]
    tab_u16: torch.Tensor = arr()  # [256, 2*Wp] f32 (kept for table parity)
    init: torch.Tensor = arr(U32)  # [Wp]
    accept_word: torch.Tensor = arr()  # [F] int32
    accept_mask: torch.Tensor = arr(U32)  # [F]
    num_words: int = 1
    num_factors: int = 0


def build_prefilter_bank(
        factors: list[tuple[frozenset[int], ...]]) -> PrefilterBank:
    """First-fit pack factor byte-class runs into uint32 words."""
    assert factors, "prefilter bank needs at least one factor"
    used: list[int] = []
    rows: list[dict[int, int]] = []
    init: list[int] = []
    acc_word: list[int] = []
    acc_mask: list[int] = []
    for fac in factors:
        m = len(fac)
        assert 0 < m <= WORD_BITS
        w = -1
        for idx, u in enumerate(used):
            if u + m <= WORD_BITS:
                w = idx
                break
        if w == -1:
            used.append(0)
            rows.append({})
            init.append(0)
            w = len(used) - 1
        base = used[w]
        for i, cls in enumerate(fac):
            bit = 1 << (base + i)
            for b in cls:
                rows[w][b] = rows[w].get(b, 0) | bit
        init[w] |= 1 << base
        acc_word.append(w)
        acc_mask.append(1 << (base + m - 1))
        used[w] += m
    W = len(used)
    table = np.zeros((256, W), dtype=np.uint32)
    for w in range(W):
        for b, mask in rows[w].items():
            table[b, w] = mask
    return PrefilterBank(
        num_words=W,
        num_factors=len(factors),
        byte_table=table,
        init=np.array(init, dtype=np.uint32),
        accept_word=np.array(acc_word, dtype=np.int32),
        accept_mask=np.array(acc_mask, dtype=np.uint32),
    )


def bank_to_prefilter_tables(bank: PrefilterBank) -> PrefilterTables:
    tab_u16 = np.concatenate(
        [(bank.byte_table & 0xFFFF).astype(np.float32),
         (bank.byte_table >> 16).astype(np.float32)], axis=1)
    return PrefilterTables.from_numpy(
        byte_table=bank.byte_table,
        tab_u16=tab_u16,
        init=bank.init,
        accept_word=bank.accept_word,
        accept_mask=bank.accept_mask,
        num_words=bank.num_words,
        num_factors=bank.num_factors,
    )


def prefilter_init_state(B: int, num_words: int, device):
    """Fresh (S, H) carry pair for a chunked scan, both [B, Wp] int32."""
    zero = torch.zeros((B, num_words), dtype=torch.int32, device=device)
    return zero, zero.clone()


def prefilter_scan_chunk_plain(tables: PrefilterTables, data: torch.Tensor,
                               lengths: torch.Tensor, S: torch.Tensor,
                               H: torch.Tensor, t_offset):
    """Plain PyTorch version of the chunk shift-AND (the JAX package's
    `prefilter_scan_chunk`): columns with t_offset + i >= lengths keep S
    unchanged, and H |= S every column."""
    B, Lc = data.shape
    if Lc == 0:
        return S, H
    lens = lengths.to(data.device, torch.int64)
    toff = row_offsets(t_offset, B, data.device).long()
    tab = widen(tables.byte_table)
    init = widen(tables.init)[None, :]
    S = widen(S)
    H = widen(H)
    for i in range(Lc):
        bc = tab[data[:, i].long()]
        S_new = (((S << 1) & MASK32) | init) & bc
        S = torch.where((toff + i < lens)[:, None], S_new, S)
        H = H | S
    return narrow(S), narrow(H)


_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = register(Kernel("prefilter", "pingoo_prefilter_chunk", [
    _P, _I, _I, _P, _P,  # data, B, Lc, lens, toff
    _P, _P, _I,  # init, tab, W
    _P, _P, _P, _P, _P,  # S_in, H_in, S_out, H_out, stream
]))


def fused_prefilter_chunk(tables: PrefilterTables, data: torch.Tensor,
                          lengths: torch.Tensor, S: torch.Tensor,
                          H: torch.Tensor, t_offset):
    """The chunk shift-AND as a CUDA kernel launch (replaces the TPU
    kernel `_pf_kernel`). Raises on a CPU tensor."""
    require_cuda(data, lengths, S, H)
    B, Lc = data.shape
    W = tables.num_words
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [B, L] uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    for name, t in (("S", S), ("H", H)):
        if tuple(t.shape) != (B, W) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be [{B}, {W}] int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if Lc == 0 or B == 0:
        return S, H
    data = data.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    toff = row_offsets(t_offset, B, data.device)
    S = S.contiguous()
    H = H.contiguous()
    require_cuda(data, lens, toff, S, H, tables.byte_table)
    S_out = torch.empty_like(S)
    H_out = torch.empty_like(H)
    KERNEL.launch(ptr(data), B, Lc, ptr(lens), ptr(toff),
                  ptr(tables.init), ptr(tables.byte_table), W,
                  ptr(S), ptr(H), ptr(S_out), ptr(H_out), stream_of(data))
    return S_out, H_out


def prefilter_scan_chunk(tables: PrefilterTables, data: torch.Tensor,
                         lengths: torch.Tensor, S: torch.Tensor,
                         H: torch.Tensor, t_offset):
    """Advance the (S, H) carry over one chunk: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if data.is_cuda:
        return fused_prefilter_chunk(tables, data, lengths, S, H, t_offset)
    return prefilter_scan_chunk_plain(tables, data, lengths, S, H, t_offset)


def prefilter_extract(tables: PrefilterTables,
                      H: torch.Tensor) -> torch.Tensor:
    """[B, Wp] sticky accumulator -> [B, F] factor hits."""
    lanes = H.index_select(1, tables.accept_word.long())
    return (lanes & tables.accept_mask[None, :]) != 0


def prefilter_scan(tables: PrefilterTables, data: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Scan one byte field against every packed factor: data [B, L]
    uint8, lengths [B] -> hits [B, F] bool."""
    B = data.shape[0]
    S, H = prefilter_init_state(B, tables.num_words, data.device)
    S, H = prefilter_scan_chunk(tables, data, lengths, S, H, 0)
    return prefilter_extract(tables, H)
