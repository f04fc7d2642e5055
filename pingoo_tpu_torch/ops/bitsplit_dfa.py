"""Bitsplit-DFA scan: one table lookup per byte, no matmul.

compiler/nfa.py lowers NFA banks to byte-indexed DFA tables
(`lower_bank_to_dfa`). Per byte, a live row ORs its state's sticky
accepts into the accumulator H and steps `state = trans[state, cls]`;
`dfa_finalize` applies the absolute-end accepts at the final state and
extracts per-slot hits (always/empty lanes as in nfa_scan).

`dfa_scan_chunk_plain` is the plain PyTorch version of the chunk walk;
`fused_dfa_chunk` launches csrc/bitsplit_dfa.cu (one thread per row,
state and H in registers, the table in the kernel's own layout, made by
`kernel_layout` once per table and staged into shared memory when it
fits) and takes CUDA tensors only. `dfa_scan_chunk` sends a CUDA tensor
to the kernel and a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.nfa import DfaBank
from ._build import Kernel, ptr, register, require_cuda, stream_of
from ._tables import U32, TensorTable, arr, derived
from .nfa_scan import row_offsets


@dataclass(frozen=True)
class DfaTables(TensorTable):
    trans_flat: torch.Tensor = arr()  # [S * C] int32, row-major
    byte_cls: torch.Tensor = arr()  # [256] int32
    step_accept: torch.Tensor = arr(U32)  # [S, Wh]
    end_accept: torch.Tensor = arr(U32)  # [S, Wh]
    trans_f32: torch.Tensor = arr()  # [S, C] f32 (kept for table parity)
    step_u16: torch.Tensor = arr()  # [S, 2*Wh] f32 u16 halves
    end_u16: torch.Tensor = arr()  # [S, 2*Wh] f32 u16 halves
    slot_word: torch.Tensor = arr()  # [P] int32 H word per slot
    slot_mask: torch.Tensor = arr(U32)  # [P] bit per slot
    slot_always: torch.Tensor = arr()  # [P] bool
    slot_empty_ok: torch.Tensor = arr()  # [P] bool
    num_states: int = 0
    num_classes: int = 0
    num_words: int = 0
    num_slots: int = 0
    exact: bool = True


def _u16_halves(words: np.ndarray) -> np.ndarray:
    """[S, W] uint32 -> [S, 2W] f32 (lo halves then hi halves)."""
    lo = (words & np.uint32(0xFFFF)).astype(np.float32)
    hi = (words >> np.uint32(16)).astype(np.float32)
    return np.concatenate([lo, hi], axis=1)


def dfa_to_tables(bank: DfaBank) -> DfaTables:
    S, C = bank.trans.shape
    P = bank.num_slots
    return DfaTables.from_numpy(
        trans_flat=bank.trans.astype(np.int32).reshape(-1),
        byte_cls=bank.byte_cls.astype(np.int32),
        step_accept=bank.step_accept.astype(np.uint32),
        end_accept=bank.end_accept.astype(np.uint32),
        trans_f32=bank.trans.astype(np.float32),
        step_u16=_u16_halves(bank.step_accept.astype(np.uint32)),
        end_u16=_u16_halves(bank.end_accept.astype(np.uint32)),
        slot_word=np.arange(P, dtype=np.int32) // 32,
        slot_mask=np.uint32(1) << (np.arange(P, dtype=np.uint32) % 32),
        slot_always=bank.slot_always.astype(bool),
        slot_empty_ok=bank.slot_empty_ok.astype(bool),
        num_states=S, num_classes=C, num_words=bank.num_words,
        num_slots=P, exact=bool(bank.exact),
    )


def dfa_init_state(B: int, num_words: int, device):
    """Fresh carry for a chunked scan: (state [B] int32, H [B, Wh]
    int32 bits)."""
    return (torch.zeros((B,), dtype=torch.int32, device=device),
            torch.zeros((B, num_words), dtype=torch.int32, device=device))


def dfa_scan_chunk_plain(tables: DfaTables, data: torch.Tensor,
                         lengths: torch.Tensor, state: torch.Tensor,
                         H: torch.Tensor, t_offset):
    """Plain PyTorch version of the chunk walk (the JAX package's
    `dfa_scan_chunk`): columns with t_offset + i >= lengths leave the
    carry untouched; end accepts are left to `dfa_finalize`."""
    B, Lc = data.shape
    if Lc == 0:
        return state, H
    C = tables.num_classes
    lens = lengths.to(data.device, torch.int64)
    toff = row_offsets(t_offset, B, data.device).long()
    cls = tables.byte_cls.long()[data.long()]  # [B, Lc]
    step_accept = tables.step_accept
    trans = tables.trans_flat
    for i in range(Lc):
        live = (toff + i) < lens
        s = state.long()
        H = torch.where(live[:, None], H | step_accept[s], H)
        state = torch.where(live, trans[s * C + cls[:, i]], state)
    return state, H


# The kernel's table layout. Entries are 16 bits, so a table has at most
# 65536 states; up to FLAG_STATES, bit 0 of an entry flags the next
# state's step accepts. The kernel stages a layout of at most
# SMEM_LAYOUT_BYTES into shared memory (the 227 KB a block may use, less
# its class map and mbarrier) and reads a larger one through L1 from L2.
MAX_STATES = 1 << 16
FLAG_STATES = 1 << 15
SMEM_LAYOUT_BYTES = 227 * 1024 - (256 * 4 + 16)


@dataclass(frozen=True)
class DfaLayout:
    """A DFA table in csrc/bitsplit_dfa.cu's layout: `data` holds
    `trans_bytes` bytes of int16-held entries [S, C] (entry = next << shift
    | flag, flag = "next has a step accept" when shift is 1), then
    `accept_bytes` bytes of step_accept [S, Wh]; both zero-padded to 16."""

    data: torch.Tensor  # uint8
    trans_bytes: int
    accept_bytes: int
    shift: int
    path: str  # "smem" (staged into shared memory) or "l2"


def _padded_bytes(t: torch.Tensor) -> torch.Tensor:
    flat = t.contiguous().view(torch.uint8).reshape(-1)
    pad = -flat.numel() % 16
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def build_layout(tables: DfaTables) -> DfaLayout:
    """The kernel's layout of `tables`, on the tables' device."""
    S, C = tables.num_states, tables.num_classes
    if S > MAX_STATES:
        raise ValueError(f"a DFA of {S} states exceeds the kernel's "
                         f"{MAX_STATES}-state limit")
    trans = tables.trans_flat.long().view(S, C)
    shift = 1 if S <= FLAG_STATES else 0
    entries = trans
    if shift:
        flag = (tables.step_accept != 0).any(dim=1).long()
        entries = (trans << 1) | flag[trans]
    entries = torch.where(entries >= 1 << 15, entries - (1 << 16), entries)
    trans_b = _padded_bytes(entries.to(torch.int16))
    acc_b = _padded_bytes(tables.step_accept)
    fits = trans_b.numel() + acc_b.numel() <= SMEM_LAYOUT_BYTES
    return DfaLayout(data=torch.cat([trans_b, acc_b]),
                     trans_bytes=trans_b.numel(), accept_bytes=acc_b.numel(),
                     shift=shift, path="smem" if fits else "l2")


def kernel_layout(tables: DfaTables) -> DfaLayout:
    """`build_layout(tables)`, made once per table."""
    return derived(tables.trans_flat, "dfa_layout",
                   lambda: build_layout(tables))


_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = register(Kernel("bitsplit_dfa", "pingoo_bitsplit_dfa_chunk", [
    _P, _I, _I, _P, _P, _I,  # data, B, Lc, lens, toff, toff_all
    _P, _I, _I,  # layout, trans_bytes, accept_bytes
    _P, _I, _I, _I,  # byte_cls, C, Wh, shift
    _P, _P, _P, _P, _P,  # state_in, H_in, state_out, H_out, stream
]))


def fused_dfa_chunk(tables: DfaTables, data: torch.Tensor,
                    lengths: torch.Tensor, state: torch.Tensor,
                    H: torch.Tensor, t_offset):
    """The chunk walk as a CUDA kernel launch (replaces the TPU kernel
    `_dfa_kernel`). Raises on a CPU tensor."""
    require_cuda(data, lengths, state, H)
    B, Lc = data.shape
    Wh = tables.num_words
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [B, L] uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if tuple(H.shape) != (B, Wh) or H.dtype != torch.int32 \
            or tuple(state.shape) != (B,) or state.dtype != torch.int32:
        raise ValueError("DFA carry must be state [B] int32 and H [B, Wh] "
                         "int32")
    if Lc == 0 or B == 0:
        return state, H
    data = data.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if isinstance(t_offset, torch.Tensor):
        toff, toff_all = row_offsets(t_offset, B, data.device), 0
        require_cuda(data, toff)
    else:
        toff, toff_all = None, int(t_offset)
        if not -2**31 <= toff_all < 2**31:
            raise ValueError(f"t_offset {toff_all} does not fit in int32")
    state = state.contiguous()
    H = H.contiguous()
    require_cuda(data, lens, state, H, tables.trans_flat, tables.byte_cls)
    layout = kernel_layout(tables)
    state_out = torch.empty_like(state)
    H_out = torch.empty_like(H)
    KERNEL.launch(
        ptr(data), B, Lc, ptr(lens), None if toff is None else ptr(toff),
        toff_all, ptr(layout.data), layout.trans_bytes, layout.accept_bytes,
        ptr(tables.byte_cls), tables.num_classes, Wh, layout.shift,
        ptr(state), ptr(H), ptr(state_out), ptr(H_out), stream_of(data))
    return state_out, H_out


def dfa_scan_chunk(tables: DfaTables, data: torch.Tensor,
                   lengths: torch.Tensor, state: torch.Tensor,
                   H: torch.Tensor, t_offset):
    """Advance the (state, H) carry over one chunk: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if data.is_cuda:
        return fused_dfa_chunk(tables, data, lengths, state, H, t_offset)
    return dfa_scan_chunk_plain(tables, data, lengths, state, H, t_offset)


def dfa_extract(tables: DfaTables, H: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """[B, Wh] accumulator -> [B, P] slot hits (always/empty lanes in)."""
    lanes = H.index_select(1, tables.slot_word.long())  # [B, P]
    hit = (lanes & tables.slot_mask[None, :]) != 0
    hit = hit | tables.slot_always[None, :]
    lens = lengths.to(torch.int32)
    return hit | (tables.slot_empty_ok[None, :] & (lens == 0)[:, None])


def dfa_finalize(tables: DfaTables, state: torch.Tensor, H: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Apply absolute-end accepts at the final state and extract hits."""
    H = H | tables.end_accept[state.long()]
    return dfa_extract(tables, H, lengths)


def dfa_scan(tables: DfaTables, data: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
    """Scan one field's [B, L] bytes -> per-slot hits [B, P] bool."""
    B = data.shape[0]
    state, H = dfa_init_state(B, tables.num_words, data.device)
    state, H = dfa_scan_chunk(tables, data, lengths, state, H, 0)
    return dfa_finalize(tables, state, H, lengths)


def dfa_skip_hits(tables: DfaTables, lengths: torch.Tensor) -> torch.Tensor:
    """Hits of rows that never scan: the always/empty_ok base only."""
    B = lengths.shape[0]
    H = torch.zeros((B, tables.num_words), dtype=torch.int32,
                    device=lengths.device)
    return dfa_extract(tables, H, lengths)


def dfa_row_candidates(tables: DfaTables, hits: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """[B] bool: rows whose DFA hits exceed the skip base — the rows an
    approximate (over-approximating) DFA hands to the exact recheck.
    Rows below the base are provably clean, so pruning them is sound."""
    base = dfa_skip_hits(tables, lengths)
    return torch.any(hits & ~base, dim=1)
