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

`prefilter_scan_chunk_plain` is the plain PyTorch version of the chunk
shift-AND, and `prefilter_scan_fields_plain` (per field: a fresh state,
the chunk, `prefilter_extract`) that of Stage A. csrc/prefilter.cu runs
both on the card (see the source for its design): `fused_prefilter_fields`
scans every field of a batch to its hits in one launch, and
`fused_prefilter_chunk` keeps the chunk contract (carried (S, H), per-row
offsets); both take CUDA tensors only. `prefilter_scan_fields`,
`prefilter_scan` and `prefilter_scan_chunk` send a CUDA tensor to the
kernel and a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ._build import Kernel, register, require_cuda, stream_of
from ._tables import MASK32, U32, TensorTable, arr, derived, narrow, widen
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


# csrc/prefilter.cu's shape of work: at most MAX_FIELDS fields a launch,
# KERNEL_WARPS warps a block, one unit of G = min(32, next_pow2(Wp)) lanes
# per (row, segment, slice of SLICE_WORDS words); a row's units share a
# block, but for a bank whose slices alone exceed one (over 4096 words),
# which spreads them over blocks. TABLE_PAD zero words follow the table for the lanes past Wp.
MAX_FIELDS = 4
KERNEL_WARPS = 16
SLICE_WORDS = 256
TABLE_PAD = 256
# The segment picker's aims: a segment of at least MIN_SEGMENT columns
# (the 32-column warm-up is then at most an eighth of its walk), and
# TARGET_WARPS warps of units, 16 for each of the H100's 132 SMs (half of
# the 32 that two blocks keep resident). On the chip, full-width fields
# ran fastest at 1024 columns (2 segments of a 2048-byte row), ahead of
# 512 and of the whole row (chip_smoke.py's segment sweep).
MIN_SEGMENT = 256
TARGET_WARPS = 132 * 16


def lanes_per_unit(num_words: int) -> int:
    """G: the lanes that walk one unit of a bank of `num_words` words."""
    return min(32, 1 << max(num_words - 1, 0).bit_length())


def segment_length(Lc: int, B: int, num_words: int) -> int:
    """Columns per segment of a [B, Lc] scan of a `num_words`-word bank:
    rows are cut into 1, 2, 4, 8 or 16 segments, as many as it takes to
    give the card TARGET_WARPS warps, while a segment keeps MIN_SEGMENT
    columns and a row's units fit one block (a bank of more than 4096
    words, whose slices alone spread over blocks, keeps one segment). A
    multiple of 16."""
    units_per_warp = 32 // lanes_per_unit(num_words)
    slices = -(-num_words // SLICE_WORDS)
    max_parts = KERNEL_WARPS * units_per_warp
    nseg = 1
    while (nseg < 16 and 2 * nseg * slices <= max_parts
           and -(-Lc // (2 * nseg)) >= MIN_SEGMENT
           and B * nseg * slices < TARGET_WARPS * units_per_warp):
        nseg *= 2
    per = -(-Lc // nseg)
    return max(16, -(-per // 16) * 16)


def kernel_table(tables: PrefilterTables) -> torch.Tensor:
    """The byte table flat, with TABLE_PAD zero words after it: the
    kernel's table, made once per table."""
    def build():
        flat = tables.byte_table.contiguous().reshape(-1)
        return torch.cat([flat, flat.new_zeros(TABLE_PAD)])
    return derived(tables.byte_table, "pf_table", build)


class _Field(ctypes.Structure):
    """csrc/prefilter.cu `PfField`: one field of a launch."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "data", "lens", "toff", "tab", "init", "accept_word", "accept_mask",
        "S_in", "H_in", "S_out", "H_out", "hits")] + [
        ("stride", ctypes.c_longlong)] + [
        (name, ctypes.c_int) for name in (
            "Lc", "toff_all", "Wp", "F", "seg")]


KERNEL = register(Kernel("prefilter", "pingoo_prefilter_scan", [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # fields, nf, B
    ctypes.c_void_p,  # stream
]))


def _field(tables: PrefilterTables, data: torch.Tensor,
           lens: torch.Tensor, B: int, t_offset=0, S=None, H=None,
           S_out=None, H_out=None, hits=None) -> _Field:
    """One field's descriptor; checks what the kernel reads. The
    descriptor's `keep` holds every tensor it points into, the int32
    lengths and unit-stride rows made here included: the caller keeps
    the descriptor until the launch is queued, so that the allocator
    hands none of that memory to a later allocation first."""
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[0] != B:
        raise ValueError(f"data must be [{B}, L] uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if tuple(lens.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lens.shape)}")
    data = _rows(data)
    lens = lens.to(torch.int32).contiguous()
    Lc = data.shape[1]
    toff = None
    if isinstance(t_offset, torch.Tensor):
        toff = t_offset
        require_cuda(data, toff)
        t_offset = 0
    elif not -2**31 <= int(t_offset) < 2**31:
        raise ValueError(f"t_offset {t_offset} does not fit in int32")
    tab = kernel_table(tables)
    Wp = tables.num_words
    require_cuda(data, lens, tab, tables.init, tables.accept_word,
                 tables.accept_mask)
    f = _Field()
    f.keep = (("data", data), ("lens", lens), ("toff", toff), ("tab", tab),
              ("init", tables.init), ("accept_word", tables.accept_word),
              ("accept_mask", tables.accept_mask), ("S_in", S), ("H_in", H),
              ("S_out", S_out), ("H_out", H_out), ("hits", hits))
    for name, t in f.keep:
        setattr(f, name, None if t is None else t.data_ptr())
    f.stride = data.stride(0)
    f.Lc, f.toff_all, f.Wp = Lc, int(t_offset), Wp
    f.F = tables.num_factors
    f.seg = segment_length(Lc, B, Wp)
    return f


def _launch(fields: list[_Field], B: int, stream) -> None:
    for lo in range(0, len(fields), MAX_FIELDS):
        group = fields[lo:lo + MAX_FIELDS]
        descs = (_Field * len(group))(*group)
        KERNEL.launch(ctypes.cast(descs, ctypes.c_void_p), len(group), B,
                      stream)


def _rows(data: torch.Tensor) -> torch.Tensor:
    """`data` with unit column stride (rows may lie any stride apart)."""
    return data if data.stride(1) == 1 or data.shape[1] <= 1 \
        else data.contiguous()


def fused_prefilter_fields(tables_list, data_list, lens_list) -> list:
    """Stage A as CUDA kernel launches, one per MAX_FIELDS fields (replaces
    the TPU kernel `_pf_kernel` and `prefilter_extract`): every field of
    one batch from a fresh state to its [B, F] factor hits. Raises on a
    CPU tensor."""
    require_cuda(*data_list, *lens_list)
    B = data_list[0].shape[0]
    hits, fields = [], []
    for tables, data, lens in zip(tables_list, data_list, lens_list,
                                  strict=True):
        out = torch.empty((B, tables.num_factors), dtype=torch.bool,
                          device=data.device)
        fields.append(_field(tables, data, lens, B, hits=out))
        hits.append(out)
    if B:
        _launch(fields, B, stream_of(data_list[0]))
    return hits


def fused_prefilter_chunk(tables: PrefilterTables, data: torch.Tensor,
                          lengths: torch.Tensor, S: torch.Tensor,
                          H: torch.Tensor, t_offset):
    """The chunk shift-AND as a CUDA kernel launch (replaces the TPU
    kernel `_pf_kernel`): carried (S, H), a scalar or per-row offset, any
    width. Raises on a CPU tensor."""
    require_cuda(data, lengths, S, H)
    B, Lc = data.shape
    W = tables.num_words
    for name, t in (("S", S), ("H", H)):
        if tuple(t.shape) != (B, W) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be [{B}, {W}] int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [B, L] uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if Lc == 0 or B == 0:
        return S, H
    if isinstance(t_offset, torch.Tensor):
        t_offset = row_offsets(t_offset, B, data.device)
    S = S.contiguous()
    H = H.contiguous()
    S_out = torch.empty_like(S)
    H_out = torch.empty_like(H)
    _launch([_field(tables, data, lengths, B, t_offset, S, H, S_out, H_out)],
            B, stream_of(data))
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


def prefilter_scan_fields_plain(tables_list, data_list, lens_list) -> list:
    """Plain PyTorch version of the grouped Stage A: per field, the chunk
    shift-AND from a fresh state, then `prefilter_extract`."""
    hits = []
    for tables, data, lens in zip(tables_list, data_list, lens_list,
                                  strict=True):
        S, H = prefilter_init_state(data.shape[0], tables.num_words,
                                    data.device)
        _, H = prefilter_scan_chunk_plain(tables, data, lens, S, H, 0)
        hits.append(prefilter_extract(tables, H))
    return hits


def prefilter_scan_fields(tables_list, data_list, lens_list) -> list:
    """Stage A of one batch: every byte field scanned against its packed
    factors, data [B, L_i] uint8 and lengths [B] -> hits [B, F_i] bool per
    field; one kernel launch on CUDA tensors, the plain version on CPU
    tensors."""
    if data_list[0].is_cuda:
        return fused_prefilter_fields(tables_list, data_list, lens_list)
    return prefilter_scan_fields_plain(tables_list, data_list, lens_list)


def prefilter_scan(tables: PrefilterTables, data: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
    """Scan one byte field against every packed factor: data [B, L]
    uint8, lengths [B] -> hits [B, F] bool."""
    return prefilter_scan_fields([tables], [data], [lengths])[0]
