"""Bit-parallel NFA scan — the exact regex/contains op of the verdict.

Executes the sticky-accept algebra built by compiler/nfa.py (build_bank)
over a byte tensor [B, L], carrying ONE [B, W] word state. Floating
matches (sticky bits), `$` and `\\b` all live inside the state words, so
a step is one byte-class lookup plus a handful of word operations.
Multi-word patterns add a cross-word carry (bit 31 of word w-1 into bit
0 of word w where `carry_mask` says the span continues) and, for
optional runs that overflow a word, extra propagation passes.

`scan_chunk_plain` is the plain PyTorch version of that step loop;
`fused_scan_chunk` launches the hand-written kernel csrc/nfa_scan.cu
(one warp per row, words across lanes; see the source for the design)
in the instantiation `kernel_variant` picks, once per segment of at
most 512 words, and takes CUDA tensors only. `scan_chunk` sends a CUDA
tensor to the kernel and a CPU tensor to the plain version. Tables hold
uint32 words as int32 bits (ops/_tables.py); the plain loop widens them
to int64.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..compiler.nfa import NfaBank
from ._build import Kernel, ptr, register, require_cuda, stream_of
from ._tables import MASK32, U32, TensorTable, arr, narrow, widen


@dataclass(frozen=True)
class NfaTables(TensorTable):
    """One field's NFA bank as tensors (fields as in the JAX package's
    NfaTables; the trailing fields are static metadata)."""

    byte_table: torch.Tensor = arr(U32)  # [256, W]
    # Byte-class compression: cls_map [256] sends a byte to its class,
    # cls_table [C, W] is the deduplicated table, cls_u16 its u16 halves
    # as f32 [C, 2W] (kept for parity with the JAX package's tables).
    cls_map: torch.Tensor = arr()  # [256] int32
    cls_table: torch.Tensor = arr(U32)  # [C, W]
    cls_u16: torch.Tensor = arr()  # [C, 2W] float32
    init_anchored: torch.Tensor = arr(U32)  # [W] injected at t == 0 only
    init_unanchored: torch.Tensor = arr(U32)  # [W] injected every step
    opt: torch.Tensor = arr(U32)  # [W]
    rep: torch.Tensor = arr(U32)  # [W]
    carry_mask: torch.Tensor = arr(U32)  # [W] 1 where word w continues w-1
    sticky: torch.Tensor = arr(U32)  # [W] sticky-accept bits
    # Accept extraction: J (word, mask) pairs; member[:, p] selects the
    # pairs of pattern slot p.
    accept_word: torch.Tensor = arr()  # [J] int32
    accept_mask: torch.Tensor = arr(U32)  # [J]
    accept_member: torch.Tensor = arr()  # [J, P] float32
    slot_always: torch.Tensor = arr()  # [P] bool
    slot_empty_ok: torch.Tensor = arr()  # [P] bool
    has_carry: bool = False
    extra_passes: int = 0
    identity_accept: bool = True
    num_words: int = 1
    atoms: tuple = ((0, 1),)
    halo_ok: bool = False
    max_footprint: int = 0


def class_compress(byte_table: np.ndarray):
    """Dedup a [256, W] byte table into (cls_map [256] i32, cls_table
    [C, W] u32, cls_u16 [C, 2W] f32 u16-halves)."""
    cls_table, cls_map = np.unique(byte_table, axis=0, return_inverse=True)
    cls_u16 = np.concatenate(
        [(cls_table & 0xFFFF).astype(np.float32),
         (cls_table >> 16).astype(np.float32)], axis=1)
    return cls_map.astype(np.int32), cls_table, cls_u16


def bank_to_tables(bank: NfaBank) -> NfaTables:
    """NfaBank (numpy build product) -> NfaTables on the CPU."""
    slots = bank.slots
    W = max(bank.num_words, 1)  # keep shapes non-empty

    def pad(a: np.ndarray) -> np.ndarray:
        if a.shape[0] == W:
            return a
        out = np.zeros(W, dtype=np.uint32)
        out[: a.shape[0]] = a
        return out

    byte_table = bank.byte_table
    if byte_table.shape[1] != W:
        bt = np.zeros((256, W), dtype=np.uint32)
        bt[:, : byte_table.shape[1]] = byte_table
        byte_table = bt
    cls_map, cls_table, cls_u16 = class_compress(byte_table)

    # Accept pairs in slot order; never-match slots contribute a dead
    # pair (word 0, mask 0) so the identity fast path survives banks
    # that mix in always/never patterns.
    acc_word: list[int] = []
    acc_mask: list[int] = []
    pair_slot: list[int] = []
    for p, slot in enumerate(slots):
        for w, mask in slot.accepts or ((0, 0),):
            acc_word.append(w)
            acc_mask.append(mask)
            pair_slot.append(p)
    J, P = len(acc_word), len(slots)
    identity = J == P and all(pair_slot[j] == j for j in range(J))
    member = np.zeros((max(J, 1), P), dtype=np.float32)
    for j, p in enumerate(pair_slot):
        member[j, p] = 1.0

    halo_ok = bool(np.all((bank.rep & ~bank.sticky_mask) == 0)) \
        if bank.num_words else True
    atoms: list[tuple[int, int]] = []
    carry_flags = pad(bank.carry_mask)
    for w in range(W):
        if carry_flags[w] == 0 or not atoms:
            atoms.append((w, w + 1))
        else:
            atoms[-1] = (atoms[-1][0], w + 1)
    return NfaTables.from_numpy(
        byte_table=byte_table,
        cls_map=cls_map,
        cls_table=cls_table,
        cls_u16=cls_u16,
        init_anchored=pad(bank.init_anchored),
        init_unanchored=pad(bank.init_unanchored),
        opt=pad(bank.opt),
        rep=pad(bank.rep),
        carry_mask=pad(bank.carry_mask),
        sticky=pad(bank.sticky_mask),
        accept_word=np.array(acc_word or [0], dtype=np.int32),
        accept_mask=np.array(acc_mask or [0], dtype=np.uint32),
        accept_member=member,
        slot_always=np.array([s.always_match for s in slots], dtype=bool),
        slot_empty_ok=np.array([s.empty_ok for s in slots], dtype=bool),
        has_carry=bank.has_carry,
        extra_passes=max(bank.prop_passes - 1, 0),
        identity_accept=identity,
        halo_ok=halo_ok,
        max_footprint=int(bank.max_footprint),
        num_words=W,
        atoms=tuple(atoms),
    )


def row_offsets(t_offset, B: int, device) -> torch.Tensor:
    """A scalar or per-row [B] global offset as an int32 [B] tensor."""
    if isinstance(t_offset, torch.Tensor):
        return t_offset.to(device=device, dtype=torch.int32).expand(B) \
            .contiguous()
    return torch.full((B,), int(t_offset), dtype=torch.int32, device=device)


def scan_chunk_plain(tables: NfaTables, data: torch.Tensor,
                     lengths: torch.Tensor, state: torch.Tensor, t_offset,
                     pair: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the chunk advance: the per-byte loop of
    the JAX package's `nfa_scan.scan_chunk`. data [B, Lc] uint8 whose
    first column sits at global position `t_offset` (int or per-row
    [B]); state [B, W] int32 bits; returns the new state.

    `pair` walks two columns per iteration; a trailing odd column is
    skipped structurally (never read as a pad byte), so both steppings
    give the same state, as on the TPU."""
    B, Lc = data.shape
    if Lc == 0:
        return state
    dev = data.device
    cls = tables.cls_map.long()[data.long()]  # [B, Lc] class ids
    tab = widen(tables.cls_table)  # [C, W]
    init_a = widen(tables.init_anchored)
    init_u = widen(tables.init_unanchored)
    opt = widen(tables.opt)
    rep = widen(tables.rep)
    carry = widen(tables.carry_mask)
    lens = lengths.to(dev, torch.int64)
    toff = row_offsets(t_offset, B, dev).long()
    has_carry = tables.has_carry
    passes = 1 + tables.extra_passes
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def shift_words(x):
        """[B, W] -> value of word w-1 moved into word w (word 0 gets 0)."""
        return F.pad(x[:, :-1], (1, 0))

    def advance(S, i):
        t = toff + i
        bc = tab[cls[:, i]]
        inj = init_u[None, :] | torch.where((t == 0)[:, None],
                                            init_a[None, :], zero)
        adv = ((S << 1) & MASK32) | inj
        if has_carry:
            # Bit 31 of span word w-1 (pre-step) advances into word w.
            adv = adv | (shift_words((S >> 31) & 1) & carry)
        for p in range(passes):
            x = ((adv & opt) + opt) & MASK32  # wraps when a closure escapes
            adv = adv | (x ^ opt)
            if has_carry and p + 1 < passes:
                esc = (x < opt).to(torch.int64)
                adv = adv | (shift_words(esc) & carry)
        S_new = (adv | (S & rep)) & bc
        live = (t >= 0) & (t < lens)
        return torch.where(live[:, None], S_new, S)

    S = widen(state)
    if pair:
        for i in range(0, Lc, 2):
            S = advance(S, i)
            if i + 1 < Lc:
                S = advance(S, i + 1)
    else:
        for i in range(Lc):
            S = advance(S, i)
    return narrow(S)


# Words per lane that csrc/nfa_scan.cu is built for: a bank of W words
# runs on the smallest K with 32 * K >= W. A wider bank runs in segments
# of SEGMENT_WORDS words at K = 16, one launch each.
WORDS_PER_LANE = (1, 2, 3, 4, 6, 8, 12, 16)
SEGMENT_WORDS = 32 * WORDS_PER_LANE[-1]


def kernel_variant(num_words: int, passes: int,
                   has_carry: bool) -> tuple[int, int, bool]:
    """The instantiation of csrc/nfa_scan.cu that runs a bank: (K words
    per lane, P unrolled passes or 0 for a loop over `passes`, carry).
    With carry, only two passes (the corpus banks' count) unroll. A bank
    wider than SEGMENT_WORDS runs its segments at K = 16 (with carry, in
    the kernel's SEG instantiation of the same P).

    A bank without cross-word carry runs one pass: with no escape carry
    between passes, a second pass sets no new bit (the kernel's note
    says why), so one pass gives the state of `passes` passes."""
    K = next((k for k in WORDS_PER_LANE if 32 * k >= num_words),
             WORDS_PER_LANE[-1])
    if not has_carry:
        return K, 1, False
    return K, 2 if passes == 2 else 0, True


def segments(num_words: int) -> list[tuple[int, int]]:
    """The [lo, hi) word ranges a bank's launches cover, in order."""
    return [(lo, min(lo + SEGMENT_WORDS, num_words))
            for lo in range(0, num_words, SEGMENT_WORDS)]


_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = register(Kernel("nfa_scan", "pingoo_nfa_scan_chunk", [
    _P, _I, _I, _P, _P, _I,  # data, B, Lc, lens, toff, toff_all
    _P, _P, _I, _I, _I, _I,  # cls_map, cls_table, C, W, tW, sW
    _P, _P, _P, _P, _P,  # init_a, init_u, opt, rep, carry
    _I, _I, _I, _I,  # passes, K, P, has_carry
    _P, _P, _I, _P, _P, _P,  # state_in, state_out, seg, cin, cout, stream
]))


def fused_scan_chunk(tables: NfaTables, data: torch.Tensor,
                     lengths: torch.Tensor, state: torch.Tensor, t_offset,
                     pair: bool = True) -> torch.Tensor:
    """The chunk advance as a CUDA kernel launch, with the contract of
    the JAX package's `pallas_scan.fused_scan_chunk` (replaces the TPU
    kernel `_kernel`). `pair` is that kernel's two-columns-per-iteration
    stepping; it changes no bits, and the CUDA kernel walks a row the
    same way for either. Raises on a CPU tensor."""
    require_cuda(data, lengths, state)
    B, Lc = data.shape
    W = tables.opt.shape[0]
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise ValueError(f"data must be [B, L] uint8, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if tuple(state.shape) != (B, W) or state.dtype != torch.int32:
        raise ValueError(f"state must be [{B}, {W}] int32, got "
                         f"{state.dtype} {tuple(state.shape)}")
    passes = 1 + tables.extra_passes
    K, P, carry = kernel_variant(W, passes, tables.has_carry)
    if Lc == 0 or B == 0:
        return state
    data = data.contiguous()
    state = state.contiguous()
    lens = lengths.to(torch.int32).contiguous()
    if isinstance(t_offset, torch.Tensor):
        toff, toff_all = row_offsets(t_offset, B, data.device), 0
        require_cuda(data, toff)
    else:
        toff, toff_all = None, int(t_offset)
        if not -2**31 <= toff_all < 2**31:
            raise ValueError(f"t_offset {toff_all} does not fit in int32")
    require_cuda(data, lens, state, tables.cls_map, tables.cls_table,
                 tables.opt)
    C = tables.cls_table.shape[0]
    spans = segments(W)
    wide = len(spans) > 1
    if wide and carry and passes > 31:
        raise ValueError(f"a bank wider than {SEGMENT_WORDS} words runs at "
                         f"most 31 passes, not {passes}")
    # A bank wider than one launch runs its segments in word order, each
    # reading and writing its words of the bank's own table and states in
    # place. With carry, segment i hands the carries out of its top word
    # to segment i + 1 through one of two [B, Lc] buffers.
    tab = tables.cls_table.contiguous()
    out = torch.empty_like(state)
    bufs = torch.empty((2, B, Lc), dtype=torch.int32, device=data.device) \
        if wide and carry else None
    for i, (lo, hi) in enumerate(spans):
        Ks, Ps, _ = kernel_variant(hi - lo, passes, False) \
            if wide and not carry else (K, P, carry)
        seg = wide and carry
        KERNEL.launch(
            ptr(data), B, Lc, ptr(lens), None if toff is None else ptr(toff),
            toff_all, ptr(tables.cls_map), ptr(tab[:, lo:]), C, hi - lo, W,
            W, ptr(tables.init_anchored[lo:]),
            ptr(tables.init_unanchored[lo:]), ptr(tables.opt[lo:]),
            ptr(tables.rep[lo:]), ptr(tables.carry_mask[lo:]), passes, Ks,
            Ps, int(carry), ptr(state[:, lo:]), ptr(out[:, lo:]), int(seg),
            ptr(bufs[(i - 1) % 2]) if seg and i > 0 else None,
            ptr(bufs[i % 2]) if seg and i + 1 < len(spans) else None,
            stream_of(data))
    return out


def scan_chunk(tables: NfaTables, data: torch.Tensor, lengths: torch.Tensor,
               state: torch.Tensor, t_offset,
               pair: bool = False) -> torch.Tensor:
    """Advance the NFA over one [B, Lc] chunk. A CUDA tensor goes through
    the CUDA kernel whatever `pair` says (the choice changes no bits);
    a CPU tensor through the plain version."""
    if data.is_cuda:
        return fused_scan_chunk(tables, data, lengths, state, t_offset,
                                pair=pair)
    return scan_chunk_plain(tables, data, lengths, state, t_offset, pair)


def init_scan_state(B: int, W: int, device) -> torch.Tensor:
    return torch.zeros((B, W), dtype=torch.int32, device=device)


def extract_slots(tables: NfaTables, state: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """Per-pattern verdicts [B, P] bool from the final state."""
    lanes = state.index_select(1, tables.accept_word.long())  # [B, J]
    pair_hit = (lanes & tables.accept_mask[None, :]) != 0
    if tables.identity_accept:
        hit = pair_hit
    else:
        # OR pairs into slots with one [B, J] x [J, P] product of 0/1
        # values: exact in float32 (counts are small integers).
        counts = pair_hit.to(torch.float32) @ tables.accept_member
        hit = counts > 0.0
    lens = lengths.to(torch.int32)
    hit = hit | (tables.slot_empty_ok[None, :] & (lens == 0)[:, None])
    return hit | tables.slot_always[None, :]


def nfa_scan(tables: NfaTables, data: torch.Tensor, lengths: torch.Tensor,
             pair: bool = False) -> torch.Tensor:
    """Run the bank over a byte batch: data [B, L] uint8, lengths [B] ->
    matched [B, P] bool."""
    B = data.shape[0]
    state = scan_chunk(tables, data, lengths,
                       init_scan_state(B, tables.opt.shape[0], data.device),
                       0, pair=pair)
    return extract_slots(tables, state, lengths)
