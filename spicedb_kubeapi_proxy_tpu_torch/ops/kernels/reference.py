"""Plain-torch twins of the CUDA kernels in csrc/ell_kernels.cu.

Same signatures and same results, bit for bit, as the kernels.  The
wrappers in this package call a twin only for tensors that lie on the CPU
(the tests, and `torch://?device=cpu`); `chip_smoke.py` holds each kernel
against its twin on the card.  They repeat the kernels' arithmetic with
ordinary torch ops and are no yardstick of speed.

Bitplanes are int32: torch has no `~`, `>>`, `<<` or index_put_ for
uint32 on the CPU.  A word with bit 31 set is negative, so `>>` is
arithmetic — still exact once masked with `& 1`.
"""

from __future__ import annotations

from typing import Optional

import torch

# perm_program opcodes (see csrc/ell_kernels.cu)
OP_READ, OP_ZERO, OP_OR, OP_AND, OP_ANDNOT = 0, 1, 2, 3, 4


def ell_gather_or(cur: torch.Tensor, idx: torch.Tensor, dst_lo: int,
                  x0: Optional[torch.Tensor] = None,
                  wc_bits: Optional[torch.Tensor] = None,
                  wc_live: Optional[torch.Tensor] = None,
                  in_place: bool = False,
                  x_in: Optional[torch.Tensor] = None) -> None:
    """cur[dst_lo + r] = OR_k src[idx[r, k]] | x0[dst_lo + r]
    | OR over the set bits t of wc_bits[r] of wc_live[t] — every gather
    reads `cur` as it stood before the write, except that with `x_in` the
    rows of the output range [dst_lo, dst_lo + n) are read from `x_in`,
    as the kernel reads them.  `in_place` asks the kernel to write
    straight into `cur`; it is refused (ValueError) when `idx` reads a row
    of the output range, since the kernel would then race with itself."""
    n = idx.shape[0]
    if n == 0:
        return
    idx64 = idx.long()
    own = ((idx64 >= dst_lo) & (idx64 < dst_lo + n)
           if in_place or x_in is not None else None)
    if in_place and x_in is None and bool(own.any()):
        raise ValueError(f"ell_gather_or: in place asked of rows [{dst_lo}, "
                         f"{dst_lo + n}), whose table reads its own rows")

    def rows(k):
        got = cur[idx64[:, k]]
        if x_in is None:
            return got
        return torch.where(own[:, k, None], x_in[idx64[:, k]], got)

    if idx.shape[1] == 0:   # no gathers: the seed and wildcard terms only
        y = torch.zeros((n, cur.shape[1]), dtype=cur.dtype, device=cur.device)
    else:
        y = rows(0)
    for k in range(1, idx.shape[1]):
        y |= rows(k)
    if x0 is not None:
        y |= x0[dst_lo: dst_lo + n]
    if wc_bits is not None:
        for t in range(wc_live.shape[0]):
            sel = ((wc_bits >> t) & 1).bool()[:, None]
            y |= torch.where(sel, wc_live[t][None, :], 0)
    cur[dst_lo: dst_lo + n] = y


def reads_in_place(code: list, offset: int, length: int) -> bool:
    """Whether a perm program may write its output rows in place: every
    READ is of the output slot itself (a thread reads only the word it
    later writes) or of a row range disjoint from it."""
    return all(op != OP_READ or arg == offset or arg + length <= offset
               or arg >= offset + length
               for op, arg in zip(code[0::2], code[1::2]))


def perm_program(cur: torch.Tensor, x0: torch.Tensor, code: torch.Tensor,
                 offset: int, length: int, in_place: bool = False,
                 half: Optional[int] = None,
                 depth: Optional[int] = None) -> None:
    """cur[offset: offset + length] = program(cur) | x0[same rows]; the
    program is evaluated entirely before the write.  `in_place` is
    refused (ValueError) for a program that READs a range overlapping the
    output rows other than the output slot itself (`reads_in_place`);
    otherwise it changes nothing here, nor does `depth` (the kernel's
    stack size).  With `half` (definite words [0, half), maybe words
    [half, 2 * half)) exclusion subtracts the other plane: a & ~swap(b),
    as the reference writes it."""
    ops = code.tolist()
    if in_place and not reads_in_place(ops, offset, length):
        raise ValueError(f"perm_program: in place asked of slot [{offset}, "
                         f"{offset + length}), which a READ overlaps")
    cur[offset: offset + length] = _program_rows(cur, x0, ops, offset,
                                                 length, half)


def _program_rows(cur: torch.Tensor, x0: torch.Tensor, ops: list,
                  offset: int, length: int,
                  half: Optional[int]) -> torch.Tensor:
    """The rows perm_program writes: program(cur) | x0[same rows]."""
    stack: list = []
    for pc in range(0, len(ops), 2):
        op, arg = ops[pc], ops[pc + 1]
        if op == OP_READ:
            stack.append(cur[arg: arg + length])
        elif op == OP_ZERO:
            stack.append(torch.zeros((length, cur.shape[1]), dtype=cur.dtype,
                                     device=cur.device))
        elif op in (OP_OR, OP_AND):
            v = stack.pop().clone()
            for _ in range(1, arg):
                if op == OP_OR:
                    v |= stack.pop()
                else:
                    v &= stack.pop()
            stack.append(v)
        elif op == OP_ANDNOT:
            b = stack.pop()
            a = stack.pop()
            if half is not None:
                b = torch.cat([b[:, half:], b[:, :half]], dim=1)
            stack.append(a & ~b)
        else:
            raise ValueError(f"bad perm opcode {op}")
    (result,) = stack
    return result | x0[offset: offset + length]


def cav_gather_or(cur: torch.Tensor, x_in: torch.Tensor, idx: torch.Tensor,
                  half: int, dst_lo: int = 0,
                  dead: Optional[int] = None) -> None:
    """cur[dst_lo + r, half:] |= OR_k x_in[idx[r, k], half:] for the rows
    r of `idx`.  Every index is gathered, `dead`'s too (the kernel skips
    them because that row is zero; gathering them here checks it)."""
    idx64 = idx.long()
    extra = x_in[idx64[:, 0], half:]
    for k in range(1, idx.shape[1]):
        extra |= x_in[idx64[:, k], half:]
    cur[dst_lo: dst_lo + idx.shape[0], half:] |= extra


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 words (as unsigned), int64 result."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def sweep_delta(x_new: torch.Tensor, x_old: torch.Tensor,
                dead: int) -> torch.Tensor:
    """Zero x_new's dead row, then int32 [2]: [popcount(x_new ^ x_old)
    mod 2^32 (as int32), any(x_new != x_old)]."""
    x_new[dead] = 0
    d = x_new ^ x_old
    cnt = int(popcount32(d).sum()) & 0xFFFFFFFF
    if cnt >= 1 << 31:
        cnt -= 1 << 32
    return torch.tensor([cnt, int(bool((d != 0).any()))], dtype=torch.int32)


def seed_bitplanes(q_idx: torch.Tensor, nt: int, n_words: int, dead: int,
                   out: Optional[torch.Tensor] = None,
                   wc_ranges: Optional[torch.Tensor] = None,
                   live: Optional[torch.Tensor] = None,
                   planes: bool = False) -> torch.Tensor:
    """One-hot packed [nt, n_words]: bit c % 32 of word c // 32 in row
    q_idx[c]; the dead row stays zero.  With `wc_ranges` ([T, 2] row
    ranges) also live[t] = OR of the seed rows in range t.  With `planes`
    both are [.., 2 * n_words], the definite words repeated as maybe."""
    b = q_idx.shape[0]
    cols = torch.arange(b, device=q_idx.device)
    acc = torch.zeros((nt, n_words), dtype=torch.int64, device=q_idx.device)
    # columns are distinct, so each bit lands at most once per
    # (row, word): the add is exactly an OR
    acc.index_put_((q_idx.long(), cols // 32),
                   torch.ones(b, dtype=torch.int64, device=q_idx.device)
                   << (cols % 32), accumulate=True)
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    x0 = acc.to(torch.int32)
    x0[dead] = 0
    if wc_ranges is not None:
        for t, (lo, hi) in enumerate(wc_ranges.tolist()):
            rows = x0[lo:hi]
            v = torch.zeros(n_words, dtype=torch.int32, device=x0.device)
            for r in torch.nonzero((rows != 0).any(dim=1)).flatten().tolist():
                v |= rows[r]
            live[t] = torch.cat([v, v]) if planes else v
    if planes:
        x0 = torch.cat([x0, x0], dim=1)
    if out is not None:
        out.copy_(x0)
        return out
    return x0


def check_gather(x: torch.Tensor, gather_idx: torch.Tensor,
                 gather_col: torch.Tensor) -> torch.Tensor:
    """int32 [G]: ((x[gi, gc // 32] >> gc % 32) & 1) * 2."""
    gc = gather_col.long()
    words = x[gather_idx.long(), gc // 32]
    return (((words >> (gc % 32).to(torch.int32)) & 1) * 2).to(torch.int32)


def check_gather3(x: torch.Tensor, gather_idx: torch.Tensor,
                  gather_col: torch.Tensor, half: int) -> torch.Tensor:
    """int32 [G]: d * 2 + (m & ~d), d and m the column's bits in the
    definite and maybe planes."""
    gc = gather_col.long()
    gi = gather_idx.long()
    b = (gc % 32).to(torch.int32)
    d = (x[gi, gc // 32] >> b) & 1
    m = (x[gi, half + gc // 32] >> b) & 1
    return (d * 2 + (m & (d ^ 1))).to(torch.int32)


def lookup_T(x: torch.Tensor, offset: int, length: int,
             words: Optional[int] = None) -> torch.Tensor:
    """int32 [words, length]: the first `words` words of rows [offset,
    offset + length) transposed, in a tensor of its own as the kernel's
    (for W = 1 `.t().contiguous()` would return a view of `x`, which the
    next batch overwrites)."""
    w = x.shape[1] if words is None else words
    out = torch.empty((w, length), dtype=x.dtype, device=x.device)
    out.copy_(x[offset: offset + length, :w].t())
    return out


def scatter_rows(src: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """A copy of `src` with out[rows[i]] = vals[i]; rows outside [0, R)
    are skipped, `src` is left as it was."""
    out = src.clone()
    keep = (rows >= 0) & (rows < src.shape[0])
    out[rows[keep].long()] = vals[keep]
    return out


def edge_or(y: torch.Tensor, x: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, dead: Optional[int] = None) -> None:
    """y[dst[e]] |= x[src[e]] for every edge, as the reference computes
    it: per bit, the 0/1 values of the edges' sources are summed per
    destination (`index_add_`) and a positive sum sets the bit.  Every
    edge is gathered, `dead`'s too (the kernel skips them because that
    row is zero; gathering them here checks it)."""
    if not src.numel():
        return
    vals = x[src.long()]                       # [E, W]
    d = dst.long()
    acc = torch.zeros(y.shape, dtype=torch.int64, device=y.device)
    for b in range(32):
        cnt = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
        cnt.index_add_(0, d, (vals >> b) & 1)
        acc |= (cnt > 0).to(torch.int64) << b
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc)
    y |= acc.to(torch.int32)


def word_cols_T(plane: torch.Tensor, rows: int,
                words: torch.Tensor) -> torch.Tensor:
    """int32 [K, rows]: plane[:rows, words].t(), in a tensor of its own."""
    out = torch.empty((words.shape[0], rows), dtype=plane.dtype,
                      device=plane.device)
    out.copy_(plane[:rows, words.long()].t())
    return out


def or_combine(parts: list) -> None:
    """Every parts[g] = parts[0] | ... | parts[G-1], elementwise."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc |= p
    for p in parts:
        p.copy_(acc)


# -- the sharded ELL sweep (parallel/sharding.py ShardedEllKernel.step) -----

def mesh_gather_or(jobs: list, split: int) -> None:
    """For each job (idx, lo, hi, seed, wc_bits, wc_live, dsts): y[r] =
    OR_k src(idx[r, k]) | seed[r] | OR over the set bits t of wc_bits[r]
    of wc_live[t], src(s) = lo[s] for s < split and hi[s - split] past
    it; y is written into every tensor of dsts.  Every job reads before
    any writes (the wrapper refuses a destination that overlaps a
    source, so the order cannot matter)."""
    ys = []
    for idx, lo, hi, seed, wc_bits, wc_live, _ in jobs:
        src = torch.cat([lo[:split], hi])
        idx64 = idx.long()
        if idx.shape[1] == 0:
            y = torch.zeros((idx.shape[0], src.shape[1]), dtype=src.dtype,
                            device=src.device)
        else:
            y = src[idx64[:, 0]]
        for k in range(1, idx.shape[1]):
            y |= src[idx64[:, k]]
        if seed is not None:
            y |= seed
        if wc_bits is not None:
            for t in range(wc_live.shape[0]):
                sel = ((wc_bits >> t) & 1).bool()[:, None]
                y |= torch.where(sel, wc_live[t][None, :], 0)
        ys.append(y)
    for job, y in zip(jobs, ys):
        for dst in job[6]:
            dst.copy_(y)


def mesh_cav_gather_or(jobs: list, half: int,
                       dead: Optional[int] = None) -> None:
    """For each job (idx, x_in, dsts): dst[r, half:] |= OR_k x_in[idx[r,
    k], half:] for every row r of idx and every tensor dst of dsts (row
    blocks of the replicas).  Every index is gathered, `dead`'s too (the
    kernel skips them because that row is zero; gathering them here
    checks it)."""
    for idx, x_in, dsts in jobs:
        idx64 = idx.long()
        extra = x_in[idx64[:, 0], half:]
        for k in range(1, idx.shape[1]):
            extra |= x_in[idx64[:, k], half:]
        for dst in dsts:
            dst[:, half:] |= extra


def mesh_perm_program(cur: torch.Tensor, x0: torch.Tensor,
                      code: torch.Tensor, offset: int, length: int,
                      dsts: list, half: Optional[int] = None,
                      depth: Optional[int] = None) -> None:
    """perm_program(cur)'s rows written into rows [offset, offset +
    length) of every tensor of dsts, in place: refused (ValueError) for a
    program whose READs overlap its slot other than the slot itself
    (`reads_in_place`).  `depth` changes nothing here."""
    ops = code.tolist()
    if not reads_in_place(ops, offset, length):
        raise ValueError(f"mesh_perm_program: slot [{offset}, "
                         f"{offset + length}) is read by an overlapping "
                         f"READ")
    rows = _program_rows(cur, x0, ops, offset, length, half)
    for dst in dsts:
        dst[offset: offset + length] = rows


def mesh_sweep_delta(x_new: torch.Tensor, x_old: torch.Tensor, dead: int,
                     out: torch.Tensor, dsts: list) -> None:
    """Zero the dead row of every tensor of dsts, then add into out (int32
    [2]) [popcount(x_new ^ x_old), any(x_new != x_old)] with x_new's dead
    row read as zero: out[0] mod 2^32 (as int32), out[1] ORed."""
    d = x_new ^ x_old
    d[dead] = x_old[dead]
    for dst in dsts:
        dst[dead] = 0
    cnt = (int(popcount32(d).sum()) + int(out[0])) & 0xFFFFFFFF
    if cnt >= 1 << 31:
        cnt -= 1 << 32
    out[0] = cnt
    out[1] = int(out[1]) | int(bool((d != 0).any()))
