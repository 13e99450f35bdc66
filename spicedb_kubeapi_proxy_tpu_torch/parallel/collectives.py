"""In-process collectives of the mesh path.

The reference's sharded programs run under `shard_map` and join their
shards with `lax.all_gather(tiled=True)`, `lax.pmax` and `lax.psum`.  The
port drives every shard from one process, so its collectives are copies
between the shards' buffers, writes that kernels make into several
replicas at once, and one small kernel:

- `all_gather_rows`: a tiled all_gather along `graph` — each replica's
  row block reaches every peer replica.  On the sharded ELL sweep the
  gather that computes a block writes it into every replica on its card
  (the mesh_* kernels), so only peers on another card get a copy
  (`written=True`); otherwise every block is copied (`Tensor.copy_` on
  row slices: `cudaMemcpyAsync` on one card, a peer copy across cards,
  ordered by torch against both devices' current streams);
- `or_allreduce`: a boolean all-reduce along `graph` — one `or_combine`
  launch ORs the replicas that share a card and writes the result into
  each; a peer on another card is copied in first and the result copied
  back to it;
- `reduce_sweep_deltas`: the convergence flag ORed over every shard and
  the changed-bit count summed over the `data` shards only (the state is
  replicated along `graph`; summing over it too would multiply the count
  by its size, reference parallel/sharding.py:548-552);
  `reduce_data_deltas` the same from one (count, changed) row a data
  shard, read back in one transfer.

`COLLECTIVES` counts the calls, the bytes each collective delivered and
the copies it made since the last `reset_collectives()`, on every device
(the CPU included), so a run can hold the bytes a sweep moves against
`sharding.comm_model` whether they moved by copy or by a kernel's write.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels

COLLECTIVES: dict = {name: {"calls": 0, "bytes": 0, "copies": 0}
                     for name in ("all_gather_rows", "or_allreduce",
                                  "reduce_sweep_deltas")}


def reset_collectives() -> None:
    for c in COLLECTIVES.values():
        for key in c:
            c[key] = 0


def _count(name: str, nbytes: int, copies: int = 0) -> None:
    COLLECTIVES[name]["calls"] += 1
    COLLECTIVES[name]["bytes"] += nbytes
    COLLECTIVES[name]["copies"] += copies


def all_gather_rows(replicas: list, lo: int, hi: int, cols: tuple = None,
                    written: bool = False) -> None:
    """Rows [lo, hi) of the replicas (one data shard's graph replicas,
    [rows, words] each) split into len(replicas) equal blocks, block g
    owned by replicas[g]: each block reaches every peer.  `cols` = (a, b)
    moves only words [a, b) of each row (the maybe plane).  `written`:
    the kernel that computed block g already wrote it into every replica
    on replicas[g]'s device, so only peers on other devices get a copy.
    The bytes counted are every block into every peer, by copy or not."""
    n = len(replicas)
    if n == 1:
        return
    if (hi - lo) % n:
        raise ValueError(f"rows [{lo}, {hi}) do not split into {n} blocks")
    b = (hi - lo) // n
    moved = copies = 0
    for g, src in enumerate(replicas):
        blk = src[lo + g * b: lo + (g + 1) * b]
        if cols is not None:
            blk = blk[:, cols[0]: cols[1]]
        for j, dst in enumerate(replicas):
            if j == g:
                continue
            moved += blk.numel() * blk.element_size()
            if written and dst.device == src.device:
                continue
            out = dst[lo + g * b: lo + (g + 1) * b]
            if cols is not None:
                out = out[:, cols[0]: cols[1]]
            out.copy_(blk)
            copies += 1
    _count("all_gather_rows", moved, copies)


def or_allreduce(partials: list, impl=kernels) -> None:
    """partials[g] |= every peer's partial, in place, for one data shard's
    graph replicas: `impl.or_combine` (the kernel, or its twin) over the
    replicas on partials[0]'s device and a copy, next to them, of each
    peer on another device; then the result is copied back to those
    peers.  One launch, and no copy between co-located replicas, up to
    MAX_OR_PARTS replicas; past that, each further group of peers is
    combined with partials[0] in its own launch and the earlier groups
    get the final result by copy.  The bytes counted are each peer's
    partial in and the result out to each peer: 2 (G - 1) partials."""
    n = len(partials)
    if n == 1:
        return
    root = partials[0]
    far = [p for p in partials[1:] if p.device != root.device]
    peers = ([p for p in partials[1:] if p.device == root.device]
             + [p.to(root.device) for p in far])
    step = kernels.MAX_OR_PARTS - 1
    groups = [peers[i: i + step] for i in range(0, len(peers), step)]
    for grp in groups:
        impl.or_combine([root] + grp)
    for grp in groups[:-1]:
        for p in grp:
            p.copy_(root)
    for p in far:
        p.copy_(root)
    _count("or_allreduce", 2 * (n - 1) * root.numel() * root.element_size())


def reduce_sweep_deltas(deltas: list) -> tuple:
    """One sweep's per-shard `sweep_delta` pairs ([D][G] int32 [2]
    tensors: changed-bit count, any change) -> (global count as int32,
    changed anywhere).  One readback for the whole mesh."""
    flat = [t for row in deltas for t in row]
    dev = flat[0].device
    vals = torch.stack([t.to(dev) for t in flat]).tolist()
    n_graph = len(deltas[0])
    count = sum(vals[d * n_graph][0] for d in range(len(deltas)))
    changed = any(v[1] for v in vals)
    _count("reduce_sweep_deltas", 8 * len(flat))
    return int(np.int64(count).astype(np.int32)), changed


def reduce_data_deltas(rows: torch.Tensor, slots: list) -> tuple:
    """One sharded ELL sweep's (changed-bit count, any change) pairs ->
    (count summed over the data shards as int32, changed anywhere).
    `rows` is int32 [D, 2] on the first shard's device, row d data shard
    d's pair; `slots[d]` is where that pair was written, copied into
    rows[d] when it lies on another device.  One readback."""
    for d, slot in enumerate(slots):
        if slot.device != rows.device:
            rows[d].copy_(slot)
    vals = rows.tolist()
    count = sum(v[0] for v in vals)
    _count("reduce_sweep_deltas", rows.numel() * rows.element_size())
    return int(np.int64(count).astype(np.int32)), any(v[1] for v in vals)