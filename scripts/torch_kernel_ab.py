#!/usr/bin/env python3
"""The hand-written sweep and table kernels against their first versions
and their PyTorch yardsticks, on one CUDA card, with device time and
host cost apart.

    python3 scripts/torch_kernel_ab.py [--rows sweep|copy|edge|mesh|tail|all]
                                       [--variants old,new,graph,library]
                                       [--rounds 3] [--out FILE]

`--rows sweep` (the default; PERF.md rows 1-6, 9, 10, 14, 14a) loads
multitenant-1m (`models/workloads.py multitenant_1m()` defaults) into
`create_endpoint("torch://")` as `chip_smoke.py` does (phase 3), seeds a
256-subject lookup batch and runs one sweep, then measures on the state
that the batch's second sweep reads, at the main path's shapes:

  mt gather i    each `ell_gather_or` launch of the staged sweep alone
                 (the aux refreshes and the stage ranges, in sweep order)
  mt program i   each `perm_program` launch alone
  mt copy        the sweep's `cur.copy_(x)`
  mt delta       `sweep_delta` (row 3)
  mt sweep       the whole staged sweep (copy, every step, delta)
  mt seed        `seed_bitplanes` of the batch (row 4a)
  mt check_gather  a 10,000-pair check batch's gathers (row 4b)
  seg edge_or    `edge_or` over the segment endpoint's full edge arrays
                 on the same store (row 10)
  mesh allreduce   a 2 x 4 `ShardedKernel` sweep's two `or_allreduce`s
                 on its real partials (rows 14a, 14)
  mesh sharded sweep  that whole sweep: partials, all-reduces,
                 permission ops, deltas (row 14)

then the caveated RBAC deployment of `chip_smoke.py` phase 10
(`caveated_rbac(n_pods=200_000, n_users=50_000, n_groups=2_000)`), on
the Jacobi sweep: `cav gather i`, `cav cav_gather_or` (row 5), `cav
program i`, `cav copy`, `cav delta`, `cav sweep`, `cav seed`, `cav
check_gather3` (row 6); last `word_cols_T` on a closure plane of
group-explosion's shape ([5,079, 65] int32, 63 word columns) and
`or_combine` on seeded random words at the mesh's partial shape
([1,084,061, 4]): the all-reduce of G = 4 replicas beside the pairwise
chain in PyTorch calls (G - 1 `bitwise_or_`, G - 1 `copy_`), of G = 2
beside one `bitwise_or_`, and with "old" the G = 4 all-reduce at each
launch shape of COMBINE_SHAPES (and `cav_gather_or` at each of
CAV_ROWS_SWEEP, after row 5), built from SHAPE_SOURCE.

`--rows edge` runs `edge_or` and `word_cols_T` (rows 10, 9) at the
shapes of `edge_cases`: multitenant-1m's segment edge arrays (W = 8)
before and after phase 11's churn rounds, one 2 x 4 `ShardedKernel`
shard (W = 4), the whole segment sweep, and a [5,079, 65] plane with the
batch's 63 words, all 65, 1 and 7, and the launch shapes of its tiled
read (COLS_TILE_SWEEP).

`--rows mesh` (PERF.md row 12) runs one sweep of the 2 x 4 mesh of
`chip_smoke.py` phase 13 (cuda:0 repeated on one card) at multitenant-1m
and at the caveated deployment, on the input of a batch's second sweep:
"old" is the first design of the sharded step (`old_mesh_step`, kept as
source: input copies, per-shard gathers through scratch, block copies
between replicas, per-replica programs and deltas, a stacked readback),
"new" the package's (`ShardedEllKernel.step`, `sweep_deltas` and one
readback); the whole sweep old, new, new, old, then each part of it
alone (`mesh old ...`, `mesh new ...`).  Its bound is the least bytes
(`chip_smoke.mesh_bound_bytes`), with the first design's count beside it.

`--rows tail` (PERF.md rows 3, 4b, 6) runs a check batch's last sweep
tail at multitenant-1m and the caveated deployment, on the output of a
batch's second sweep, up to the answers on the host: "old" the pair the
ELL path ran before the fused tail (`sweep_delta` and its 8-byte
readback, then `check_gather` or `check_gather3` and its side-stream
readback), "new" `sweep_delta_checks` with its copy to pinned memory and
the host's decode, "graph" the fused tail replayed from a CUDA graph;
old, new, graph, then reversed, at 10,000 pairs padded to 16,384 slots.

`--rows copy` runs `lookup_T` and `scatter_rows` (rows 4c, 8, 11, 13) at
multitenant-1m after `--rounds` rounds of phase 9's churn, as before:
the lookup transpose of the converged state (and of its two-plane
shape), the churn's last real flush, the segment flush's shape (two
[cap, 1] edge arrays, 212 positions) and the sharded flush's (the main
and aux tables cut into 4 row blocks), and last the host time of that
flush sent in two pageable copies a table against one pinned copy.

Variants: "old" is the first CUDA version of each kernel with its first
wrapper (`ell_gather_or` one thread per (row, word) through a scratch
buffer copied back into the state; `perm_program` with a run-time
indexed stack, through scratch when it reads its own slot;
`cav_gather_or` one thread per (row, word), every index gathered;
`edge_or` one thread per (edge, word), every edge gathered;
`word_cols_T` one thread per output word;
`or_combine` a launch per peer into replica 0, then a copy back to each
peer; `lookup_T` one thread per output word; `scatter_rows` a copy
launch and a scatter launch), kept here as source and built beside the
package's library so that it can be measured and never reached from the
path; "new" the package's kernel, launched eagerly; "graph" (whole
sweeps only) the same sweep captured once in a CUDA graph and replayed,
as `EllKernelCache.evaluate` runs it; "library" one PyTorch call (or,
for the all-reduce, the chain of them) computing the same function
where there is one.  Every variant is first held bit
for bit against the plain twins, then measured by `chip_smoke.attribute`:
(a) event-timed loop, (b) device-only time, (c) host cost per call,
(d) device time with L2 flushed.  Each case runs the variants in the
order given and then reversed (old, new, new, old), and reports each
reading.  Prints the card's nvidia-smi line first and one JSON object
last (and to --out, if given, with the names of the device activities
each variant ran).  Needs one card.
"""

from __future__ import annotations

import argparse
import asyncio
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG_POSITIONS = 212     # the segment flush's positions (PERF.md row 11)
MESH_GRAPH = 4          # graph shards of the 2 x 4 mesh (PERF.md row 13)
PLANE_SHAPE = (5_079, 65)       # group-explosion's doc#view closure plane
PLANE_WORDS = 63                # the word columns one batch reads from it
COMBINE_SHAPE = (1_084_061, 4)  # one replica's partial on the 2 x 4 mesh
N_CHECKS = 10_000               # pairs of a check batch (chip_smoke.py)
LANES = 256                     # lanes of a lookup batch (chip_smoke.py)
# or_combine launch shapes swept at G = 4: 16-byte chunks a thread a trip,
# and the grid's cap in blocks (0: one trip a thread; else 2-16 blocks an
# SM of the 132).  The package runs (2, 0).
COMBINE_SHAPES = [(u, b) for u in (1, 2) for b in (0, 264, 528, 1056, 2112)]
CAV_ROWS_SWEEP = (1, 2, 4)      # cav_gather_or's table rows a thread; the
                                # package runs 1
# word_cols_T's (plane rows, threads) a block
COLS_TILE_SWEEP = [(t, b) for t in (8, 16, 32) for b in (128, 256)]

OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#define EXPORT extern "C" __attribute__((visibility("default")))
namespace {
constexpr int kBlock = 256;
inline unsigned int grid_for(long long n, int block, long long cap) {
    long long g = (n + block - 1) / block;
    if (g < 1) g = 1;
    if (g > cap) g = cap;
    return (unsigned int)g;
}
__global__ void lookup_T_kernel(const int32_t* __restrict__ x, int W,
                                long long S, long long offset, long long L,
                                int32_t* __restrict__ out) {
    const long long total = L * W;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long w = t / L;
        const long long l = t - w * L;
        out[t] = x[(offset + l) * S + w];
    }
}
__global__ void copy_words_kernel(const int32_t* __restrict__ src,
                                  int32_t* __restrict__ out, long long n,
                                  int vec) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    if (vec) {
        const long long n4 = n >> 2;
        const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
        int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
        for (long long t = t0; t < n4; t += stride) o4[t] = __ldg(s4 + t);
        done = n4 << 2;
    }
    for (long long t = done + t0; t < n; t += stride) out[t] = __ldg(src + t);
}
__global__ void scatter_rows_kernel(const int32_t* __restrict__ rows,
                                    const int32_t* __restrict__ vals,
                                    long long b, int K, long long R,
                                    int32_t* __restrict__ out) {
    const long long total = b * K;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long i = t / K;
        const int k = (int)(t - i * K);
        const long long r = __ldg(rows + i);
        if (r >= 0 && r < R) out[r * K + k] = __ldg(vals + t);
    }
}
constexpr int kMaxStack = 16;
// y[r, w] = OR_j cur[idx[r, j], w]  |  seed[r, w]  |  OR_{t in wc_bits[r]} wc_live[t, w]
__global__ void ell_gather_or_kernel(const int32_t* __restrict__ cur,
                                     const int32_t* __restrict__ idx, int k,
                                     long long nrows, int W,
                                     const int32_t* __restrict__ seed,
                                     const int32_t* __restrict__ wc_bits,
                                     const int32_t* __restrict__ wc_live,
                                     int32_t* __restrict__ out) {
    const long long total = nrows * W;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long r = t / W;
        const int w = (int)(t - r * W);
        const int32_t* ir = idx + r * k;
        uint32_t v = 0;
        for (int j = 0; j < k; ++j) {
            v |= (uint32_t)__ldg(cur + (long long)__ldg(ir + j) * W + w);
        }
        if (seed != nullptr) v |= (uint32_t)seed[t];
        if (wc_bits != nullptr) {
            uint32_t b = (uint32_t)wc_bits[r];
            while (b) {
                const int term = __ffs(b) - 1;
                b &= b - 1;
                v |= (uint32_t)wc_live[(long long)term * W + w];
            }
        }
        out[t] = (int32_t)v;
    }
}

// Postfix program over slot slices, two int32 per instruction:
//   0 READ offset   push cur[offset + i, w]
//   1 ZERO -        push 0
//   2 OR   n        pop n, push their OR
//   3 AND  n        pop n, push their AND
//   4 ANDNOT -      pop b, pop a, push a & ~b
// out[i, w] = result | seed[i, w].  `out` may point into `cur` (the slot
// being written is never read by its own program when in place; the
// wrapper routes self-reading programs through a scratch buffer).
__global__ void perm_program_kernel(const int32_t* cur,
                                    const int32_t* __restrict__ code,
                                    int n_code, long long length, int W,
                                    const int32_t* __restrict__ seed,
                                    int32_t* out) {
    const long long total = length * W;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long i = t / W;
        const int w = (int)(t - i * W);
        uint32_t stack[kMaxStack];
        int sp = 0;
        for (int pc = 0; pc < n_code; pc += 2) {
            const int op = __ldg(code + pc);
            const int arg = __ldg(code + pc + 1);
            if (op == 0) {
                stack[sp++] = (uint32_t)cur[((long long)arg + i) * W + w];
            } else if (op == 1) {
                stack[sp++] = 0u;
            } else if (op == 2) {
                uint32_t v = stack[--sp];
                for (int j = 1; j < arg; ++j) v |= stack[--sp];
                stack[sp++] = v;
            } else if (op == 3) {
                uint32_t v = stack[--sp];
                for (int j = 1; j < arg; ++j) v &= stack[--sp];
                stack[sp++] = v;
            } else {
                const uint32_t b = stack[--sp];
                const uint32_t a = stack[--sp];
                stack[sp++] = a & ~b;
            }
        }
        out[t] = (int32_t)(stack[0] | (uint32_t)seed[t]);
    }
}

// The same program over definite/maybe planes (rows of stride 2H): thread
// (i, w) owns the word pair (w, w + H) and a stack of pairs.  OR and AND
// act on each plane; ANDNOT mixes them (Kleene exclusion):
//   def(a - b) = def(a) & ~maybe(b),   maybe(a - b) = maybe(a) & ~def(b).
__global__ void perm_program_planes_kernel(const int32_t* cur,
                                           const int32_t* __restrict__ code,
                                           int n_code, long long length,
                                           int H,
                                           const int32_t* __restrict__ seed,
                                           int32_t* out) {
    const long long total = length * H;
    const long long S = 2LL * H;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long i = t / H;
        const int w = (int)(t - i * H);
        uint32_t sd[kMaxStack], sm[kMaxStack];
        int sp = 0;
        for (int pc = 0; pc < n_code; pc += 2) {
            const int op = __ldg(code + pc);
            const int arg = __ldg(code + pc + 1);
            if (op == 0) {
                const int32_t* r = cur + ((long long)arg + i) * S + w;
                sd[sp] = (uint32_t)r[0];
                sm[sp] = (uint32_t)r[H];
                ++sp;
            } else if (op == 1) {
                sd[sp] = 0u;
                sm[sp] = 0u;
                ++sp;
            } else if (op == 2) {
                --sp;
                uint32_t d = sd[sp], m = sm[sp];
                for (int j = 1; j < arg; ++j) { --sp; d |= sd[sp]; m |= sm[sp]; }
                sd[sp] = d;
                sm[sp] = m;
                ++sp;
            } else if (op == 3) {
                --sp;
                uint32_t d = sd[sp], m = sm[sp];
                for (int j = 1; j < arg; ++j) { --sp; d &= sd[sp]; m &= sm[sp]; }
                sd[sp] = d;
                sm[sp] = m;
                ++sp;
            } else {
                const uint32_t bd = sd[--sp], bm = sm[sp];
                const uint32_t ad = sd[--sp], am = sm[sp];
                sd[sp] = ad & ~bm;
                sm[sp] = am & ~bd;
                ++sp;
            }
        }
        const long long o = i * S + w;
        out[o] = (int32_t)(sd[0] | (uint32_t)seed[o]);
        out[o + H] = (int32_t)(sm[0] | (uint32_t)seed[o + H]);
    }
}
// Maybe plane of rows [0, R) (stride 2H): out[r, H + w] |= OR_j
// x[idx[r, j], H + w], one thread per (row, word).
__global__ void cav_gather_or_kernel(const int32_t* __restrict__ x,
                                     const int32_t* __restrict__ idx, int k,
                                     long long R, int H,
                                     int32_t* __restrict__ out) {
    const long long total = R * H;
    const long long S = 2LL * H;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long r = t / H;
        const int w = (int)(t - r * H);
        const int32_t* ir = idx + r * k;
        uint32_t v = 0;
        for (int j = 0; j < k; ++j) {
            v |= (uint32_t)__ldg(x + (long long)__ldg(ir + j) * S + H + w);
        }
        if (v) out[r * S + H + w] |= (int32_t)v;
    }
}

// Segment sweep, one thread per (edge, word): y[dst[e], w] |= x[src[e], w];
// a zero source word makes no atomic.
__global__ void edge_or_kernel(const uint32_t* __restrict__ x,
                               const int32_t* __restrict__ src,
                               const int32_t* __restrict__ dst,
                               long long E, int W,
                               uint32_t* __restrict__ y) {
    const long long total = E * W;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long e = t / W;
        const int w = (int)(t - e * W);
        const uint32_t v = __ldg(x + (long long)__ldg(src + e) * W + w);
        if (v) atomicOr(y + (long long)__ldg(dst + e) * W + w, v);
    }
}

// out[k, r] = plane[r, words[k]] for r < R, one thread per output word.
__global__ void word_cols_T_kernel(const int32_t* __restrict__ plane, int Wc,
                                   const int32_t* __restrict__ words, int K,
                                   long long R, int32_t* __restrict__ out) {
    const long long total = (long long)K * R;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long k = t / R;
        const long long r = t - k * R;
        out[t] = __ldg(plane + r * Wc + __ldg(words + k));
    }
}

// dst[i] |= src[i] over n packed words (one peer into replica 0).
__global__ void or_combine_kernel(int32_t* __restrict__ dst,
                                  const int32_t* __restrict__ src,
                                  long long n, int vec) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    if (vec) {
        const long long n4 = n >> 2;
        const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
        int4* __restrict__ d4 = reinterpret_cast<int4*>(dst);
        for (long long t = t0; t < n4; t += stride) {
            const int4 b = __ldg(s4 + t);
            int4 a = d4[t];
            a.x |= b.x;
            a.y |= b.y;
            a.z |= b.z;
            a.w |= b.w;
            d4[t] = a;
        }
        done = n4 << 2;
    }
    for (long long t = done + t0; t < n; t += stride) dst[t] |= __ldg(src + t);
}
}  // namespace
// Gather-OR a row range into `scratch`, then copy it to `dst` (rows of the
// state).  Out of place on purpose: the range's gathers must read the
// state as it stood before the range is written (reference ell.py:478-488).
EXPORT int old_ell_gather_or(const void* cur, const void* idx, int k,
                         long long nrows, int W, const void* seed,
                         const void* wc_bits, const void* wc_live,
                         void* scratch, void* dst, void* stream) {
    if (nrows <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long total = nrows * W;
    ell_gather_or_kernel<<<grid_for(total, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)cur, (const int32_t*)idx, k, nrows, W,
        (const int32_t*)seed, (const int32_t*)wc_bits,
        (const int32_t*)wc_live, (int32_t*)scratch);
    int e = (int)cudaGetLastError();
    if (e) return e;
    return (int)cudaMemcpyAsync(dst, scratch, (size_t)total * 4,
                                cudaMemcpyDeviceToDevice, s);
}

// `half` > 0: the tri-state program over rows of W = 2 * half words.
EXPORT int old_perm_program(const void* cur, const void* code, int n_code,
                            long long length, int W, int half,
                            const void* seed, void* out, void* stream) {
    if (length <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (half > 0) {
        const long long total = length * half;
        perm_program_planes_kernel<<<grid_for(total, kBlock, 1LL << 30),
                                     kBlock, 0, s>>>(
            (const int32_t*)cur, (const int32_t*)code, n_code, length, half,
            (const int32_t*)seed, (int32_t*)out);
        return (int)cudaGetLastError();
    }
    const long long total = length * W;
    perm_program_kernel<<<grid_for(total, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)cur, (const int32_t*)code, n_code, length, W,
        (const int32_t*)seed, (int32_t*)out);
    return (int)cudaGetLastError();
}

EXPORT int old_lookup_T(const void* x, int W, long long S, long long offset,
                        long long L, void* out, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    lookup_T_kernel<<<grid_for(L * W, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, W, S, offset, L, (int32_t*)out);
    return (int)cudaGetLastError();
}
EXPORT int old_scatter_rows(const void* src, long long R, int K,
                            const void* rows, long long b, const void* vals,
                            void* out, int vec, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long n = R * K;
    if (n > 0) {
        const long long work = vec ? (n >> 2) : n;
        copy_words_kernel<<<grid_for(work, kBlock, 132 * 32), kBlock, 0, s>>>(
            (const int32_t*)src, (int32_t*)out, n, vec);
        int e = (int)cudaGetLastError();
        if (e) return e;
    }
    if (b > 0 && K > 0) {
        scatter_rows_kernel<<<grid_for(b * K, kBlock, 1LL << 30), kBlock, 0,
                              s>>>(
            (const int32_t*)rows, (const int32_t*)vals, b, K, R,
            (int32_t*)out);
        return (int)cudaGetLastError();
    }
    return 0;
}
EXPORT int old_cav_gather_or(const void* x, const void* idx, int k,
                             long long R, int half, void* out, void* stream) {
    if (R <= 0 || half <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long total = R * half;
    cav_gather_or_kernel<<<grid_for(total, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, (const int32_t*)idx, k, R, half, (int32_t*)out);
    return (int)cudaGetLastError();
}
EXPORT int old_edge_or(const void* x, const void* src, const void* dst,
                       long long E, int W, void* y, void* stream) {
    if (E <= 0 || W <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    edge_or_kernel<<<grid_for(E * W, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const uint32_t*)x, (const int32_t*)src, (const int32_t*)dst, E, W,
        (uint32_t*)y);
    return (int)cudaGetLastError();
}
EXPORT int old_word_cols_T(const void* plane, int Wc, const void* words,
                           int K, long long R, void* out, void* stream) {
    if (K <= 0 || R <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    word_cols_T_kernel<<<grid_for((long long)K * R, kBlock, 1LL << 30),
                         kBlock, 0, s>>>(
        (const int32_t*)plane, Wc, (const int32_t*)words, K, R,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
EXPORT int old_or_combine(void* dst, const void* src, long long n, int vec,
                          void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long work = vec ? (n >> 2) : n;
    or_combine_kernel<<<grid_for(work, kBlock, 132 * 32), kBlock, 0, s>>>(
        (int32_t*)dst, (const int32_t*)src, n, vec);
    return (int)cudaGetLastError();
}
"""


# The launch shapes the redesigned or_combine and cav_gather_or were
# chosen from, built over the package's source (its Chunk<V>, Parts,
# kBlock and grid_for) into a library of their own.
SHAPE_SOURCE = r"""
#include "ell_kernels.cu"
namespace {
template <int G, int U>
__global__ void __launch_bounds__(kBlock)
shape_or_combine_kernel(Parts parts, long long n) {
    const long long n4 = n >> 2;
    const long long stride = (long long)gridDim.x * blockDim.x * U;
    for (long long t = (long long)blockIdx.x * blockDim.x * U + threadIdx.x;
         t < n4; t += stride) {
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = Chunk<uint4>::zero();
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const long long c = t + (long long)u * blockDim.x;
                if (c < n4)
                    v[u] = Chunk<uint4>::or_(
                        v[u], Chunk<uint4>::ld(parts.p[j] + 4 * c));
            }
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const long long c = t + (long long)u * blockDim.x;
                if (c < n4) Chunk<uint4>::st(parts.p[j] + 4 * c, v[u]);
            }
    }
}
template <int RPT>
__global__ void __launch_bounds__(kBlock)
shape_cav_kernel(const int32_t* __restrict__ x,
                 const int32_t* __restrict__ idx, unsigned int R, int H,
                 int dead, int32_t* __restrict__ out) {
    using C = Chunk<uint4>;
    const long long S = 2LL * H;
    const unsigned int stride = gridDim.x * blockDim.x * RPT;
    for (unsigned int r0 = blockIdx.x * blockDim.x * RPT + threadIdx.x;
         r0 < R; r0 += stride) {
        int s[RPT][kCav];
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
            const unsigned int r = r0 + u * blockDim.x;
#pragma unroll
            for (int j = 0; j < kCav; j += 4) {
                const int4 q = r < R ? __ldg(reinterpret_cast<const int4*>(
                                           idx + r * kCav + j))
                                     : make_int4(dead, dead, dead, dead);
                s[u][j] = q.x; s[u][j + 1] = q.y;
                s[u][j + 2] = q.z; s[u][j + 3] = q.w;
            }
        }
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
            unsigned int live = 0;
#pragma unroll
            for (int j = 0; j < kCav; ++j)
                live |= (s[u][j] != dead ? 1u : 0u) << j;
            if (!live) continue;
            int32_t* o = out + (long long)(r0 + u * blockDim.x) * S + H;
            for (int c = 0; c < H; c += C::N) {
                uint4 v = C::zero();
#pragma unroll
                for (int j = 0; j < kCav; ++j)
                    if (live >> j & 1u)
                        v = C::or_(v, C::ld(x + (long long)s[u][j] * S + H
                                            + c));
                if (C::any(v)) C::st(o + c, C::or_(C::ld(o + c), v));
            }
        }
    }
}
}  // namespace
// word_cols_T's tiled read at T plane rows (a power of two) and
// `threads` (<= kColsThreads, whole warps) a block
EXPORT int shape_word_cols_T(const void* plane, int Wc, const void* words,
                             int K, long long R, int T, int threads,
                             void* out, void* stream) {
    const int P = Wc | 1;
    word_cols_tile_kernel<<<(unsigned int)((R + T - 1) / T), threads,
                            (size_t)(T * P + K) * 4, (cudaStream_t)stream>>>(
        (const int32_t*)plane, Wc, P, T, (const int32_t*)words, K, (int)R,
        (int32_t*)out);
    return (int)cudaGetLastError();
}
// G = 4 replicas, 16-byte aligned, n % 4 == 0; `per_thread` 1 or 2,
// `max_blocks` 0 for one trip a thread
EXPORT int shape_or_combine(const void* const* ptrs, long long n,
                            int per_thread, long long max_blocks,
                            void* stream) {
    Parts parts = {};
    for (int j = 0; j < 4; ++j) parts.p[j] = (int32_t*)ptrs[j];
    const unsigned int grid = grid_for(((n >> 2) + per_thread - 1) / per_thread,
                                       kBlock, max_blocks ? max_blocks
                                                          : 1LL << 30);
    cudaStream_t s = (cudaStream_t)stream;
    if (per_thread == 2)
        shape_or_combine_kernel<4, 2><<<grid, kBlock, 0, s>>>(parts, n);
    else
        shape_or_combine_kernel<4, 1><<<grid, kBlock, 0, s>>>(parts, n);
    return (int)cudaGetLastError();
}
// half % 4 == 0, every pointer 16-byte aligned; `rows` 1, 2 or 4
EXPORT int shape_cav_gather_or(const void* x, const void* idx, long long R,
                               int half, int dead, int rows, void* out,
                               void* stream) {
    const unsigned int grid = grid_for((R + rows - 1) / rows, kBlock,
                                       1LL << 30);
    cudaStream_t s = (cudaStream_t)stream;
    const int32_t *x_ = (const int32_t*)x, *i_ = (const int32_t*)idx;
    int32_t* o_ = (int32_t*)out;
    if (rows == 4)
        shape_cav_kernel<4><<<grid, kBlock, 0, s>>>(x_, i_, R, half, dead, o_);
    else if (rows == 2)
        shape_cav_kernel<2><<<grid, kBlock, 0, s>>>(x_, i_, R, half, dead, o_);
    else
        shape_cav_kernel<1><<<grid, kBlock, 0, s>>>(x_, i_, R, half, dead, o_);
    return (int)cudaGetLastError();
}
"""

def log(msg: str) -> None:
    print(msg, flush=True)


def build_lib(kernels, source: str, stem: str, *flags: str,
              includes: str = ""):
    """`source` built with the package's nvcc flags (and `flags`) into
    the package's build directory, once per source, `includes` (the text
    of the files it includes) and flags; a ctypes handle and nvcc's
    output (empty when it was built before)."""
    h = hashlib.sha256((source + includes + " ".join(
        kernels.NVCC_FLAGS + flags)).encode())
    out = kernels.BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"
    build_log = ""
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(f".{os.getpid()}.cu")
        src.write_text(source)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, *flags,
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        src.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
        build_log = proc.stdout + proc.stderr
        os.replace(tmp, out)
    return ctypes.CDLL(str(out)), build_log


class OldKernels:
    """The first versions, built from OLD_SOURCE with the package's nvcc
    flags, behind wrappers with the first versions' host path, and the
    launch shapes of SHAPE_SOURCE.  Kernels without a first version here
    are the package's."""

    def __init__(self):
        import torch
        from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
        self.torch, self.kernels = torch, kernels
        lib, self.build_log = build_lib(kernels, OLD_SOURCE, "old_kernels")
        shape, log_ = build_lib(kernels, SHAPE_SOURCE, "shape_kernels",
                                "-I", str(kernels.SOURCE.parent),
                                includes=kernels.SOURCE.read_text())
        self.build_log += log_
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for lib_, fn, args in (
                (lib, "old_lookup_T", (P, I, L, L, L, P, P)),
                (lib, "old_scatter_rows", (P, L, I, P, L, P, P, I, P)),
                (lib, "old_ell_gather_or", (P, P, I, L, I, P, P, P, P, P,
                                            P)),
                (lib, "old_perm_program", (P, P, I, L, I, I, P, P, P)),
                (lib, "old_cav_gather_or", (P, P, I, L, I, P, P)),
                (lib, "old_or_combine", (P, P, L, I, P)),
                (lib, "old_edge_or", (P, P, P, L, I, P, P)),
                (lib, "old_word_cols_T", (P, I, P, I, L, P, P)),
                (shape, "shape_or_combine", (P, L, I, L, P)),
                (shape, "shape_cav_gather_or", (P, P, L, I, I, I, P, P)),
                (shape, "shape_word_cols_T", (P, I, P, I, L, I, I, P, P))):
            getattr(lib_, fn).argtypes = list(args)
            getattr(lib_, fn).restype = ctypes.c_int
        self.lib, self.shape = lib, shape

    def __getattr__(self, name):
        return getattr(self.kernels, name)

    def _run(self, fn, device, *args):
        torch = self.torch
        lib = self.shape if fn.startswith("shape_") else self.lib
        with torch.cuda.device(device):
            code = getattr(lib, fn)(
                *args, torch.cuda.current_stream(device).cuda_stream)
        if code:
            raise RuntimeError(f"{fn}: CUDA error {code}")

    def ell_gather_or(self, cur, idx, dst_lo, x0=None, wc_bits=None,
                      wc_live=None, **_):
        """The first wrapper: always through a scratch buffer, copied
        back into the state by the launcher (the package's `in_place` and
        `x_in` choices do not change what it computes)."""
        torch = self.torch
        n, k = idx.shape
        w = cur.shape[1]
        if n == 0:
            return
        seed = x0[dst_lo: dst_lo + n] if x0 is not None else None
        scratch = torch.empty((n, w), dtype=torch.int32, device=cur.device)
        dst = cur[dst_lo: dst_lo + n]
        p = lambda t: None if t is None else t.data_ptr()
        self._run("old_ell_gather_or", cur.device, cur.data_ptr(),
                  idx.data_ptr(), k, n, w, p(seed), p(wc_bits), p(wc_live),
                  scratch.data_ptr(), dst.data_ptr())

    def perm_program(self, cur, x0, code, offset, length, in_place=False,
                     half=None, **_):
        torch = self.torch
        if length == 0:
            return
        w = cur.shape[1]
        seed = x0[offset: offset + length]
        dst = cur[offset: offset + length]
        out = dst if in_place else torch.empty((length, w),
                                               dtype=torch.int32,
                                               device=cur.device)
        self._run("old_perm_program", cur.device, cur.data_ptr(),
                  code.data_ptr(), code.shape[0], length, w, half or 0,
                  seed.data_ptr(), out.data_ptr())
        if not in_place:
            dst.copy_(out)

    def lookup_T(self, x, offset, length, words=None):
        self.kernels._check(x, "x", 2)
        w = x.shape[1] if words is None else words
        out = self.torch.empty((w, length), dtype=self.torch.int32,
                               device=x.device)
        self._run("old_lookup_T", x.device, x.data_ptr(), w, x.shape[1],
                  offset, length, out.data_ptr())
        return out

    def cav_gather_or(self, cur, x_in, idx, half, dst_lo=0, dead=None):
        """The first version: one thread per (row, word), every index
        gathered (`dead` is not read)."""
        r, k = idx.shape
        self._run("old_cav_gather_or", x_in.device, x_in.data_ptr(),
                  idx.data_ptr(), k, r, half, cur[dst_lo:].data_ptr())

    def or_combine(self, parts):
        """The first all-reduce (the first `or_allreduce`, over the pairwise
        kernel): each peer ORed into parts[0] by its own launch, then
        parts[0] copied back to each peer."""
        root = parts[0]
        for src in parts[1:]:
            vec = int(root.data_ptr() % 16 == 0 and src.data_ptr() % 16 == 0)
            self._run("old_or_combine", root.device, root.data_ptr(),
                      src.data_ptr(), root.numel(), vec)
        for dst in parts[1:]:
            dst.copy_(root)

    def edge_or(self, y, x, src, dst, dead=None):
        """The first version: one thread per (edge, word), every edge
        gathered (`dead` is not read)."""
        self._run("old_edge_or", x.device, x.data_ptr(), src.data_ptr(),
                  dst.data_ptr(), src.numel(), x.shape[1], y.data_ptr())

    def word_cols_T(self, plane, rows, words):
        out = self.torch.empty((words.numel(), rows), dtype=self.torch.int32,
                               device=plane.device)
        self._run("old_word_cols_T", plane.device, plane.data_ptr(),
                  plane.shape[1], words.data_ptr(), words.numel(), rows,
                  out.data_ptr())
        return out

    def scatter_rows(self, src, rows, vals):
        for t, name in ((src, "src"), (rows, "rows"), (vals, "vals")):
            self.kernels._check(t, name)
        r, k = src.shape
        out = self.torch.empty_like(src)
        vec = int(src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        self._run("old_scatter_rows", src.device, src.data_ptr(), r, k,
                  rows.data_ptr(), rows.shape[0], vals.data_ptr(),
                  out.data_ptr(), vec)
        return out


def old_steps(steps: list) -> list:
    """A sweep's steps as the first plan ran them: a permission program
    goes through scratch exactly when it reads its own slot (the first
    plan's rule; the gathers' modes are ignored by the first wrapper)."""
    out = []
    for s in steps:
        if s[0] == "perm_program":
            code = s[1].cpu().tolist()
            self_read = any(op == 0 and arg == s[2]
                            for op, arg in zip(code[0::2], code[1::2]))
            s = s[:4] + (not self_read,) + s[5:]
        out.append(s)
    return out


class Case:
    """One row of the A/B: its variants' callables, the twin's, and what
    each one's result is compared on.  `capturable` False: a variant reads
    back to the host, so no CUDA graph may capture it."""

    def __init__(self, name, shape, nbytes, fns, twin, result, reset,
                 order=None, capturable=True, extra=None):
        self.name, self.shape, self.nbytes = name, shape, nbytes
        self.fns, self.twin, self.result, self.reset = (fns, twin, result,
                                                        reset)
        self.order = order    # its own variants, else the run's
        self.capturable = capturable
        self.extra = extra or {}   # further numbers for the JSON row


def step_bytes(step, word: int, live, dead: int) -> int:
    """Bytes one sweep step must move: each input read once (distinct
    gathered rows), each output written once (`chip_smoke.py`'s count)."""
    import torch
    if step[0] == "ell_gather_or":
        idx, seeded, wcb = step[1], step[3], step[4]
        n, k = idx.shape
        uniq = int(torch.unique(idx).numel())
        return (n * k * 4 + uniq * word + n * word * (1 + seeded)
                + (n * 4 + word * live.shape[0] if wcb is not None else 0))
    if step[0] == "cav_gather_or":
        idx, half = step[1], step[2]
        r_, k = idx.shape
        uniq = int(torch.unique(idx).numel())
        reached = int((idx != dead).any(dim=1).sum())
        return r_ * k * 4 + (uniq + 2 * reached) * 4 * half
    code, length = step[1], step[3]
    n_read = int((code[0::2] == 0).sum())
    return code.numel() * 4 + length * word * (n_read + 2)


def sweep_cases(label, kc, tables, q, n_words, old, variants) -> list:
    """The cases of one single-device sweep (see the module docstring)."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import EllKernelCache
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference

    prog = kc.prog
    dead = prog.dead_index
    nt = prog.state_size + kc.n_aux_rows
    width = kc.width(n_words)
    word = 4 * width
    live = None
    if kc._wc_ranges is not None:
        live = torch.empty((kc._wc_ranges.shape[0], width),
                           dtype=torch.int32, device=q.device)
    x0 = kernels.seed_bitplanes(q, nt, n_words, dead,
                                wc_ranges=kc._wc_ranges, live=live,
                                planes=kc.planes)
    steps = list(kc.sweep_steps(*tables, n_words=n_words))
    first = old_steps(steps)
    st = {"x": x0.clone(), "cur": x0.clone()}

    def sweep(impl, ss, whole=True):
        def fn():
            cur, x = st["cur"], st["x"]
            if whole:
                cur.copy_(x)
            for s in ss:
                EllKernelCache.run_step(s, cur, x0, live, impl, x_in=x)
            if whole:
                impl.sweep_delta(cur, x, dead)
        return fn

    # the input of the batch's second sweep
    sweep(kernels, steps)()
    st["x"] = st["cur"].clone()
    reset = lambda: st["cur"].copy_(st["x"])
    result = lambda out: st["cur"]
    impls = {"old": (old, first), "new": (kernels, steps)}
    cases = []
    n_of = {}
    for i, s in enumerate(steps):
        kind = {"ell_gather_or": "gather", "perm_program": "program",
                "cav_gather_or": "cav_gather_or"}[s[0]]
        j = n_of[kind] = n_of.get(kind, -1) + 1
        if kind == "gather":
            idx, lo = s[1], s[2]
            shape = (f"rows [{lo}, {lo + idx.shape[0]}) x K {idx.shape[1]}, "
                     f"{width} words")
        elif kind == "program":
            shape = (f"slot [{s[2]}, {s[2] + s[3]}), {s[1].numel() // 2} "
                     f"instructions, {width} words")
        else:
            shape = f"[{s[1].shape[0]}, {s[1].shape[1]}] maybe plane"
        name = f"{label} {kind}" + ("" if kind == "cav_gather_or" else
                                    f" {j}")
        fns = {v: sweep(m, [ss[i]], whole=False)
               for v, (m, ss) in impls.items() if v in variants}
        cases.append(Case(name, shape, step_bytes(s, word, live, dead), fns,
                          sweep(reference, [s], whole=False), result, reset))
    cases.append(Case(f"{label} copy", f"[{nt}, {width}]", 2 * nt * word,
                      {"new": lambda: st["cur"].copy_(st["x"])},
                      lambda: st["cur"].copy_(st["x"]), result, reset))
    cases.append(Case(f"{label} delta", f"[{nt}, {width}]",
                      2 * nt * word + 8,
                      {"new": lambda: kernels.sweep_delta(st["cur"], st["x"],
                                                          dead)},
                      lambda: reference.sweep_delta(st["cur"], st["x"], dead),
                      result, reset))
    fns = {v: sweep(m, ss) for v, (m, ss) in impls.items() if v in variants}
    if "graph" in variants:
        lg = kernels.LaunchGraph(q.device)
        lg.capture(sweep(kernels, steps))
        fns["graph"] = lg.replay
    total = (sum(step_bytes(s, word, live, dead) for s in steps)
             + 4 * nt * word + 8)
    cases.append(Case(f"{label} sweep",
                      f"{len(steps)} steps + copy + delta on [{nt}, {width}]",
                      total, fns, sweep(reference, steps), result, reset))
    # row 5: cav_gather_or at each of its launch shapes (CAV_ROWS_SWEEP)
    for s in steps if old is not None else ():
        if s[0] != "cav_gather_or":
            continue
        _, idx, half, dead_ = s

        def rows_fn(n, idx=idx, half=half, dead_=dead_):
            cur, x = st["cur"], st["x"]
            return lambda: old._run(
                "shape_cav_gather_or", cur.device, x.data_ptr(),
                idx.data_ptr(), idx.shape[0], half, dead_, n, cur.data_ptr())
        shapes = {f"rows {n}": rows_fn(n) for n in CAV_ROWS_SWEEP}
        cases.append(Case(f"{label} cav_gather_or launch shapes",
                          f"[{idx.shape[0]}, {idx.shape[1]}] maybe plane",
                          step_bytes(s, word, live, dead), shapes,
                          sweep(reference, [s], whole=False), result, reset,
                          order=list(shapes)))
    # rows 4a and 4b / 6: the batch's seed, and a check batch's gathers
    # (the smoke's 10,000 pairs) on the second sweep's input
    seed = dict(wc_ranges=kc._wc_ranges, planes=kc.planes)
    s_live = None if live is None else torch.empty_like(live)
    s_out = torch.empty_like(x0)
    cases.append(Case(
        f"{label} seed", f"{q.numel()} columns into [{nt}, {width}]",
        q.numel() * 4 + nt * word,
        {"new": lambda: kernels.seed_bitplanes(q, nt, n_words, dead,
                                               out=s_out, live=s_live,
                                               **seed)},
        lambda: reference.seed_bitplanes(
            q, nt, n_words, dead, live=None if live is None
            else torch.empty_like(live), **seed),
        lambda out: out, lambda: None))
    rng = np.random.default_rng(13)
    off, length = prog.slot_range("pod", "view")
    gi = torch.from_numpy(rng.integers(off, off + length, N_CHECKS)
                          .astype(np.int32)).to(q.device)
    gc = torch.from_numpy(rng.integers(0, LANES, N_CHECKS)
                          .astype(np.int32)).to(q.device)
    cells = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    if kc.planes:
        name, fn = "check_gather3", lambda impl: impl.check_gather3(
            st["x"], gi, gc, n_words)
    else:
        name, fn = "check_gather", lambda impl: impl.check_gather(
            st["x"], gi, gc)
    cases.append(Case(f"{label} {name}", f"{N_CHECKS} gathers of [{nt}, "
                                         f"{width}]",
                      N_CHECKS * 4 * 3 + cells * 4 * (1 + kc.planes),
                      {"new": lambda: fn(kernels)}, lambda: fn(reference),
                      lambda out: out, lambda: None))
    return cases


def tail_cases(label, kc, tables, q, n_words, variants) -> list:
    """`--rows tail` (PERF.md rows 3, 4b, 6): a check batch's last sweep
    tail on the state that the batch's second sweep writes, each variant
    up to its answers on the host: "old" the pair the ELL path ran before
    the fused tail (`sweep_delta`, its 8-byte `.tolist()`, then
    `check_gather` or `check_gather3` and its pinned side-stream readback,
    `_Readback`, waited on), "new" `sweep_delta_checks` with its copy to
    pinned memory, a wait on the stream and the host's decode of the
    answer words (`EllKernelCache._answers`), "graph" the same tail
    replayed from a CUDA graph, as the sweep graphs replay it."""
    import numpy as np
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import (TAIL_SLOTS,
                                                         EllKernelCache,
                                                         _Arena)
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import (
        _Readback, _unify_check_buckets)

    prog = kc.prog
    dead = prog.dead_index
    nt = prog.state_size + kc.n_aux_rows
    width = kc.width(n_words)
    half = n_words if kc.planes else None
    live = None
    if kc._wc_ranges is not None:
        live = torch.empty((kc._wc_ranges.shape[0], width),
                           dtype=torch.int32, device=q.device)
    x0 = kernels.seed_bitplanes(q, nt, n_words, dead,
                                wc_ranges=kc._wc_ranges, live=live,
                                planes=kc.planes)

    def one_sweep(src):
        dst = src.clone()
        for s in kc.sweep_steps(*tables, n_words=n_words):
            EllKernelCache.run_step(s, dst, x0, live, kernels, x_in=src)
        kernels.sweep_delta(dst, src, dead)
        return dst

    # x: the first sweep's output; cur: the second's
    x = one_sweep(x0)
    cur = one_sweep(x)
    rng = np.random.default_rng(13)
    off, length = prog.slot_range("pod", "view")
    _, gi_np, gc_np = _unify_check_buckets(
        q.cpu().numpy(), rng.integers(off, off + length, N_CHECKS),
        rng.integers(0, LANES, N_CHECKS))
    g = len(gi_np)
    gi = torch.from_numpy(gi_np).to(q.device)
    gc = torch.from_numpy(gc_np).to(q.device)
    arena = _Arena(x0=x0, a=x, b=cur)
    kc.size_tail(arena, max(TAIL_SLOTS, g))
    kc._load_tail(arena, n_words, (gi_np, gc_np))
    stream = torch.cuda.current_stream(q.device)

    def old_fn():
        pair = kernels.sweep_delta(cur, x, dead).tolist()
        v = (kernels.check_gather3(cur, gi, gc, n_words) if kc.planes
             else kernels.check_gather(cur, gi, gc))
        return torch.cat([torch.tensor(pair, dtype=torch.int32),
                          _Readback(v).wait()])

    # calls alternate the two delta pairs, as a batch's sweeps do: each
    # adds into its pair and zeroes the other, the next call's
    turn = [0]

    def decoded(slot):
        return torch.cat([torch.from_numpy(
            arena.words[2 * slot:2 * slot + 2].copy()), kc._answers(arena)])

    def tail_call(slot):
        return lambda: kernels.sweep_delta_checks(
            cur, x, dead, arena.tail, arena.out, half=half, host=arena.host,
            slot=slot)
    calls = [tail_call(0), tail_call(1)]

    def new_fn():
        slot = turn[0] = 1 - turn[0]
        calls[slot]()
        stream.synchronize()
        return decoded(slot)

    def twin():
        out_t = torch.zeros_like(arena.out)
        reference.sweep_delta_checks(cur.clone(), x, dead, arena.tail,
                                     out_t, half=half)
        arena.words[:] = out_t.cpu().numpy()
        return decoded(0)

    fns = {"old": old_fn, "new": new_fn}
    if "graph" in variants:
        graphs = [kernels.LaunchGraph(q.device) for _ in range(2)]
        for g_, call in zip(graphs, calls):
            g_.capture(call)

        def graph_fn():
            slot = turn[0] = 1 - turn[0]
            graphs[slot].replay()
            stream.synchronize()
            return decoded(slot)
        fns["graph"] = graph_fn
    cells = int(torch.unique(gi.long() * n_words + gc.long() // 32).numel())
    nbytes = (2 * nt * 4 * width + 8 * g + 4
              + cells * 4 * (2 if kc.planes else 1)
              + 2 * arena.out.numel() * 4)
    return [Case(f"{label} check tail",
                 f"delta over [{nt}, {width}] + {g} check slots "
                 f"({N_CHECKS} pairs)", nbytes, fns, twin, lambda out: out,
                 lambda: None, capturable=False,
                 extra={"slots": g, "pairs": N_CHECKS})]


def tail_rows(args, variants, peak, result) -> None:
    """`--rows tail`: the old tail pair against the fused tail at
    multitenant-1m (definite) and the caveated deployment (planes)."""
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    for label, kwargs, gen in (("mt", {}, "multitenant_1m"),
                               ("cav", cs.CAVEAT_WORKLOAD, "caveated_rbac")):
        ep, w = cs.load("cuda", kwargs, gen)
        g = ep.graph()
        rng = np.random.default_rng(cs.SEED)
        batch = [SubjectRef("user", w.subjects[i]) for i in
                 rng.choice(len(w.subjects), cs.LOOKUP_LANES, replace=False)]
        q_arr, _, _ = ep._encode_subjects(g, batch)
        q = torch.from_numpy(q_arr).cuda()
        cases = tail_cases(label, g.kernel, g.snapshot(), q,
                           len(q_arr) // 32, variants)
        torch.cuda.synchronize()
        run_cases(cases, variants, peak, result)
        del ep, w, g, cases
        gc.collect()
        torch.cuda.empty_cache()


def old_mesh_step(kern, cur, x, x0, live, tables, n_words, impl,
                  parts=("gathers", "all_gathers", "cav", "programs")):
    """The first design of the sharded ELL step (row 12), kept as
    source for `--rows mesh`: every replica `cur` starts as a copy of the
    sweep's input `x` (the caller's copy); `aux_passes` times, each shard
    gathers its aux block into its own replica through scratch and the
    aux blocks are copied into every peer replica (`all_gather_rows`);
    then the main blocks with the seed, the same way; with planes each
    shard's caveat block (`cav_gather_or`) and a copy of the maybe words;
    then every replica runs the permission ops (through scratch where a
    program reads its own slot).  `parts` runs a subset, for the split."""
    from spicedb_kubeapi_proxy_tpu_torch.parallel.collectives import (
        all_gather_rows)
    main, aux = tables[0], tables[1]
    cav = tables[2] if kern.planes else None
    n_pad, a_pad = kern.n_pad, kern.a_pad
    grid = [(d, g, dev) for d, row in enumerate(kern.mesh.devices)
            for g, dev in enumerate(row)]
    half = n_words // kern.mesh.shape["data"] if kern.planes else None
    for _ in range(kern.aux_passes):
        if "gathers" in parts:
            for d, g, _dev in grid:
                impl.ell_gather_or(cur[d][g], aux[d][g],
                                   n_pad + g * kern.block_aux)
        if "all_gathers" in parts:
            for reps in cur:
                all_gather_rows(reps, n_pad, n_pad + a_pad)
    if "gathers" in parts:
        for d, g, dev in grid:
            wc = kern._plans[dev][1][g]
            impl.ell_gather_or(cur[d][g], main[d][g], g * kern.block_main,
                               x0=x0[d][g], wc_bits=wc,
                               wc_live=live[d][g] if wc is not None
                               else None)
    if "all_gathers" in parts:
        for reps in cur:
            all_gather_rows(reps, 0, n_pad)
    if cav is not None:
        if "cav" in parts:
            for d, g, _dev in grid:
                impl.cav_gather_or(cur[d][g], x[d][g], cav[d][g], half,
                                   dst_lo=g * kern.block_cav,
                                   dead=kern.prog.dead_index)
        if "all_gathers" in parts:
            for reps in cur:
                all_gather_rows(reps, 0, kern.rows, cols=(half, 2 * half))
    if "programs" in parts:
        for d, g, dev in grid:
            for code, off, length, depth in kern._plans[dev][2]:
                key = (id(code), off)
                if key not in OLD_SELF_READ:
                    ops = code.cpu().tolist()
                    OLD_SELF_READ[key] = any(
                        op == 0 and arg == off
                        for op, arg in zip(ops[0::2], ops[1::2]))
                self_read = OLD_SELF_READ[key]
                impl.perm_program(cur[d][g], x0[d][g], code, off, length,
                                  in_place=not self_read, half=half,
                                  depth=depth)


OLD_SELF_READ: dict = {}   # (code id, offset) -> the program reads its slot


def mesh_cases(label, kern, tables, q_arr, n_words, variants) -> list:
    """`--rows mesh` (PERF.md row 12): one sweep of a sharded ELL kernel,
    the first version ("old": input copies, per-shard gathers through
    scratch, block copies, per-replica programs and deltas, a stacked
    readback) against the package's ("new": one launch a pass a card
    writing every co-located replica, programs and deltas once a data
    shard, one readback), whole and split, on the input of the batch's
    second sweep."""
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel.collectives import (
        reduce_data_deltas, reduce_sweep_deltas)

    dead = kern.prog.dead_index
    arenas = kern._alloc_arenas(n_words)
    x0, live = kern.seed(q_arr, n_words, arenas)
    aux = [[a.aux for a in row] for row in arenas]
    cur = [[a.b for a in row] for row in arenas]
    x = [[a.a for a in row] for row in arenas]
    for cr, xr in zip(cur, x0):
        for c, a in zip(cr, xr):
            c.copy_(a)
    old_mesh_step(kern, cur, x0, x0, live, tables, n_words, kernels)
    for xr, cr in zip(x, cur):
        for a, c in zip(xr, cr):
            a.copy_(c)
    n_data = kern.mesh.shape["data"]
    dev0 = kern.mesh.devices[0][0]
    deltas = {dev: torch.zeros((1, n_data, 2), dtype=torch.int32,
                               device=dev) for dev in kern._placement}
    flat = lambda bufs: [t for row in bufs for t in row]

    def copies():
        for cr, xr in zip(cur, x):
            for c, a in zip(cr, xr):
                c.copy_(a)

    def old_part(*parts):
        return lambda: old_mesh_step(kern, cur, x, x0, live, tables,
                                     n_words, kernels, parts)

    def old_deltas():
        return [[kernels.sweep_delta(c, a, dead) for c, a in zip(cr, xr)]
                for cr, xr in zip(cur, x)]

    d_old = old_deltas() if "old" in variants else None

    def old_sweep():
        copies()
        old_mesh_step(kern, cur, x, x0, live, tables, n_words, kernels)
        reduce_sweep_deltas(old_deltas())

    def new_part(name):
        calls = [fn for n, fn in kern.sweep_calls(cur, x, x0, live, aux,
                                                   tables, n_words)
                 if n == name]
        return lambda: [fn(kernels) for fn in calls]

    def new_deltas(impl=kernels):
        return kern.sweep_deltas(cur, x, {dev: t[0] for dev, t in
                                          deltas.items()}, impl)

    slots = new_deltas() if "new" in variants else None

    def new_sweep():
        kern.step(cur, x, x0, live, aux, tables, n_words)
        reduce_data_deltas(deltas[dev0][0], new_deltas())

    def twin():
        kern.step(cur, x, x0, live, aux, tables, n_words, reference)
        new_deltas(reference)

    def poison():
        for t in flat(cur) + flat(aux):
            t.fill_(0x5A5A5A5A)

    state = lambda out: flat(cur)
    bound = cs.mesh_bound_bytes(kern, tables, n_words)
    per_kernel = cs.mesh_kernel_bytes(kern, tables, n_words)
    word = 4 * kern.width(n_words)
    n_rep = kern.mesh.size
    m_bytes = 2 * n_rep * kern.rows * word
    shape = (f"{kern.mesh.shape['data']} x {kern.mesh.shape['graph']} "
             f"shards, [{kern.rows}, {kern.width(n_words)}] a replica, "
             f"{kern.aux_passes} aux passes")
    cases = [Case(f"{label} sweep", shape, bound["bytes"],
                  {v: f for v, f in (("old", old_sweep), ("new", new_sweep))
                   if v in variants}, twin, state, poison,
                  capturable=False,
                  extra={"old_bytes": bound["old_bytes"],
                         "old_bound_ms": None})]
    fn_old = {"input copies": (copies, m_bytes),
              "gathers": (old_part("gathers", "cav"), None),
              "all_gathers": (old_part("all_gathers"),
                              2 * bound["copy_bytes"]),
              "programs": (old_part("programs"), None),
              "deltas": (old_deltas, 2 * n_rep * kern.rows * word),
              "readback": (lambda: reduce_sweep_deltas(d_old), 8 * n_rep)}
    if "old" in variants:
        for part, (fn, nb) in fn_old.items():
            cases.append(Case(f"{label} old {part}", shape, nb or 0,
                              {"old": fn}, fn, lambda out: flat(cur),
                              copies, capturable=part != "readback"))
    fn_new = {"gathers": ([new_part("mesh_gather_or"),
                           new_part("mesh_cav_gather_or")],
                          per_kernel["mesh_gather_or"]
                          + per_kernel.get("mesh_cav_gather_or", 0)),
              "copies": ([new_part("all_gather_rows")], 0),
              "programs": ([new_part("mesh_perm_program")],
                           per_kernel["mesh_perm_program"]),
              "deltas": ([new_deltas], per_kernel["mesh_sweep_delta"]),
              "readback": ([lambda: reduce_data_deltas(deltas[dev0][0],
                                                       slots)], 8 * n_data)}
    if "new" in variants:
        for part, (fns, nb) in fn_new.items():
            fn = (lambda fns=fns: [f() for f in fns])
            cases.append(Case(f"{label} new {part}", shape, nb, {"new": fn},
                              fn, lambda out: flat(cur), lambda: None,
                              capturable=part != "readback"))
    return cases


def mesh_rows(args, variants, old, peak, result) -> None:
    """`--rows mesh`: one sharded ELL sweep (PERF.md row 12), old against
    new, on the 2 x 4 mesh of `chip_smoke.py` phase 13 (cuda:0 repeated
    on one card) at multitenant-1m and at the caveated deployment."""
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    for label, kwargs, gen in (("mesh", {}, "multitenant_1m"),
                               ("mesh cav", cs.CAVEAT_WORKLOAD,
                                "caveated_rbac")):
        ep, w = cs.load("cuda", kwargs, gen)
        mesh = cs.make_smoke_mesh("cuda")
        m_ep = cs._mesh_endpoint(ep.store, w.schema_text, mesh, "cuda")
        g = m_ep.graph()
        rng = np.random.default_rng(cs.SEED)
        batch = [SubjectRef("user", w.subjects[i]) for i in
                 rng.choice(len(w.subjects), cs.LOOKUP_LANES, replace=False)]
        q_arr, _, _ = m_ep._encode_subjects(g, batch)
        cases = mesh_cases(label, g.kernel, g.snapshot(), q_arr,
                           len(q_arr) // 32, variants)
        torch.cuda.synchronize()
        run_cases(cases, [v for v in variants if v in ("old", "new")], peak,
                  result)
        for case in cases:
            row = result["rows"][case.name]
            if "old_bytes" in row:
                row["old_bound_ms"] = row["old_bytes"] / peak * 1e3
                log(f"{case.name}: bound over the first design's count "
                    f"{row['old_bound_ms']:.6f} ms over {row['old_bytes']} "
                    "bytes")
        del ep, w, m_ep, g, cases
        gc.collect()
        torch.cuda.empty_cache()


def segment_cases(ep, w, batch, old, variants) -> list:
    """Rows 10, 14 and 14a on the store of `ep`: `edge_or` over the
    segment endpoint's full edge arrays, then a 2 x 4 `ShardedKernel` on
    its program (cuda:0 for every shard on one card), as `chip_smoke.py`
    phase 13b drives it: one sweep's all-reduces alone and the whole
    sweep, on the partials of its third sweep."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        ShardedKernel)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)

    seg = create_endpoint("torch://", Bootstrap(w.schema_text, ""),
                          kernel="segment", store=ep.store)
    g = seg.graph()
    kc, prog = g.kernel, g.prog
    dead = prog.dead_index
    src, dst = g.snapshot()
    q_arr, _, _ = seg._encode_subjects(g, batch)
    n_words = len(q_arr) // 32
    word = 4 * n_words
    q = torch.from_numpy(q_arr).cuda()
    x0, live = kc.init_state(q, n_words)
    x, y = x0.clone(), torch.empty_like(x0)
    for step in kc.sweep_steps(src, dst):        # the second sweep's input
        kc.run_step(step, y, x, x0, live)
    x = y.clone()
    y0 = torch.empty_like(x0)
    kc.run_step(("init", kc._wc_bits), y0, x, x0, live)
    y = y0.clone()
    e_bytes = lambda s_, d_: (s_.numel() * 8
                              + int(torch.unique(s_).numel()) * word
                              + 2 * int(torch.unique(d_).numel()) * word)
    have = {"old": old, "new": kernels}
    cases = [Case("seg edge_or", f"{src.numel()} edges, {n_words} words",
                  e_bytes(src, dst),
                  {v: (lambda m=m: m.edge_or(y, x, src, dst, dead=dead))
                   for v, m in have.items() if v in variants},
                  lambda: reference.edge_or(y, x, src, dst),
                  lambda out: y, lambda: y.copy_(y0))]

    mesh = cs.make_smoke_mesh("cuda")
    sk = ShardedKernel(dataclasses.replace(
        prog, edge_src=g.host_src.copy(), edge_dst=g.host_dst.copy()), mesh)
    e_src, e_dst = sk.device_edges(len(g.host_src))
    nw = cs.MESH_DATA * max(1, LANES // 32 // cs.MESH_DATA)
    qp = np.full(32 * nw, dead, np.int32)
    qp[:LANES] = q_arr[:LANES]
    sx0, slive = sk.seed(qp, nw)
    sx = [[t.clone() for t in row] for row in sx0]
    sy = [[torch.empty_like(t) for t in row] for row in sx0]
    for _ in range(2):
        sk.partials(sy, sx, sx0, slive, e_src, e_dst)
        for reps in sy:
            collectives.or_allreduce(reps)
        sk.finish_step(sy, sx, sx0, slive)
        sx, sy = sy, sx
    sk.partials(sy, sx, sx0, slive, e_src, e_dst)
    parts0 = [[t.clone() for t in reps] for reps in sy]

    def reset():
        for reps, p0 in zip(sy, parts0):
            for t, u in zip(reps, p0):
                t.copy_(u)

    flat = lambda out: [t for reps in sy for t in reps]
    allreduce = lambda impl: (
        lambda: [collectives.or_allreduce(reps, impl) for reps in sy])

    def sweep(impl):
        def fn():
            sk.partials(sy, sx, sx0, slive, e_src, e_dst, impl)
            for reps in sy:
                collectives.or_allreduce(reps, impl)
            sk.finish_step(sy, sx, sx0, slive, impl)
            for ra, rb in zip(sy, sx):
                for a_, b_ in zip(ra, rb):
                    impl.sweep_delta(a_, b_, dead)
        return fn

    n = prog.state_size
    sw = 4 * (nw // cs.MESH_DATA)
    d_, g_ = cs.MESH_DATA, cs.MESH_GRAPH
    part_bytes = n * sw
    sweep_bytes = 2 * d_ * g_ * part_bytes       # the all-reduces
    for d in range(d_):
        for gg in range(g_):
            s_, t_ = e_src[d][gg], e_dst[d][gg]
            sweep_bytes += (s_.numel() * 8 + int(torch.unique(s_).numel()) * sw
                            + 2 * int(torch.unique(t_).numel()) * sw
                            + 4 * n * sw)        # init and delta
            for code, _, length, *_ in sk._caches[s_.device]._ops:
                n_read = int((code[0::2] == 0).sum())
                sweep_bytes += code.numel() * 4 + length * sw * (n_read + 2)
    ar = {v: allreduce(m) for v, m in have.items() if v in variants}
    if "library" in variants:
        ar["library"] = lambda: [cs.or_chain(reps) for reps in sy]
    cases.append(Case("mesh allreduce", f"{d_} data shards x {g_} replicas "
                      f"[{n}, {nw // d_}]", 2 * d_ * g_ * part_bytes, ar,
                      allreduce(reference), flat, reset))
    cases.append(Case("mesh sharded sweep", f"{d_} x {g_} shards, "
                      f"{e_src[0][0].numel()} edges a shard",
                      sweep_bytes, {v: sweep(m) for v, m in have.items()
                                    if v in variants},
                      sweep(reference), flat, reset))
    return cases, seg


def word_cols_cases(plane, batch, old, variants) -> list:
    """`word_cols_T` on `plane` with the batch's words (`batch`), all
    words, 1 and 7: first version, new, library (row 9)."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    rows, wc = plane.shape
    sets = [("the batch's", batch),
            ("all", torch.arange(wc, dtype=torch.int32, device=plane.device)),
            ("1", batch[:1].clone()), ("7", batch[:7].clone())]
    cases = []
    for label, cols in sets:
        k = cols.numel()
        cols64 = cols.long()
        fns = {v: (lambda m=m, cols=cols: m.word_cols_T(plane, rows, cols))
               for v, m in (("old", old), ("new", kernels))
               if v in variants and m is not None}
        if "library" in variants:
            fns["library"] = (lambda cols64=cols64:
                              plane[:rows, cols64].t().contiguous())
        name = "word_cols_T" if label == "the batch's" else \
            f"word_cols_T {label} words"
        cases.append(Case(name, f"[{k}, {rows}] of a [{rows}, {wc}] plane "
                                f"({label} words)",
                          2 * k * rows * 4 + k * 4, fns,
                          lambda cols=cols: reference.word_cols_T(
                              plane, rows, cols),
                          lambda out: out, lambda: None))
    return cases


def edge_cases(ep, w, batch, old, variants) -> list:
    """`--rows edge` (PERF.md rows 9, 10): `edge_or` on the segment
    endpoint's full edge arrays at multitenant-1m (W = 8) before and after
    `chip_smoke.SEG_ROUNDS` rounds of phase 11's churn, on one graph shard
    of a 2 x 4 `ShardedKernel` (W = 4, cap/G edges), and the whole
    segment sweep (init, `edge_or`, permission programs, delta), where
    "old" is the package's sweep with the first `edge_or`.  `edge_rows`
    then runs `word_cols_T` on a plane of group-explosion's shape
    (PLANE_SHAPE) with PLANE_WORDS seeded words as the batch's, all words,
    1 and 7, and with "old" the batch's words at each launch shape of
    COLS_TILE_SWEEP."""
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.parallel import collectives
    from spicedb_kubeapi_proxy_tpu_torch.parallel.sharding import (
        ShardedKernel)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.endpoints import (
        Bootstrap, create_endpoint)
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, UpdateOp, parse_relationship)

    seg = create_endpoint("torch://", Bootstrap(w.schema_text, ""),
                          kernel="segment", store=ep.store)
    g = seg.graph()
    kc, prog = g.kernel, g.prog
    dead = prog.dead_index
    src, dst = g.snapshot()
    q_arr, _, _ = seg._encode_subjects(g, batch)
    n_words = len(q_arr) // 32
    word = 4 * n_words
    q = torch.from_numpy(q_arr).cuda()
    x0, live = kc.init_state(q, n_words)
    x, y = x0.clone(), torch.empty_like(x0)
    for step in kc.sweep_steps(src, dst):        # the second sweep's input
        kc.run_step(step, y, x, x0, live)
    x = y.clone()
    y0 = torch.empty_like(x0)
    kc.run_step(("init", kc._wc_bits), y0, x, x0, live)
    y = y0.clone()
    e_bytes = lambda s_, d_, wd: (s_.numel() * 8
                                  + int(torch.unique(s_).numel()) * wd
                                  + 2 * int(torch.unique(d_).numel()) * wd)
    have = {v: m for v, m in (("old", old), ("new", kernels))
            if v in variants and m is not None}

    def edge_case(name, yy, yy0, xx, s_, d_, wd):
        return Case(name, f"{s_.numel()} edges, [{xx.shape[0]}, "
                          f"{xx.shape[1]}] state",
                    e_bytes(s_, d_, wd),
                    {v: (lambda m=m: m.edge_or(yy, xx, s_, d_, dead=dead))
                     for v, m in have.items()},
                    lambda: reference.edge_or(yy, xx, s_, d_),
                    lambda out: yy, lambda: yy.copy_(yy0))

    cases = [edge_case("seg edge_or", y, y0, x, src, dst, word)]

    class FirstEdge:
        """The package's kernels with the first `edge_or`."""
        def __getattr__(self, name):
            return getattr(old if name == "edge_or" else kernels, name)

    steps = list(kc.sweep_steps(src, dst))

    def sweep(impl):
        def fn():
            for st in steps:
                kc.run_step(st, y, x, x0, live, impl)
            impl.sweep_delta(y, x, dead)
        return fn

    n = prog.state_size
    s_bytes = 4 * n * word + 8 + e_bytes(src, dst, word)
    for code, _, length, *_ in kc._ops:
        n_read = int((code[0::2] == 0).sum())
        s_bytes += code.numel() * 4 + length * word * (n_read + 2)
    fns = {"new": sweep(kernels)} if "new" in variants else {}
    if "old" in have:
        fns["old"] = sweep(FirstEdge())
    cases.append(Case("seg sweep", f"{len(steps)} steps + delta on [{n}, "
                                   f"{n_words}]", s_bytes, fns,
                      sweep(reference), lambda out: y,
                      lambda: y.copy_(y0)))

    # one graph shard of a 2 x 4 ShardedKernel, on its third sweep's input
    mesh = cs.make_smoke_mesh("cuda")
    sk = ShardedKernel(dataclasses.replace(
        prog, edge_src=g.host_src.copy(), edge_dst=g.host_dst.copy()), mesh)
    e_src, e_dst = sk.device_edges(len(g.host_src))
    nw = cs.MESH_DATA * max(1, LANES // 32 // cs.MESH_DATA)
    qp = np.full(32 * nw, dead, np.int32)
    qp[:LANES] = q_arr[:LANES]
    sx0, slive = sk.seed(qp, nw)
    sx = [[t.clone() for t in row] for row in sx0]
    sy = [[torch.empty_like(t) for t in row] for row in sx0]
    for _ in range(2):
        sk.partials(sy, sx, sx0, slive, e_src, e_dst)
        for reps in sy:
            collectives.or_allreduce(reps)
        sk.finish_step(sy, sx, sx0, slive)
        sx, sy = sy, sx
    kc0 = sk._caches[sx[0][0].device]
    sh_y0 = torch.empty_like(sx[0][0])
    kc0.run_step(("init", kc0._wc_bits), sh_y0, sx[0][0], sx0[0][0],
                 slive[0][0])
    sh_y = sh_y0.clone()
    cases.append(edge_case("shard edge_or", sh_y, sh_y0, sx[0][0],
                           e_src[0][0], e_dst[0][0], 4 * (nw // cs.MESH_DATA)))

    # phase 11's churn rounds through the segment endpoint, then the arrays
    # its last flush produced
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    for rnd in cs._churn_plan(w, cs.SEG_ROUNDS, cs.SEED + 11, tag="s"):
        for wr in rnd["writes"]:
            asyncio.run(seg.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr]))
        asyncio.run(seg.lookup_resources_batch("pod", "view", batch[:8]))
    if seg.graph() is not g:
        raise AssertionError("the segment endpoint rebuilt under churn")
    src_c, dst_c = g.snapshot()
    descents = int((np.diff(g.host_dst.astype(np.int64)) < 0).sum())
    cases.append(edge_case(f"seg edge_or after churn ({descents} "
                           f"descents)", y, y0, x, src_c, dst_c, word))
    return cases, (seg, sk)


def edge_rows(args, variants, old, peak, result) -> None:
    """`--rows edge`: rows 9 and 10 at the shapes of `edge_cases`."""
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    ep, w = cs.load("cuda", {})
    rng = np.random.default_rng(cs.SEED)
    batch = [SubjectRef("user", w.subjects[i]) for i in
             rng.choice(len(w.subjects), cs.LOOKUP_LANES, replace=False)]
    cases, keep = edge_cases(ep, w, batch, old, variants)
    torch.cuda.synchronize()
    run_cases(cases, [v for v in variants if v != "graph"], peak, result)
    del ep, w, cases, keep
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(7)
    plane = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, PLANE_SHAPE, dtype=np.int64)
        .astype(np.int32)).cuda()
    cols = torch.from_numpy(np.sort(rng.choice(
        PLANE_SHAPE[1], PLANE_WORDS, replace=False)).astype(np.int32)).cuda()
    cases = word_cols_cases(plane, cols, old, variants)
    if old is not None:
        rows, wc = plane.shape
        k = cols.numel()

        def tile_fn(t, b):
            out = torch.empty((k, rows), dtype=torch.int32, device="cuda")
            return lambda: (old._run("shape_word_cols_T", plane.device,
                                     plane.data_ptr(), wc, cols.data_ptr(),
                                     k, rows, t, b, out.data_ptr()), out)[1]
        shapes = {f"rows {t}, threads {b}": tile_fn(t, b)
                  for t, b in COLS_TILE_SWEEP}
        cases.append(Case("word_cols_T launch shapes", cases[0].shape,
                          cases[0].nbytes, shapes, cases[0].twin,
                          lambda out: out, lambda: None,
                          order=list(shapes)))
    run_cases(cases, [v for v in variants if v != "graph"], peak, result)


def library_cases(variants, old) -> list:
    """`word_cols_T` and `or_combine` on seeded random words at the main
    path's shapes, beside their library calls: `or_combine` as the 2 x 4
    mesh's all-reduce of one data shard (G = 4, against the pairwise
    chain in PyTorch calls) and at G = 2 (against one `bitwise_or_`,
    which writes one replica of the two), then its launch shapes at
    G = 4 (COMBINE_SHAPES)."""
    import ctypes

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference

    rng = np.random.default_rng(7)
    words32 = lambda shape: torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, shape, dtype=np.int64).astype(np.int32)).cuda()
    plane = words32(PLANE_SHAPE)
    cols = torch.from_numpy(np.sort(rng.choice(
        PLANE_SHAPE[1], PLANE_WORDS, replace=False)).astype(np.int32)).cuda()
    p0 = [words32(COMBINE_SHAPE) for _ in range(MESH_GRAPH)]
    parts = [t.clone() for t in p0]
    pair = parts[:2]
    numel = parts[0].numel()

    def reset():
        for t, u in zip(parts, p0):
            t.copy_(u)

    def shape_fn(per_thread, max_blocks):
        ptrs = (ctypes.c_void_p * len(parts))(*(t.data_ptr() for t in parts))
        return lambda: old._run("shape_or_combine", parts[0].device, ptrs,
                                numel, per_thread, max_blocks)

    fns4 = {"new": lambda: kernels.or_combine(parts),
            "library": lambda: cs.or_chain(parts)}
    fns2 = {"new": lambda: kernels.or_combine(pair),
            "library": lambda: pair[0].bitwise_or_(pair[1])}
    if old is not None:
        fns4["old"] = lambda: old.or_combine(parts)
        fns2["old"] = lambda: old.or_combine(pair)
    shapes = {f"chunks {u}, blocks {b or 'all'}": shape_fn(u, b)
              for u, b in COMBINE_SHAPES} if old is not None else {}
    cases = word_cols_cases(plane, cols, old, variants)[:1] + [
        Case("or_combine G=4", f"{MESH_GRAPH} x [{COMBINE_SHAPE[0]}, "
             f"{COMBINE_SHAPE[1]}]", 2 * MESH_GRAPH * numel * 4, fns4,
             lambda: reference.or_combine(parts), lambda out: parts, reset),
        # the result compared is replica 0's: bitwise_or_ writes no other
        Case("or_combine G=2", f"2 x [{COMBINE_SHAPE[0]}, "
             f"{COMBINE_SHAPE[1]}]", 2 * 2 * numel * 4, fns2,
             lambda: reference.or_combine(pair), lambda out: pair[0], reset),
        Case("or_combine G=4 launch shapes", f"{MESH_GRAPH} x "
             f"[{COMBINE_SHAPE[0]}, {COMBINE_SHAPE[1]}]",
             2 * MESH_GRAPH * numel * 4, shapes,
             lambda: reference.or_combine(parts), lambda out: parts, reset,
             order=list(shapes)),
    ]
    return [c for c in cases
            if c.order or any(v in variants for v in c.fns)]


def run_cases(cases, variants, peak, result: dict) -> None:
    """Hold each variant against the twin, then attribute it, in the
    order given and reversed."""
    import chip_smoke as cs
    for case in cases:
        order = case.order or variants
        order = order + order[::-1]
        case.reset()
        want = case.result(case.twin())
        want = [t.clone() for t in (want if isinstance(want, list)
                                    else [want])]
        readings = {}
        for v in order:
            if v not in case.fns:
                continue
            fn = case.fns[v]
            case.reset()
            got = case.result(fn())
            got = got if isinstance(got, list) else [got]
            err = max(cs._diff(a, b) for a, b in zip(got, want))
            if err:
                raise AssertionError(f"{case.name}: {v} differs from the "
                                     f"twin by {err}")
            readings.setdefault(v, []).append(
                cs.attribute(fn, capturable=case.capturable
                             and v != "graph"))
        row = {"shape": case.shape, "bound_ms": case.nbytes / peak * 1e3,
               "bytes": case.nbytes, "readings": readings, **case.extra}
        result["rows"][case.name] = row
        for v, rs in readings.items():
            log(f"{case.name} {v}: " + " | ".join(
                f"event {r['event_ms']:.6f} ms, device {r['device_ms']:.6f} "
                f"ms ({r['device_by']}, {r['launches']:g} launches), host "
                f"{r['host_us']:.2f} us, cold {r['cold_ms']:.6f} ms"
                for r in rs))
        log(f"{case.name}: {case.shape}; bound {row['bound_ms']:.6f} ms "
            f"over {case.nbytes} bytes")


def sweep_rows(args, variants, old, peak, result) -> None:
    """`--rows sweep`: multitenant-1m's staged sweep, the caveated
    deployment's Jacobi sweep, and the two library pairs (the mesh sweep
    is `--rows mesh`)."""
    import gc

    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    for label, kwargs, gen in (("mt", {}, "multitenant_1m"),
                               ("cav", cs.CAVEAT_WORKLOAD, "caveated_rbac")):
        ep, w = cs.load("cuda", kwargs, gen)
        g = ep.graph()
        rng = np.random.default_rng(cs.SEED)
        batch = [SubjectRef("user", w.subjects[i]) for i in
                 rng.choice(len(w.subjects), cs.LOOKUP_LANES, replace=False)]
        q_arr, _, _ = ep._encode_subjects(g, batch)
        n_words = len(q_arr) // 32
        q = torch.from_numpy(q_arr).cuda()
        tables = g.snapshot()
        cases = sweep_cases(label, g.kernel, tables, q, n_words, old,
                            variants)
        seg = None
        if label == "mt":
            more, seg = segment_cases(ep, w, batch, old, variants)
            cases += more
        torch.cuda.synchronize()
        run_cases(cases, variants, peak, result)
        del ep, w, g, cases, seg, tables
        gc.collect()
        torch.cuda.empty_cache()
    run_cases(library_cases(variants, old), variants, peak, result)


def churn_flush(ep, w, n_rounds: int):
    """Phase 9's first `n_rounds` rounds through the endpoint; returns the
    last round's pre-flush device tables and its (rows, vals) per table
    (main, aux), as the flush scattered them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import (
        RelationshipUpdate, SubjectRef, UpdateOp, parse_relationship)
    ops = {"touch": UpdateOp.TOUCH, "delete": UpdateOp.DELETE}
    plan = cs._churn_plan(w, n_rounds, cs.SEED + 9)
    readers = [SubjectRef("user", u) for u in w.subjects[:8]]

    async def commit(writes):
        for wr in writes:
            await ep.write_relationships(
                [RelationshipUpdate(ops[o], parse_relationship(r))
                 for o, r in wr])

    for r, rnd in enumerate(plan):
        g = ep.graph()
        prev_dev = g.snapshot()[:2]
        prev_host = (g.host_main.copy(), g.host_aux.copy())
        asyncio.run(commit(rnd["writes"]))
        asyncio.run(ep.lookup_resources_batch("pod", "view", readers))
        torch.cuda.synchronize()
    g = ep.graph()
    out = []
    for src, host_prev, host in zip(prev_dev, prev_host,
                                    (g.host_main, g.host_aux)):
        rows = np.nonzero((host != host_prev).any(axis=1))[0].astype(np.int32)
        out.append((src, torch.from_numpy(rows).to(src.device),
                    torch.from_numpy(np.ascontiguousarray(host[rows]))
                    .to(src.device)))
    return out


def staged_upload(device, *arrays) -> list:
    """int32 host arrays -> tensors on `device` in one transfer: packed
    into one pinned host buffer and copied asynchronously (torch's
    caching host allocator reuses the buffer once the copy has read it).
    Measured against the flush's two pageable copies and not taken into
    the flush (PERF.md §6)."""
    import numpy as np
    import torch
    arrs = [np.ascontiguousarray(a, np.int32) for a in arrays]
    sizes = [a.size for a in arrs]
    stage = torch.empty(sum(sizes), dtype=torch.int32, pin_memory=True)
    np.concatenate([a.ravel() for a in arrs], out=stage.numpy())
    flat = stage.to(device, non_blocking=True)
    return [t.view(a.shape) for t, a in zip(flat.split(sizes), arrs)]


def flush_host_us(work, staged: bool, reps: int = 50) -> float:
    """Median host µs of one flush of `work` ([(device table, host rows,
    host values)]): each table's rows and values sent to the card, then
    its `scatter_rows` launched.  `staged`: one pinned asynchronous copy
    a table (`staged_upload`); else the flush's two pageable copies
    (`_to_device`).  Synchronised between flushes, outside the timed
    span, as the read batches between flushes are."""
    import statistics

    import torch
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.ell import _to_device
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for table, rows, vals in work:
            if staged:
                kernels.scatter_rows(table, *staged_upload(table.device,
                                                           rows, vals))
            else:
                kernels.scatter_rows(table, _to_device(rows, table.device),
                                     _to_device(vals, table.device))
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def blocks_of(table, rows, vals, n_blocks: int):
    """The table cut into `n_blocks` row blocks (own tensors, padded with
    the last row to a multiple), with each block's share of the flush."""
    import torch
    n = table.shape[0]
    b = -(-n // n_blocks)
    pad = b * n_blocks - n
    full = torch.cat([table, table[-1:].expand(pad, -1)]) if pad else table
    work = []
    for gi in range(n_blocks):
        sel = (rows >= gi * b) & (rows < (gi + 1) * b)
        if not bool(sel.any()):
            continue
        blk = full[gi * b: (gi + 1) * b].clone()
        work.append((blk, (rows[sel] - gi * b).contiguous(),
                     vals[sel].contiguous()))
    return work


def copy_rows(args, variants, old, peak, result) -> None:
    """`--rows copy`: `lookup_T` and `scatter_rows` (rows 4c, 8, 11, 13)
    and the flush's host time, pageable against staged."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels
    from spicedb_kubeapi_proxy_tpu_torch.ops.kernels import reference
    from spicedb_kubeapi_proxy_tpu_torch.ops.torch_endpoint import bucket
    from spicedb_kubeapi_proxy_tpu_torch.spicedb.types import SubjectRef

    ep, w = cs.load("cuda", {})
    g = ep.graph()
    kc, prog = g.kernel, g.prog
    main_t, aux_t, _ = g.snapshot()
    rng = np.random.default_rng(cs.SEED)
    batch = [SubjectRef("user", w.subjects[i]) for i in
             rng.choice(len(w.subjects), cs.LOOKUP_LANES, replace=False)]
    q_arr, _, _ = ep._encode_subjects(g, batch)
    n_words = len(q_arr) // 32
    q = torch.from_numpy(q_arr).cuda()
    x, _ = kc.evaluate(q, n_words, main_t, aux_t, kc.take_arena(n_words))
    x = x.clone()
    x_pl = torch.cat([x, x], dim=1).contiguous()
    off, length = prog.slot_range("pod", "view")
    cap = bucket(max(len(prog.edge_src) * 2, 1))
    flush = churn_flush(ep, w, args.rounds)
    seg_rows = torch.from_numpy(np.sort(rng.choice(
        cap, SEG_POSITIONS, replace=False)).astype(np.int32)).cuda()
    seg = [(torch.from_numpy(rng.integers(0, 1 << 20, (cap, 1))
                             .astype(np.int32)).cuda(), seg_rows,
            torch.from_numpy(rng.integers(0, 1 << 20, (SEG_POSITIONS, 1))
                             .astype(np.int32)).cuda()) for _ in range(2)]
    mesh = [a for t in flush for a in blocks_of(*t, MESH_GRAPH)]
    sources = flush + seg + mesh
    kept = [s.clone() for s, _, _ in sources]
    torch.cuda.synchronize()

    impl = {"old": old, "new": kernels}

    def lookup_case(name, xx, words):
        lib = (lambda: xx.narrow(0, off, length).t().contiguous()) \
            if words == xx.shape[1] else \
            (lambda: xx.narrow(0, off, length)[:, :words].t().contiguous())
        fns = {v: (lambda m=m: m.lookup_T(xx, off, length, words))
               for v, m in impl.items() if v in variants}
        if "library" in variants:
            fns["library"] = lib
        return Case(name, f"[{words}, {length}] of [{xx.shape[0]}, "
                          f"{xx.shape[1]}]", 2 * length * words * 4, fns,
                    lambda: reference.lookup_T(xx, off, length, words),
                    lambda out: out, lambda: None)

    def scatter_case(name, work, shape):
        fns = {v: (lambda m=m: [m.scatter_rows(*a) for a in work])
               for v, m in impl.items() if v in variants}
        if "library" in variants:
            fns["library"] = lambda: [torch.index_put(s, (r.long(),), v)
                                      for s, r, v in work]
        return Case(name, shape,
                    sum(2 * s.numel() * 4 + r.numel() * 4 + v.numel() * 4
                        for s, r, v in work), fns,
                    lambda: [reference.scatter_rows(*a) for a in work],
                    lambda out: out, lambda: None)

    cases = [
        lookup_case("4c", x, n_words),
        lookup_case("4c_planes", x_pl, n_words),
        scatter_case("8", flush, "; ".join(
            f"[{s.shape[0]}, {s.shape[1]}] with {r.numel()} rows"
            for s, r, _ in flush)),
        scatter_case("11", seg, f"2 x [{cap}, 1] with {SEG_POSITIONS} "
                                f"positions"),
        scatter_case("13", mesh, "; ".join(
            f"[{s.shape[0]}, {s.shape[1]}] with {r.numel()} rows"
            for s, r, _ in mesh)),
    ]
    run_cases(cases, [v for v in variants if v != "graph"], peak, result)
    host_work = [(t, r.cpu().numpy(), v.cpu().numpy()) for t, r, v in flush]
    result["flush_host_us"] = {"pageable": [], "staged": []}
    for staged in (False, True, True, False):
        us = flush_host_us(host_work, staged)
        result["flush_host_us"]["staged" if staged else "pageable"].append(us)
    log("flush host µs (row 8's tables, median of 50): " + json.dumps(
        result["flush_host_us"]))
    if not all(torch.equal(s, s0) for (s, _, _), s0 in zip(sources, kept)):
        raise AssertionError("a scatter wrote its source table")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="sweep",
                    choices=("sweep", "copy", "edge", "mesh", "tail",
                             "all"))
    ap.add_argument("--variants", default="old,new,graph,library")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    peak = cs.hbm_peak(name)
    log(smi)
    t0 = time.perf_counter()
    kernels.build()
    kernels._load()
    variants = args.variants.split(",")
    # the mesh rows' first version is the package's kernels in the old
    # step (old_mesh_step), not OLD_SOURCE
    old = (OldKernels() if "old" in variants
           and args.rows not in ("mesh", "tail") else None)
    log(f"built in {time.perf_counter() - t0:.1f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line
                                     or "spill" in line):
            log("  " + line.strip())
    result = {"smi": smi, "device": name, "variants": variants, "rows": {}}
    if args.rows in ("sweep", "all"):
        sweep_rows(args, variants, old, peak, result)
    if args.rows in ("copy", "all"):
        copy_rows(args, variants, old, peak, result)
    if args.rows in ("edge", "all"):
        edge_rows(args, variants, old, peak, result)
    if args.rows in ("mesh", "all"):
        mesh_rows(args, variants, old, peak, result)
    if args.rows in ("tail", "all"):
        tail_rows(args, variants, peak, result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    for row in result["rows"].values():
        for rs in row["readings"].values():
            for r in rs:
                r.pop("device_names", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
