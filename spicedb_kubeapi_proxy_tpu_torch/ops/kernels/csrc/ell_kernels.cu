// Hand-written Hopper (sm_90a) kernels for the bit-packed ELL fixpoint
// sweep.  They replace the jitted JAX programs of the reference package
// (spicedb_kubeapi_proxy_tpu/ops/ell.py), which XLA lowered for the TPU:
//
//   ell_gather_or  <- make_ell_step.staged_step, gather part (ell.py:444-500)
//                     and the Jacobi step's aux + main gathers (ell.py:504-527)
//   cav_gather_or  <- the Jacobi step's idx_cav gather        (ell.py:528-536)
//   perm_program   <- _apply_perm_expr_packed, both planes    (ell.py:215-254)
//   sweep_delta    <- make_ell_evaluate.fixpoint test + trace (ell.py:613-631)
//   seed_bitplanes <- init_packed_state, both planes          (ell.py:556-584)
//                     + the steps' wildcard liveness          (ell.py:462-468)
//   check_gather   <- _pipe_fns.run_checks, definite          (ell.py:878-887)
//   check_gather3  <- _pipe_fns.run_checks, tri-state         (ell.py:853-865)
//   lookup_T       <- _pipe_fns.run_lookup, definite plane    (ell.py:867-895)
//   scatter_rows   <- _EllGraph.flush's `.at[rows].set`  (jax_endpoint.py:1004-1050)
//                     and _SegmentGraph.flush's edge scatter (jax_endpoint.py:690-704)
//   edge_or        <- the segment kernel's gather + segment_sum + `> 0`
//                     (spmv.py:130-134), on packed words
//   word_cols_T    <- the Leopard plane's word-column reads
//                     (jax_endpoint.py:2970-2977)
//   or_combine     <- the sharded segment kernel's `lax.pmax(y, "graph")`,
//                     its compute half (parallel/sharding.py:69); the peer
//                     partials reach the local device as plain copies
//
// State layout: x is int32 [NT, W] row-major (W packed words per row, bit
// b of word w = query column 32*w + b).  Words are handled as uint32
// inside the kernels, so bit 31 needs no special case.  On the tri-state
// (caveat) path a row is 2H words: words [0, H) are the definite plane,
// words [H, 2H) the maybe plane, and the kernels that read planes take H
// (`half`) and use 2H as the row stride.
//
// What bounds them on this card: every kernel here is a memory-bound
// streaming pass (a few integer ops per 4-byte word, far below the
// ~300 op/byte balance point of an H100).  The gathers read rows at data-
// dependent addresses; with W words per row a warp reads 32/W rows'
// worth of contiguous W-word segments, so their design is one thread per
// (row, word) — neighbouring threads on neighbouring words of a row, then
// of the next row — with no shared memory and no tensor cores.  Making
// them fast (row-per-warp gathers with 16-byte loads, fusing the range
// copy-back) is later work.  Two kernels are redesigned for the card:
// lookup_T, whose one-thread-per-output-word loads were strided (each
// 4-byte load cost a 32-byte sector, fetched again by every other word
// pass), is a tiled transpose through shared memory with 16-byte loads
// and stores; scatter_rows, a copy launch then a scatter launch that
// waited on it, is one launch whose blocks copy their span and then
// write the overrides inside it.  At the main path's sizes (6.4-8.7 MB)
// both run for a few microseconds, close to the cost of a launch, and
// the wrapper's host path per call is longer than either.
//
// Interface: plain C launchers taking raw device pointers and the CUDA
// stream, bound from Python with ctypes.  Each launcher returns the CUDA
// error code of its launches (0 on success); the Python wrapper raises on
// anything else.  No launcher synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kBlock = 256;
constexpr int kMaxStack = 16;   // perm_program operand stack (MAX_STACK in __init__.py)

inline unsigned int grid_for(long long n, int block, long long cap) {
    long long g = (n + block - 1) / block;
    if (g < 1) g = 1;
    if (g > cap) g = cap;
    return (unsigned int)g;
}

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
// x[idx[r, j], H + w].  `x` is the sweep's input state, a buffer other
// than `out`, so every read sees the previous sweep's values.  `out` may
// point at any row of the state (the wrapper's `dst_lo`): a mesh shard
// fills the maybe half of its own block of the caveat table's rows.
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

// out[0] += popcount(a ^ b) (mod 2^32), out[1] |= any(a != b)
__global__ void sweep_delta_kernel(const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b,
                                   long long n, uint32_t* __restrict__ out) {
    uint32_t cnt = 0, any = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < n; t += stride) {
        const uint32_t d = (uint32_t)(a[t] ^ b[t]);
        cnt += __popc(d);
        any |= d;
    }
    for (int o = 16; o > 0; o >>= 1) {
        cnt += __shfl_down_sync(0xffffffffu, cnt, o);
        any |= __shfl_down_sync(0xffffffffu, any, o);
    }
    if ((threadIdx.x & 31) == 0) {
        if (cnt) atomicAdd(out, cnt);
        if (any) atomicOr(out + 1, 1u);
    }
}

// x0[q[c], c / 32] |= 1 << (c % 32); and live[t, c / 32] |= the same bit
// when q[c] lies in wildcard term t's self range [lo_t, hi_t).  Self rows
// are static seeds (no edge ever targets a self slot), so this equals the
// reference's per-sweep OR over x's self rows.  With `planes` the rows
// are 2W words and the bit is set in both planes (a query subject is
// definite, hence also maybe), in x0 and in live alike.
__global__ void seed_kernel(const int32_t* __restrict__ q, int B, int W,
                            int planes,
                            const int32_t* __restrict__ wc_ranges, int n_wc,
                            uint32_t* __restrict__ x0,
                            uint32_t* __restrict__ live) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c < B) {
        const long long S = (long long)W * (1 + planes);
        const long long row = q[c];
        const uint32_t bit = 1u << (c & 31);
        atomicOr(x0 + row * S + (c >> 5), bit);
        if (planes) atomicOr(x0 + row * S + W + (c >> 5), bit);
        for (int t = 0; t < n_wc; ++t) {
            if (row >= wc_ranges[2 * t] && row < wc_ranges[2 * t + 1]) {
                atomicOr(live + (long long)t * S + (c >> 5), bit);
                if (planes) atomicOr(live + (long long)t * S + W + (c >> 5), bit);
            }
        }
    }
}

// out[g] = ((x[gi[g], gc[g] / 32] >> (gc[g] % 32)) & 1) * 2
__global__ void check_gather_kernel(const int32_t* __restrict__ x, int W,
                                    const int32_t* __restrict__ gi,
                                    const int32_t* __restrict__ gc,
                                    long long G, int32_t* __restrict__ out) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < G) {
        const int col = gc[g];
        const uint32_t word = (uint32_t)x[(long long)gi[g] * W + (col >> 5)];
        out[g] = (int32_t)(((word >> (col & 31)) & 1u) * 2u);
    }
}

// Tri-state check (rows of stride 2H): d and m are the bits of column
// gc[g] in row gi[g]'s definite and maybe planes; out[g] = d * 2 + (m & ~d):
// 2 = HAS, 1 = CONDITIONAL, 0 = NO.
__global__ void check_gather3_kernel(const int32_t* __restrict__ x, int H,
                                     const int32_t* __restrict__ gi,
                                     const int32_t* __restrict__ gc,
                                     long long G, int32_t* __restrict__ out) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (g < G) {
        const int col = gc[g];
        const int32_t* row = x + (long long)gi[g] * 2 * H + (col >> 5);
        const uint32_t d = ((uint32_t)row[0] >> (col & 31)) & 1u;
        const uint32_t m = ((uint32_t)row[H] >> (col & 31)) & 1u;
        out[g] = (int32_t)(d * 2u + (m & (d ^ 1u)));
    }
}

// lookup_T: out[w, l] = x[offset + l, w] for the first W words of rows
// of stride S (S = W, or 2W to read the definite plane of a tri-state
// row), as a tiled transpose through shared memory.
//
// A block owns a tile of T rows by wc words (blockIdx.x the rows,
// blockIdx.y the word chunk, wc <= 32, T * wc <= 2048 words).  It reads
// the tile row by row (neighbouring threads on neighbouring 16-byte words
// of a row, then of the next row), so each 32-byte sector of the state is
// fetched once, and writes it transposed into `tile` [wc][P].  After one
// barrier it stores each output row segment out[w, l0 : l0 + T] with
// 16-byte stores, neighbouring threads on neighbouring words.  The row
// pitch P = T + pad keeps the transposing writes free of bank conflicts
// and the rows 16-byte aligned for the reads: for wc a power of two up to
// 8 (256 lanes), pad = 32 / wc words (mod 32) puts the 32 lanes of a warp
// (32 / wc rows by wc words, or 16-byte words of them) on 32 distinct
// banks; wider chunks take pad 4 and 2- or 4-way conflicts.  Tile indices
// are 32-bit; the only 64-bit arithmetic is one multiply per loaded row.
//
// Ragged edges: the last tile is short (tl < T); a row start that is not
// 16-byte aligned (offset * S or S or wc not a multiple of 4, or a
// misaligned base) takes the 4-byte load path; an output row segment that
// does not start on a 16-byte boundary (L % 4 != 0) is stored as aligned
// 16-byte words covering it, the partial words at either end one by one.
// TMA (cp.async.bulk.tensor) would need a tensor map encoded on the host
// for every call (the state buffer and the slot range change per batch),
// a driver-API call on a path whose per-call host cost already exceeds
// the kernel's device time; the 16-byte loads already move each sector
// once.
constexpr int kLookupThreads = 256;
constexpr int kLookupTileWords = 2048;  // T * wc
constexpr int kLookupMaxChunk = 32;     // words of a row per block (wc)
constexpr int kLookupUnroll = 4;        // 16-byte loads in flight a thread

__global__ void __launch_bounds__(kLookupThreads)
lookup_T_kernel(const int32_t* __restrict__ x, int W, long long S,
                long long offset, long long L, int wc, int T, int P,
                int vec_load, int32_t* __restrict__ out) {
    extern __shared__ int4 tile_raw[];
    int32_t* tile = reinterpret_cast<int32_t*>(tile_raw);  // [wc][P]
    const long long l0 = (long long)blockIdx.x * T;
    const int w0 = blockIdx.y * wc;
    const int wn = min(wc, W - w0);
    const int tl = (int)min((long long)T, L - l0);
    const int tid = threadIdx.x;
    const int32_t* base = x + (offset + l0) * S + w0;

    if (vec_load && (wn & 3) == 0) {
        const int quads = wn >> 2;             // 16-byte words a row
        const int units = tl * quads;
        for (int u0 = tid; u0 < units;
             u0 += kLookupThreads * kLookupUnroll) {
            int4 v[kLookupUnroll];
#pragma unroll
            for (int i = 0; i < kLookupUnroll; ++i) {
                const int u = u0 + i * kLookupThreads;
                if (u < units) {
                    const int r = u / quads;
                    const int q = u - r * quads;
                    v[i] = __ldg(reinterpret_cast<const int4*>(
                                     base + (long long)r * S) + q);
                }
            }
#pragma unroll
            for (int i = 0; i < kLookupUnroll; ++i) {
                const int u = u0 + i * kLookupThreads;
                if (u < units) {
                    const int r = u / quads;
                    const int q = u - r * quads;
                    int32_t* d = tile + 4 * q * P + r;
                    d[0] = v[i].x;
                    d[P] = v[i].y;
                    d[2 * P] = v[i].z;
                    d[3 * P] = v[i].w;
                }
            }
        }
    } else {
        const int units = tl * wn;
        for (int u = tid; u < units; u += kLookupThreads) {
            const int r = u / wn;
            const int w = u - r * wn;
            tile[w * P + r] = __ldg(base + (long long)r * S + w);
        }
    }
    __syncthreads();

    // slot j of row w: the aligned 16-byte output word that starts 4j
    // words after the row segment's first word rounded down to 16 bytes
    // (`out` is 16-byte aligned)
    const int slots = (T >> 2) + 1;
    for (int e = tid; e < wn * slots; e += kLookupThreads) {
        const int w = e / slots;
        const int j = e - w * slots;
        const long long g0 = (long long)(w0 + w) * L + l0;
        const int m = (int)(g0 & 3);
        const int lo = 4 * j - m;              // tile column of the slot
        if (lo >= tl) continue;
        const int32_t* src = tile + w * P;
        int32_t* dst = out + (g0 - m) + 4 * j;
        if (lo >= 0 && lo + 4 <= tl) {
            int4 v;
            if (m == 0) {
                v = *reinterpret_cast<const int4*>(src + lo);
            } else {
                v = make_int4(src[lo], src[lo + 1], src[lo + 2], src[lo + 3]);
            }
            *reinterpret_cast<int4*>(dst) = v;
        } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int r = lo + c;
                if (r >= 0 && r < tl) dst[c] = src[r];
            }
        }
    }
}

// scatter_rows: out = src with out[rows[i], k] = vals[i, k] (rows
// outside [0, R) skipped), one launch.  Block i owns the words
// [i * kScatterSpan, (i + 1) * kScatterSpan) of the flat [R * K] table:
// it copies them (16-byte loads and stores when both pointers are 16-byte
// aligned, kScatterVec of them in flight a thread; 4-byte otherwise),
// then, after a barrier, writes every override word that falls in its
// span.  A row's overrides are thus ordered after the copy of that row
// by the block that owns it, with no second launch.  Each thread reads
// `rows` entries straight from global memory: every entry is read once
// per block, by one thread, so staging the list in shared memory would
// add a copy and a barrier without saving a read; the list (<= a few
// hundred rows a flush) stays in L2.  Equal rows must carry equal values
// (pad_scatter's padding): their writes then race to the same word with
// the same bits.  Bound by bytes: 2 * R * K * 4 of copy against
// b * (K + 1) * 4 of overrides.
constexpr int kScatterThreads = 256;
constexpr int kScatterVec = 4;
constexpr int kScatterSpan = kScatterThreads * kScatterVec * 4;  // words

__global__ void __launch_bounds__(kScatterThreads)
scatter_rows_kernel(const int32_t* __restrict__ src, long long R, int K,
                    const int32_t* __restrict__ rows, long long b,
                    const int32_t* __restrict__ vals, int vec,
                    int32_t* __restrict__ out) {
    const long long n = R * K;
    const long long e0 = (long long)blockIdx.x * kScatterSpan;
    const long long e1 = min(e0 + kScatterSpan, n);
    const int tid = threadIdx.x;
    if (vec) {
        const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src + e0);
        int4* __restrict__ o4 = reinterpret_cast<int4*>(out + e0);
        const int n4 = (int)((e1 - e0) >> 2);
        int4 v[kScatterVec];
#pragma unroll
        for (int i = 0; i < kScatterVec; ++i) {
            const int t = tid + i * kScatterThreads;
            if (t < n4) v[i] = __ldg(s4 + t);
        }
#pragma unroll
        for (int i = 0; i < kScatterVec; ++i) {
            const int t = tid + i * kScatterThreads;
            if (t < n4) o4[t] = v[i];
        }
        const long long e = e0 + 4LL * n4 + tid;   // the table's < 4 last words
        if (e < e1) out[e] = __ldg(src + e);
    } else {
        for (int t = tid; t < (int)(e1 - e0); t += kScatterThreads)
            out[e0 + t] = __ldg(src + e0 + t);
    }
    __syncthreads();
    const long long r_lo = e0 / K;               // rows meeting the span
    const long long r_hi = (e1 - 1) / K;
    for (long long i = tid; i < b; i += kScatterThreads) {
        const long long r = __ldg(rows + i);
        if (r < r_lo || r > r_hi || r >= R) continue;   // r_lo >= 0
        const long long rk = r * K;
        const int32_t* v = vals + i * K;
        const int k0 = (int)max(0LL, e0 - rk);
        const int k1 = (int)min((long long)K, e1 - rk);
        for (int k = k0; k < k1; ++k) out[rk + k] = __ldg(v + k);
    }
}

// Segment sweep, one thread per (edge, word): y[dst[e], w] |= x[src[e], w].
// `x` is the sweep's input and `y` another buffer (Jacobi).  The OR of the
// 0/1 values of a column equals the reference's `segment_sum(...) > 0`.
// A zero source word makes no atomic, so the padding edges (dead -> dead,
// the dead row is all zero) and freed positions cost one load each and
// never serialize on the dead row.  Words go through uint32_t so bit 31
// is an ordinary bit.
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

// out[k, r] = plane[r, words[k]] for r < R: the batch's distinct closure
// word columns, each made contiguous (one launch, one readback).
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

// dst[i] |= src[i] over n packed words: the OR-combine of one peer's
// partial one-step closure into the local one.  A streaming pass (two
// reads and one write per word, one OR), so it is bound by bytes: 16-byte
// words when both pointers are 16-byte aligned (`vec`), then the < 4
// trailing int32 one by one.
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

inline int last_error() { return (int)cudaGetLastError(); }

}  // namespace

EXPORT const char* ell_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Gather-OR a row range into `scratch`, then copy it to `dst` (rows of the
// state).  Out of place on purpose: the range's gathers must read the
// state as it stood before the range is written (reference ell.py:478-488).
EXPORT int ell_gather_or(const void* cur, const void* idx, int k,
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
    int e = last_error();
    if (e) return e;
    return (int)cudaMemcpyAsync(dst, scratch, (size_t)total * 4,
                                cudaMemcpyDeviceToDevice, s);
}

// `half` > 0: the tri-state program over rows of W = 2 * half words.
EXPORT int ell_perm_program(const void* cur, const void* code, int n_code,
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
        return last_error();
    }
    const long long total = length * W;
    perm_program_kernel<<<grid_for(total, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)cur, (const int32_t*)code, n_code, length, W,
        (const int32_t*)seed, (int32_t*)out);
    return last_error();
}

EXPORT int ell_cav_gather_or(const void* x, const void* idx, int k,
                             long long R, int half, void* out, void* stream) {
    if (R <= 0 || half <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long total = R * half;
    cav_gather_or_kernel<<<grid_for(total, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, (const int32_t*)idx, k, R, half, (int32_t*)out);
    return last_error();
}

// Zero the dead row of `x_new` (the step's last write, ell.py:500), then
// out = [popcount(x_new ^ x_old) mod 2^32, any(x_new != x_old)].
EXPORT int ell_sweep_delta(void* x_new, const void* x_old, long long nt,
                           int W, long long dead, void* out, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int e = (int)cudaMemsetAsync((int32_t*)x_new + dead * W, 0,
                                 (size_t)W * 4, s);
    if (e) return e;
    e = (int)cudaMemsetAsync(out, 0, 8, s);
    if (e) return e;
    const long long n = nt * W;
    sweep_delta_kernel<<<grid_for(n, kBlock, 132 * 16), kBlock, 0, s>>>(
        (const int32_t*)x_new, (const int32_t*)x_old, n, (uint32_t*)out);
    return last_error();
}

EXPORT int ell_seed_bitplanes(const void* q, int B, long long nt, int W,
                              int planes, long long dead,
                              const void* wc_ranges, int n_wc, void* x0,
                              void* live, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const long long S = (long long)W * (planes ? 2 : 1);
    int e = (int)cudaMemsetAsync(x0, 0, (size_t)nt * S * 4, s);
    if (e) return e;
    if (n_wc > 0) {
        e = (int)cudaMemsetAsync(live, 0, (size_t)n_wc * S * 4, s);
        if (e) return e;
    }
    if (B > 0) {
        seed_kernel<<<grid_for(B, kBlock, 1LL << 30), kBlock, 0, s>>>(
            (const int32_t*)q, B, W, planes ? 1 : 0,
            (const int32_t*)wc_ranges, n_wc, (uint32_t*)x0, (uint32_t*)live);
        e = last_error();
        if (e) return e;
    }
    return (int)cudaMemsetAsync((int32_t*)x0 + dead * S, 0, (size_t)S * 4, s);
}

EXPORT int ell_check_gather(const void* x, int W, const void* gi,
                            const void* gc, long long G, void* out,
                            void* stream) {
    if (G <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    check_gather_kernel<<<grid_for(G, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, W, (const int32_t*)gi, (const int32_t*)gc, G,
        (int32_t*)out);
    return last_error();
}

EXPORT int ell_check_gather3(const void* x, int half, const void* gi,
                             const void* gc, long long G, void* out,
                             void* stream) {
    if (G <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    check_gather3_kernel<<<grid_for(G, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, half, (const int32_t*)gi, (const int32_t*)gc, G,
        (int32_t*)out);
    return last_error();
}

EXPORT int ell_lookup_T(const void* x, int W, long long S, long long offset,
                        long long L, void* out, void* stream) {
    if (L <= 0 || W <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int wc = W < kLookupMaxChunk ? W : kLookupMaxChunk;
    int T = 1;
    while (2 * T * wc <= kLookupTileWords) T *= 2;
    T = T < 32 ? 32 : (T > 1024 ? 1024 : T);
    if ((uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
    const int pad = (wc & (wc - 1)) == 0 && wc <= 8 ? (32 / wc) % 32 : 4;
    const int P = T + pad;                      // a multiple of 4
    const int vec_load = S % 4 == 0 && wc % 4 == 0 &&
                         ((uintptr_t)x + (uintptr_t)(offset * S * 4)) % 16 == 0;
    const dim3 grid((unsigned int)((L + T - 1) / T),
                    (unsigned int)((W + wc - 1) / wc));
    lookup_T_kernel<<<grid, kLookupThreads, (size_t)wc * P * 4, s>>>(
        (const int32_t*)x, W, S, offset, L, wc, T, P, vec_load,
        (int32_t*)out);
    return last_error();
}

// Copy-on-write row scatter of one gather table (int32 [R, K]): `out` (a
// fresh buffer) = `src` with rows[i] replaced by vals[i, :].  `src` is
// only read, so a batch that captured it keeps sweeping the old table.
// One launch: the copy and the overrides, ordered inside each block.
EXPORT int ell_scatter_rows(const void* src, long long R, int K,
                            const void* rows, long long b, const void* vals,
                            void* out, int vec, void* stream) {
    const long long n = R * K;
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    scatter_rows_kernel<<<(unsigned int)((n + kScatterSpan - 1) / kScatterSpan),
                          kScatterThreads, 0, s>>>(
        (const int32_t*)src, R, K, (const int32_t*)rows, b,
        (const int32_t*)vals, vec, (int32_t*)out);
    return last_error();
}

EXPORT int ell_edge_or(const void* x, const void* src, const void* dst,
                       long long E, int W, void* y, void* stream) {
    if (E <= 0 || W <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    edge_or_kernel<<<grid_for(E * W, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const uint32_t*)x, (const int32_t*)src, (const int32_t*)dst, E, W,
        (uint32_t*)y);
    return last_error();
}

EXPORT int ell_word_cols_T(const void* plane, int Wc, const void* words,
                           int K, long long R, void* out, void* stream) {
    if (K <= 0 || R <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    word_cols_T_kernel<<<grid_for((long long)K * R, kBlock, 1LL << 30),
                         kBlock, 0, s>>>(
        (const int32_t*)plane, Wc, (const int32_t*)words, K, R,
        (int32_t*)out);
    return last_error();
}

EXPORT int ell_or_combine(void* dst, const void* src, long long n, int vec,
                          void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const long long work = vec ? (n >> 2) : n;
    or_combine_kernel<<<grid_for(work, kBlock, 132 * 32), kBlock, 0, s>>>(
        (int32_t*)dst, (const int32_t*)src, n, vec);
    return last_error();
}
