// Hand-written Hopper (sm_90a) kernels for the bit-packed ELL fixpoint
// sweep.  They replace the jitted JAX programs of the reference package
// (spicedb_kubeapi_proxy_tpu/ops/ell.py), which XLA lowered for the TPU:
//
//   ell_gather_or  <- make_ell_step.staged_step, gather part (ell.py:444-500)
//                     and the Jacobi step's aux + main gathers (ell.py:504-527)
//   cav_gather_or  <- the Jacobi step's idx_cav gather        (ell.py:528-536)
//   perm_program   <- _apply_perm_expr_packed, both planes    (ell.py:215-254)
//   sweep_delta    <- make_ell_evaluate.fixpoint test + trace (ell.py:613-631)
//   sweep_delta_checks
//                  <- the fixpoint test + trace and _pipe_fns.run_checks'
//                     gather (ell.py:613-631, 853-887) in one launch:
//                     the ELL sweep's tail (sweep_delta and the check
//                     gather fused, answers packed as ballot words)
//   seed_bitplanes <- init_packed_state, both planes          (ell.py:556-584)
//                     + the steps' wildcard liveness          (ell.py:462-468)
//   check_gather   <- _pipe_fns.run_checks, definite          (ell.py:878-887)
//   check_gather3  <- _pipe_fns.run_checks, tri-state         (ell.py:853-865)
//                     (on the ELL path both ride sweep_delta_checks; the
//                     standalone kernels serve the Leopard plane, the
//                     segment sweep and the mesh)
//   lookup_T       <- _pipe_fns.run_lookup, definite plane    (ell.py:867-895)
//   scatter_rows   <- _EllGraph.flush's `.at[rows].set`  (jax_endpoint.py:1004-1050)
//                     and _SegmentGraph.flush's edge scatter (jax_endpoint.py:690-704)
//   edge_or        <- the segment kernel's gather + segment_sum + `> 0`
//                     (spmv.py:130-134), on packed words
//   word_cols_T    <- the Leopard plane's word-column reads
//                     (jax_endpoint.py:2970-2977)
//   or_combine     <- the sharded segment kernel's `lax.pmax(y, "graph")`,
//                     its compute half (parallel/sharding.py:69): the OR
//                     all-reduce of a data shard's co-located replicas;
//                     peers on another card reach it as plain copies
//   mesh_gather_or, mesh_cav_gather_or, mesh_perm_program,
//   mesh_sweep_delta
//                  <- the sharded ELL sweep, ShardedEllKernel's step
//                     (parallel/sharding.py:474-552): each pass's gathers
//                     over every shard block on a card in one launch,
//                     written into every co-located replica (the tiled
//                     all_gathers between them), the permission ops and
//                     the convergence delta once a data shard a card
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
// dependent addresses; their first design was one thread per (row, word)
// — neighbouring threads on neighbouring words of a row, then of the next
// row — with no shared memory and no tensor cores, which the check and
// seed kernels keep.  Eight kernels are redesigned for the card: lookup_T, whose
// one-thread-per-output-word loads were strided (each 4-byte load cost a
// 32-byte sector, fetched again by every other word pass), is a tiled
// transpose through shared memory with 16-byte loads and stores;
// scatter_rows, a copy launch then a scatter launch that waited on it, is
// one launch whose blocks copy their span and then write the overrides
// inside it; ell_gather_or and perm_program work on 16-byte chunks of a
// row, read their indices or program once, and write the state in place
// wherever that is exact, which drops the scratch buffer and the copy
// back into the state that every launch paid; cav_gather_or is one
// thread a table row that skips the dead row's gathers, so it streams the
// table and gathers only where a caveat edge is; or_combine ORs all of a
// data shard's replicas in one pass and writes the result into each, in
// place of a launch and a copy per peer; edge_or takes four edges a
// thread, skips the dead row's edges and makes one atomic a destination
// run; word_cols_T stages whole plane rows in shared memory and writes
// each requested column as a coalesced segment.  The sharded sweep's
// kernels (mesh_*) replace per-shard launches that went through scratch,
// an input copy of every replica and block copies between replicas: no
// launch of a pass reads what the pass writes, so each writes its rows
// straight into every replica on its card.  At the main path's sizes each
// launch runs for microseconds, close to the cost of a launch, and the
// wrapper's host path per call is longer than most; the single-device
// sweep therefore replays its launches from a CUDA graph (ops/ell.py).
//
// Interface: plain C launchers taking raw device pointers and the CUDA
// stream, bound from Python with ctypes.  Each launcher returns the CUDA
// error code of its launches (0 on success); the Python wrapper raises on
// anything else.  No launcher synchronises or allocates.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kBlock = 256;
constexpr int kSMs = 132;       // streaming multiprocessors of an H100 SXM
constexpr int kMaxStack = 16;   // perm_program operand stack (MAX_STACK in __init__.py)

inline unsigned int grid_for(long long n, int block, long long cap) {
    long long g = (n + block - 1) / block;
    if (g < 1) g = 1;
    if (g > cap) g = cap;
    return (unsigned int)g;
}

// Chunks of one row: a thread of the gather and program kernels owns N
// consecutive words of a row, N = 4 (one 16-byte load and store; rows of
// W % 4 == 0 words, 16-byte aligned) or N = 1 (any W).  Chunk<V> gives
// the loads, stores and bitwise ops for either, so both kernels are
// written once.
template <typename V> struct Chunk;

template <> struct Chunk<uint32_t> {
    static constexpr int N = 1;
    static __device__ __forceinline__ uint32_t ld(const int32_t* p) {
        return (uint32_t)*p;
    }
    static __device__ __forceinline__ void st(int32_t* p, uint32_t v) {
        *p = (int32_t)v;
    }
    static __device__ __forceinline__ uint32_t zero() { return 0u; }
    static __device__ __forceinline__ uint32_t ones() { return ~0u; }
    static __device__ __forceinline__ uint32_t or_(uint32_t a, uint32_t b) {
        return a | b;
    }
    static __device__ __forceinline__ uint32_t and_(uint32_t a, uint32_t b) {
        return a & b;
    }
    static __device__ __forceinline__ uint32_t andn(uint32_t a, uint32_t b) {
        return a & ~b;
    }
    static __device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) {
        return __shfl_xor_sync(0xffffffffu, v, m);
    }
    static __device__ __forceinline__ uint32_t shfl_down(uint32_t v, int d) {
        return __shfl_down_sync(0xffffffffu, v, d);
    }
    static __device__ __forceinline__ bool any(uint32_t v) { return v != 0u; }
};

template <> struct Chunk<uint4> {
    static constexpr int N = 4;
    static __device__ __forceinline__ uint4 ld(const int32_t* p) {
        return *reinterpret_cast<const uint4*>(p);
    }
    static __device__ __forceinline__ void st(int32_t* p, uint4 v) {
        *reinterpret_cast<uint4*>(p) = v;
    }
    static __device__ __forceinline__ uint4 zero() {
        return make_uint4(0u, 0u, 0u, 0u);
    }
    static __device__ __forceinline__ uint4 ones() {
        return make_uint4(~0u, ~0u, ~0u, ~0u);
    }
    static __device__ __forceinline__ uint4 or_(uint4 a, uint4 b) {
        return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
    }
    static __device__ __forceinline__ uint4 and_(uint4 a, uint4 b) {
        return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
    }
    static __device__ __forceinline__ uint4 andn(uint4 a, uint4 b) {
        return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
    }
    static __device__ __forceinline__ uint4 shfl_xor(uint4 v, int m) {
        return make_uint4(__shfl_xor_sync(0xffffffffu, v.x, m),
                          __shfl_xor_sync(0xffffffffu, v.y, m),
                          __shfl_xor_sync(0xffffffffu, v.z, m),
                          __shfl_xor_sync(0xffffffffu, v.w, m));
    }
    static __device__ __forceinline__ uint4 shfl_down(uint4 v, int d) {
        return make_uint4(__shfl_down_sync(0xffffffffu, v.x, d),
                          __shfl_down_sync(0xffffffffu, v.y, d),
                          __shfl_down_sync(0xffffffffu, v.z, d),
                          __shfl_down_sync(0xffffffffu, v.w, d));
    }
    static __device__ __forceinline__ bool any(uint4 v) {
        return (v.x | v.y | v.z | v.w) != 0u;
    }
};

// ell_gather_or: out[r] = OR_j src(idx[r, j]) | seed[r] | OR over the set
// bits t of wc_bits[r] of wc_live[t], where src(s) is row s of x_in when
// s lies in [in_lo, in_lo + in_span) and row s of cur otherwise.
//
// One thread per (row, chunk, part): the C = W / N chunks of a row sit
// side by side, so a warp's gathers of one index read 32 / C rows'
// contiguous 16-byte words.  A row of K >= 16 indices (the aux tables,
// K = 32) is split over P = 4 neighbouring lanes, each gathering K / P of
// them, and the partial ORs meet by warp shuffles: two threads a row with
// 32 gathers each left an aux table of 6,333 rows only ~12,700 threads
// and a long chain of round trips a thread.  Each thread reads its share
// of the row's indices once (16-, 8- or 4-byte loads, `iv` indices a
// load), which the first version re-read for every word of the row, and
// issues all its gathers before it needs any.  Launches of fewer threads
// than two full waves take blocks of 64, not 256, so that every SM gets
// some.
//
// Where it writes (the wrapper's choice, see ops/kernels/__init__.py):
// `out` is either a scratch buffer that the launcher copies into the
// state afterwards (the range may read its own rows: every read must see
// the state as it stood before the write), or the destination rows
// themselves.  Writing the state directly is exact when no gather reads a
// row of the output range (the plan proves it from the host table), or
// when those reads are redirected to x_in, a buffer equal to the state on
// those rows (the Jacobi step's sweep input, in_span = the range).  No
// thread then reads a word that another thread writes.
//
// Bound by bytes: the distinct gathered rows, the index rows, the seed
// rows and the written rows, once each.  Half the main table's index
// slots hold the dead row, whose word stays in L1; the copy-back the
// scratch path adds (a read and a write of every output row) is what
// writing in place saves.
//
// The body is `gather_rows`, written once over where rows come from
// (`Src`) and where output chunks go (`Out`): `StateSrc` and `OneOut` for
// this kernel, `SplitSrc` and `DstList` for mesh_gather_or below.
constexpr int kMeshDsts = 16;   // MESH_DSTS: replicas a mesh launch writes
constexpr int kMeshJobs = 16;   // MESH_JOBS: shard blocks a mesh launch

// Rows of `cur`, those in [in_lo, in_lo + in_span) read from `x_in`.
struct StateSrc {
    const int32_t* cur;
    const int32_t* x_in;
    long long in_lo;
    unsigned long long in_span;
    __device__ __forceinline__ const int32_t* row(int s, int W) const {
        return ((unsigned long long)(s - in_lo) < in_span ? x_in : cur) +
               (long long)s * W;
    }
};

// Rows [0, split) of `lo`, and row s >= split as row s - split of `hi`.
struct SplitSrc {
    const int32_t* lo;
    const int32_t* hi;
    int split;
    __device__ __forceinline__ const int32_t* row(int s, int W) const {
        return s < split ? lo + (long long)s * W
                         : hi + (long long)(s - split) * W;
    }
};

// One output: chunk `o` (a word offset) stored at p + o, or ORed into it.
struct OneOut {
    int32_t* p;
    template <typename V>
    __device__ __forceinline__ void st(long long o, V v) const {
        Chunk<V>::st(p + o, v);
    }
    template <typename V>
    __device__ __forceinline__ void or_st(long long o, V v) const {
        Chunk<V>::st(p + o, Chunk<V>::or_(Chunk<V>::ld(p + o), v));
    }
};

// The same chunk into each of n outputs: the co-located replicas of one
// data shard, each pointer at the same row of its replica.
struct DstList {
    int32_t* p[kMeshDsts];
    int n;
    template <typename V>
    __device__ __forceinline__ void st(long long o, V v) const {
        for (int q = 0; q < n; ++q) Chunk<V>::st(p[q] + o, v);
    }
    template <typename V>
    __device__ __forceinline__ void or_st(long long o, V v) const {
        for (int q = 0; q < n; ++q)
            Chunk<V>::st(p[q] + o, Chunk<V>::or_(Chunk<V>::ld(p[q] + o), v));
    }
};

template <typename V, int P, typename Src, typename Out>
__device__ __forceinline__ void
gather_rows(const Src& src, const int32_t* __restrict__ idx, int k, int iv,
            long long nrows, int W, const int32_t* __restrict__ seed,
            const int32_t* __restrict__ wc_bits,
            const int32_t* __restrict__ wc_live, const Out& out) {
    using C = Chunk<V>;
    const int chunks = W / C::N;
    const int kp = k / P;
    const long long total = nrows * chunks * P;
    // 32-bit thread-index arithmetic when the launch fits (a 64-bit
    // division per thread costs as much as the gathers of a short row)
    const bool narrow = total <= 0x7fffffffLL;
    const long long stride = (long long)gridDim.x * blockDim.x;
    // the loop runs the same trips in every lane of a block (its bound
    // moves with the block's base), so the shuffles see whole warps
    for (long long base = (long long)blockIdx.x * blockDim.x; base < total;
         base += stride) {
        const long long t = base + threadIdx.x;
        const bool active = t < total;
        const long long tt = active ? t : 0;
        const int part = (int)(tt % P);
        long long r;
        int c;
        if (narrow) {
            const unsigned int u = (unsigned int)tt / P;    // (row, chunk)
            const unsigned int ru = u / (unsigned int)chunks;
            r = ru;
            c = (int)(u - ru * (unsigned int)chunks) * C::N;
        } else {
            const long long u = tt / P;
            r = u / chunks;
            c = (int)(u - r * chunks) * C::N;
        }
        auto row = [&](int s) -> V { return C::ld(src.row(s, W) + c); };
        V v = C::zero();
        if (active) {
            const int32_t* ir = idx + r * k + part * kp;
            if (iv == 4) {
#pragma unroll 8
                for (int j = 0; j < kp; j += 4) {
                    const int4 s =
                        __ldg(reinterpret_cast<const int4*>(ir + j));
                    const V a = row(s.x), b = row(s.y), d = row(s.z),
                            e = row(s.w);
                    v = C::or_(v, C::or_(C::or_(a, b), C::or_(d, e)));
                }
            } else if (iv == 2) {
                for (int j = 0; j < kp; j += 2) {
                    const int2 s =
                        __ldg(reinterpret_cast<const int2*>(ir + j));
                    const V a = row(s.x), b = row(s.y);
                    v = C::or_(v, C::or_(a, b));
                }
            } else {
                for (int j = 0; j < kp; ++j) v = C::or_(v, row(__ldg(ir + j)));
            }
        }
#pragma unroll
        for (int m = 1; m < P; m <<= 1) v = C::or_(v, C::shfl_xor(v, m));
        if (!active || part != 0) continue;
        if (seed != nullptr) v = C::or_(v, C::ld(seed + r * W + c));
        if (wc_bits != nullptr) {
            uint32_t b = (uint32_t)__ldg(wc_bits + r);
            while (b) {
                const int term = __ffs(b) - 1;
                b &= b - 1;
                v = C::or_(v, C::ld(wc_live + (long long)term * W + c));
            }
        }
        out.st(r * W + c, v);
    }
}

template <typename V, int P>
__global__ void __launch_bounds__(kBlock)
gather_or_kernel(const int32_t* cur, const int32_t* x_in, long long in_lo,
                 unsigned long long in_span,
                 const int32_t* __restrict__ idx, int k, int iv,
                 long long nrows, int W, const int32_t* __restrict__ seed,
                 const int32_t* __restrict__ wc_bits,
                 const int32_t* __restrict__ wc_live, int32_t* out) {
    gather_rows<V, P>(StateSrc{cur, x_in, in_lo, in_span}, idx, k, iv, nrows,
                      W, seed, wc_bits, wc_live, OneOut{out});
}

// mesh_gather_or: the gathers of one pass of the sharded ELL sweep
// (parallel/sharding.py ShardedEllKernel.step) for every shard block on
// one card, in one launch: block job j = blockIdx.y computes its table
// block's rows as gather_or_kernel does, reading rows [0, split) from
// `lo` and the rows past `split` from `hi` (the sweep's input, or the
// previous aux pass's output), and writes each output chunk into every
// co-located replica of its data shard (`out`): the all_gather between
// replicas on one card is those writes, not copies.  The jobs are passed
// by value (as or_combine's Parts) and read from the constant bank.
// No destination overlaps a source of the launch (the wrapper checks), so
// no thread reads a word that another writes.  Bound by bytes: each
// distinct table block and source row once a card, each replica's output
// rows once.
struct GatherJob {
    const int32_t* idx;       // [nrows, k] table block
    const int32_t* lo;
    const int32_t* hi;
    const int32_t* seed;      // [nrows, W] or null
    const int32_t* wc_bits;   // [nrows] or null
    const int32_t* wc_live;   // [terms, W] or null
    DstList out;
};
struct GatherJobs {
    GatherJob j[kMeshJobs];
};

template <typename V, int P>
__global__ void __launch_bounds__(kBlock)
mesh_gather_or_kernel(const __grid_constant__ GatherJobs jobs, int split,
                      int k, int iv, long long nrows, int W) {
    const GatherJob& j = jobs.j[blockIdx.y];
    gather_rows<V, P>(SplitSrc{j.lo, j.hi, split}, j.idx, k, iv, nrows, W,
                      j.seed, j.wc_bits, j.wc_live, j.out);
}

// S stack slots of chunks as named members (head, then the tail's), not
// an array: every access is to a member, so the compiler keeps all of
// them in registers whatever the index (a run-time index becomes a chain
// of selects over the S slots); an array indexed in a loop went to a
// local-memory stack frame.
template <typename V, int S> struct Slots {
    V head;
    Slots<V, S - 1> tail;
    __device__ __forceinline__ V get(int i) const {
        return i == 0 ? head : tail.get(i - 1);
    }
    __device__ __forceinline__ void set(int i, V v) {
        if (i == 0) {
            head = v;
        } else {
            tail.set(i - 1, v);
        }
    }
};

template <typename V> struct Slots<V, 0> {
    __device__ __forceinline__ V get(int) const { return Chunk<V>::zero(); }
    __device__ __forceinline__ void set(int, V) {}
};

// perm_program: a postfix program over slot slices, two int32 per
// instruction:
//   0 READ offset   push cur[offset + i]
//   1 ZERO -        push 0
//   2 OR   n        pop n, push their OR
//   3 AND  n        pop n, push their AND
//   4 ANDNOT -      pop b, pop a, push a & ~b
// out[i] = result | seed[i].  With PLANES the rows are definite/maybe
// pairs of stride W = 2H: a thread owns chunk c of both planes and a stack
// of pairs; OR and AND act on each plane, ANDNOT mixes them (Kleene
// exclusion): def(a - b) = def(a) & ~maybe(b), maybe(a - b) = maybe(a) &
// ~def(b).
//
// Design.  One thread per (row, chunk), the chunks of a row side by side.
// Each block copies the program into shared memory once (`prog`), so the
// interpreter's instruction reads cost no global loads.  The operand
// stack is S register slots (`Slots`); S is 4 for programs at most 4 deep
// (the plans of every schema here) and 16 (kMaxStack) otherwise, and a
// plane program deeper than 4 runs on 4-byte chunks.  `nvcc -Xptxas -v`
// on sm_90a: no stack frame and no spill for every S = 4 variant (32-70
// registers) and the definite S = 16 ones (48 and 142); 12 bytes of spill
// for the 4-byte plane S = 16 one (80); 16-byte plane pairs at S = 16
// took 255 registers and spilled 504 bytes, hence the 4-byte path; the
// stack as an array indexed in unrolled loops sat in a local-memory
// frame (32-512 bytes).  A run of READs issues all its loads before any
// is used.  `out` may be the
// output rows of `cur` (the single-device plan always writes in place):
// slots of one type are disjoint row ranges of one length, so a READ of
// another slot never reaches the output range, and a READ of the output
// slot itself reads only the word its own thread writes, before writing
// it.  Bound by bytes: the rows each READ reads, the seed rows and the
// written rows.
//
// `Out` is where the result rows go: `OneOut`, or (mesh_perm_program) a
// `DstList` of the data shard's co-located replicas, each at the slot's
// first row; `cur` is one of them, so every replica gets the program of
// that one, which the sharded sweep keeps equal to the others.
template <typename V, int S, bool PLANES, typename Out>
__global__ void __launch_bounds__(kBlock)
perm_program_kernel(const int32_t* cur, const int32_t* __restrict__ code,
                    int n_ins, long long length, int W, int H,
                    const int32_t* __restrict__ seed,
                    const __grid_constant__ Out out) {
    using C = Chunk<V>;
    extern __shared__ int2 prog[];
    for (int p = threadIdx.x; p < n_ins; p += blockDim.x)
        prog[p] = make_int2(__ldg(code + 2 * p), __ldg(code + 2 * p + 1));
    __syncthreads();
    const int chunks = H / C::N;
    const long long total = length * chunks;
    const bool narrow = total <= 0x7fffffffLL;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        long long i;
        int c;
        if (narrow) {
            const unsigned int iu = (unsigned int)t / (unsigned int)chunks;
            i = iu;
            c = (int)((unsigned int)t - iu * (unsigned int)chunks) * C::N;
        } else {
            i = t / chunks;
            c = (int)(t - i * chunks) * C::N;
        }
        Slots<V, S> sd, sm;
        int sp = 0;
        for (int pc = 0; pc < n_ins;) {
            const int op = prog[pc].x;
            if (op == 0) {
                int m = 1;
                while (pc + m < n_ins && prog[pc + m].x == 0) ++m;
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    if (j >= sp && j < sp + m) {
                        const int32_t* r =
                            cur + ((long long)prog[pc + j - sp].y + i) * W + c;
                        sd.set(j, C::ld(r));
                        if constexpr (PLANES) sm.set(j, C::ld(r + H));
                    }
                }
                sp += m;
                pc += m;
                continue;
            }
            if (op == 1) {
                sd.set(sp, C::zero());
                if constexpr (PLANES) sm.set(sp, C::zero());
                ++sp;
            } else if (op == 2 || op == 3) {
                const int lo = sp - prog[pc].y;
                V d = op == 2 ? C::zero() : C::ones();
                V m = d;
#pragma unroll
                for (int j = 0; j < S; ++j) {
                    if (j >= lo && j < sp) {
                        d = op == 2 ? C::or_(d, sd.get(j))
                                    : C::and_(d, sd.get(j));
                        if constexpr (PLANES)
                            m = op == 2 ? C::or_(m, sm.get(j))
                                        : C::and_(m, sm.get(j));
                    }
                }
                sd.set(lo, d);
                if constexpr (PLANES) sm.set(lo, m);
                sp = lo + 1;
            } else {
                const V ad = sd.get(sp - 2), bd = sd.get(sp - 1);
                if constexpr (PLANES) {
                    const V am = sm.get(sp - 2), bm = sm.get(sp - 1);
                    sd.set(sp - 2, C::andn(ad, bm));
                    sm.set(sp - 2, C::andn(am, bd));
                } else {
                    sd.set(sp - 2, C::andn(ad, bd));
                }
                --sp;
            }
            ++pc;
        }
        const long long o = i * W + c;
        out.st(o, C::or_(sd.head, C::ld(seed + o)));
        if constexpr (PLANES) out.st(o + H, C::or_(sm.head, C::ld(seed + o + H)));
    }
}

// cav_gather_or: the maybe plane of rows [0, R) (stride 2H): out[r, H +
// w] |= OR_j x[idx[r, j], H + w].  `x` is the sweep's input state, a
// buffer other than `out`, so every read sees the previous sweep's
// values.  `out` may point at any row of the state (the wrapper's
// `dst_lo`): a mesh shard fills the maybe half of its own block of the
// caveat table's rows.
//
// Design.  One thread per table row.  It reads the row's kCav = 8
// indices once (two 16-byte loads, so a warp reads 32 rows x 32 bytes of
// the table, contiguous) and skips every index equal to `dead`, the dead
// row, wherever it sits in the row: a caveated delete leaves holes
// mid-row.  The dead row of `x` is zero (sweep_delta and the seed zero
// it), so a skipped gather would OR in nothing.  Only the destinations
// of undecidable caveat edges and the caveat OR-tree nodes hold a live
// index, so nearly every thread ends after its index loads and the launch
// is a streaming read of the table.  A live row gathers each live
// source's maybe half in chunks (Chunk<V>: 16 bytes when H % 4 == 0 and
// the rows are 16-byte aligned, else 4), ORs them in registers and does
// one read-modify-write of its own maybe chunk, only when the OR is not
// zero.  No thread writes a word that another thread reads.  Row and
// index arithmetic is 32-bit where R * kCav < 2^31 (`I`); there is no
// division.  Two or four rows a thread, their index loads issued
// together, read slower on an H100 (scripts/torch_kernel_ab.py, PERF.md
// row 5).  The first design ran one thread per (row, word), with a
// 64-bit division each, re-read the row's indices for every word and
// gathered the dead row for every padding slot.  Bound by bytes: the
// table, once; the live rows' distinct sources and their maybe chunks
// are a few hundred KB at the caveated deployment's size.
constexpr int kCav = 8;  // the caveat table's width (ops/ell.py K_CAV)

template <typename V, typename I, typename Out>
__device__ __forceinline__ void cav_rows(const int32_t* __restrict__ x,
                                         const int32_t* __restrict__ idx,
                                         I R, int H, int dead,
                                         const Out& out) {
    using C = Chunk<V>;
    const long long S = 2LL * H;
    const I stride = (I)gridDim.x * blockDim.x;
    for (I r = (I)blockIdx.x * blockDim.x + threadIdx.x; r < R;
         r += stride) {
        const int4* ir = reinterpret_cast<const int4*>(idx + r * (I)kCav);
        const int4 a = __ldg(ir), b = __ldg(ir + 1);
        const int s[kCav] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        unsigned int live = 0;
#pragma unroll
        for (int j = 0; j < kCav; ++j)
            live |= (s[j] != dead ? 1u : 0u) << j;
        if (!live) continue;
        const long long o = (long long)r * S + H;
        for (int c = 0; c < H; c += C::N) {
            V v = C::zero();
#pragma unroll
            for (int j = 0; j < kCav; ++j) {
                if (live >> j & 1u)
                    v = C::or_(v, C::ld(x + (long long)s[j] * S + H + c));
            }
            if (C::any(v)) out.or_st(o + c, v);
        }
    }
}

template <typename V, typename I>
__global__ void __launch_bounds__(kBlock)
cav_gather_or_kernel(const int32_t* __restrict__ x,
                     const int32_t* __restrict__ idx, I R, int H, int dead,
                     int32_t* __restrict__ out) {
    cav_rows<V, I>(x, idx, R, H, dead, OneOut{out});
}

// mesh_cav_gather_or: the caveat gathers of one sharded sweep for every
// shard block on one card, in one launch (block job j = blockIdx.y):
// cav_gather_or's rows over the job's caveat table block, each nonzero OR
// read-modify-written into the maybe chunk of every co-located replica of
// its data shard (`out`, each pointer at the block's first row).  `x` is
// the sweep's input; no replica is a source.  Bound by bytes: each
// distinct table block once a card, and the live rows' sources and
// maybe chunks in each replica.
struct CavJob {
    const int32_t* idx;       // [R, kCav] table block
    const int32_t* x;         // the sweep's input state
    DstList out;
};
struct CavJobs {
    CavJob j[kMeshJobs];
};

template <typename V, typename I>
__global__ void __launch_bounds__(kBlock)
mesh_cav_gather_or_kernel(const __grid_constant__ CavJobs jobs, I R, int H,
                          int dead) {
    const CavJob& j = jobs.j[blockIdx.y];
    cav_rows<V, I>(j.x, j.idx, R, H, dead, j.out);
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

// sweep_delta_checks: sweep_delta and the batch's check gather in one
// launch, the tail of every ELL sweep (ops/ell.py `_sweep`).  It replaces
// sweep_delta, then check_gather or check_gather3, launched one after the
// other and each followed by its own copy to the host: the reference
// computes the gather inside the jitted program of its fixpoint
// (_pipe_fns.run_checks, ell.py:853-887), one dispatch and one result.
//
// Part (a) is sweep_delta, into pair `slot` of out[0..3]:
// out[2 slot] += popcount(a ^ b) (mod 2^32), out[2 slot + 1] |= any(a !=
// b), with the dead row's words [dead_lo, dead_lo + S) of `a` read as
// zero (and zeroed in memory, `dead_words`, at the end); the other pair is
// zeroed for the next sweep, which takes it (the fixpoint alternates
// slots, and each batch's seed zeroes both), so the launch needs no
// memset.  Part (b) gathers the batch's G check slots from `a`, the
// sweep's output (a slot on the dead row reads zero).  `tail` holds the
// batch on the card: tail[0] = G (clamped to [0, 32 nw]), tail[1]
// unused, then (gi, gc) pairs from tail[2]; the host writes it once a
// batch, so one captured graph serves every batch.  A warp owns 32
// consecutive slots and packs their bits with __ballot_sync into one
// answer word: out[4 + w] the definite bits; with PLANES (rows of stride
// S = 2H) also out[4 + nw + w] the bits of maybe & ~definite
// (CONDITIONAL).  Every answer word is written, zero past G.  Every sweep
// runs the gather, since the last one is known only after its readback:
// the answers of the last sweep are those of the fixpoint.
//
// What bounds it: bytes, as sweep_delta (a and b once) plus 8 bytes of
// tail a slot, one word (two with planes) a distinct gathered row word
// and the answer words; at the main path's sizes the launch.  The design
// removes the check's own launch and its second copy to the host, and
// sweep_delta's two memsets: the launcher issues the kernel and then the
// copy of out[] to the host, inside the sweep's graph.
template <bool PLANES>
__global__ void sweep_delta_checks_kernel(const int32_t* __restrict__ a,
                                          const int32_t* __restrict__ b,
                                          long long n, long long dead_lo,
                                          int S, int H,
                                          const int32_t* __restrict__ tail,
                                          int nw, int slot,
                                          uint32_t* __restrict__ out,
                                          int32_t* dead_words) {
    uint32_t cnt = 0, any = 0;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    // the loop only reads `a` (read-only loads, no store to order them
    // against); the dead row's words count as zero, and the first S
    // threads zero them in memory at the end
    for (long long t = tid; t < n; t += stride) {
        uint32_t v = (uint32_t)a[t];
        if ((unsigned long long)(t - dead_lo) < (unsigned)S) v = 0u;
        const uint32_t d = v ^ (uint32_t)b[t];
        cnt += __popc(d);
        any |= d;
    }
    for (int o = 16; o > 0; o >>= 1) {
        cnt += __shfl_down_sync(0xffffffffu, cnt, o);
        any |= __shfl_down_sync(0xffffffffu, any, o);
    }
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
        if (cnt) atomicAdd(out + 2 * slot, cnt);
        if (any) atomicOr(out + 2 * slot + 1, 1u);
    }
    if (tid == 0) {
        out[2 - 2 * slot] = 0u;
        out[3 - 2 * slot] = 0u;
    }
    const int G = min(max(tail[0], 0), 32 * nw);
    const int2* pairs = reinterpret_cast<const int2*>(tail + 2);
    const long long dead_row = dead_lo / S;
    // warp-uniform loop (blockDim is a multiple of 32): every lane of a
    // warp takes the same words, so the ballots see the full warp
    for (long long w = tid >> 5; w < nw; w += stride >> 5) {
        const int s = (int)w * 32 + lane;
        uint32_t d = 0u, m = 0u;
        if (s < G) {
            const int2 p = pairs[s];
            if (p.x != dead_row) {
                const int32_t* row = a + (long long)p.x * S + (p.y >> 5);
                d = ((uint32_t)row[0] >> (p.y & 31)) & 1u;
                if (PLANES) m = ((uint32_t)row[H] >> (p.y & 31)) & 1u;
            }
        }
        const uint32_t dw = __ballot_sync(0xffffffffu, d);
        if (PLANES) {
            const uint32_t mw = __ballot_sync(0xffffffffu, m & (d ^ 1u));
            if (lane == 0) out[4 + nw + w] = mw;
        }
        if (lane == 0) out[4 + w] = dw;
    }
    if (tid < S) dead_words[tid] = 0;
}

// mesh_sweep_delta: sweep_delta for one data shard's co-located
// replicas in one launch: out[0] += popcount(a ^ b), out[1] |= any(a !=
// b), with the dead row's words [dead_lo, dead_lo + W) of `a` read as
// zero, and that row zeroed in every replica of `dsts` (`a` among them)
// by the threads that read it.  `out` is zeroed by the caller once a
// batch (a slot a sweep), so the launch has no memset.  Bound by bytes:
// a and b once, the dead row of each replica.
__global__ void mesh_sweep_delta_kernel(const int32_t* a,
                                        const int32_t* __restrict__ b,
                                        long long n, long long dead_lo,
                                        int W, const __grid_constant__
                                        DstList dsts,
                                        uint32_t* __restrict__ out) {
    uint32_t cnt = 0, any = 0;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < n; t += stride) {
        const bool dead = (unsigned long long)(t - dead_lo) < (unsigned)W;
        const uint32_t d = (dead ? 0u : (uint32_t)a[t]) ^ (uint32_t)b[t];
        if (dead)
            for (int q = 0; q < dsts.n; ++q) dsts.p[q][t] = 0;
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

// edge_or: y[dst[e], :] |= x[src[e], :] for every edge e, `x` the
// sweep's input and `y` another buffer (Jacobi).  The OR of a column's 0/1
// values equals the reference's `segment_sum(x[src], dst) > 0`.
//
// Design.  A thread takes kEdgesPer = 4 consecutive edges: their `src` and
// `dst` in one 16-byte load each (4-byte loads when an array is not
// 16-byte aligned or at the ragged end), then the source rows of a slice
// of the row's words: NC chunks (Chunk<V>: 16 bytes when W % 4 == 0 and
// `x` is 16-byte aligned, else 4), all of them issued before any is used.
// A block covers one slice (blockIdx.y), so any W works with NC chunks
// in registers.  An edge whose source is `dead` loads nothing: padding
// and freed positions are (dead, dead), half the capacity, and the dead
// row of `x` is zero (sweep_delta and the seed zero it).
//
// One atomic a destination run.  The build sorts edges by destination
// (ops/graph_compile.py), so neighbouring edges mostly share one.  A
// thread ORs its consecutive same-destination edges in registers.  A run
// that ends inside the thread and did not start in it (a middle run) is
// ORed into `y` at once.  Its first run (head) and last run (tail) may
// cross into the neighbouring lanes: a segmented suffix OR over the warp
// (shuffles keyed on the lanes' first and last destinations, log steps
// while some lane's run goes on) gives each lane S = its head run ORed
// with every following lane's head run while the destination carries on
// through lanes that hold one run only.  A run's owner, the lane where it
// starts, then makes its one read-modify-write: S for a one-run lane, its
// tail ORed with the next lane's S otherwise.  A continued head adds
// nothing on its own.  The writes stay atomic (`atomicOr`, 64-bit where
// `y` is 8-byte aligned and W even, 32-bit otherwise, a zero word never):
// `y` already holds the init step's x0 | wildcard terms, a run may go on
// in the next warp or block, and inserted edges sit in free positions out
// of destination order (deltas) — each of those is a run of its own, so
// the result is exact for any order, duplicate edges included.
//
// All index arithmetic is 32-bit (E < 2^31; a row address is one widening
// multiply), with no division.  The first design ran one thread per
// (edge, word): a 64-bit division each, W reads of src[e] an edge, 4-byte
// loads, and an atomic per nonzero word, which serialised in L2 on the
// run's one address.  Bound by bytes: the two edge arrays, each distinct
// live source row's words read once and each distinct destination row's
// words read and written once.
constexpr int kEdgeThreads = 256;
constexpr int kEdgesPer = 4;

__device__ __forceinline__ void or_words(int32_t* p, uint32_t v, int) {
    if (v) atomicOr(reinterpret_cast<unsigned int*>(p), v);
}

__device__ __forceinline__ void or_words(int32_t* p, uint4 v, int a64) {
    if (a64) {
        const unsigned long long lo = (unsigned long long)v.y << 32 | v.x;
        const unsigned long long hi = (unsigned long long)v.w << 32 | v.z;
        if (lo) atomicOr(reinterpret_cast<unsigned long long*>(p), lo);
        if (hi) atomicOr(reinterpret_cast<unsigned long long*>(p + 2), hi);
    } else {
        or_words(p, v.x, 0);
        or_words(p + 1, v.y, 0);
        or_words(p + 2, v.z, 0);
        or_words(p + 3, v.w, 0);
    }
}

template <typename V, int NC>
__global__ void __launch_bounds__(kEdgeThreads)
edge_or_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ src,
               const int32_t* __restrict__ dst, unsigned int E, int W,
               int dead, int vec_idx, int a64, int32_t* __restrict__ y) {
    using C = Chunk<V>;
    constexpr int U = kEdgesPer;
    constexpr unsigned int kFull = 0xffffffffu;
    const int w0 = (int)blockIdx.y * NC * C::N;  // this slice's first word
    const int lane = (int)(threadIdx.x & 31u);
    const unsigned int groups = (E + U - 1) / U;
    const unsigned int stride = gridDim.x * blockDim.x;
    auto flush = [&](int d, const V* v) {
        int32_t* row = y + (long long)d * W + w0;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            if (w0 + c * C::N < W) or_words(row + c * C::N, v[c], a64);
    };
    // the trip count is the same in every lane of a block (its bound moves
    // with the block's base), so the shuffles see whole warps
    for (unsigned int base = blockIdx.x * blockDim.x; base < groups;
         base += stride) {
        const unsigned int g = base + threadIdx.x;
        const unsigned int e0 = g * U;
        const int n = g < groups ? (int)min((unsigned int)U, E - e0) : 0;
        int s[U], d[U];
        if (n == U && vec_idx) {
            const int4 a = __ldg(reinterpret_cast<const int4*>(src + e0));
            const int4 b = __ldg(reinterpret_cast<const int4*>(dst + e0));
            s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
            d[0] = b.x; d[1] = b.y; d[2] = b.z; d[3] = b.w;
        } else {
#pragma unroll
            for (int i = 0; i < U; ++i) {
                s[i] = i < n ? __ldg(src + e0 + i) : dead;
                d[i] = i < n ? __ldg(dst + e0 + i) : -1;
            }
        }
        V v[U][NC];
#pragma unroll
        for (int i = 0; i < U; ++i) {
            const bool live = i < n && s[i] != dead;
            const int32_t* row = x + (long long)s[i] * W + w0;
#pragma unroll
            for (int c = 0; c < NC; ++c)
                v[i][c] = live && w0 + c * C::N < W ? C::ld(row + c * C::N)
                                                    : C::zero();
        }
        // the lane's runs: head (first), middle ones flushed here, tail
        V h[NC], t[NC];
        const int fd = n ? d[0] : -1;
        int td = fd;
        bool single = true;
#pragma unroll
        for (int c = 0; c < NC; ++c) t[c] = v[0][c];
#pragma unroll
        for (int i = 1; i < U; ++i) {
            if (i >= n) break;
            if (d[i] == td) {
#pragma unroll
                for (int c = 0; c < NC; ++c) t[c] = C::or_(t[c], v[i][c]);
                continue;
            }
            if (single) {
#pragma unroll
                for (int c = 0; c < NC; ++c) h[c] = t[c];
                single = false;
            } else {
                flush(td, t);
            }
            td = d[i];
#pragma unroll
            for (int c = 0; c < NC; ++c) t[c] = v[i][c];
        }
        if (single) {
#pragma unroll
            for (int c = 0; c < NC; ++c) h[c] = t[c];
        }
        // across the warp: does my tail go on into the next lane, and did
        // my head come from the previous one?  (inactive lanes hold -1,
        // which no edge's destination equals)
        const int next_fd = __shfl_down_sync(kFull, fd, 1);
        const int prev_td = __shfl_up_sync(kFull, td, 1);
        const bool conn = lane < 31 && n > 0 && next_fd == td;
        const bool cont = lane > 0 && n > 0 && prev_td == fd;
        // S: my head run ORed with the following lanes' heads along one
        // destination; `link`: the run goes on past the lanes S covers
        V S[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) S[c] = h[c];
        bool link = single && conn;
        for (int o = 1; o < 32 && __any_sync(kFull, link); o <<= 1) {
            const int up_link = __shfl_down_sync(kFull, (int)link, o);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const V up = C::shfl_down(S[c], o);
                if (link) S[c] = C::or_(S[c], up);
            }
            if (link) link = up_link != 0;
        }
        const bool carry = !single && conn;
        if (__any_sync(kFull, carry)) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const V up = C::shfl_down(S[c], 1);
                if (carry) t[c] = C::or_(t[c], up);
            }
        }
        if (n == 0) continue;
        if (single) {
            if (!cont) flush(fd, S);
        } else {
            if (!cont) flush(fd, h);
            flush(td, t);
        }
    }
}

// word_cols_T: out[k, r] = plane[r, words[k]] for r < R, the batch's
// distinct closure word columns each made contiguous (one launch, one
// readback).
//
// Design.  Where the requested words touch most of a row's 32-byte
// sectors (K * 8 >= Wc), a block stages a tile of T = 16 plane rows in
// shared memory: the tile is one contiguous span of T * Wc words, read
// with 16-byte loads from its first 16-byte boundary (4-byte loads for
// the head before it and the tail after the last whole chunk), so each
// sector of the plane is fetched once.  It lands in rows of pitch P = Wc
// rounded up to odd, so that the column reads after the barrier — lane j
// reads row j of the tile — hit 32 distinct banks.  Then for each
// requested word k the block writes out[k, r0 : r0 + T], neighbouring
// threads on neighbouring rows: one coalesced segment a word.  Repeated
// words are read again from shared memory, not from the plane.  Where
// few words are asked for (K * 8 < Wc), whole rows would move more than
// the columns' sectors, and a block reads one column (blockIdx.y) down
// the rows, one 4-byte load a row.  The launcher chooses from K and Wc.
// The K words are staged in shared memory beside the tile, and each
// thread keeps four loads and four stores in flight.  On an H100 at
// phase 12's [5,079, 65] plane and 63 words, tiles of 8 to 64 rows at
// 128 or 256 threads read 0.0026-0.0039 ms; 16 rows at 256 threads was
// the fastest in every run (scripts/torch_kernel_ab.py, PERF.md row 9).
// Index arithmetic is 32-bit with one division a 16-byte chunk; the first
// design ran one thread per output word with a 64-bit division each, and
// its neighbouring threads read rows Wc * 4 bytes apart, a sector a load
// (phase 12's batch asks for ~63 of 65 words: ~8x the plane in sectors).
// Bound by bytes: the columns read (K * R words) and written once.
constexpr int kColsThreads = 256;
constexpr int kColsTileRows = 16;      // T, a power of two
constexpr int kColsTileWords = 12288;  // T * P + K at most: 48 KB of shared memory
constexpr int kColsUnroll = 4;         // 16-byte loads in flight a thread

__global__ void __launch_bounds__(kColsThreads)
word_cols_tile_kernel(const int32_t* __restrict__ plane, int Wc, int P,
                      int T, const int32_t* __restrict__ words, int K, int R,
                      int32_t* __restrict__ out) {
    extern __shared__ int32_t cols_tile[];  // [T][P], then the K words
    int32_t* wsh = cols_tile + T * P;
    const int r0 = (int)blockIdx.x * T;
    const int tl = min(T, R - r0);
    const int n = tl * Wc;                  // words of the tile's span
    const int32_t* base = plane + (long long)r0 * Wc;
    const int tid = (int)threadIdx.x;
    const int nt = (int)blockDim.x;
    const int head = min(n, (int)((16u - ((unsigned int)(uintptr_t)base
                                          & 15u)) & 15u) >> 2);
    const int quads = (n - head) >> 2;
    const int4* b4 = reinterpret_cast<const int4*>(base + head);
    for (int k = tid; k < K; k += nt) wsh[k] = __ldg(words + k);
    for (int q0 = tid; q0 < quads; q0 += nt * kColsUnroll) {
        int4 v[kColsUnroll];
#pragma unroll
        for (int i = 0; i < kColsUnroll; ++i) {
            const int q = q0 + i * nt;
            if (q < quads) v[i] = __ldg(b4 + q);
        }
#pragma unroll
        for (int i = 0; i < kColsUnroll; ++i) {
            const int q = q0 + i * nt;
            if (q >= quads) continue;
            const int o = head + 4 * q;
            int r = o / Wc;
            int c = o - r * Wc;
            const int32_t vals[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                cols_tile[r * P + c] = vals[j];
                if (++c == Wc) {
                    c = 0;
                    ++r;
                }
            }
        }
    }
    // the < 4 words before the first chunk and the < 4 after the last
    if (tid < 8) {
        const int o = tid < 4 ? tid : head + 4 * quads + tid - 4;
        if (tid < 4 ? o < head : o < n) {
            const int r = o / Wc;
            cols_tile[r * P + (o - r * Wc)] = __ldg(base + o);
        }
    }
    __syncthreads();
    // output e = k * T + j, neighbouring threads on neighbouring rows;
    // kColsUnroll of them in flight a thread
    const int shift = __ffs(T) - 1;
    const int total = K * T;
    for (int e0 = tid; e0 < total; e0 += nt * kColsUnroll) {
        int32_t v[kColsUnroll];
#pragma unroll
        for (int i = 0; i < kColsUnroll; ++i) {
            const int e = e0 + i * nt;
            const int j = e & (T - 1);
            v[i] = e < total && j < tl ? cols_tile[j * P + wsh[e >> shift]]
                                       : 0;
        }
#pragma unroll
        for (int i = 0; i < kColsUnroll; ++i) {
            const int e = e0 + i * nt;
            const int j = e & (T - 1);
            if (e < total && j < tl)
                out[(long long)(e >> shift) * R + r0 + j] = v[i];
        }
    }
}

__global__ void __launch_bounds__(kColsThreads)
word_cols_kernel(const int32_t* __restrict__ plane, int Wc,
                 const int32_t* __restrict__ words, int K, int R,
                 int32_t* __restrict__ out) {
    for (int k = (int)blockIdx.y; k < K; k += (int)gridDim.y) {
        const int32_t* col = plane + __ldg(words + k);
        int32_t* o = out + (long long)k * R;
        for (int r = (int)(blockIdx.x * blockDim.x + threadIdx.x); r < R;
             r += (int)(gridDim.x * blockDim.x))
            o[r] = __ldg(col + (long long)r * Wc);
    }
}

// or_combine: the OR all-reduce of G co-located replicas of n packed
// words: every p[g][i] = OR_j p[j][i], in one launch.
//
// Design.  The G pointers (G <= kMaxParts) travel by value in `Parts`.
// Each thread owns kCombineChunks = 2 16-byte chunks (blockDim apart, so
// each of its loads is coalesced across the warp), loads those chunks of
// all G replicas before it uses any, ORs them in registers and stores the
// result into every replica: one read and one write of each replica, 2G
// streams in all.  The grid has one trip a thread.  The first design ORed
// one peer a launch into replica 0 (G - 1 launches of two reads and a
// write) and copied the result back to each peer (G - 1 copies): 5(G - 1)
// streams.  No thread reads a word that another thread writes.  The < 4
// trailing words, and all n when a replica is not 16-byte aligned (`vec`
// 0), go one word a thread.  On an H100 at G = 4, one or two chunks a
// thread with the grid capped at 2-16 blocks an SM or not all read within
// 3 % of each other cold (scripts/torch_kernel_ab.py, PERF.md row 14a).
// Bound by bytes: 2 * G * n * 4.
constexpr int kMaxParts = 8;
struct Parts {
    int32_t* p[kMaxParts];
};

constexpr int kCombineChunks = 2;

template <int G>
__global__ void __launch_bounds__(kBlock)
or_combine_kernel(Parts parts, long long n, int vec) {
    constexpr int U = kCombineChunks;
    const long long t0 = (long long)blockIdx.x * blockDim.x * U + threadIdx.x;
    long long done = 0;
    if (vec) {
        const long long n4 = n >> 2;
        const long long stride = (long long)gridDim.x * blockDim.x * U;
        for (long long t = t0; t < n4; t += stride) {
            uint4 v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) v[u] = Chunk<uint4>::zero();
#pragma unroll
            for (int j = 0; j < G; ++j) {
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const long long c = t + (long long)u * blockDim.x;
                    if (c < n4)
                        v[u] = Chunk<uint4>::or_(
                            v[u], Chunk<uint4>::ld(parts.p[j] + 4 * c));
                }
            }
#pragma unroll
            for (int j = 0; j < G; ++j) {
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const long long c = t + (long long)u * blockDim.x;
                    if (c < n4) Chunk<uint4>::st(parts.p[j] + 4 * c, v[u]);
                }
            }
        }
        done = n4 << 2;
    }
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long t = done + (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < n; t += step) {
        int32_t v = 0;
#pragma unroll
        for (int j = 0; j < G; ++j) v |= parts.p[j][t];
#pragma unroll
        for (int j = 0; j < G; ++j) parts.p[j][t] = v;
    }
}

inline int last_error() { return (int)cudaGetLastError(); }

// -- device-time stamps ------------------------------------------------------
// A thread that opened a stamp set (ell_stamps_open) has each launcher it
// calls on the set's card record a CUDA timing event on the launcher's
// stream before its first launch and another after its last, inside the
// one C call, so that no host delay between two Python calls (a wait for
// the interpreter lock) falls between an event and the work it times.  A
// launcher whose stream is capturing a graph records nothing (the graph's
// own events time its replays).  Events come from a per-card pool and go
// back to it when the set is read (ell_stamps_read) after the batch's
// readback.  A stamp that cannot be recorded is left out; it never fails
// the launch.

constexpr int kMaxCards = 64;

struct StampSet {
    int card;
    std::vector<cudaEvent_t> ev;   // (start, end) pairs
};

std::mutex g_pool_mu;
std::vector<cudaEvent_t> g_pool[kMaxCards];
thread_local StampSet* t_stamps = nullptr;

cudaEvent_t take_event(int card) {
    {
        std::lock_guard<std::mutex> g(g_pool_mu);
        std::vector<cudaEvent_t>& p = g_pool[card];
        if (!p.empty()) {
            cudaEvent_t e = p.back();
            p.pop_back();
            return e;
        }
    }
    cudaEvent_t e = nullptr;
    if (cudaEventCreateWithFlags(&e, cudaEventDefault) != cudaSuccess) {
        cudaGetLastError();
        return nullptr;
    }
    return e;
}

void give_events(int card, const cudaEvent_t* ev, size_t n) {
    std::lock_guard<std::mutex> g(g_pool_mu);
    for (size_t i = 0; i < n; ++i)
        if (ev[i] != nullptr) g_pool[card].push_back(ev[i]);
}

class Stamp {
  public:
    explicit Stamp(void* stream) : s_((cudaStream_t)stream) {
        StampSet* set = t_stamps;
        if (set == nullptr) return;
        int card = -1;
        cudaStreamCaptureStatus cap = cudaStreamCaptureStatusNone;
        if (cudaGetDevice(&card) != cudaSuccess || card != set->card ||
            cudaStreamIsCapturing(s_, &cap) != cudaSuccess ||
            cap != cudaStreamCaptureStatusNone) {
            cudaGetLastError();
            return;
        }
        cudaEvent_t ev[2] = {take_event(card), take_event(card)};
        if (ev[0] == nullptr || ev[1] == nullptr ||
            cudaEventRecord(ev[0], s_) != cudaSuccess) {
            cudaGetLastError();
            give_events(card, ev, 2);
            return;
        }
        set_ = set;
        a_ = ev[0];
        b_ = ev[1];
    }
    ~Stamp() {
        if (set_ == nullptr) return;
        if (cudaEventRecord(b_, s_) != cudaSuccess) {
            cudaGetLastError();
            cudaEvent_t ev[2] = {a_, b_};
            give_events(set_->card, ev, 2);
            return;
        }
        set_->ev.push_back(a_);
        set_->ev.push_back(b_);
    }
    Stamp(const Stamp&) = delete;
    Stamp& operator=(const Stamp&) = delete;

  private:
    cudaStream_t s_;
    StampSet* set_ = nullptr;
    cudaEvent_t a_ = nullptr, b_ = nullptr;
};

}  // namespace

// Open a stamp set for this thread's launches on `card`; returns it (null
// for a card out of range).  A set already open on the thread is replaced.
EXPORT void* ell_stamps_open(int card) {
    if (card < 0 || card >= kMaxCards) return nullptr;
    StampSet* set = new StampSet{card, {}};
    t_stamps = set;
    return set;
}

// Stop stamping this thread's launches (the set stays readable).
EXPORT void ell_stamps_close(void) { t_stamps = nullptr; }

// Stamp this thread's launches into an open set again.
EXPORT void ell_stamps_resume(void* p) { t_stamps = (StampSet*)p; }

// The summed milliseconds of a closed set's windows; returns the events
// to the pool and frees the set.  A window not yet complete is waited for
// on its own end event; one that cannot be read is left out.
EXPORT double ell_stamps_read(void* p) {
    StampSet* set = (StampSet*)p;
    double sum = 0.0;
    for (size_t i = 0; i + 1 < set->ev.size(); i += 2) {
        float m = 0.0f;
        cudaError_t e = cudaEventElapsedTime(&m, set->ev[i], set->ev[i + 1]);
        if (e == cudaErrorNotReady) {
            cudaGetLastError();
            e = cudaEventSynchronize(set->ev[i + 1]);
            if (e == cudaSuccess)
                e = cudaEventElapsedTime(&m, set->ev[i], set->ev[i + 1]);
        }
        if (e != cudaSuccess) {
            cudaGetLastError();
            continue;
        }
        sum += m;
    }
    give_events(set->card, set->ev.data(), set->ev.size());
    delete set;
    return sum;
}

// Free a set without reading it (its batch failed); its events go back
// to the pool.
EXPORT void ell_stamps_free(void* p) {
    StampSet* set = (StampSet*)p;
    give_events(set->card, set->ev.data(), set->ev.size());
    delete set;
}

EXPORT const char* ell_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Gather-OR of `nrows` rows into `out` (rows of the state, or a scratch
// buffer that is then copied into `dst`; `dst` null when `out` is the
// destination).  Reads of rows [in_lo, in_lo + in_span) go to `x_in`
// (in_span 0: every read goes to `cur`).  `vec`: W % 4 == 0 and every row
// pointer 16-byte aligned; `iv`: indices a load (4, 2 or 1; k % iv == 0
// and the index rows aligned to it).
EXPORT int ell_gather_or(const void* cur, const void* x_in, long long in_lo,
                         long long in_span, const void* idx, int k, int iv,
                         long long nrows, int W, int vec, const void* seed,
                         const void* wc_bits, const void* wc_live, void* out,
                         void* dst, void* stream) {
    const Stamp stamp(stream);
    if (nrows <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    // a wide row's indices over 4 lanes, each share a whole number of
    // index loads
    const int parts = k >= 16 && k % (4 * iv) == 0 ? 4 : 1;
    const long long total = nrows * (vec ? W / 4 : W) * parts;
    // fewer threads than two full waves of 256-thread blocks: smaller
    // blocks, so that every SM gets some
    const int block = total < 2LL * kSMs * kBlock ? kBlock / 4 : kBlock;
    const unsigned int grid = grid_for(total, block, 1LL << 30);
    const int32_t *c_ = (const int32_t*)cur, *x_ = (const int32_t*)x_in,
                  *i_ = (const int32_t*)idx, *s_ = (const int32_t*)seed,
                  *b_ = (const int32_t*)wc_bits, *l_ = (const int32_t*)wc_live;
    int32_t* o_ = (int32_t*)out;
    const unsigned long long span = (unsigned long long)in_span;
    if (vec && parts == 4) {
        gather_or_kernel<uint4, 4><<<grid, block, 0, s>>>(
            c_, x_, in_lo, span, i_, k, iv, nrows, W, s_, b_, l_, o_);
    } else if (vec) {
        gather_or_kernel<uint4, 1><<<grid, block, 0, s>>>(
            c_, x_, in_lo, span, i_, k, iv, nrows, W, s_, b_, l_, o_);
    } else if (parts == 4) {
        gather_or_kernel<uint32_t, 4><<<grid, block, 0, s>>>(
            c_, x_, in_lo, span, i_, k, iv, nrows, W, s_, b_, l_, o_);
    } else {
        gather_or_kernel<uint32_t, 1><<<grid, block, 0, s>>>(
            c_, x_, in_lo, span, i_, k, iv, nrows, W, s_, b_, l_, o_);
    }
    int e = last_error();
    if (e || dst == nullptr) return e;
    return (int)cudaMemcpyAsync(dst, out, (size_t)nrows * W * 4,
                                cudaMemcpyDeviceToDevice, s);
}

// A DstList of the n (1..kMeshDsts) device pointers in the host array
// `p`; false when n is out of range.
inline bool dst_list(void* const* p, int n, DstList* out) {
    if (n < 1 || n > kMeshDsts) return false;
    *out = DstList{};
    for (int q = 0; q < n; ++q) out->p[q] = (int32_t*)p[q];
    out->n = n;
    return true;
}

// One pass of the sharded sweep's gathers over `n_jobs` (1..kMeshJobs)
// table blocks of `nrows` x k indices: `ptrs` holds 6 + kMeshDsts
// pointers a job (idx, lo, hi, seed, wc_bits, wc_live, then its
// destinations, `n_dst[j]` of them), `split` the first row read from
// `hi`.  `vec` and `iv` as ell_gather_or's, over every job's pointers.
EXPORT int ell_mesh_gather_or(void* const* ptrs, const int* n_dst,
                              int n_jobs, int split, int k, int iv,
                              long long nrows, int W, int vec,
                              void* stream) {
    const Stamp stamp(stream);
    if (nrows <= 0 || n_jobs <= 0) return 0;
    if (n_jobs > kMeshJobs) return (int)cudaErrorInvalidValue;
    constexpr int kPer = 6 + kMeshDsts;
    GatherJobs jobs = {};
    for (int j = 0; j < n_jobs; ++j) {
        void* const* p = ptrs + j * kPer;
        GatherJob& g = jobs.j[j];
        g.idx = (const int32_t*)p[0];
        g.lo = (const int32_t*)p[1];
        g.hi = (const int32_t*)p[2];
        g.seed = (const int32_t*)p[3];
        g.wc_bits = (const int32_t*)p[4];
        g.wc_live = (const int32_t*)p[5];
        if (!dst_list(p + 6, n_dst[j], &g.out))
            return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const int parts = k >= 16 && k % (4 * iv) == 0 ? 4 : 1;
    const long long total = nrows * (vec ? W / 4 : W) * parts;
    const int block =
        total * n_jobs < 2LL * kSMs * kBlock ? kBlock / 4 : kBlock;
    const dim3 grid(grid_for(total, block, 1LL << 30), (unsigned int)n_jobs);
    if (vec && parts == 4) {
        mesh_gather_or_kernel<uint4, 4><<<grid, block, 0, s>>>(
            jobs, split, k, iv, nrows, W);
    } else if (vec) {
        mesh_gather_or_kernel<uint4, 1><<<grid, block, 0, s>>>(
            jobs, split, k, iv, nrows, W);
    } else if (parts == 4) {
        mesh_gather_or_kernel<uint32_t, 4><<<grid, block, 0, s>>>(
            jobs, split, k, iv, nrows, W);
    } else {
        mesh_gather_or_kernel<uint32_t, 1><<<grid, block, 0, s>>>(
            jobs, split, k, iv, nrows, W);
    }
    return last_error();
}

template <typename V, int S, bool PLANES, typename Out>
int launch_perm(const void* cur, const void* code, int n_ins,
                long long length, int W, int H, const void* seed,
                const Out& out, cudaStream_t s) {
    const long long total = length * (H / Chunk<V>::N);
    perm_program_kernel<V, S, PLANES, Out>
        <<<grid_for(total, kBlock, 1LL << 30), kBlock,
           (size_t)n_ins * sizeof(int2), s>>>(
            (const int32_t*)cur, (const int32_t*)code, n_ins, length, W, H,
            (const int32_t*)seed, out);
    return last_error();
}

template <typename V, bool PLANES, typename Out>
int launch_perm_depth(int depth, const void* cur, const void* code,
                      int n_ins, long long length, int W, int H,
                      const void* seed, const Out& out, cudaStream_t s) {
    if (depth <= 4)
        return launch_perm<V, 4, PLANES>(cur, code, n_ins, length, W, H,
                                         seed, out, s);
    return launch_perm<V, kMaxStack, PLANES>(cur, code, n_ins, length, W, H,
                                             seed, out, s);
}

// The variant for a program: `half` > 0 the tri-state program over rows
// of W = 2 * half words; `depth` its stack depth (<= kMaxStack); `vec`
// the plane width (half, else W) a multiple of 4 and the row pointers
// 16-byte aligned.
template <typename Out>
int launch_perm_for(const void* cur, const void* code, int n_ins,
                    long long length, int W, int half, int depth, int vec,
                    const void* seed, const Out& out, cudaStream_t s) {
    if (depth > kMaxStack) return (int)cudaErrorInvalidValue;
    const int H = half > 0 ? half : W;
    if (half > 0) {
        // 16 slots of 16-byte definite/maybe pairs need 255 registers and
        // spill: a deeper plane program takes 4-byte chunks
        return vec && depth <= 4
                   ? launch_perm<uint4, 4, true>(cur, code, n_ins, length, W,
                                                 H, seed, out, s)
                   : launch_perm_depth<uint32_t, true>(
                         depth, cur, code, n_ins, length, W, H, seed, out, s);
    }
    return vec ? launch_perm_depth<uint4, false>(depth, cur, code, n_ins,
                                                 length, W, H, seed, out, s)
               : launch_perm_depth<uint32_t, false>(depth, cur, code, n_ins,
                                                    length, W, H, seed, out,
                                                    s);
}

// `out` may be the output rows of `cur` (see the kernel).
EXPORT int ell_perm_program(const void* cur, const void* code, int n_ins,
                            long long length, int W, int half, int depth,
                            int vec, const void* seed, void* out,
                            void* stream) {
    const Stamp stamp(stream);
    if (length <= 0) return 0;
    return launch_perm_for(cur, code, n_ins, length, W, half, depth, vec,
                           seed, OneOut{(int32_t*)out},
                           (cudaStream_t)stream);
}

// The program of `cur` (one replica) written into each of the `n_dst`
// slot rows `dsts` (the data shard's co-located replicas, `cur`'s among
// them), in place: its READs are of other slots or of the thread's own
// word (the wrapper checks the program).
EXPORT int ell_mesh_perm_program(const void* cur, const void* code,
                                 int n_ins, long long length, int W,
                                 int half, int depth, int vec,
                                 const void* seed, void* const* dsts,
                                 int n_dst, void* stream) {
    const Stamp stamp(stream);
    if (length <= 0) return 0;
    DstList out;
    if (!dst_list(dsts, n_dst, &out)) return (int)cudaErrorInvalidValue;
    return launch_perm_for(cur, code, n_ins, length, W, half, depth, vec,
                           seed, out, (cudaStream_t)stream);
}

template <typename V, typename I>
int launch_cav(const void* x, const void* idx, long long R, int half,
               int dead, void* out, cudaStream_t s) {
    const unsigned int grid = grid_for(R, kBlock, 1LL << 30);
    const int32_t *x_ = (const int32_t*)x, *i_ = (const int32_t*)idx;
    cav_gather_or_kernel<V, I><<<grid, kBlock, 0, s>>>(
        x_, i_, (I)R, half, dead, (int32_t*)out);
    return last_error();
}

// Row and index arithmetic in 32 bits where R * kCav allows it.
inline bool cav_narrow(long long R) {
    return R * kCav < 0x7fffffffLL - (long long)kBlock * kCav;
}

// `idx`: R rows of kCav indices, 16-byte aligned; `vec`: half % 4 == 0
// and `x`, `out` 16-byte aligned.  `dead`: the state's dead row, whose
// gathers are skipped.
EXPORT int ell_cav_gather_or(const void* x, const void* idx, long long R,
                             int half, int dead, int vec, void* out,
                             void* stream) {
    const Stamp stamp(stream);
    if (R <= 0 || half <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (cav_narrow(R))
        return vec ? launch_cav<uint4, unsigned int>(x, idx, R, half, dead,
                                                     out, s)
                   : launch_cav<uint32_t, unsigned int>(x, idx, R, half,
                                                        dead, out, s);
    return vec ? launch_cav<uint4, long long>(x, idx, R, half, dead, out, s)
               : launch_cav<uint32_t, long long>(x, idx, R, half, dead, out,
                                                 s);
}

template <typename V, typename I>
int launch_mesh_cav(const CavJobs& jobs, int n_jobs, long long R, int half,
                    int dead, cudaStream_t s) {
    const dim3 grid(grid_for(R, kBlock, 1LL << 30), (unsigned int)n_jobs);
    mesh_cav_gather_or_kernel<V, I><<<grid, kBlock, 0, s>>>(jobs, (I)R,
                                                           half, dead);
    return last_error();
}

// The caveat gathers of `n_jobs` (1..kMeshJobs) table blocks of R rows:
// `ptrs` holds 2 + kMeshDsts pointers a job (idx, x, then its
// destinations, each at the block's first state row; `n_dst[j]` of
// them).  `vec`: half % 4 == 0 and every x and destination 16-byte
// aligned.
EXPORT int ell_mesh_cav_gather_or(void* const* ptrs, const int* n_dst,
                                  int n_jobs, long long R, int half,
                                  int dead, int vec, void* stream) {
    const Stamp stamp(stream);
    if (R <= 0 || half <= 0 || n_jobs <= 0) return 0;
    if (n_jobs > kMeshJobs) return (int)cudaErrorInvalidValue;
    constexpr int kPer = 2 + kMeshDsts;
    CavJobs jobs = {};
    for (int j = 0; j < n_jobs; ++j) {
        void* const* p = ptrs + j * kPer;
        jobs.j[j].idx = (const int32_t*)p[0];
        jobs.j[j].x = (const int32_t*)p[1];
        if (!dst_list(p + 2, n_dst[j], &jobs.j[j].out))
            return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    if (cav_narrow(R))
        return vec ? launch_mesh_cav<uint4, unsigned int>(jobs, n_jobs, R,
                                                          half, dead, s)
                   : launch_mesh_cav<uint32_t, unsigned int>(
                         jobs, n_jobs, R, half, dead, s);
    return vec ? launch_mesh_cav<uint4, long long>(jobs, n_jobs, R, half,
                                                   dead, s)
               : launch_mesh_cav<uint32_t, long long>(jobs, n_jobs, R, half,
                                                      dead, s);
}

// Zero the dead row of `x_new` (the step's last write, ell.py:500), then
// out = [popcount(x_new ^ x_old) mod 2^32, any(x_new != x_old)].
EXPORT int ell_sweep_delta(void* x_new, const void* x_old, long long nt,
                           int W, long long dead, void* out, void* stream) {
    const Stamp stamp(stream);
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

// The fused tail of an ELL sweep: sweep_delta_checks_kernel over `x_new`
// (rows of S words, H > 0: planes of H words) into pair `slot` (0 or 1)
// of `out`, then, when `host` is not null, a copy of the whole result
// [4 + nw * (1 + planes)] into `host` (pinned memory) on the same stream,
// so that a captured sweep carries its own readback.
EXPORT int ell_sweep_delta_checks(void* x_new, const void* x_old,
                                  long long nt, int S, int H, long long dead,
                                  const void* tail, int nw, int slot,
                                  void* out, void* host, void* stream) {
    const Stamp stamp(stream);
    cudaStream_t s = (cudaStream_t)stream;
    const long long n = nt * S;
    const long long cap = 132 * 16;
    long long blocks = grid_for(n, kBlock, cap);
    const long long tail_blocks = ((long long)nw * 32 + kBlock - 1) / kBlock;
    if (tail_blocks > blocks) blocks = tail_blocks < cap ? tail_blocks : cap;
    if (H > 0)
        sweep_delta_checks_kernel<true><<<(unsigned)blocks, kBlock, 0, s>>>(
            (const int32_t*)x_new, (const int32_t*)x_old, n, dead * S, S, H,
            (const int32_t*)tail, nw, slot, (uint32_t*)out,
            (int32_t*)x_new + dead * S);
    else
        sweep_delta_checks_kernel<false><<<(unsigned)blocks, kBlock, 0, s>>>(
            (const int32_t*)x_new, (const int32_t*)x_old, n, dead * S, S, 0,
            (const int32_t*)tail, nw, slot, (uint32_t*)out,
            (int32_t*)x_new + dead * S);
    int e = last_error();
    if (e || host == nullptr) return e;
    const size_t bytes = (size_t)(4 + (long long)nw * (H > 0 ? 2 : 1)) * 4;
    return (int)cudaMemcpyAsync(host, out, bytes, cudaMemcpyDeviceToHost, s);
}

// sweep_delta over one data shard's co-located replicas: `x_new` one of
// them, `dsts` all `n_dst` of them, whose dead rows are zeroed; the
// result is added into `out` (two words the caller zeroed).
EXPORT int ell_mesh_sweep_delta(const void* x_new, const void* x_old,
                                long long nt, int W, long long dead,
                                void* const* dsts, int n_dst, void* out,
                                void* stream) {
    const Stamp stamp(stream);
    DstList zero;
    if (!dst_list(dsts, n_dst, &zero)) return (int)cudaErrorInvalidValue;
    const long long n = nt * W;
    if (n <= 0) return 0;
    mesh_sweep_delta_kernel<<<grid_for(n, kBlock, 132 * 16), kBlock, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)x_new, (const int32_t*)x_old, n, dead * W, W, zero,
        (uint32_t*)out);
    return last_error();
}

EXPORT int ell_seed_bitplanes(const void* q, int B, long long nt, int W,
                              int planes, long long dead,
                              const void* wc_ranges, int n_wc, void* x0,
                              void* live, void* stream) {
    const Stamp stamp(stream);
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
    const Stamp stamp(stream);
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
    const Stamp stamp(stream);
    if (G <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    check_gather3_kernel<<<grid_for(G, kBlock, 1LL << 30), kBlock, 0, s>>>(
        (const int32_t*)x, half, (const int32_t*)gi, (const int32_t*)gc, G,
        (int32_t*)out);
    return last_error();
}

EXPORT int ell_lookup_T(const void* x, int W, long long S, long long offset,
                        long long L, void* out, void* stream) {
    const Stamp stamp(stream);
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
    const Stamp stamp(stream);
    const long long n = R * K;
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    scatter_rows_kernel<<<(unsigned int)((n + kScatterSpan - 1) / kScatterSpan),
                          kScatterThreads, 0, s>>>(
        (const int32_t*)src, R, K, (const int32_t*)rows, b,
        (const int32_t*)vals, vec, (int32_t*)out);
    return last_error();
}

template <typename V, int NC>
int launch_edge_or(const void* x, const void* src, const void* dst,
                   long long E, int W, int dead, int vec_idx, int a64,
                   void* y, cudaStream_t s) {
    const int slice = NC * Chunk<V>::N;                  // words a block
    const long long slices = (W + slice - 1) / slice;
    if (slices > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid(grid_for((E + kEdgesPer - 1) / kEdgesPer, kEdgeThreads,
                             1LL << 30),
                    (unsigned int)slices);
    edge_or_kernel<V, NC><<<grid, kEdgeThreads, 0, s>>>(
        (const int32_t*)x, (const int32_t*)src, (const int32_t*)dst,
        (unsigned int)E, W, dead, vec_idx, a64, (int32_t*)y);
    return last_error();
}

// `dead`: the state's dead row, whose edges load nothing (-1: none).  The
// launcher picks the chunk width and the index loads from W and the
// pointers' alignment.
EXPORT int ell_edge_or(const void* x, const void* src, const void* dst,
                       long long E, int W, int dead, void* y, void* stream) {
    const Stamp stamp(stream);
    if (E <= 0 || W <= 0) return 0;
    if (E > 0x7fffffffLL - (long long)kEdgeThreads * kEdgesPer)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int vec_idx =
        ((uintptr_t)src | (uintptr_t)dst) % 16 == 0 ? 1 : 0;
    const int a64 = W % 2 == 0 && (uintptr_t)y % 8 == 0 ? 1 : 0;
    if (W % 4 == 0 && (uintptr_t)x % 16 == 0) {
        return W >= 8 ? launch_edge_or<uint4, 2>(x, src, dst, E, W, dead,
                                                 vec_idx, a64, y, s)
                      : launch_edge_or<uint4, 1>(x, src, dst, E, W, dead,
                                                 vec_idx, a64, y, s);
    }
    if (W >= 4)
        return launch_edge_or<uint32_t, 4>(x, src, dst, E, W, dead, vec_idx,
                                           0, y, s);
    if (W >= 2)
        return launch_edge_or<uint32_t, 2>(x, src, dst, E, W, dead, vec_idx,
                                           0, y, s);
    return launch_edge_or<uint32_t, 1>(x, src, dst, E, W, dead, vec_idx, 0,
                                       y, s);
}

// out [K, R] (16-byte alignment not needed); the tiled read where the
// words cover most of a row's sectors, the column read otherwise.
EXPORT int ell_word_cols_T(const void* plane, int Wc, const void* words,
                           int K, long long R, void* out, void* stream) {
    const Stamp stamp(stream);
    if (K <= 0 || R <= 0) return 0;
    if (R > 0x7fffffffLL || Wc <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int P = Wc | 1;
    const int T = kColsTileRows;
    const int32_t *p_ = (const int32_t*)plane, *w_ = (const int32_t*)words;
    int32_t* o_ = (int32_t*)out;
    if ((long long)K * 8 >= Wc && (long long)T * P + K <= kColsTileWords &&
        (long long)K * T <= 0x7fffffffLL - kColsThreads * kColsUnroll) {
        word_cols_tile_kernel<<<(unsigned int)((R + T - 1) / T),
                                kColsThreads, (size_t)(T * P + K) * 4, s>>>(
            p_, Wc, P, T, w_, K, (int)R, o_);
    } else {
        const dim3 grid(grid_for(R, kColsThreads, 1LL << 30),
                        (unsigned int)(K < 65535 ? K : 65535));
        word_cols_kernel<<<grid, kColsThreads, 0, s>>>(p_, Wc, w_, K, (int)R,
                                                       o_);
    }
    return last_error();
}

int launch_or_combine(const Parts& parts, int g, long long n, int vec,
                      cudaStream_t s) {
    const long long work =
        vec ? ((n >> 2) + kCombineChunks - 1) / kCombineChunks : n;
    const unsigned int grid = grid_for(work, kBlock, 1LL << 30);
    switch (g) {
#define OR_COMBINE_CASE(G)                                              \
        case G:                                                         \
            or_combine_kernel<G><<<grid, kBlock, 0, s>>>(parts, n, vec); \
            break;
        OR_COMBINE_CASE(2) OR_COMBINE_CASE(3) OR_COMBINE_CASE(4)
        OR_COMBINE_CASE(5) OR_COMBINE_CASE(6) OR_COMBINE_CASE(7)
        OR_COMBINE_CASE(8)
#undef OR_COMBINE_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return last_error();
}

// The OR all-reduce of `g` (2..kMaxParts) replicas: `ptrs` a host array of
// their device pointers, n int32 words each.  `vec`: every replica
// 16-byte aligned.
EXPORT int ell_or_combine(const void* const* ptrs, int g, long long n,
                          int vec, void* stream) {
    const Stamp stamp(stream);
    if (n <= 0 || g == 1) return 0;
    if (g < 1 || g > kMaxParts) return (int)cudaErrorInvalidValue;
    Parts parts = {};
    for (int j = 0; j < g; ++j) parts.p[j] = (int32_t*)ptrs[j];
    return launch_or_combine(parts, g, n, vec, (cudaStream_t)stream);
}
