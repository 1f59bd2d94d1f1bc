// The Hopper probes: counterparts of the Mosaic micro-benchmarks in tools/
// (perf_probe21.py, perf_probe21b.py, perf_probe21c.py, probe_when.py,
// probe_cond.py). Each TPU probe asked a design question of the texture
// path or of the branch layout; each kernel here asks it of the H100 and
// computes, value for value, what the TPU probe's kernel computes. Their
// launchers, plain PyTorch versions and printouts are the modules of
// terminal_raytracer_tpu_torch/tools/.
//
// The probes' (16, 128) tile becomes 2048 threads, one per tile element e
// = blockIdx.x * block + threadIdx.x = row * 128 + col: blocks of 32 for
// the gather probes and probe21c (one warp on each of 64 SMs), of 128 for
// their *_serial entries (one tile row a block) and of 256 for the branch
// probes. A TPU probe's sequential grid
// steps become blockIdx.y: each step's blocks write their own copy of the
// output tile, and the launcher checks that every copy is equal.
//
// Gather probes (tools/perf_probe21.py:73, perf_probe21b.py:88): out = sum
// over i < iters of g(tab, (idx0 + i) & (n - 1)), added in loop order, with
// the table in one of three homes or on the tensor cores:
//   global      a plain global load (ld.global)
//   ldg         __ldg, the read-only path of the port's texel fetch
//               (trace.cuh fetch_texel)
//   shared      the table staged in shared memory by each block, as one
//               bulk asynchronous copy (cp.async.bulk on an mbarrier)
//   shfl        the table held in the warp's registers and fetched with
//               __shfl_sync plus a select on the register index: 4 shuffles
//               for a 128-wide row, 64 for the full 2048-texel table; a
//               column (perf_probe21b tala0) sits in the thread's own 16
//               registers and takes a select only
//   onehotmm    the one-hot product of the TPU's matrix unit as warp-level
//               mma.sync m16n8k8 TF32: the warp's 32 lanes are two 16-row
//               tiles of A (A[r][k] = idx_r == k), B[k][*] = tf32(tab[k]),
//               n / 8 k-steps; exact for a one-hot A, so g = tf32(tab[idx])
//   onehot_hi   the same over the 2048-texel table in 3xTF32: tab = big +
//               small (both cvt.rna.tf32), mma's of small A x big B (A is
//               exact in TF32, so its small part is 0), big A x small B,
//               then big A x big B, so g = big + small
//   selectacc   the O(n) compare-select loop g += idx == k ? tab[k] : 0
// What bounds them: not bytes or FP32 rate. A thread's adds are one
// dependent chain (512 FP32 adds of 4 clocks: 1.03 µs at 1980 MHz), and
// every fetch is a warp instruction of its own. The loop runs in trips of U
// iterations (gather_loop; U per form, beside its entry): the next trip's
// fetches are issued before this trip's adds, so they wait under the adds,
// one warp to an SM. What is left is the launch and, for a per-lane load,
// the SM's rate for one warp's scattered loads (PERF.md §6).
//
// Texture building blocks (tools/perf_probe21c.py:65): x = x0 + 0.001 i,
// then the texel index from uv (floor, cast, iv * 32 + iu), atan2 (CUDA's
// atan2f, the counterpart of jnp.arctan2, and the port's polynomial
// trace.cuh atan2_poly), or the packed rgb texel through __ldg and
// trace.cuh unpack_texel's arithmetic (three values an iteration: r, g,
// b). Only the adds depend on the iteration before: x, the index, the
// fetch and the atan2 of iteration i depend on i alone. So the loop runs as
// the gather probes' does (gather_loop, V values an iteration): the next
// trip's index math, fetches and atan2 are issued before this trip's adds,
// which stay in loop order, one warp on each of 64 SMs. What holds a form
// then (tools/gather_tune.py, tools/sass_ops.py; PERF.md §6): packed at 65
// clocks an iteration, against 12 for its 3 dependent adds, on one warp's
// issue of the index math and unpack and its scattered __ldg; atan2f at
// 265 clocks an iteration at every trip width, as serial: CUDA's atan2f
// compiles to about 12 branch instructions (BRA, BSSY, CALL) an iteration,
// and the trips' atan2f chains do not overlap across them. The *_serial entries keep the
// parent's loop (one iteration after another, 16 blocks of 128).
//
// Branch probes (tools/probe_when.py:54 with 64 grid steps, probe_cond.py:58
// with 256): K iterations whose heavy body runs when pred = ((i * 40503 +
// seed) mod 1000) < thresh: guarded (pred is the same for every thread, so
// a warp skips the body as a whole), unguarded (the body every time), and
// divergent (each thread's own pred at seed + e, so a warp runs the body
// whenever any of its lanes takes it), over 131,072 (when) and 524,288
// (cond) threads. A heavy step is y = y * m + a; y = y - floor(y * s), s =
// 0.25 (when) or 0.5 (cond). floorf compiles to FRND.FLOOR, which runs at
// 16 lanes a clock an SM, an eighth of the FP32 pipe, and paced both probes;
// the bodies take the floor on the FP32 pipe instead (floor_scaled), so a
// step is five FP32-pipe instructions (FMUL, FADD, FFMA.RM, FADD, FADD), one
// warp dispatch slot each, and the dispatch rate bounds the body. The plain
// versions' floor arguments lie in [0.25, 1.2500009] (cond) and [0.0751,
// 1.0750001] (when) at the probes' loop counts, where floor_scaled is exact
// (tests/test_torch_probes.py holds them there). A guarded form pays its
// iterations' dispatch slots beyond its taken bodies, so the loop carries the
// predicate's residue (next_residue), four iterations a trip. The _frnd
// entries keep the design this replaced (floorf, the residue by division
// each iteration) as the baseline.
//
// The file builds with --fmad=false like the kernels: each multiply and add
// rounds alone, as in the plain versions.

#include "trace.cuh"

namespace {

constexpr int TILE = 2048;     // the probes' (16, 128) tile
constexpr int TILE_W = 128;
constexpr int BLOCK = 128;     // probe21c, the *_serial entries: one tile row a block
constexpr int BR_BLOCK = 256;  // branch probes
constexpr unsigned FULL = 0xffffffffu;
#ifndef TRT_GATHER_BLOCK
#define TRT_GATHER_BLOCK 32
#endif
constexpr int GBLOCK = TRT_GATHER_BLOCK;  // gather probes: threads a block

// A gather form's block: GBLOCK threads, but a whole warp where its fetch
// is a warp collective (shuffles, mma).
constexpr int gather_block(bool collective) {
  return collective && GBLOCK < 32 ? 32 : GBLOCK;
}

}  // namespace

// Launch arguments (tools/_probe.py GatherArgs, BranchArgs).
struct ProbeGather {
  int n;      // table size (a power of two) of perf_probe21; 2048 for 21b
  int iters;  // loop trips
};

struct ProbeBranch {
  int iters;   // K
  int seed;    // the probe's runtime seed
  int thresh;  // int(frac_true * 1000): pred is (... mod 1000) < thresh
  int copies;  // grid steps of the TPU probe: one output tile each
};

namespace {

// cvt.rna.tf32.f32, with the 13 bits below the TF32 mantissa cleared.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

__device__ __forceinline__ float ld_global(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// D += A (16x8, row) * B (8x8, col), TF32 in, FP32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// reg[sel], by a select over the registers (no local-memory indexing).
template <int R>
__device__ __forceinline__ float reg_select(const float (&reg)[R], int sel) {
  float g = reg[0];
#pragma unroll
  for (int r = 1; r < R; ++r) g = sel == r ? reg[r] : g;
  return g;
}

// Register sel of lane src: one shuffle per register, then the select.
template <int R>
__device__ __forceinline__ float shfl_select(const float (&reg)[R], int src, int sel) {
  float g = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float v = __shfl_sync(FULL, reg[r], src);
    g = sel == r ? v : g;
  }
  return g;
}

// ------------------------------------------------- the gather probes' loop

// acc = the sum over i < iters of g_i, added in loop order. The parent's
// design (serial_loop, kept as the *_serial entries): one iteration after
// another, as written, in blocks of BLOCK. The shipped loop: trips of U
// iterations, trip t + 1's fetches issued before trip t's adds, so that a
// fetch waits under the adds of the trip before it and the adds alone are
// the dependent chain; iters mod U iterations end it as one shorter trip.
// trip(i, n, g) sets g[u] = g_(i + u) for u < n <= U; n is the same on
// every lane of a warp, so a fetch may be a warp collective. With V > 1 an
// iteration adds V values in order: trip sets g[u * V + v] for v < V.
template <int U>
__device__ __forceinline__ void add_trip(float& acc, const float (&g)[U], int n = U) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < n) acc = acc + g[u];
}

// PAIRS: two trips a pass, g and h in turn, so that no register is copied
// (a form whose fetch is one instruction); else one trip a pass and the
// fetched values copied (a form whose fetch is a loop of its own, beside
// which the copies cost nothing and a second trip's code ran slower).
template <int U, bool PAIRS, int V = 1, typename Trip>
__device__ __forceinline__ float gather_loop(int iters, const Trip& trip) {
  float acc = 0.0f, g[U * V], h[U * V];
  const int full = iters - iters % U;
  if (full > 0) trip(0, U, g);
  if constexpr (PAIRS) {
    int i = U;
#pragma unroll 1
    for (; i + U < full; i += 2 * U) {
      trip(i, U, h);
      add_trip(acc, g);
      trip(i + U, U, g);
      add_trip(acc, h);
    }
    if (i < full) {
      trip(i, U, h);
      add_trip(acc, g);
      add_trip(acc, h);
    } else if (full > 0) {
      add_trip(acc, g);
    }
  } else {
#pragma unroll 1
    for (int i = U; i < full; i += U) {
      trip(i, U, h);
      add_trip(acc, g);
#pragma unroll
      for (int u = 0; u < U * V; ++u) g[u] = h[u];
    }
    if (full > 0) add_trip(acc, g);
  }
  const int rest = iters - full;
  if (rest > 0) {
    trip(full, rest, g);
    add_trip(acc, g, rest * V);
  }
  return acc;
}

template <typename Fetch>
__device__ __forceinline__ float serial_loop(int iters, const Fetch& fetch) {
  float acc = 0.0f;
  for (int i = 0; i < iters; ++i) acc = acc + fetch(i);
  return acc;
}

// The trip of a form whose fetch(i) is one iteration's alone.
template <int U, typename Fetch>
struct Each {
  Fetch fetch;
  __device__ __forceinline__ void operator()(int i, int n, float (&g)[U]) const {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < n) g[u] = fetch(i + u);
  }
};

template <int U, typename Fetch>
__device__ __forceinline__ Each<U, Fetch> each(const Fetch& fetch) {
  return {fetch};
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// src to shared dst as one bulk asynchronous copy on an mbarrier; every
// thread of the block returns once it has landed.
__device__ __forceinline__ void stage_bulk(float* dst, const float* src, uint32_t bytes) {
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
        "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(b) : "memory");
}

// g[u] = tab[idx[u]] of every lane for u < cnt as a one-hot product on the
// tensor cores (a warp collective: all 32 lanes call it). big: the TF32
// table in shared memory; SPLIT adds small, tab - big in TF32, as the
// 3xTF32 split. Lane l's row is row l & 15 of tile l >> 4. Fragments (PTX
// ISA, mma.m16n8k8 .tf32), with gr = lane >> 2, t = lane & 3: A a0/a1 rows
// gr/gr+8 at column t, a2/a3 the same rows at t+4; B b0/b1 rows t/t+4
// (every column alike); D c0 row gr, c2 row gr+8. The trip's products run
// side by side, k-step by k-step, each with its own accumulators and k
// order, so that their mma's overlap on the tensor cores.
template <bool SPLIT, int U>
__device__ __forceinline__ void onehot_trip(const float* big, const float* small, int n,
                                            const int (&idx)[U], int cnt, float (&g)[U]) {
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const uint32_t ONE = 0x3f800000u;  // 1.0f, exact in TF32
  int r00[U], r01[U], r10[U], r11[U];
  float d0[U][4], d1[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < cnt) {
      r00[u] = __shfl_sync(FULL, idx[u], gr);
      r01[u] = __shfl_sync(FULL, idx[u], gr + 8);
      r10[u] = __shfl_sync(FULL, idx[u], gr + 16);
      r11[u] = __shfl_sync(FULL, idx[u], gr + 24);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) d0[u][c] = d1[u][c] = 0.0f;
  }
  for (int k0 = 0; k0 < n; k0 += 8) {
    const int ka = k0 + t, kb = k0 + t + 4;
    const uint32_t b0 = __float_as_uint(big[ka]), b1 = __float_as_uint(big[kb]);
    uint32_t s0 = 0u, s1 = 0u;
    if constexpr (SPLIT) s0 = __float_as_uint(small[ka]), s1 = __float_as_uint(small[kb]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u >= cnt) continue;
      const uint32_t a00 = r00[u] == ka ? ONE : 0u, a01 = r01[u] == ka ? ONE : 0u;
      const uint32_t a02 = r00[u] == kb ? ONE : 0u, a03 = r01[u] == kb ? ONE : 0u;
      const uint32_t a10 = r10[u] == ka ? ONE : 0u, a11 = r11[u] == ka ? ONE : 0u;
      const uint32_t a12 = r10[u] == kb ? ONE : 0u, a13 = r11[u] == kb ? ONE : 0u;
      if constexpr (SPLIT) {
        mma_tf32(d0[u], 0u, 0u, 0u, 0u, b0, b1);  // small A x big B
        mma_tf32(d1[u], 0u, 0u, 0u, 0u, b0, b1);
        mma_tf32(d0[u], a00, a01, a02, a03, s0, s1);  // big A x small B
        mma_tf32(d1[u], a10, a11, a12, a13, s0, s1);
      }
      mma_tf32(d0[u], a00, a01, a02, a03, b0, b1);  // big A x big B
      mma_tf32(d1[u], a10, a11, a12, a13, b0, b1);
    }
  }
  // Row r of a tile: lane 4 (r & 7) holds it, in c0 for r < 8, else c2.
  const int src = (lane & 7) << 2, q = lane >> 3;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u >= cnt) continue;
    const float v00 = __shfl_sync(FULL, d0[u][0], src), v01 = __shfl_sync(FULL, d0[u][2], src);
    const float v10 = __shfl_sync(FULL, d1[u][0], src), v11 = __shfl_sync(FULL, d1[u][2], src);
    g[u] = q == 0 ? v00 : q == 1 ? v01 : q == 2 ? v10 : v11;
  }
}

// g[u] = the sum over k < n, in order, of idx[u] == k ? tab[k] : 0, for
// u < cnt: a trip's compare-select loops side by side.
template <int U>
__device__ __forceinline__ void select_trip(const float* tab, int n, const int (&idx)[U],
                                            int cnt, float (&g)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) g[u] = 0.0f;
  for (int k = 0; k < n; ++k) {
    const float v = tab[k];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < cnt) g[u] = g[u] + (idx[u] == k ? v : 0.0f);
  }
}

// ----------------------------------------------------- perf_probe21.py:73

enum { P21_NONE, P21_GLOBAL, P21_LDG, P21_SHARED, P21_ONEHOT, P21_SELECT };

// U: iterations a trip; 0, the serial loop in blocks of BLOCK.
template <int F, int U>
constexpr int BLOCK21 = U == 0 ? BLOCK : gather_block(F == P21_ONEHOT);

template <int F, int U>
__global__ void __launch_bounds__(BLOCK21<F, U>)
    probe21(ProbeGather a, const float* tab, const int* idx0, float* out) {
  constexpr int B = BLOCK21<F, U>;
  extern __shared__ __align__(16) float s_tab[];
  if constexpr (F == P21_ONEHOT) {
    for (int k = threadIdx.x; k < a.n; k += B) s_tab[k] = tf32(tab[k]);
    __syncthreads();
  } else if constexpr (F == P21_SHARED || F == P21_SELECT) {
    stage_bulk(s_tab, tab, a.n * sizeof(float));
  }
  const int e = blockIdx.x * B + threadIdx.x;
  const int mask = a.n - 1, i0 = idx0[e];
  auto fetch = [&](int i) -> float {
    const int idx = (i0 + i) & mask;
    if constexpr (F == P21_NONE) {
      return (float)idx;
    } else if constexpr (F == P21_GLOBAL) {
      return ld_global(tab + idx);
    } else if constexpr (F == P21_LDG) {
      return __ldg(tab + idx);
    } else {
      return s_tab[idx];
    }
  };
  float acc;
  if constexpr (U == 0) {
    acc = serial_loop(a.iters, fetch);
  } else if constexpr (F == P21_ONEHOT || F == P21_SELECT) {
    acc = gather_loop<U, false>(a.iters, [&](int i, int n, float(&g)[U]) {
      int idx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) idx[u] = (i0 + i + u) & mask;
      if constexpr (F == P21_ONEHOT) {
        onehot_trip<false>(s_tab, nullptr, a.n, idx, n, g);
      } else {
        select_trip(s_tab, a.n, idx, n, g);
      }
    });
  } else {
    acc = gather_loop<U, true>(a.iters, each<U>(fetch));
  }
  out[e] = acc;
}

template <int F, int U>
int launch21(const ProbeGather* a, const float* tab, const int* idx0, float* out, void* stream) {
  constexpr int B = BLOCK21<F, U>;
  const bool staged = F == P21_SHARED || F == P21_ONEHOT || F == P21_SELECT;
  const size_t smem = staged ? a->n * sizeof(float) : 0;
  probe21<F, U><<<TILE / B, B, smem, (cudaStream_t)stream>>>(*a, tab, idx0, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- perf_probe21b.py:88

enum { B_NONE, B_TALA1, B_TALA0, B_ROWSEL, B_ONEHOT_HI };
enum { H_LDG, H_SHARED, H_SHFL };

// tala0's register home takes a select on the thread's own registers, no
// shuffle.
template <int OP, int HOME, int U>
constexpr int BLOCK21B =
    U == 0 ? BLOCK
           : gather_block((HOME == H_SHFL && OP != B_TALA0) || OP == B_ONEHOT_HI);

template <int OP, int HOME, int U>
__global__ void __launch_bounds__(BLOCK21B<OP, HOME, U>)
    probe21b(ProbeGather a, const float* tab, const int* idx0, float* out) {
  constexpr int B = BLOCK21B<OP, HOME, U>;
  // The table (shared), or its TF32 big and small parts (onehot_hi).
  __shared__ __align__(16) float s_tab[2 * TILE];
  const int e = blockIdx.x * B + threadIdx.x;
  const int row = e / TILE_W, col = e % TILE_W, lane = threadIdx.x & 31;
  if constexpr (OP == B_ONEHOT_HI) {
    for (int k = threadIdx.x; k < TILE; k += B) {
      const float v = tab[k], big = tf32(v);
      s_tab[k] = big;
      s_tab[TILE + k] = tf32(v - big);
    }
    __syncthreads();
  } else if constexpr (HOME == H_SHARED) {
    stage_bulk(s_tab, tab, TILE * sizeof(float));
  }
  // shfl: tala1 holds the warp's row (element c in lane c & 31, register
  // c >> 5), tala0 the thread's own column, rowsel the whole table (flat f
  // in lane f & 31, register f >> 5).
  constexpr int R = HOME != H_SHFL ? 1 : OP == B_TALA1 ? 4 : OP == B_TALA0 ? 16 : 64;
  float reg[R];
  if constexpr (HOME == H_SHFL) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      reg[r] = __ldg(tab + (OP == B_TALA1   ? row * TILE_W + lane + 32 * r
                            : OP == B_TALA0 ? r * TILE_W + col
                                            : lane + 32 * r));
  }
  const int i0 = idx0[e];
  auto fetch = [&](int i) -> float {
    const int idx = (i0 + i) & (TILE - 1);
    if constexpr (OP == B_NONE) {
      return (float)idx;
    } else if constexpr (HOME == H_SHFL && OP == B_TALA0) {
      return reg_select(reg, idx & 15);
    } else if constexpr (HOME == H_SHFL) {
      const int f = OP == B_TALA1 ? idx & 127 : idx;
      return shfl_select(reg, f & 31, f >> 5);
    } else {
      const int f = OP == B_TALA1   ? row * TILE_W + (idx & 127)
                    : OP == B_TALA0 ? (idx & 15) * TILE_W + col
                                    : (idx >> 7) * TILE_W + (idx & 127);
      return HOME == H_LDG ? __ldg(tab + f) : s_tab[f];
    }
  };
  float acc;
  if constexpr (U == 0) {
    acc = serial_loop(a.iters, fetch);
  } else if constexpr (OP == B_ONEHOT_HI) {
    acc = gather_loop<U, false>(a.iters, [&](int i, int n, float(&g)[U]) {
      int idx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) idx[u] = (i0 + i + u) & (TILE - 1);
      onehot_trip<true>(s_tab, s_tab + TILE, TILE, idx, n, g);
    });
  } else {
    acc = gather_loop<U, HOME != H_SHFL>(a.iters, each<U>(fetch));
  }
  out[e] = acc;
}

template <int OP, int HOME, int U>
int launch21b(const ProbeGather* a, const float* tab, const int* idx0, float* out,
              void* stream) {
  constexpr int B = BLOCK21B<OP, HOME, U>;
  probe21b<OP, HOME, U><<<TILE / B, B, 0, (cudaStream_t)stream>>>(*a, tab, idx0, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- perf_probe21c.py:65

enum { C_NONE, C_F2I, C_ATAN2F, C_ATAN2_POLY, C_PACKED };

// The values an iteration adds: packed's r, g, b; one for the others.
template <int F>
constexpr int VALS21C = F == C_PACKED ? 3 : 1;

// U: iterations a trip; 0, the serial loop in blocks of BLOCK.
template <int U>
constexpr int BLOCK21C = U == 0 ? BLOCK : GBLOCK;

// v[0, VALS21C<F>) of iteration i at x = xe + 0.001 i, in their order.
template <int F>
__device__ __forceinline__ void values21c(const int32_t* tab, float xe, int i, float* v) {
  const float x = xe + 0.001f * (float)i;
  if constexpr (F == C_NONE) {
    v[0] = x;
  } else if constexpr (F == C_ATAN2F) {
    v[0] = atan2f(x, 1.0f - x);
  } else if constexpr (F == C_ATAN2_POLY) {
    v[0] = trt::atan2_poly(x, 1.0f - x);
  } else {
    // The texel index of uv on a 32x32 texture; x >= 0, so u, v < 1.
    const float x17 = x * 1.7f;
    const float u = x - floorf(x), w = x17 - floorf(x17);
    const int idx = (int)floorf(w * 32.0f) * 32 + (int)floorf(u * 32.0f);
    if constexpr (F == C_F2I) {
      v[0] = (float)idx;
    } else {
      const trt::V3 c = trt::unpack_texel(__ldg(tab + idx));
      v[0] = c.x;
      v[1] = c.y;
      v[2] = c.z;
    }
  }
}

template <int F, int U>
__global__ void __launch_bounds__(BLOCK21C<U>)
    probe21c(ProbeGather a, const int32_t* tab, const float* x0, float* out) {
  constexpr int B = BLOCK21C<U>, V = VALS21C<F>;
  const int e = blockIdx.x * B + threadIdx.x;
  const float xe = x0[e];
  float acc = 0.0f;
  if constexpr (U == 0) {
    for (int i = 0; i < a.iters; ++i) {
      float v[V];
      values21c<F>(tab, xe, i, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc = acc + v[k];
    }
  } else {
    acc = gather_loop<U, true, V>(a.iters, [&](int i, int n, float(&g)[U * V]) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < n) values21c<F>(tab, xe, i + u, g + u * V);
    });
  }
  out[e] = acc;
}

template <int F, int U>
int launch21c(const ProbeGather* a, const int32_t* tab, const float* x0, float* out,
              void* stream) {
  constexpr int B = BLOCK21C<U>;
  probe21c<F, U><<<TILE / B, B, 0, (cudaStream_t)stream>>>(*a, tab, x0, out);
  return (int)cudaGetLastError();
}

// ------------------------------------- probe_when.py:54, probe_cond.py:58

enum { BR_GUARDED, BR_UNGUARDED, BR_DIVERGENT };

// v mod 1000 with the sign of the divisor, as jnp's % on int32.
__device__ __forceinline__ int mod1000(int v) {
  const int m = v % 1000;
  return m < 0 ? m + 1000 : m;
}

// The predicate's residue mod1000(i * 40503 + seed) of iteration i + 1 from
// iteration i's: 40503 = 503 (mod 1000), so it is r + 503, less 1000 where
// that reaches 1000. Each iteration still computes and tests its own residue
// (nothing hoisted, no table), in three integer instructions where the
// division by 1000 took seven. The division ran on the uniform datapath in
// the guarded forms, but a uniform instruction takes a dispatch slot like
// any other: an untaken iteration cost 14-15 slots, against 6-7 now (nvcc
// keeps the carried residue in a vector register).
__device__ __forceinline__ int next_residue(int r) {
  r += 503;
  return r >= 1000 ? r - 1000 : r;
}

// floor(y * s) for s a power of two. FRND: floorf. Else on the FP32 pipe:
// y * s + C with C = 1.5 * 2^23, rounded down once. For y * s exact and in
// [-2^22, 2^22) the exact sum lies in [2^23, 2^24), where floats are 1
// apart, so it rounds to C + floor(y * s) and the subtraction of C is
// exact. It gives +0.0 where floorf gives -0.0 (y * s = -0.0 only).
// --fmad=false leaves the explicit __fmaf_rd alone.
template <bool FRND>
__device__ __forceinline__ float floor_scaled(float y, float s) {
  if constexpr (FRND) {
    return floorf(y * s);
  } else {
    constexpr float C = 0x1.8p23f;
    return __fmaf_rd(y, s, C) - C;
  }
}

// Run body(pred) for i < iters, pred = mod1000(i * 40503 + seed) < thresh.
// The shipped loop carries the residue (next_residue), four iterations an
// unrolled trip; FRND, the design the shipped one replaced, divides every
// iteration.
template <bool FRND, typename Body>
__device__ __forceinline__ void branch_loop(const ProbeBranch& a, int seed, Body body) {
  if constexpr (FRND) {
    for (int i = 0; i < a.iters; ++i) body(mod1000(i * 40503 + seed) < a.thresh);
  } else {
    int r = mod1000(seed);
#pragma unroll 4
    for (int i = 0; i < a.iters; ++i, r = next_residue(r)) body(r < a.thresh);
  }
}

template <int F, bool FRND>
__global__ void __launch_bounds__(BR_BLOCK)
    probe_when(ProbeBranch a, const float* x, float* out) {
  const int e = blockIdx.x * BR_BLOCK + threadIdx.x;
  const int seed = F == BR_DIVERGENT ? a.seed + e : a.seed;
  float acc = x[e];
  branch_loop<FRND>(a, seed, [&](bool pred) {
    if (F == BR_UNGUARDED || pred) {
      float y = acc;
      for (int h = 0; h < 48; ++h) {
        y = y * 1.0000001f + 0.3f;
        y = y - floor_scaled<FRND>(y, 0.25f);
      }
      acc = y;
    }
  });
  out[blockIdx.y * TILE + e] = acc;
}

template <bool FRND>
__device__ __forceinline__ float heavy_cond(float y) {
  for (int h = 0; h < 40; ++h) {
    y = y * 1.000001f + 0.5f;
    y = y - floor_scaled<FRND>(y, 0.5f);
  }
  return y;
}

template <int F, bool FRND>
__global__ void __launch_bounds__(BR_BLOCK) probe_cond(ProbeBranch a, float* out) {
  const int e = blockIdx.x * BR_BLOCK + threadIdx.x;
  const int seed = F == BR_DIVERGENT ? a.seed + e : a.seed;
  float x = (float)(e % TILE_W) * 0.01f;
  branch_loop<FRND>(a, seed, [&](bool pred) {
    if constexpr (F == BR_UNGUARDED) {
      const float w = pred ? 1.0f : 0.0f;
      x = w * 0.0f + heavy_cond<FRND>(x);
    } else if (pred) {
      x = heavy_cond<FRND>(x);
    } else {
      x = x + 0.0f;
    }
  });
  out[blockIdx.y * TILE + e] = x;
}

}  // namespace

// Every entry: out f32 [16, 128] (branch probes [copies, 16, 128]) on the
// given stream; returns cudaGetLastError().

// The gather forms' and probe21c's iterations a trip, each form's fastest
// of 4, 8, 16 and 32 (tools/gather_tune.py); -DTRT_GATHER_U=u gives every
// form u for that sweep. 0: the serial loop the shipped one replaced.
#ifdef TRT_GATHER_U
#define TRIP(u) TRT_GATHER_U
#else
#define TRIP(u) u
#endif

#define PROBE21(form, F, U)                                                               \
  extern "C" int trt_probe21_##form(const ProbeGather* a, const float* tab, const int* idx0, \
                                    float* out, void* stream) {                          \
    return launch21<F, U>(a, tab, idx0, out, stream);                                    \
  }
PROBE21(none, P21_NONE, TRIP(32))
PROBE21(global, P21_GLOBAL, TRIP(32))
PROBE21(ldg, P21_LDG, TRIP(32))
PROBE21(shared, P21_SHARED, TRIP(32))
PROBE21(onehotmm, P21_ONEHOT, TRIP(8))
PROBE21(selectacc, P21_SELECT, TRIP(16))
PROBE21(none_serial, P21_NONE, 0)
PROBE21(ldg_serial, P21_LDG, 0)

#define PROBE21B(form, OP, HOME, U)                                                        \
  extern "C" int trt_probe21b_##form(const ProbeGather* a, const float* tab, const int* idx0, \
                                     float* out, void* stream) {                          \
    return launch21b<OP, HOME, U>(a, tab, idx0, out, stream);                             \
  }
PROBE21B(none, B_NONE, H_LDG, TRIP(32))
PROBE21B(tala1_ldg, B_TALA1, H_LDG, TRIP(32))
PROBE21B(tala1_shared, B_TALA1, H_SHARED, TRIP(32))
PROBE21B(tala1_shfl, B_TALA1, H_SHFL, TRIP(16))
PROBE21B(tala0_ldg, B_TALA0, H_LDG, TRIP(32))
PROBE21B(tala0_shared, B_TALA0, H_SHARED, TRIP(32))
PROBE21B(tala0_shfl, B_TALA0, H_SHFL, TRIP(16))
PROBE21B(rowsel_ldg, B_ROWSEL, H_LDG, TRIP(32))
PROBE21B(rowsel_shared, B_ROWSEL, H_SHARED, TRIP(16))
PROBE21B(rowsel_shfl, B_ROWSEL, H_SHFL, TRIP(4))
PROBE21B(onehot_hi, B_ONEHOT_HI, H_SHARED, TRIP(8))
PROBE21B(none_serial, B_NONE, H_LDG, 0)
PROBE21B(rowsel_ldg_serial, B_ROWSEL, H_LDG, 0)

#define PROBE21C(form, F, U)                                                               \
  extern "C" int trt_probe21c_##form(const ProbeGather* a, const int32_t* tab, const float* x0, \
                                     float* out, void* stream) {                          \
    return launch21c<F, U>(a, tab, x0, out, stream);                                      \
  }
PROBE21C(none, C_NONE, TRIP(32))
PROBE21C(f2i, C_F2I, TRIP(16))
PROBE21C(atan2f, C_ATAN2F, TRIP(8))
PROBE21C(atan2_poly, C_ATAN2_POLY, TRIP(16))
PROBE21C(packed, C_PACKED, TRIP(32))
PROBE21C(atan2f_serial, C_ATAN2F, 0)
PROBE21C(packed_serial, C_PACKED, 0)

#define PROBE_WHEN(form, F, FRND)                                                           \
  extern "C" int trt_probe_when_##form(const ProbeBranch* a, const float* x, float* out,     \
                                       void* stream) {                                     \
    probe_when<F, FRND><<<dim3(TILE / BR_BLOCK, a->copies), BR_BLOCK, 0,                   \
                          (cudaStream_t)stream>>>(*a, x, out);                             \
    return (int)cudaGetLastError();                                                        \
  }
PROBE_WHEN(guarded, BR_GUARDED, false)
PROBE_WHEN(unguarded, BR_UNGUARDED, false)
PROBE_WHEN(divergent, BR_DIVERGENT, false)
PROBE_WHEN(guarded_frnd, BR_GUARDED, true)

#define PROBE_COND(form, F, FRND)                                                           \
  extern "C" int trt_probe_cond_##form(const ProbeBranch* a, float* out, void* stream) {     \
    probe_cond<F, FRND><<<dim3(TILE / BR_BLOCK, a->copies), BR_BLOCK, 0,                   \
                          (cudaStream_t)stream>>>(*a, out);                                \
    return (int)cudaGetLastError();                                                        \
  }
PROBE_COND(cond, BR_GUARDED, false)
PROBE_COND(unguarded, BR_UNGUARDED, false)
PROBE_COND(divergent, BR_DIVERGENT, false)
PROBE_COND(cond_frnd, BR_GUARDED, true)
