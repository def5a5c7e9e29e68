// Sweep-resident dense p-bit sampling engine for NVIDIA Hopper (sm_90a): K3.
//
// Replaces the TPU kernel src/repro/kernels/sweep_fused.py::sweep_fused_pallas
// (:545; its pallas_call at :504, body `_kernel` with sparse=False).  One
// launch runs S chromatic sweeps of a tile of chains whose spins stay on
// chip: eqn 1 is the dense product with the (N, N) couplings W, eqn 2 the
// tanh + noise + comparator, the noise the reference's own integer streams
// (counter hash or per-cell Galois LFSR, pbit_common.cuh, shared with K1 and
// K2), and optionally the first moment s_sum (N,), the second moment as the
// Gram matrix sum m^T m (N, N), and the visible-pattern histogram.
//
// Two bodies for the sweeps, chosen by shape in Python
// (kernels/sweep_fused.py::dense_plan), and one statistics kernel:
//
// * cluster body (k3_cluster_sweeps), where W fits the shared memory of a
//   thread-block cluster of k = 1..16 CTAs (on an H100, N up to 452 at
//   k=4, 632 at k=8, 868 at k=16) and the clusters the card holds at once
//   cover the chains in at most 4 waves.
//   A cluster owns a tile of chains for all 2S half-sweeps.  Each colour's
//   update list is split into k even pieces; each CTA holds the float32
//   rows of W of its pieces in its own shared memory, read once per launch,
//   and a full copy of the tile's spins (float +-1, node-major, chains
//   contiguous).  A thread sums eqn 1 for one node and four chains.  What
//   bounds it: the dependent chain of N adds per (node, chain) — about 4N
//   cycles a half-sweep, ~1 us at N=440 — and the instructions that feed
//   it from shared memory (per four terms of four chains: one 16-byte read
//   of the W row, four 16-byte spin vectors, sixteen FMAs).  The design
//   hides the add latency behind the four chains a thread carries and the
//   threads of the CTA, reads W from shared memory instead of L2 (rows
//   padded to a stride of 4 mod 32 words: conflict-free 16-byte reads),
//   picks the cluster size whose resident clusters cover the chains in
//   one wave, and pays one cluster barrier per half-sweep: each CTA
//   writes its new spins into every CTA's next buffer through distributed
//   shared memory (synchronous, Jacobi: a dense W may couple one colour),
//   nodes outside the colour are copied locally, then barrier.cluster
//   (arrive.release / wait.acquire) and the buffers swap.
// * streamed body (k3_streamed_sweeps), for larger N or more waves: a
//   block per chain tile, W passed transposed and read from L2 every
//   half-sweep (bound by those reads, one per term), double-buffered float
//   spins.
//
// In both, eqn 1 is the sequential float32 sum over ascending j from +0.0
// (no tensor cores, no split-K): spins are +-1, so w*m is exact and
// __fmaf_rn(w, m, acc) rounds exactly as __fadd_rn(acc, __fmul_rn(w, m));
// the sum equals the plain version and, on a Chimera chip, K1's
// ascending-slot sum bit for bit (zeros are additive identities).
//
// Statistics: on every sweep s with measured[s] != 0 the sweeps write the
// tile's spins as int8 into a record (S, N, B_pad) — node-major, chains
// contiguous, B_pad = B rounded up to 32, padding chains 0.  After the
// sweeps, k3_stats walks the record in sweep order: the upper-triangular
// 64x64 tiles of the Gram take each sweep's integer m^T m on the int8
// tensor cores (mma.sync m16n8k32 s8.s8.s32, fragments loaded straight
// from the record) and accumulate acc = __fadd_rn(acc, __fmul_rn(w_s,
// corr)) in registers, mirrored into both triangles; s_sum and the
// histogram take the same record in the same order.  That is
// sweep_fused_ref's order (c_sum + w * pair_sums(m)), so the statistics
// equal the plain version bit for bit for any float weights.  No atomics
// in float sums, no per-block partials.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

namespace cg = cooperative_groups;

namespace {

using pbit::kNoiseLfsr;

constexpr int kChainsPerThread = 4;  // cluster body: chains one thread sums
constexpr int kGramTile = 64;        // statistics: edge of a Gram tile
constexpr int kStatsThreads = 128;   // statistics: four warps, 32x32 each

struct Params {
  const float* m_in;          // (B, N) spins, +-1
  float* m_out;               // (B, N)
  int B, N, S;
  const float* W;             // (N, N) couplings (cluster body)
  const float* WT;            // (N, N) transposed couplings (streamed body)
  const float* h;             // (N,) rows
  const float* gain;
  const float* off;
  const float* rg;
  const float* co;
  const uint8_t* mask0;       // (N,) colour-0 update set
  const uint8_t* mask1;       // (N,) colour-1 update set
  const float* betas;         // (S, B)
  const uint8_t* clamp_mask;  // (N,) or null
  const float* clamp_values;  // (B, N) or null
  const float* measured;      // (S,) or null
  int noise_mode;
  const uint32_t* noise_in;   // counter: (2,) = (seed, ctr0); lfsr: (B, C)
  uint32_t* noise_out;
  int C;                      // LFSR cells per chain
  const int* perm;            // (N,) node -> flat LFSR column, or null
  int decimation;
  uint32_t row0, col0;        // counter-hash coordinate offsets
  int8_t* rec;                // (S, N, B_pad) spin record, or null
  int B_pad;
  int tb;                     // chains per tile (a block or a cluster)
  int rows_cap;               // cluster body: W rows a CTA holds
};

// The noise byte of (chain b of the tile, node i) in this half-sweep.
__device__ __forceinline__ uint32_t noise_byte(const Params& p, bool lfsr,
                                               const uint32_t* lf,
                                               uint32_t half_key, int b0,
                                               int b, int i) {
  return lfsr ? pbit::lfsr_byte(lf + b * p.C, pbit::lfsr_tap(p.perm[i], p.C))
              : pbit::counter_byte(half_key, b0 + b, p.row0,
                                   pbit::counter_col_key(i, p.col0));
}

// rec[s][i][b0 + b] = spin(b, i) for nodes [lo, hi) and the tile's nb
// chains; the tile that holds chain B-1 also zeroes the padding chains
// [B, B_pad).  No barrier.
template <typename Spin>
__device__ __forceinline__ void record_sweep(const Params& p, int s, int b0,
                                             int nb, int lo, int hi,
                                             Spin spin, int tid, int nt) {
  int8_t* base = p.rec + (size_t)s * p.N * p.B_pad;
  const int width = nb + (b0 + nb == p.B ? p.B_pad - p.B : 0);
  for (int k = tid; k < (hi - lo) * width; k += nt) {
    const int r = k / width, b = k - r * width, i = lo + r;
    base[(size_t)i * p.B_pad + b0 + b] = b < nb ? (int8_t)spin(b, i) : 0;
  }
}

// ---------------------------------------------------------------------------
// cluster body: W rows resident across the CTAs of a cluster
// ---------------------------------------------------------------------------
// A row of W in shared memory: N4 = N rounded up to 4 (zeros past N), its
// stride Np >= N4 with Np = 4 (mod 32), so that eight lanes reading 16
// bytes of eight consecutive rows touch all 32 banks once.
__host__ __device__ inline int w_row_words(int N) {
  const int n4 = (N + 3) & ~3;
  return ((n4 - 4 + 31) / 32) * 32 + 4;
}

// Where chain b of the tile reads node i in a spin buffer [G][N4][4].
__device__ __forceinline__ size_t spin_at(int b, int i, int N4) {
  return ((size_t)(b >> 2) * N4 + i) * 4 + (b & 3);
}

// Shared memory of one CTA (kernels/sweep_fused.py::cluster_smem_bytes):
// two spin buffers [G][N4][4] float — four chains of a node side by side,
// nodes of a group of four chains contiguous, so one thread's spins for
// consecutive j are consecutive 16-byte vectors; rows past N hold +1 and
// meet zero couplings — the W rows [rows_cap][Np] float, the tile's LFSR
// registers [tb][C], the two colours' update lists, 33 ints of compaction
// scratch and each node's colour bits [N] uint8.
__global__ void __launch_bounds__(512, 1) k3_cluster_sweeps(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / k;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = p.N, B = p.B, C = p.C, tb = p.tb, rows_cap = p.rows_cap;
  const int N4 = (N + 3) & ~3, Np = w_row_words(N);
  const int G = (tb + kChainsPerThread - 1) / kChainsPerThread;
  const int tbp = G * kChainsPerThread;  // the tile's chains, padded
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + (size_t)N4 * tbp;
  float* Ws = buf1 + (size_t)N4 * tbp;
  uint32_t* lf = reinterpret_cast<uint32_t*>(Ws + (size_t)rows_cap * Np);
  int* list0 = reinterpret_cast<int*>(lf + (size_t)tb * C);
  int* list1 = list0 + N;
  int* scratch = list1 + N;
  uint8_t* colour = reinterpret_cast<uint8_t*>(scratch + 33);  // [N] bits

  const int b0 = tile * tb;
  const int nb = min(tb, B - b0);
  const bool lfsr = p.noise_mode == kNoiseLfsr;
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;

  for (int i = tid; i < N; i += nt)
    colour[i] = (p.mask0[i] ? 1 : 0) | (p.mask1[i] ? 2 : 0);
  const int n0 = pbit::compact_mask(p.mask0, N, list0, scratch, tid, nt);
  const int n1 = pbit::compact_mask(p.mask1, N, list1, scratch, tid, nt);
  // this CTA's piece of each colour's list: slots [0, m0) hold colour 0,
  // [m0, m0 + m1) colour 1; rows past rows_cap (only when the masks share
  // nodes) are read from device memory instead
  const int R0 = (n0 + k - 1) / k, R1 = (n1 + k - 1) / k;
  const int lo0 = min(n0, rank * R0), m0 = min(n0, lo0 + R0) - lo0;
  const int lo1 = min(n1, rank * R1), m1 = min(n1, lo1 + R1) - lo1;
  const int held = min(m0 + m1, rows_cap);
  // a warp per row: coalesced reads of W, contiguous writes
  const int lane = tid & 31, n_warps = nt >> 5;
  for (int slot = tid >> 5; slot < held; slot += n_warps) {
    const int node = slot < m0 ? list0[lo0 + slot] : list1[lo1 + slot - m0];
    const float* src = p.W + (size_t)node * N;
    float* dst = Ws + (size_t)slot * Np;
#pragma unroll 4
    for (int j = lane; j < N4; j += 32) dst[j] = j < N ? src[j] : 0.0f;
  }
  for (int e = tid; e < N4 * tbp; e += nt) {
    const int b = e / N4, i = e - b * N4;
    const float v =
        (b < nb && i < N)
            ? (float)pbit::sign_spin(p.m_in[(size_t)(b0 + b) * N + i])
            : 1.0f;
    buf0[spin_at(b, i, N4)] = v;
    buf1[spin_at(b, i, N4)] = v;
  }
  if (lfsr)
    for (int e = tid; e < nb * C; e += nt)
      lf[e] = p.noise_in[(size_t)b0 * C + e];
  uint32_t seed = 0, ctr0 = 0;
  if (!lfsr) {
    seed = p.noise_in[0];
    ctr0 = p.noise_in[1];
  }
  // every CTA of the cluster runs before any writes into its shared memory
  cluster.sync();

  // the nodes whose record rows and outputs this CTA writes
  const int per = (N + k - 1) / k;
  const int own_lo = min(N, rank * per), own_hi = min(N, own_lo + per);
  float* cur = buf0;
  float* nxt = buf1;
  const int n_half = 2 * p.S;
  for (int j = 0; j < n_half; ++j) {
    const int s = j >> 1;  // sweep: indexes betas and measured
    const int c = j & 1;   // colour
    bool barrier = false;
    // clamps are re-imposed at the start of every sweep
    if (has_clamp && c == 0) {
      for (int e = tid; e < nb * N; e += nt) {
        const int b = e / N, i = e - b * N;
        if (p.clamp_mask[i])
          cur[spin_at(b, i, N4)] = (float)pbit::sign_spin(
              p.clamp_values[(size_t)(b0 + b) * N + i]);
      }
      barrier = true;
    }
    uint32_t half_key = 0;
    if (lfsr) {
      pbit::lfsr_step_tile(lf, nb * C, p.decimation, tid, nt);
      barrier = true;
    } else {
      half_key = pbit::counter_half_key(seed, ctr0 + (uint32_t)j);
    }
    if (barrier) __syncthreads();

    const float4* cur4 = reinterpret_cast<const float4*>(cur);
    float4* nxt4 = reinterpret_cast<float4*>(nxt);
    // nodes outside the colour keep their spin: a local copy
    for (int i = tid; i < N; i += nt)
      if (!(colour[i] & (1 << c)))
        for (int g = 0; g < G; ++g)
          nxt4[(size_t)g * N4 + i] = cur4[(size_t)g * N4 + i];

    const int* list = c ? list1 : list0;
    const int lo = c ? lo1 : lo0;
    const int cnt = c ? m1 : m0;
    const int base = c ? m0 : 0;
    for (int q = tid; q < cnt * G; q += nt) {
      const int li = q % cnt, g = q / cnt;
      const int i = list[lo + li];
      const int slot = base + li;
      const float4* sj = cur4 + (size_t)g * N4;  // this group's spins by j
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      if (slot < rows_cap) {
        // four terms a step: one 16-byte read of the row, four of spins,
        // at constant offsets from two pointers; the next step's reads
        // are issued before this step's FMAs, so the shared-memory latency
        // hides behind the add chain
        const float4* w4 = reinterpret_cast<const float4*>(Ws + (size_t)slot * Np);
        const float4* const w_end = w4 + N4 / 4 - 1;
        float4 w = w4[0], v0 = sj[0], v1 = sj[1], v2 = sj[2], v3 = sj[3];
        auto step = [&](const float4& x, const float4& y0, const float4& y1,
                        const float4& y2, const float4& y3) {
          a0 = __fmaf_rn(x.x, y0.x, a0);
          a1 = __fmaf_rn(x.x, y0.y, a1);
          a2 = __fmaf_rn(x.x, y0.z, a2);
          a3 = __fmaf_rn(x.x, y0.w, a3);
          a0 = __fmaf_rn(x.y, y1.x, a0);
          a1 = __fmaf_rn(x.y, y1.y, a1);
          a2 = __fmaf_rn(x.y, y1.z, a2);
          a3 = __fmaf_rn(x.y, y1.w, a3);
          a0 = __fmaf_rn(x.z, y2.x, a0);
          a1 = __fmaf_rn(x.z, y2.y, a1);
          a2 = __fmaf_rn(x.z, y2.z, a2);
          a3 = __fmaf_rn(x.z, y2.w, a3);
          a0 = __fmaf_rn(x.w, y3.x, a0);
          a1 = __fmaf_rn(x.w, y3.y, a1);
          a2 = __fmaf_rn(x.w, y3.z, a2);
          a3 = __fmaf_rn(x.w, y3.w, a3);
        };
#pragma unroll 2
        for (; w4 < w_end; ++w4, sj += 4) {
          const float4 wn = w4[1];
          const float4 n0 = sj[4], n1 = sj[5], n2 = sj[6], n3 = sj[7];
          step(w, v0, v1, v2, v3);
          w = wn;
          v0 = n0;
          v1 = n1;
          v2 = n2;
          v3 = n3;
        }
        step(w, v0, v1, v2, v3);
      } else {
        const float* wi = p.W + (size_t)i * N;
        for (int jj = 0; jj < N; ++jj) {
          const float w = wi[jj];
          const float4 v = sj[jj];
          a0 = __fmaf_rn(w, v.x, a0);
          a1 = __fmaf_rn(w, v.y, a1);
          a2 = __fmaf_rn(w, v.z, a2);
          a3 = __fmaf_rn(w, v.w, a3);
        }
      }
      const float h_i = p.h[i], gain_i = p.gain[i], off_i = p.off[i];
      const float rg_i = p.rg[i], co_i = p.co[i];
      // eqn 2 for chain r of the group (padding chains keep +1)
      auto spin = [&](float acc, int r) {
        const int b = g * kChainsPerThread + r;
        if (b >= nb) return 1.0f;
        const uint32_t byte = noise_byte(p, lfsr, lf, half_key, b0, b, i);
        return (float)pbit::sign_spin(pbit::decision(
            acc, h_i, p.betas[(size_t)s * B + b0 + b], gain_i, off_i, rg_i,
            co_i, byte));
      };
      const float4 o = make_float4(spin(a0, 0), spin(a1, 1), spin(a2, 2),
                                   spin(a3, 3));
      // the new spins go into every CTA's next buffer
      for (int r = 0; r < k; ++r)
        cluster.map_shared_rank(nxt4, r)[(size_t)g * N4 + i] = o;
    }
    cluster.sync();
    float* t = cur;
    cur = nxt;
    nxt = t;

    // the sweep's spins into the record, weighted later by measured[s]
    if (c == 1 && p.rec != nullptr && p.measured[s] != 0.0f) {
      record_sweep(p, s, b0, nb, own_lo, own_hi,
                   [&](int b, int i) { return cur[spin_at(b, i, N4)]; },
                   tid, nt);
      __syncthreads();  // the next sweep's clamps write what was read
    }
  }

  for (int e = tid; e < nb * (own_hi - own_lo); e += nt) {
    const int b = e / (own_hi - own_lo), i = own_lo + e % (own_hi - own_lo);
    p.m_out[(size_t)(b0 + b) * N + i] = cur[spin_at(b, i, N4)];
  }
  if (rank == 0) {
    if (lfsr) {
      for (int e = tid; e < nb * C; e += nt)
        p.noise_out[(size_t)b0 * C + e] = lf[e];
    } else if (tile == 0 && tid == 0) {
      p.noise_out[0] = seed;
      p.noise_out[1] = ctr0 + (uint32_t)n_half;
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster.sync();
}

// ---------------------------------------------------------------------------
// streamed body: W read from L2 every half-sweep (large N)
// ---------------------------------------------------------------------------
// Shared memory (kernels/sweep_fused.py::dense_smem_bytes): two spin
// buffers [tb][N] float, the LFSR registers [tb][C], the two update lists
// and 33 ints of scratch.
__global__ void __launch_bounds__(1024) k3_streamed_sweeps(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x, blk = blockIdx.x;
  const int N = p.N, B = p.B, C = p.C, tb = p.tb;
  float* cur = reinterpret_cast<float*>(smem);  // [tb][N] spins being read
  float* nxt = cur + (size_t)tb * N;            // [tb][N] spins being written
  uint32_t* lf = reinterpret_cast<uint32_t*>(nxt + (size_t)tb * N);
  int* list0 = reinterpret_cast<int*>(lf + (size_t)tb * C);
  int* list1 = list0 + N;
  int* scratch = list1 + N;

  const int b0 = blk * tb;
  const int nb = min(tb, B - b0);  // real chains of this tile
  const bool lfsr = p.noise_mode == kNoiseLfsr;
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;

  for (int k = tid; k < nb * N; k += nt)
    cur[k] = (float)pbit::sign_spin(p.m_in[(size_t)b0 * N + k]);
  if (lfsr)
    for (int k = tid; k < nb * C; k += nt) lf[k] = p.noise_in[(size_t)b0 * C + k];
  const int n0 = pbit::compact_mask(p.mask0, N, list0, scratch, tid, nt);
  const int n1 = pbit::compact_mask(p.mask1, N, list1, scratch, tid, nt);

  uint32_t seed = 0, ctr0 = 0;
  if (!lfsr) {
    seed = p.noise_in[0];
    ctr0 = p.noise_in[1];
  }

  const int n_half = 2 * p.S;
  for (int j = 0; j < n_half; ++j) {
    const int s = j >> 1;
    const int c = j & 1;

    if (has_clamp && c == 0) {
      pbit::impose_clamps(cur, nb, N, p.clamp_mask,
                          p.clamp_values + (size_t)b0 * N, tid, nt);
      __syncthreads();
    }

    uint32_t half_key = 0;
    if (lfsr) {
      pbit::lfsr_step_tile(lf, nb * C, p.decimation, tid, nt);
      __syncthreads();
    } else {
      half_key = pbit::counter_half_key(seed, ctr0 + (uint32_t)j);
    }

    const uint8_t* mask = c ? p.mask1 : p.mask0;
    const int* list = c ? list1 : list0;
    const int n_c = c ? n1 : n0;

    for (int k = tid; k < nb * N; k += nt)
      if (!mask[k % N]) nxt[k] = cur[k];

    // (chain, node) pairs of the colour; neighbouring threads take
    // neighbouring nodes of one chain, which read one j's couplings from
    // neighbouring addresses of WT
    for (int k = tid; k < nb * n_c; k += nt) {
      const int b = k / n_c;
      const int i = list[k - b * n_c];
      const float* row = cur + (size_t)b * N;
      const float* col = p.WT + i;
      float acc = 0.0f;
#pragma unroll 8
      for (int jj = 0; jj < N; ++jj)
        acc = __fadd_rn(acc, __fmul_rn(col[(size_t)jj * N], row[jj]));
      const uint32_t byte = noise_byte(p, lfsr, lf, half_key, b0, b, i);
      const float beta = p.betas[(size_t)s * B + b0 + b];
      nxt[(size_t)b * N + i] = (float)pbit::sign_spin(pbit::decision(
          acc, p.h[i], beta, p.gain[i], p.off[i], p.rg[i], p.co[i], byte));
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;

    if (c == 1 && p.rec != nullptr && p.measured[s] != 0.0f) {
      record_sweep(p, s, b0, nb, 0, N,
                   [&](int b, int i) { return cur[(size_t)b * N + i]; },
                   tid, nt);
      __syncthreads();  // the next half-sweep writes what was read
    }
  }

  for (int k = tid; k < nb * N; k += nt) p.m_out[(size_t)b0 * N + k] = cur[k];
  if (lfsr) {
    for (int k = tid; k < nb * C; k += nt) p.noise_out[(size_t)b0 * C + k] = lf[k];
  } else if (blk == 0 && tid == 0) {
    p.noise_out[0] = seed;
    p.noise_out[1] = ctr0 + (uint32_t)n_half;
  }
}

// ---------------------------------------------------------------------------
// statistics from the record, in sweep order
// ---------------------------------------------------------------------------
struct StatsParams {
  const int8_t* rec;       // (S, N, B_pad)
  int N, B, B_pad, S;
  const float* measured;   // (S,)
  const int* visible_idx;  // (n_visible,) or null
  int n_visible;
  float* out_s;            // (N,) or null
  float* out_c;            // (N, N) or null
  float* out_h;            // (2^n_visible,) or null
  int carry;               // 1: continue the sums in out_*; 0: from +0
  int n_tiles;             // upper-triangular Gram tiles
  int n_sblocks;           // blocks of s_sum, kStatsThreads nodes each
};

// d += a (16x32, s8, row) * b (32x8, s8, col), s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 64x64 tile (ti <= tj) of the Gram: warp w owns rows ti*64 +
// (w/2)*32 and columns tj*64 + (w%2)*32, two m16 by four n8 fragments.
// Record rows are 32-bit words of four chains; A[i][k] and B[k][j] are
// both node rows of the record, so every fragment register is one word.
__device__ void gram_tile(const StatsParams& q, int t) {
  const int T = (q.N + kGramTile - 1) / kGramTile;
  int ti = 0;
  while (t >= T - ti) {
    t -= T - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int r_base = ti * kGramTile + (warp >> 1) * 32;
  const int c_base = tj * kGramTile + (warp & 1) * 32;
  const int N = q.N, words = q.B_pad / 4;
  const uint32_t* rec32 = reinterpret_cast<const uint32_t*>(q.rec);

  int rows[2][2], cols[4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb) {
    rows[mb][0] = r_base + mb * 16 + g;
    rows[mb][1] = rows[mb][0] + 8;
  }
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) cols[nb] = c_base + nb * 8 + g;

  float acc[2][4][4];
#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r_base + mb * 16 + g + (r >= 2 ? 8 : 0);
        const int col = c_base + nb * 8 + tq * 2 + (r & 1);
        acc[mb][nb][r] = (q.carry && row < N && col < N)
                             ? q.out_c[(size_t)row * N + col]
                             : 0.0f;
      }

  for (int s = 0; s < q.S; ++s) {
    const float w = q.measured[s];
    if (w == 0.0f) continue;
    const uint32_t* base = rec32 + (size_t)s * N * words;
    int d[2][4][4] = {};
    for (int kk = 0; kk < words; kk += 8) {  // 32 chains a step
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rows[mb][h];
          const uint32_t* src = base + (size_t)row * words + kk + tq;
          a[mb][h] = row < N ? src[0] : 0u;
          a[mb][h + 2] = row < N ? src[4] : 0u;
        }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const uint32_t* src = base + (size_t)cols[nb] * words + kk + tq;
        b[nb][0] = cols[nb] < N ? src[0] : 0u;
        b[nb][1] = cols[nb] < N ? src[4] : 0u;
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) mma_s8(d[mb][nb], a[mb], b[nb]);
    }
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mb][nb][r] = __fadd_rn(acc[mb][nb][r],
                                     __fmul_rn(w, (float)d[mb][nb][r]));
  }

#pragma unroll
  for (int mb = 0; mb < 2; ++mb)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r_base + mb * 16 + g + (r >= 2 ? 8 : 0);
        const int col = c_base + nb * 8 + tq * 2 + (r & 1);
        if (row < N && col < N) {
          q.out_c[(size_t)row * N + col] = acc[mb][nb][r];
          q.out_c[(size_t)col * N + row] = acc[mb][nb][r];
        }
      }
}

// s_sum[i] for one node per thread: each sweep's chain sum by dp4a over
// the node's record row.
__device__ void spin_sums(const StatsParams& q, int sb) {
  const int i = sb * kStatsThreads + threadIdx.x;
  if (i >= q.N) return;
  const int words = q.B_pad / 4;
  const int* rec32 = reinterpret_cast<const int*>(q.rec);
  float acc = q.carry ? q.out_s[i] : 0.0f;
  for (int s = 0; s < q.S; ++s) {
    const float w = q.measured[s];
    if (w == 0.0f) continue;
    const int* row = rec32 + ((size_t)s * q.N + i) * words;
    int sum = 0;
    for (int k = 0; k < words; ++k) sum = __dp4a(row[k], 0x01010101, sum);
    acc = __fadd_rn(acc, __fmul_rn(w, (float)sum));
  }
  q.out_s[i] = acc;
}

// The visible-pattern histogram: per sweep, integer counts per code
// (shared-memory atomics on integers: order-free), then hist[code] +=
// w * count for every code.
__device__ void visible_hist(const StatsParams& q, unsigned char* hsmem) {
  const int NB = 1 << q.n_visible;
  int* counts = reinterpret_cast<int*>(hsmem);
  float* hacc = reinterpret_cast<float*>(counts + NB);
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = tid; k < NB; k += nt) hacc[k] = q.carry ? q.out_h[k] : 0.0f;
  for (int s = 0; s < q.S; ++s) {
    const float w = q.measured[s];
    if (w == 0.0f) continue;
    for (int k = tid; k < NB; k += nt) counts[k] = 0;
    __syncthreads();
    const int8_t* base = q.rec + (size_t)s * q.N * q.B_pad;
    for (int b = tid; b < q.B; b += nt) {
      int code = 0;
      for (int v = 0; v < q.n_visible; ++v)
        code |= (base[(size_t)q.visible_idx[v] * q.B_pad + b] > 0) << v;
      atomicAdd(&counts[code], 1);
    }
    __syncthreads();
    for (int k = tid; k < NB; k += nt)
      hacc[k] = __fadd_rn(hacc[k], __fmul_rn(w, (float)counts[k]));
    __syncthreads();
  }
  for (int k = tid; k < NB; k += nt) q.out_h[k] = hacc[k];
}

__global__ void __launch_bounds__(kStatsThreads) k3_stats(const StatsParams q) {
  extern __shared__ __align__(16) unsigned char smem[];  // histogram only
  const int blk = blockIdx.x;
  if (blk < q.n_tiles)
    gram_tile(q, blk);
  else if (blk < q.n_tiles + q.n_sblocks)
    spin_sums(q, blk - q.n_tiles);
  else
    visible_hist(q, smem);
}

}  // namespace

extern "C" {

// Clusters of `k` CTAs of `threads` threads and `smem` bytes that the card
// can hold at once (0: the configuration cannot run).
int sweep_fused_max_clusters(int k, int threads, int smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      k3_cluster_sweeps, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (k > 8) {
    err = cudaFuncSetAttribute(
        k3_cluster_sweeps, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(out, k3_cluster_sweeps, &cfg);
  return (int)err;
}

// One window of sweeps: body 1 = cluster (k CTAs a cluster, `rows_cap` W
// rows a CTA), 0 = streamed (k = 1, a block per tile); `threads` and
// `smem` as kernels/sweep_fused.py::dense_plan computes them.  With a
// record, the statistics kernel follows on the same stream and writes
// out_s / out_c / out_h (each may be null), continuing their sums when
// `carry` is 1.
int sweep_fused_launch(
    const float* m_in, float* m_out, int B, int N, int S, const float* W,
    const float* WT, const float* h, const float* gain, const float* off,
    const float* rg, const float* co, const uint8_t* mask0,
    const uint8_t* mask1, const float* betas, const uint8_t* clamp_mask,
    const float* clamp_values, const float* measured, const int* visible_idx,
    int n_visible, int noise_mode, const uint32_t* noise_in,
    uint32_t* noise_out, int C, const int* perm, int decimation,
    uint32_t row0, uint32_t col0, int8_t* rec, int B_pad, float* out_s,
    float* out_c, float* out_h, int carry, int body, int k, int tb,
    int rows_cap, int threads, int smem, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Params p;
  p.m_in = m_in; p.m_out = m_out; p.B = B; p.N = N; p.S = S; p.W = W;
  p.WT = WT; p.h = h; p.gain = gain; p.off = off; p.rg = rg; p.co = co;
  p.mask0 = mask0; p.mask1 = mask1; p.betas = betas;
  p.clamp_mask = clamp_mask; p.clamp_values = clamp_values;
  p.measured = measured; p.noise_mode = noise_mode; p.noise_in = noise_in;
  p.noise_out = noise_out; p.C = C; p.perm = perm;
  p.decimation = decimation; p.row0 = row0; p.col0 = col0; p.rec = rec;
  p.B_pad = B_pad; p.tb = tb; p.rows_cap = rows_cap;

  const int n_tiles = (B + tb - 1) / tb;
  cudaError_t err;
  if (body == 1) {
    err = cudaFuncSetAttribute(
        k3_cluster_sweeps, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (k > 8) {
      err = cudaFuncSetAttribute(k3_cluster_sweeps,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
      if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles * k, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = k;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, k3_cluster_sweeps, p);
    if (err != cudaSuccess) return (int)err;
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          k3_streamed_sweeps, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return (int)err;
    }
    k3_streamed_sweeps<<<n_tiles, threads, smem, stream>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || rec == nullptr) return (int)err;

  StatsParams q;
  q.rec = rec; q.N = N; q.B = B; q.B_pad = B_pad; q.S = S;
  q.measured = measured; q.visible_idx = visible_idx;
  q.n_visible = n_visible; q.out_s = out_s; q.out_c = out_c; q.out_h = out_h;
  q.carry = carry;
  const int T = (N + kGramTile - 1) / kGramTile;
  q.n_tiles = out_c ? T * (T + 1) / 2 : 0;
  q.n_sblocks = out_s ? (N + kStatsThreads - 1) / kStatsThreads : 0;
  const int hist = out_h ? 1 : 0;
  const int hsmem = hist ? 8 << n_visible : 0;
  k3_stats<<<q.n_tiles + q.n_sblocks + hist, kStatsThreads, hsmem, stream>>>(q);
  return (int)cudaGetLastError();
}

const char* sweep_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
