// Sweep-resident slot-layout engine with the halo exchange inside the launch,
// for NVIDIA Hopper (sm_90a): K5.
//
// Replaces the TPU kernel
// src/repro/kernels/sweep_fused.py::sweep_sparse_exchange_pallas (body
// `_exchange_kernel`).  On the TPU every row band was a device of a mesh and
// the kernel moved the boundary spins to its row neighbours by remote DMA.  On
// one H100 every row band lives on the card: ONE launch runs all bands, and a
// band's halo columns are refreshed from its neighbours' boundary spins at
// every exchange point of the launch (`Sync.exchange_points()`), inside the
// kernel.
//
// What it computes (per band, per chain): K1's S chromatic sweeps (the same
// half-sweep and moments; counter noise) on the halo-extended block
// [local | halo_up | halo_dn] of N = n_loc + 2H columns, whose halo columns
// are never updated, with the launch split at the exchange points into
// half-sweep windows [h0, h1) (`kernels/ref.py::halo_exchange_segments`).
// Before window e every band publishes its boundary (the columns `send_up` /
// `send_dn` of its first / last cell row) and then
//   * barrier: installs the values its neighbours just published;
//   * async:   installs the values they published at exchange e-1 (window 0
//              runs on the halo columns the caller primed), and after the
//              last window the values of the last exchange are installed, so
//              the output carries them into the next launch.
// Edge bands install zeros, or with `edge_block` (the `edge_halos="block"`
// operand) keep the outer halo columns they were given: the first band's
// halo_up and the last band's halo_dn, which a rank of a process group
// fills between launches from its neighbouring ranks (the launch is then
// one window between exchange points, and the bands of the launch are one
// card's run of a lattice cut across cards).  Noise is the counter hash at
// (chain + row0, column + col0[band]) with counter ctr0 + half-sweep
// index; the noise state comes back as ctr0 + 2S.  Optional: per-band
// moments (as K1's, over the extended columns), clamps (re-imposed at every
// sweep start and at a window that opens on a second half), or a staged
// copy of the next program.
//
// What bounds it on this card: operations, as K1 (per update: D shared-memory
// gathers with a multiply-add, two 32-bit hashes, one tanhf), plus the
// exchanges; by the roofline's count the bytes of the spins read and written
// once (float32, 37.7 MB each way at 8 bands x 256 chains x 4608 columns).
// Two bodies, chosen by kernels/sweep_fused.py::exchange_plan before the
// launch:
//
//   * the cluster body (`sweep_exchange_cluster_kernel`; D = 6, R <= 16
//     bands, 9..16 with the non-portable cluster size): a thread-block
//     cluster is the R bands of one tile of chains, one CTA a band.  The
//     halo of a chain comes only from the same chain in the neighbouring
//     bands, so every exchange stays inside the cluster: a CTA publishes its
//     boundary rows into an outbox in its own shared memory, the cluster
//     meets at barrier.cluster (arrive.release / wait.acquire), and each CTA
//     reads its neighbours' outboxes through distributed shared memory.  The
//     same three outbox slots rotate over the exchanges as the mailbox's do
//     (see below); a cluster barrier before exit keeps every outbox alive
//     while a neighbour may still read it.  No grid-wide wait: the grid may
//     take several waves, and the plan sizes the tile from the card's
//     resident-cluster count (cudaOccupancyMaxActiveClusters).
//     The spins are bytes s + 1, column-major: column i holds the tile's
//     chains in 4·NQ consecutive bytes (NQ words of four chains; a padded
//     chain's byte is 1, no spin), so one shared load gathers a neighbour's
//     spin for every chain, and a byte permute into the bits 0x4B0000yy of
//     2^23 + y and one subtraction make it a float exactly, on the
//     full-rate pipes (an int-to-float conversion runs at a quarter rate).
//     Each band's colours come as ascending update lists with the node
//     tables in list order, structure of arrays (`ExchangeTables`, built
//     once per call on the host, the counter hash's column key included):
//     every lane updates a node of the half-sweep's colour, the table loads
//     coalesce, and a thread issues all its node's gathers for every chain
//     before it stores the node's new spins (one packed store); chains past
//     the tile's are not computed.  512 threads and one block an SM asked
//     for: ptxas holds a thread in at most 128 registers without a spill.
//     The moments are integer dot products of the packed words (__dp4a).
//   * the mailbox body (`sweep_exchange_kernel`; everything else: more than
//     16 bands, D != 6, a cluster the card cannot hold): the grid-wide
//     kernel that came before the cluster body, its code unchanged.  A grid
//     of (band x chain tile) blocks, band-major; a block
//     keeps its band's extended spins for its `tb` chains in shared memory
//     as int8 (0 marks a halo column past the lattice's edge) and runs
//     pbit::slot_half_sweep (K1's strided body).  Each exchange goes through
//     a global mailbox [slot][band][direction][chain][H] and a grid barrier
//     (a counter in device memory, zeroed before the launch, target
//     (e+1)·blocks at exchange e: thread 0 of each block fences, adds one and
//     spins with a volatile read; mailbox reads are volatile too, so they
//     come from L2 and never from a stale L1 line).  Blocks that wait for
//     each other must all be resident: the launch is cooperative, and the
//     plan sizes `tb` from the occupancy API so the grid fits.
//   * three slots in both: under `async` a CTA reads exchange e-1's slot
//     after barrier e, and the slot is written again only at exchange e+2,
//     which no CTA reaches before every CTA has passed barrier e+1 — after
//     its read.
//   * moments: per-block partials (integer sums with 0/1 weights), then ONE
//     fixed-order reduce over each band's tiles for every band — no atomics,
//     reproducible.
//
// Plain C interface (loaded with ctypes); every function launches on the given
// stream, allocates nothing, does not synchronise, and returns the CUDA error.
// What every launch of one prepared call shares is an `ExStatic`
// (kernels/sweep_fused.py `_ExStatic` mirrors it field for field): a launch
// passes only the spins, betas, noise state and outputs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

// What every launch of one prepared K5 call shares.  Outside the anonymous
// namespace: the extern "C" entry points take it.
struct ExStatic {
  const int* nbr_idx;         // (R, D, N) extended-local neighbour table
  const float* nbr_w;         // (R, D, N)   (mailbox body)
  const float* h;             // (R, N) rows (mailbox body)
  const float* gain;
  const float* off;
  const float* rg;
  const float* co;
  const uint8_t* mask0;       // (R, N) colour-0 update set (mailbox body)
  const uint8_t* mask1;
  const int* send_up;         // (R, H) local columns of the first-row verts
  const int* send_dn;         // (R, H) local columns of the last-row verts
  const uint8_t* clamp_mask;  // (R, N) or null
  const float* clamp_values;  // (R, B, N) or null
  const uint32_t* col0;       // (R,) global id of each band's column 0
  const int* ex_pts;          // (n_ex,) exchange points, ascending from 0
  const int* tab;             // cluster body: (R, 2, kFields, L) list tables
  const int* n_list;          // cluster body: (R, 2) list lengths
  int8_t* mailbox;            // mailbox body: (kSlots, R, 2, B, H)
  unsigned int* barrier;      // mailbox body: one counter
  int R, B, N, D, n_loc, H, n_ex, async_mode, L;
  int body;                   // 0 mailbox, 1 cluster
  int cluster;                // CTAs a cluster (R; 1 for the mailbox body)
  int tb;                     // chains per block
  int threads, smem;
  int edge_block;             // 1: the outer edge halos are kept as given
};

namespace {

constexpr int kSlots = 3;  // mailbox slots, rotated over the exchanges

struct ExParams {
  const float* m_in;          // (R, B, N) spins, +-1 (0 in dead halo columns)
  float* m_out;               // (R, B, N)
  int R, B, N, D, S, n_loc, H;
  const int* nbr_idx;         // (R, D, N) extended-local neighbour table
  const float* nbr_w;         // (R, D, N)
  const float* h;             // (R, N) rows
  const float* gain;
  const float* off;
  const float* rg;
  const float* co;
  const uint8_t* mask0;       // (R, N) colour-0 update set (halo excluded)
  const uint8_t* mask1;
  const float* betas;         // (S, B)
  const int* send_up;         // (R, H) local columns of the first-row verts
  const int* send_dn;         // (R, H) local columns of the last-row verts
  const uint8_t* clamp_mask;  // (R, N) or null
  const float* clamp_values;  // (R, B, N) or null
  const float* measured;      // (S,) or null
  const uint32_t* noise_in;   // (2,) = (seed, ctr0)
  uint32_t* noise_out;
  uint32_t row0;              // global id of chain 0
  const uint32_t* col0;       // (R,) global id of each band's column 0
  const int* ex_pts;          // (n_ex,) exchange points, ascending from 0
  int n_ex;
  int async_mode;
  float* part_s;              // (blocks, N) or null
  float* part_c;              // (blocks, D, N) or null
  const float* next_w;        // stream: (R, D, N) next program's slots
  const float* next_h;        // stream: (R, N)
  float* staged_w;
  float* staged_h;
  int8_t* mailbox;            // (kSlots, R, 2, B, H)
  unsigned int* barrier;      // one counter, zero at launch
  int tb;                     // chains per block
  int tiles;                  // chain tiles per band
  int edge_block;             // 1: the outer edge halos are kept as given
};

// Every block of the grid arrives before any leaves; `target` is the count
// after this barrier, (exchange + 1) * blocks.
__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's mailbox writes before its arrival
    atomicAdd(count, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(count) < target)
      __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// dir 0: a band's first-row boundary (for the band above, as its halo_dn);
// dir 1: its last-row boundary (for the band below, as its halo_up).
__device__ __forceinline__ size_t mailbox_at(const ExParams& p, int slot,
                                             int band, int dir, int chain,
                                             int j) {
  return ((((size_t)slot * p.R + band) * 2 + dir) * p.B + chain) * p.H + j;
}

__device__ void publish(const ExParams& p, const int8_t* sp, int slot, int r,
                        int b0, int nb, int tid, int nt) {
  const int H = p.H;
  for (int k = tid; k < nb * H; k += nt) {
    const int b = k / H, j = k - b * H;
    const int8_t* row = sp + (size_t)b * p.N;
    p.mailbox[mailbox_at(p, slot, r, 0, b0 + b, j)] =
        row[p.send_up[(size_t)r * H + j]];
    p.mailbox[mailbox_at(p, slot, r, 1, b0 + b, j)] =
        row[p.send_dn[(size_t)r * H + j]];
  }
}

__device__ __forceinline__ int8_t read_mailbox(const ExParams& p, size_t at) {
  return *reinterpret_cast<const volatile int8_t*>(p.mailbox + at);
}

__device__ void install(const ExParams& p, int8_t* sp, int slot, int r,
                        int b0, int nb, int tid, int nt) {
  const int H = p.H;
  for (int k = tid; k < nb * H; k += nt) {
    const int b = k / H, j = k - b * H;
    int8_t* row = sp + (size_t)b * p.N;
    if (r > 0)
      row[p.n_loc + j] =
          read_mailbox(p, mailbox_at(p, slot, r - 1, 1, b0 + b, j));
    else if (!p.edge_block)
      row[p.n_loc + j] = 0;
    if (r < p.R - 1)
      row[p.n_loc + H + j] =
          read_mailbox(p, mailbox_at(p, slot, r + 1, 0, b0 + b, j));
    else if (!p.edge_block)
      row[p.n_loc + H + j] = 0;
  }
}

// DT > 0: the slot count is the compile-time constant DT (see
// pbit::slot_half_sweep); DT == 0: any slot count.  Stream: the next program
// is copied into the staged buffers during the launch.
template <int DT, bool Stream>
__global__ void __launch_bounds__(1024) sweep_exchange_kernel(const ExParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sp = reinterpret_cast<int8_t*>(smem);  // [tb][N] spins

  const int tid = threadIdx.x, nt = blockDim.x, blk = blockIdx.x;
  const int N = p.N, B = p.B;
  const int D = DT ? DT : p.D;
  const int r = blk / p.tiles;
  const int b0 = (blk - r * p.tiles) * p.tb;
  const int nb = min(p.tb, B - b0);  // real chains of this tile
  const size_t band = (size_t)r * N;
  const int* nbr_idx = p.nbr_idx + (size_t)r * D * N;
  const float* nbr_w = p.nbr_w + (size_t)r * D * N;
  const float* hr = p.h + band;
  const float* gr = p.gain + band;
  const float* offr = p.off + band;
  const float* rgr = p.rg + band;
  const float* cor = p.co + band;
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;
  const uint32_t col0 = p.col0[r];
  const size_t tile0 = ((size_t)r * B + b0) * N;  // this tile's first spin

  for (int k = tid; k < nb * N; k += nt) sp[k] = pbit::spin_of(p.m_in[tile0 + k]);
  if (p.part_s) {
    for (int i = tid; i < N; i += nt) p.part_s[(size_t)blk * N + i] = 0.0f;
    for (int k = tid; k < D * N; k += nt)
      p.part_c[(size_t)blk * D * N + k] = 0.0f;
  }
  const uint32_t seed = p.noise_in[0], ctr0 = p.noise_in[1];
  if (Stream) {  // before the first barrier: overlaps the other blocks' sweeps
    pbit::copy_slice(p.next_w, p.staged_w, (size_t)p.R * D * N, blk,
                     gridDim.x, tid, nt);
    pbit::copy_slice(p.next_h, p.staged_h, (size_t)p.R * N, blk, gridDim.x,
                     tid, nt);
  }
  __syncthreads();

  for (int e = 0; e < p.n_ex; ++e) {
    const int h0 = p.ex_pts[e];
    const int h1 = e + 1 < p.n_ex ? p.ex_pts[e + 1] : 2 * p.S;
    publish(p, sp, e % kSlots, r, b0, nb, tid, nt);
    grid_barrier(p.barrier, (unsigned int)(e + 1) * gridDim.x);
    if (!p.async_mode)
      install(p, sp, e % kSlots, r, b0, nb, tid, nt);
    else if (e > 0)
      install(p, sp, (e - 1) % kSlots, r, b0, nb, tid, nt);
    __syncthreads();

    for (int g = h0; g < h1; ++g) {
      const int s = g >> 1;  // sweep: indexes betas and measured
      const int c = g & 1;   // colour
      // clamps: at every sweep start, and at a window opening on a second half
      if (has_clamp && (c == 0 || g == h0)) {
        pbit::impose_clamps(sp, nb, N, p.clamp_mask + band,
                            p.clamp_values + tile0, tid, nt);
        __syncthreads();
      }
      const pbit::SlotNoise noise{
          false, pbit::counter_half_key(seed, ctr0 + (uint32_t)g), b0,
          p.row0, col0, nullptr, 0, nullptr};
      pbit::slot_half_sweep<DT>(sp, nb, N, D, nbr_idx, nbr_w, hr, gr, offr,
                                rgr, cor, (c ? p.mask1 : p.mask0) + band,
                                p.betas + (size_t)s * B + b0, noise, tid, nt);
      __syncthreads();

      // statistics after a sweep's second half, weighted by measured[s]
      if (c == 1 && p.measured != nullptr && p.part_s != nullptr) {
        const float wgt = p.measured[s];
        if (wgt != 0.0f) {
          pbit::accumulate_slot_moments(sp, nb, N, D, nbr_idx, wgt,
                                        p.part_s + (size_t)blk * N,
                                        p.part_c + (size_t)blk * D * N, tid,
                                        nt);
          __syncthreads();  // the next half-sweep overwrites what was read
        }
      }
    }
  }
  if (p.async_mode) {
    // the last exchange is the next launch's first halo
    install(p, sp, (p.n_ex - 1) % kSlots, r, b0, nb, tid, nt);
    __syncthreads();
  }

  for (int k = tid; k < nb * N; k += nt) p.m_out[tile0 + k] = (float)sp[k];
  if (blk == 0 && tid == 0) {
    p.noise_out[0] = seed;
    p.noise_out[1] = ctr0 + (uint32_t)(2 * p.S);
  }
}

using Kernel = void (*)(const ExParams);

Kernel kernel_for(int D, int stream) {
  if (stream)
    return D == 6 ? sweep_exchange_kernel<6, true>
                  : sweep_exchange_kernel<0, true>;
  return D == 6 ? sweep_exchange_kernel<6, false>
                : sweep_exchange_kernel<0, false>;
}

cudaError_t opt_in_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// the cluster body
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kD = 6;                    // the slot count the body takes
constexpr int kClusterThreads = 512;     // see __launch_bounds__ below
constexpr int kMaxCluster = 16;          // CTAs: 9..16 are non-portable
// a list entry's table fields, each a row of L int32 (floats as bits)
constexpr int kNode = 0, kIdx = 1, kW = 1 + kD, kH = 1 + 2 * kD;
constexpr int kGain = kH + 1, kOff = kH + 2, kRg = kH + 3, kCo = kH + 4;
constexpr int kColKey = kH + 5, kFields = kH + 6;
constexpr uint32_t kRowMul = 0x85EBCA77u;  // the counter hash's row key

struct ClusterParams {
  const float* m_in;          // (R, B, N) spins, +-1 (0 in dead halo columns)
  float* m_out;               // (R, B, N)
  int R, B, N, S, n_loc, H, L, tb, tiles;
  const int* tab;             // (R, 2, kFields, L)
  const int* n_list;          // (R, 2)
  const int* nbr_idx;         // (R, kD, N): the moments' neighbours
  const float* betas;         // (S, B)
  const int* send_up;         // (R, H)
  const int* send_dn;
  const uint8_t* clamp_mask;  // (R, N) or null
  const float* clamp_values;  // (R, B, N) or null
  const float* measured;      // (S,) or null
  const uint32_t* noise_in;   // (2,) = (seed, ctr0)
  uint32_t* noise_out;
  uint32_t row0;              // global id of chain 0
  const int* ex_pts;
  int n_ex, async_mode;
  float* part_s;              // (R·tiles, N) or null
  float* part_c;              // (R·tiles, kD, N) or null
  const float* next_w;        // stream: (R, kD, N) next program's slots
  const float* next_h;        // stream: (R, N)
  float* staged_w;
  float* staged_h;
  uint32_t two23_bits;        // 0x4B000000 (see spin_in)
  int edge_block;             // 1: the outer edge halos are kept as given
};

__host__ __device__ inline size_t pad16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

constexpr int kMaxChains = 32;  // chains a CTA: eight words of four

// Words of four chains a column holds: 1, 2, 4 or 8 (up to 4, 8, 16 or 32
// chains; words past the tile's chains are never computed).
__host__ __device__ inline int chain_words(int tb) {
  return tb <= 4 ? 1 : (tb <= 8 ? 2 : (tb <= 16 ? 4 : 8));
}

// Shared memory of one CTA (kernels/sweep_fused.py::
// exchange_cluster_smem_bytes): the spins [N][4·NQ] int8, the outbox
// [kSlots][2][H][4·NQ] int8 and the sweep's betas [4·NQ] float.
__host__ __device__ inline size_t cluster_smem_bytes(int nq, int N, int H) {
  const size_t row = 4 * (size_t)nq;
  return pad16((size_t)N * row) + pad16((size_t)kSlots * 2 * H * row) +
         4 * row;
}

template <int NQ>
struct Row {
  uint32_t w[NQ];
};

// G consecutive words from word `at` of the tile (one vector load; `at` a
// multiple of G).
template <int G>
__device__ __forceinline__ void load_words(const uint32_t* sp, int at,
                                           uint32_t* w) {
  if constexpr (G == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(sp + at);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (G == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(sp + at);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = sp[at];
  }
}

template <int G>
__device__ __forceinline__ void store_words(uint32_t* sp, int at,
                                            const uint32_t* w) {
  if constexpr (G == 4) {
    *reinterpret_cast<uint4*>(sp + at) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<uint2*>(sp + at) = make_uint2(w[0], w[1]);
  } else {
    sp[at] = w[0];
  }
}

// Column `col` of the tile: its NQ words (vector loads of up to four).
template <int NQ>
__device__ __forceinline__ Row<NQ> load_row(const uint32_t* sp, int col) {
  constexpr int G = NQ < 4 ? NQ : 4;
  Row<NQ> r;
#pragma unroll
  for (int q = 0; q < NQ; q += G) load_words<G>(sp, col * NQ + q, r.w + q);
  return r;
}

template <int NQ>
__device__ __forceinline__ void store_row(uint32_t* sp, int col,
                                          const Row<NQ>& r) {
  constexpr int G = NQ < 4 ? NQ : 4;
#pragma unroll
  for (int q = 0; q < NQ; q += G) store_words<G>(sp, col * NQ + q, r.w + q);
}

// A spin s of -1, 0 or +1 is held as the byte s + 1 (0, 1, 2); a padded
// chain's byte is 1 (no spin).  kPadded: a word of four such bytes.
constexpr uint32_t kPadded = 0x01010101u;
constexpr float kTwo23 = 8388608.0f;  // 2^23: the float of bits 0x4B000000

// The float of the byte y < 2^8 — 2^23 + y, its bits 0x4B0000yy, less 2^23,
// exact — on the full-rate pipes (an int-to-float conversion runs at a
// quarter of their rate).
__device__ __forceinline__ float byte_float(uint32_t bits_4b0000yy) {
  return __fsub_rn(__int_as_float((int)bits_4b0000yy), kTwo23);
}

// Chain j of a packed word as the kernels' float spin (-1, 0, +1): one
// byte permute into 0x4B0000yy, then less 2^23 + 1, exact.  two23: the bits
// 0x4B000000 in a register (a kernel argument), so the permute's selector
// is its immediate and no instruction moves a selector into a register.
__device__ __forceinline__ float spin_in(uint32_t word, int j,
                                         uint32_t two23 = 0x4B000000u) {
  return __fsub_rn(__int_as_float((int)__byte_perm(word, two23, 0x7540u + j)),
                   kTwo23 + 1.0f);
}

// The byte of a float spin: s + 1 for s of sign_spin's or spin_of's.
__device__ __forceinline__ uint32_t spin_byte(int8_t s) {
  return (uint32_t)(s + 1);
}

// Word q's bytes of chains at or past nb, padded (from byte j on).
__device__ __forceinline__ uint32_t pad_from(int j) {
  return kPadded << (8 * j);
}

// A list entry's operands, loaded once a half-sweep from its table row.
struct Entry {
  float w[kD];
  float h, gain, off, rg, co;
  uint32_t hc;  // this half-sweep's counter key ^ the node's column key
};

// The entry's new spins for the chains of word q (those below nb; the
// others padded), from the word q of each of its kD slots' columns: eqn 1
// over the slots in ascending d from +0.0, then + h, and eqn 2's decision
// in pbit::decision's order, each step rounded on its own; noise at (chain
// 4q + j of the tile, the node).  A slot's term is one fused multiply-add:
// w·s is exact for s of -1, 0, +1, so it rounds as the product then the
// sum do (a zero term adds ±0 to an acc that is never -0).
__device__ __forceinline__ uint32_t update_word(const uint32_t* s,
                                                const Entry& e, int q,
                                                int nb, const float* sbeta,
                                                uint32_t rk0,
                                                uint32_t two23) {
  const float4 bq = reinterpret_cast<const float4*>(sbeta)[q];
  const float beta[4] = {bq.x, bq.y, bq.z, bq.w};
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (4 * q + j >= nb) {  // uniform across the CTA
      word |= pad_from(j);
      break;
    }
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      acc = __fmaf_rn(e.w[d], spin_in(s[d], j, two23), acc);
    const float act = pbit::activation(acc, e.h, beta[j], e.gain, e.off);
    const uint32_t mixed =
        pbit::mix32(e.hc ^ (rk0 + (uint32_t)(4 * q + j) * kRowMul));
    // u = (byte - 127.5) / 128 as a multiply by 2^-7: exact, as the
    // division is (pbit::byte_to_uniform)
    const float u = __fmul_rn(
        __fsub_rn(byte_float((mixed & 0xFFu) | 0x4B000000u), 127.5f),
        0.0078125f);
    word |= (pbit::decide(act, e.rg, e.co, u) >= 0.0f ? 2u : 0u) << (8 * j);
  }
  return word;
}

// One half-sweep of the CTA's tile on its band: list entry k of the colour
// (k = tid, tid + nt, ...) updates node tab[kNode][k] for each of the
// tile's nb chains (`update_word`), gathering every slot of every chain (a
// vector load of up to four words a slot) before the one packed store;
// padded chains are not computed and keep the padded byte.  hk: this
// half-sweep's counter key; rk0: the row key of the tile's chain 0.  No
// barrier.
template <int NQ>
__device__ __forceinline__ void cluster_half_sweep(
    uint32_t* sp, const int* __restrict__ tab, int n, int L,
    const float* sbeta, uint32_t hk, uint32_t rk0, int nb, uint32_t two23,
    int tid, int nt) {
  constexpr int G = NQ < 4 ? NQ : 4;  // words a gather brings
  for (int k = tid; k < n; k += nt) {
    const int* t = tab + k;
    int ix[kD];
    Entry e;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      ix[d] = __ldg(t + (kIdx + d) * L) * NQ;
      e.w[d] = __int_as_float(__ldg(t + (kW + d) * L));
    }
    const int node = __ldg(t + kNode * L);
    e.h = __int_as_float(__ldg(t + kH * L));
    e.gain = __int_as_float(__ldg(t + kGain * L));
    e.off = __int_as_float(__ldg(t + kOff * L));
    e.rg = __int_as_float(__ldg(t + kRg * L));
    e.co = __int_as_float(__ldg(t + kCo * L));
    e.hc = hk ^ (uint32_t)__ldg(t + kColKey * L);
    Row<NQ> out;
#pragma unroll
    for (int q0 = 0; q0 < NQ; q0 += G) {
      uint32_t g[G][kD];  // word q0 + i of slot d's column
      if (4 * q0 < nb) {
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          uint32_t v[G];
          load_words<G>(sp, ix[d] + q0, v);
#pragma unroll
          for (int i = 0; i < G; ++i) g[i][d] = v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int q = q0 + i;
        out.w[q] = 4 * q < nb  // uniform across the CTA
                       ? update_word(g[i], e, q, nb, sbeta, rk0, two23)
                       : kPadded;
      }
    }
    store_row<NQ>(sp, node, out);
  }
}

// The CTA's boundary into outbox slot `slot`: direction 0 its first row
// (send_up, the band above's halo_dn), 1 its last row (send_dn, the band
// below's halo_up); [2][H][NQ] words.
template <int NQ>
__device__ __forceinline__ void publish_rows(const uint32_t* sp,
                                             uint32_t* box, const int* up,
                                             const int* dn, int H, int tid,
                                             int nt) {
  const int per = H * NQ;
  for (int k = tid; k < 2 * per; k += nt) {
    const int dir = k >= per, jq = k - dir * per;
    const int j = jq / NQ, q = jq - j * NQ;
    box[k] = sp[(size_t)(dir ? dn[j] : up[j]) * NQ + q];
  }
}

// The halo columns from the neighbours' outbox slot `slot`, through
// distributed shared memory: halo_up from band r-1's last row, halo_dn from
// band r+1's first row; past the edge zeros, or with `keep_edges` the
// columns as they are.
template <int NQ>
__device__ __forceinline__ void install_rows(cg::cluster_group& cluster,
                                             uint32_t* sp, uint32_t* outbox,
                                             int slot, int r, int R,
                                             int n_loc, int H,
                                             bool keep_edges, int tid,
                                             int nt) {
  const int per = H * NQ;
  for (int k = tid; k < 2 * per; k += nt) {
    const int dir = k >= per, jq = k - dir * per;
    const int src = dir ? r + 1 : r - 1;
    uint32_t v = kPadded;  // no spin past the lattice's edge
    if (src >= 0 && src < R) {
      const uint32_t* box = cluster.map_shared_rank(outbox, src);
      v = box[((size_t)slot * 2 + (dir ? 0 : 1)) * per + jq];
    } else if (keep_edges) {
      continue;
    }
    sp[(size_t)(n_loc + dir * H) * NQ + jq] = v;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A sweep's moments over the tile, weighted by wgt: part_s[i] += wgt·Σ_b m_bi
// and part_c[d·N + i] += wgt·Σ_b m_bi·m_b,idx[d,i] (integer sums from dot
// products of the packed bytes y = m + 1: Σ m = Σ y - n and Σ m·m' = Σ y·y'
// - Σ y - Σ y' + n over a word's four bytes, padded ones m = 0; one owner
// thread per column, in sweep order).  No barrier.
template <int NQ>
__device__ __forceinline__ void cluster_moments(const uint32_t* sp, int N,
                                                const int* nbr_idx,
                                                float wgt, float* part_s,
                                                float* part_c, int tid,
                                                int nt) {
  constexpr int n = 4 * NQ;
  for (int i = tid; i < N; i += nt) {
    const Row<NQ> a = load_row<NQ>(sp, i);
    unsigned sa = 0;
#pragma unroll
    for (int q = 0; q < NQ; ++q) sa = __dp4a(a.w[q], kPadded, sa);
    part_s[i] = __fadd_rn(part_s[i], __fmul_rn(wgt, (float)((int)sa - n)));
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const Row<NQ> b = load_row<NQ>(sp, nbr_idx[(size_t)d * N + i]);
      unsigned ab = 0, sb = 0;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        ab = __dp4a(a.w[q], b.w[q], ab);
        sb = __dp4a(b.w[q], kPadded, sb);
      }
      const int corr = (int)ab - (int)sa - (int)sb + n;
      float* dc = part_c + (size_t)d * N + i;
      *dc = __fadd_rn(*dc, __fmul_rn(wgt, (float)corr));
    }
  }
}

// The tile's nb chains (rows of N floats from `rows`) into its packed
// columns, a column a thread: coalesced loads across the warp, every
// chain's load of a column issued before the first is used (predicated,
// no branch between them), the column's words stored as vectors.
template <int NQ>
__device__ __forceinline__ void load_tile(uint32_t* sp, const float* rows,
                                          int N, int nb, int tid, int nt) {
  for (int i = tid; i < N; i += nt) {
    float v[4 * NQ];
#pragma unroll
    for (int b = 0; b < 4 * NQ; ++b)
      v[b] = b < nb ? __ldg(rows + (size_t)b * N + i) : 0.0f;
    Row<NQ> r;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (4 * q + j < nb ? spin_byte(pbit::spin_of(v[4 * q + j]))
                                : 1u) << (8 * j);
      r.w[q] = word;
    }
    store_row<NQ>(sp, i, r);
  }
}

// The packed columns back into the tile's nb rows of N floats.
template <int NQ>
__device__ __forceinline__ void store_tile(const uint32_t* sp, float* rows,
                                           int N, int nb, int tid, int nt) {
  for (int i = tid; i < N; i += nt) {
    const Row<NQ> r = load_row<NQ>(sp, i);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = 4 * q + j;
        if (b < nb) rows[(size_t)b * N + i] = spin_in(r.w[q], j);
      }
    }
  }
}

// The cluster body (see the head of this file).  NQ: words of four chains a
// column; Stream: the next program is copied into the staged buffers.  At
// 512 threads and one block an SM asked for, ptxas may give a thread up to
// 128 registers: the node's gathered words stay in registers.
template <int NQ, bool Stream>
__global__ void __launch_bounds__(kClusterThreads, 1)
    sweep_exchange_cluster_kernel(const ClusterParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TB = 4 * NQ;  // bytes of a column
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();  // the band
  const int tile = blockIdx.x / p.R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int N = p.N, B = p.B, H = p.H;
  const int b0 = tile * p.tb;
  const int nb = min(p.tb, B - b0);  // real chains of this tile
  uint32_t* sp = reinterpret_cast<uint32_t*>(smem);
  uint32_t* outbox = reinterpret_cast<uint32_t*>(smem + pad16((size_t)N * TB));
  float* sbeta = reinterpret_cast<float*>(
      smem + pad16((size_t)N * TB) + pad16((size_t)kSlots * 2 * H * TB));
  const int blk = r * p.tiles + tile;  // partial row: band-major
  const size_t tile0 = ((size_t)r * B + b0) * N;
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;
  const uint8_t* cm = has_clamp ? p.clamp_mask + (size_t)r * N : nullptr;
  const int* up = p.send_up + (size_t)r * H;
  const int* dn = p.send_dn + (size_t)r * H;
  const int* tab0 = p.tab + (size_t)(2 * r) * kFields * p.L;  // colour 0
  const int* tab1 = tab0 + (size_t)kFields * p.L;               // colour 1
  const int n0 = p.n_list[2 * r], n1 = p.n_list[2 * r + 1];
  load_tile<NQ>(sp, p.m_in + tile0, N, nb, tid, nt);
  if (p.part_s) {
    for (int i = tid; i < N; i += nt) p.part_s[(size_t)blk * N + i] = 0.0f;
    for (int k = tid; k < kD * N; k += nt)
      p.part_c[(size_t)blk * kD * N + k] = 0.0f;
  }
  const uint32_t seed = p.noise_in[0], ctr0 = p.noise_in[1];
  const uint32_t rk0 = ((uint32_t)b0 + p.row0) * kRowMul;
  if (Stream) {  // before the first barrier: overlaps the other CTAs' sweeps
    pbit::copy_slice(p.next_w, p.staged_w, (size_t)p.R * kD * N, blockIdx.x,
                     gridDim.x, tid, nt);
    pbit::copy_slice(p.next_h, p.staged_h, (size_t)p.R * N, blockIdx.x,
                     gridDim.x, tid, nt);
  }
  __syncthreads();

  for (int e = 0; e < p.n_ex; ++e) {
    const int h0 = p.ex_pts[e];
    const int h1 = e + 1 < p.n_ex ? p.ex_pts[e + 1] : 2 * p.S;
    publish_rows<NQ>(sp, outbox + (size_t)(e % kSlots) * 2 * H * NQ, up, dn,
                     H, tid, nt);
    cluster_arrive();
    cluster_wait();
    if (!p.async_mode)
      install_rows<NQ>(cluster, sp, outbox, e % kSlots, r, p.R, p.n_loc, H,
                       p.edge_block, tid, nt);
    else if (e > 0)
      install_rows<NQ>(cluster, sp, outbox, (e - 1) % kSlots, r, p.R,
                       p.n_loc, H, p.edge_block, tid, nt);
    __syncthreads();

    for (int g = h0; g < h1; ++g) {
      const int s = g >> 1;  // sweep: indexes betas and measured
      const int c = g & 1;   // colour
      if (c == 0 || g == h0) {
        // clamps: at every sweep start, and at a window opening on a second
        // half; and the sweep's betas
        if (has_clamp) {
          int8_t* sb = reinterpret_cast<int8_t*>(sp);
          for (int i = tid; i < N; i += nt) {
            if (!cm[i]) continue;
            for (int b = 0; b < nb; ++b)
              sb[(size_t)i * TB + b] = (int8_t)spin_byte(pbit::sign_spin(
                  p.clamp_values[tile0 + (size_t)b * N + i]));
          }
        }
        if (tid < TB)
          sbeta[tid] = tid < nb ? p.betas[(size_t)s * B + b0 + tid] : 0.0f;
        __syncthreads();
      }
      cluster_half_sweep<NQ>(
          sp, c ? tab1 : tab0, c ? n1 : n0, p.L, sbeta,
          pbit::counter_half_key(seed, ctr0 + (uint32_t)g), rk0, nb,
          p.two23_bits, tid, nt);
      __syncthreads();

      // statistics after a sweep's second half, weighted by measured[s]
      if (c == 1 && p.measured != nullptr && p.part_s != nullptr) {
        const float wgt = p.measured[s];
        if (wgt != 0.0f) {
          cluster_moments<NQ>(sp, N, p.nbr_idx + (size_t)r * kD * N, wgt,
                              p.part_s + (size_t)blk * N,
                              p.part_c + (size_t)blk * kD * N, tid, nt);
          __syncthreads();  // the next half-sweep overwrites what was read
        }
      }
    }
  }
  if (p.async_mode) {
    // the last exchange is the next launch's first halo
    install_rows<NQ>(cluster, sp, outbox, (p.n_ex - 1) % kSlots, r, p.R,
                     p.n_loc, H, p.edge_block, tid, nt);
    __syncthreads();
  }
  // this CTA reads no outbox past here; it leaves only when its neighbours
  // read none of its own
  cluster_arrive();

  store_tile<NQ>(sp, p.m_out + tile0, N, nb, tid, nt);
  if (blockIdx.x == 0 && tid == 0) {
    p.noise_out[0] = seed;
    p.noise_out[1] = ctr0 + (uint32_t)(2 * p.S);
  }
  cluster_wait();
}

using ClusterKernel = void (*)(const ClusterParams);

ClusterKernel cluster_kernel_for(int nq, int stream) {
  switch (nq * 2 + (stream ? 1 : 0)) {
    case 2: return sweep_exchange_cluster_kernel<1, false>;
    case 3: return sweep_exchange_cluster_kernel<1, true>;
    case 4: return sweep_exchange_cluster_kernel<2, false>;
    case 5: return sweep_exchange_cluster_kernel<2, true>;
    case 8: return sweep_exchange_cluster_kernel<4, false>;
    case 9: return sweep_exchange_cluster_kernel<4, true>;
    case 16: return sweep_exchange_cluster_kernel<8, false>;
    case 17: return sweep_exchange_cluster_kernel<8, true>;
    default: return nullptr;
  }
}

// Lets a cluster instance launch with up to the card's opt-in shared memory
// (one setting for every plan) and, above 8 CTAs, non-portable clusters.
cudaError_t allow_cluster(ClusterKernel kernel, int cluster) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(int grid, int threads, int smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// out_s[r][i] = Σ_t part_s[r·tiles + t][i] and out_c likewise over every
// band at once, tiles in order (fixed, so the result does not depend on
// scheduling; no atomics): one launch for all bands.
__global__ void reduce_band_partials_kernel(const float* part_s,
                                            const float* part_c, float* out_s,
                                            float* out_c, int R, int tiles,
                                            int N, int DN) {
  const size_t per = (size_t)N + DN;
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (size_t)R * per) return;
  const size_t r = k / per, j = k - r * per;
  const bool s = j < (size_t)N;
  const size_t len = s ? (size_t)N : (size_t)DN, at = s ? j : j - N;
  const float* src = (s ? part_s : part_c) + r * tiles * len + at;
  float acc = 0.0f;
  for (int t = 0; t < tiles; ++t) acc = __fadd_rn(acc, src[(size_t)t * len]);
  (s ? out_s : out_c)[r * len + at] = acc;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: body 1 the cluster body's CTA at `tb`
// chains, body 0 the mailbox body's.
int sweep_exchange_smem_bytes(int body, int tb, int N, int H) {
  return body ? (int)cluster_smem_bytes(chain_words(tb), N, H)
              : (int)pbit::tile_spin_bytes(tb, N);
}

// How many blocks of `threads` threads and `smem` bytes of shared memory can
// be resident on the current device at once (the mailbox body's cooperative
// launch's ceiling), into *out.
int sweep_exchange_max_blocks(int D, int stream, int threads, int smem,
                              int* out) {
  const Kernel kernel = kernel_for(D, stream);
  cudaError_t err = opt_in_smem(kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *out = per_sm * sms;
  return 0;
}

// Clusters of `cluster` CTAs of the cluster body at `tb` chains, `threads`
// threads and `smem` bytes that the card can hold at once, into *out (0:
// the configuration cannot run).
int sweep_exchange_max_clusters(int tb, int stream, int cluster, int threads,
                                int smem, int* out) {
  const ClusterKernel kernel = cluster_kernel_for(chain_words(tb), stream);
  if (kernel == nullptr || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_cluster(kernel, cluster);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem, 0, attr, cluster);
  return (int)cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

// Once per prepared call: checks the plan against the kernel and lets the
// body's kernels use its shared memory (and its cluster size).
int sweep_exchange_prepare(const ExStatic* s) {
  if (s->body == 1) {
    if (s->D != kD || s->tb < 1 || s->tb > kMaxChains || s->cluster != s->R ||
        s->R > kMaxCluster || s->threads > kClusterThreads ||
        s->threads % 32 != 0 ||
        (size_t)s->smem != cluster_smem_bytes(chain_words(s->tb), s->N, s->H))
      return (int)cudaErrorInvalidValue;
    for (int stream = 0; stream < 2; ++stream) {
      const cudaError_t err = allow_cluster(
          cluster_kernel_for(chain_words(s->tb), stream), s->cluster);
      if (err != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if ((size_t)s->smem != pbit::tile_spin_bytes(s->tb, s->N))
    return (int)cudaErrorInvalidValue;
  for (int stream = 0; stream < 2; ++stream) {
    const cudaError_t err =
        opt_in_smem(kernel_for(s->D, stream), (size_t)s->smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One launch of a prepared call: S sweeps of every band from m_in into
// m_out; with `measured` the moments into out_s (R, N) / out_c (R, D, N)
// through the per-block partials part_s / part_c; with next_w the next
// program staged into staged_w / staged_h.
int sweep_sparse_exchange_launch(
    const ExStatic* s, const float* m_in, float* m_out, const float* betas,
    int S, const uint32_t* noise_in, uint32_t* noise_out, uint32_t row0,
    const float* measured, float* part_s, float* part_c, float* out_s,
    float* out_c, const float* next_w, const float* next_h, float* staged_w,
    float* staged_h, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int tiles = (s->B + s->tb - 1) / s->tb;
  cudaError_t err;
  if (s->body == 1) {
    ClusterParams p = {};
    p.m_in = m_in; p.m_out = m_out; p.R = s->R; p.B = s->B; p.N = s->N;
    p.S = S; p.n_loc = s->n_loc; p.H = s->H; p.L = s->L; p.tb = s->tb;
    p.tiles = tiles; p.tab = s->tab; p.n_list = s->n_list;
    p.nbr_idx = s->nbr_idx; p.betas = betas; p.send_up = s->send_up;
    p.send_dn = s->send_dn; p.clamp_mask = s->clamp_mask;
    p.clamp_values = s->clamp_values; p.measured = measured;
    p.noise_in = noise_in; p.noise_out = noise_out; p.row0 = row0;
    p.ex_pts = s->ex_pts; p.n_ex = s->n_ex; p.async_mode = s->async_mode;
    p.part_s = part_s; p.part_c = part_c; p.next_w = next_w;
    p.next_h = next_h; p.staged_w = staged_w; p.staged_h = staged_h;
    p.two23_bits = 0x4B000000u;
    p.edge_block = s->edge_block;
    const ClusterKernel kernel =
        cluster_kernel_for(chain_words(s->tb), next_w != nullptr);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(
        s->R * tiles, s->threads, s->smem, stream, attr, s->cluster);
    err = cudaLaunchKernelEx(&cfg, kernel, p);
  } else {
    ExParams p = {};
    p.m_in = m_in; p.m_out = m_out; p.R = s->R; p.B = s->B; p.N = s->N;
    p.D = s->D; p.S = S; p.n_loc = s->n_loc; p.H = s->H;
    p.nbr_idx = s->nbr_idx; p.nbr_w = s->nbr_w; p.h = s->h;
    p.gain = s->gain; p.off = s->off; p.rg = s->rg; p.co = s->co;
    p.mask0 = s->mask0; p.mask1 = s->mask1; p.betas = betas;
    p.send_up = s->send_up; p.send_dn = s->send_dn;
    p.clamp_mask = s->clamp_mask; p.clamp_values = s->clamp_values;
    p.measured = measured; p.noise_in = noise_in; p.noise_out = noise_out;
    p.row0 = row0; p.col0 = s->col0; p.ex_pts = s->ex_pts; p.n_ex = s->n_ex;
    p.async_mode = s->async_mode; p.part_s = part_s; p.part_c = part_c;
    p.next_w = next_w; p.next_h = next_h; p.staged_w = staged_w;
    p.staged_h = staged_h; p.mailbox = s->mailbox; p.barrier = s->barrier;
    p.tb = s->tb; p.tiles = tiles; p.edge_block = s->edge_block;
    err = cudaMemsetAsync(s->barrier, 0, sizeof(unsigned int), stream);
    if (err != cudaSuccess) return (int)err;
    const Kernel kernel = kernel_for(s->D, next_w != nullptr);
    void* args[] = {&p};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(s->R * tiles), dim3(s->threads),
                                      args, s->smem, stream);
  }
  if (err != cudaSuccess) return (int)err;
  if (part_s) {
    const size_t DN = (size_t)s->D * s->N;
    const size_t total = (size_t)s->R * (s->N + DN);
    reduce_band_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                  stream>>>(part_s, part_c, out_s, out_c,
                                            s->R, tiles, s->N, (int)DN);
  }
  return (int)cudaGetLastError();
}

const char* sweep_exchange_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
