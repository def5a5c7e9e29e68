// Device code shared by the port's p-bit kernels (sm_90a): the noise streams,
// the eqn-2 decision, the slot-layout half-sweep of a tile of chains and its
// moments (K5 and K1's strided body run the same body), clamp re-imposition, the
// visible-pattern histogram, colour-mask compaction, a sliced copy and the
// fixed-order reduction of per-block partials.
//
// Included by sweep_sparse.cu (K1, K4), pbit_update.cu (K2), sweep_fused.cu
// (K3) and sweep_exchange.cu (K5); each is built into its own library, so
// everything here has internal linkage.  Every float operation is an explicit round-to-nearest intrinsic
// (no FMA contraction) and tanhf is libdevice's: the kernels equal their plain
// PyTorch versions bit for bit (build without --use_fast_math).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pbit {
namespace {

constexpr uint32_t kGaloisMask = 0x80200003u;  // x^32 + x^22 + x^2 + x + 1
constexpr int kNoiseLfsr = 1;  // noise_mode: 0 counter hash, 1 Galois LFSR

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The 8-bit RNG DAC: byte -> mid-tread uniform (b - 127.5) / 128, exact.
__device__ __forceinline__ float byte_to_uniform(uint32_t b) {
  return __fdiv_rn(__fsub_rn((float)b, 127.5f), 128.0f);
}

__device__ __forceinline__ int8_t sign_spin(float x) {
  return x >= 0.0f ? (int8_t)1 : (int8_t)-1;
}

// A spin as the kernels hold it in shared memory: +1, -1, or 0 for a column
// that is never updated and reads as no spin at all (a halo column past the
// lattice's edge in the sharded engine).  Exact for every such input.
__device__ __forceinline__ int8_t spin_of(float x) {
  return x > 0.0f ? (int8_t)1 : (x < 0.0f ? (int8_t)-1 : (int8_t)0);
}

// ---------------------------------------------------------------------------
// counter-hash noise: byte of (seed, ctr, chain + row0, node + col0)
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t counter_half_key(uint32_t seed,
                                                     uint32_t ctr) {
  return mix32(seed ^ (ctr * 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t counter_col_key(int node, uint32_t col0) {
  return ((uint32_t)node + col0) * 0xC2B2AE3Du;
}

__device__ __forceinline__ uint32_t counter_byte(uint32_t half_key, int chain,
                                                 uint32_t row0,
                                                 uint32_t col_key) {
  const uint32_t row_key = ((uint32_t)chain + row0) * 0x85EBCA77u;
  return mix32(half_key ^ row_key ^ col_key) & 0xFFu;
}

// ---------------------------------------------------------------------------
// chip-faithful noise: one Galois LFSR per unit cell, vertical nodes read the
// register's bytes, horizontal nodes the bit-reversed bytes
// ---------------------------------------------------------------------------
struct LfsrTap {
  int cell;       // register within the chain's C registers
  int shift;      // byte position * 8
  bool reversed;  // horizontal node: bit-reversed byte
};

// col: the node's flat column of core/lfsr.py::flat_cell_uniforms
__device__ __forceinline__ LfsrTap lfsr_tap(int col, int C) {
  const int kk = col / C;
  LfsrTap t;
  t.cell = col - kk * C;
  t.shift = 8 * (kk & 3);
  t.reversed = kk >= 4;
  return t;
}

__device__ __forceinline__ uint32_t lfsr_byte(const uint32_t* regs,
                                              LfsrTap t) {
  uint32_t byte = (regs[t.cell] >> t.shift) & 0xFFu;
  if (t.reversed) byte = __brev(byte) >> 24;
  return byte;
}

// Clock every register of the tile `decimation` times (no barrier).
__device__ __forceinline__ void lfsr_step_tile(uint32_t* lf, int count,
                                               int decimation, int tid,
                                               int nt) {
  for (int k = tid; k < count; k += nt) {
    uint32_t st = lf[k];
    for (int t = 0; t < decimation; ++t)
      st = (st >> 1) ^ ((st & 1u) ? kGaloisMask : 0u);
    lf[k] = st;
  }
}

// ---------------------------------------------------------------------------
// eqn 2: the pre-comparator decision, in the order of
// kernels/ref.py::decision_value — I = acc + h, act = tanh((beta*gain) *
// (I + off)), decision = (act + rg*u) + co.  K1 issues the tanh before it
// draws the noise byte (activation, then decide): the other order measured
// slower there.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float activation(float acc, float h, float beta,
                                            float gain, float off) {
  const float I = __fadd_rn(acc, h);
  return tanhf(__fmul_rn(__fmul_rn(beta, gain), __fadd_rn(I, off)));
}

__device__ __forceinline__ float decide(float act, float rg, float co,
                                        float u) {
  return __fadd_rn(__fadd_rn(act, __fmul_rn(rg, u)), co);
}

__device__ __forceinline__ float decision_u(float acc, float h, float beta,
                                            float gain, float off, float rg,
                                            float co, float u) {
  return decide(activation(acc, h, beta, gain, off), rg, co, u);
}

// The same with the uniform drawn from a noise byte.
__device__ __forceinline__ float decision(float acc, float h, float beta,
                                          float gain, float off, float rg,
                                          float co, uint32_t byte) {
  return decision_u(acc, h, beta, gain, off, rg, co, byte_to_uniform(byte));
}

// Clamped nodes of the tile's nb chains take their clamp values (no barrier).
// sp: [nb][N] spins; values: the tile's first row of clamp_values.
template <typename T>
__device__ __forceinline__ void impose_clamps(T* sp, int nb, int N,
                                              const uint8_t* clamp_mask,
                                              const float* values, int tid,
                                              int nt) {
  for (int k = tid; k < nb * N; k += nt) {
    if (clamp_mask[k % N]) sp[k] = (T)sign_spin(values[k]);
  }
}

// ---------------------------------------------------------------------------
// the slot-layout half-sweep of a tile of chains (K5, and the strided body
// of K1 and K4)
// ---------------------------------------------------------------------------
// A tile's spins in shared memory: tb chains of N int8 columns, padded to 16
// bytes.
__host__ __device__ inline size_t tile_spin_bytes(int tb, int N) {
  return (((size_t)tb * (size_t)N) + 15) & ~(size_t)15;
}

// Where a tile's noise bytes come from in one half-sweep: the counter hash
// at (chain + row0, node + col0) under this half-sweep's key, or (lfsr) the
// tile's registers read through the node's flat LFSR column perm[i].
struct SlotNoise {
  bool lfsr;
  uint32_t half_key;   // counter
  int b0;              // the tile's first chain
  uint32_t row0, col0;
  const uint32_t* lf;  // lfsr: [nb][C] registers, stepped for this half
  int C;
  const int* perm;
};

// One half-sweep of the tile: each node i of `mask` takes eqn 1 over its D
// slots (float32, ascending d from +0.0, then + h) and eqn 2's decision, for
// the tile's nb chains, in place.  Threads stride over nodes; with DT > 0 the
// slot count is the compile-time DT and a node's slot weights/indices stay in
// registers across the chains (DT == 0: any D, read per chain from device
// memory).  beta: this sweep's row of betas from the tile's first chain.
// Each mask must be an independent set of the slot graph.  No barrier.
template <int DT>
__device__ __forceinline__ void slot_half_sweep(
    int8_t* sp, int nb, int N, int D, const int* nbr_idx, const float* nbr_w,
    const float* h, const float* gain, const float* off, const float* rg,
    const float* co, const uint8_t* mask, const float* beta,
    const SlotNoise& noise, int tid, int nt) {
  for (int i = tid; i < N; i += nt) {
    if (!mask[i]) continue;
    int iv[DT ? DT : 1];
    float wv[DT ? DT : 1];
    if (DT) {
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        iv[d] = nbr_idx[(size_t)d * N + i];
        wv[d] = nbr_w[(size_t)d * N + i];
      }
    }
    const float h_i = h[i], gain_i = gain[i], off_i = off[i];
    const float rg_i = rg[i], co_i = co[i];
    uint32_t col_key = 0;
    LfsrTap tap{};
    if (noise.lfsr)
      tap = lfsr_tap(noise.perm[i], noise.C);
    else
      col_key = counter_col_key(i, noise.col0);
    for (int b = 0; b < nb; ++b) {
      const int8_t* row = sp + (size_t)b * N;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < (DT ? DT : D); ++d) {
        const int ix = DT ? iv[d] : nbr_idx[(size_t)d * N + i];
        const float w = DT ? wv[d] : nbr_w[(size_t)d * N + i];
        acc = __fadd_rn(acc, __fmul_rn(w, (float)row[ix]));
      }
      const float act = activation(acc, h_i, beta[b], gain_i, off_i);
      const uint32_t byte =
          noise.lfsr ? lfsr_byte(noise.lf + b * noise.C, tap)
                     : counter_byte(noise.half_key, noise.b0 + b, noise.row0,
                                    col_key);
      sp[(size_t)b * N + i] =
          sign_spin(decide(act, rg_i, co_i, byte_to_uniform(byte)));
    }
  }
}

// A sweep's moments over the tile's nb chains, weighted by wgt:
// part_s[i] += wgt·Σ_b m_bi and part_c[d·N + i] += wgt·Σ_b m_bi·m_b,idx[d,i]
// (integer chain sums; one owner thread per entry, in sweep order).  T is
// the tile's spin type (int8 or float holding -1, 0, +1).  No barrier.
template <typename T>
__device__ __forceinline__ void accumulate_slot_moments(
    const T* sp, int nb, int N, int D, const int* nbr_idx, float wgt,
    float* part_s, float* part_c, int tid, int nt) {
  for (int i = tid; i < N; i += nt) {
    int sum = 0;
    for (int b = 0; b < nb; ++b) sum += (int)sp[(size_t)b * N + i];
    part_s[i] = __fadd_rn(part_s[i], __fmul_rn(wgt, (float)sum));
    for (int d = 0; d < D; ++d) {
      const int ix = nbr_idx[(size_t)d * N + i];
      int corr = 0;
      for (int b = 0; b < nb; ++b)
        corr += (int)sp[(size_t)b * N + i] * (int)sp[(size_t)b * N + ix];
      float* dc = part_c + (size_t)d * N + i;
      *dc = __fadd_rn(*dc, __fmul_rn(wgt, (float)corr));
    }
  }
}

// One thread walks the tile's chains in order (two chains of a tile may share
// a bin): dst[code] += wgt for each chain's visible pattern.
template <typename T>
__device__ __forceinline__ void hist_accumulate(const T* sp, int nb, int N,
                                                const int* visible_idx,
                                                int n_visible, float wgt,
                                                float* dst) {
  for (int b = 0; b < nb; ++b) {
    int code = 0;
    for (int k = 0; k < n_visible; ++k)
      code |= (sp[(size_t)b * N + visible_idx[k]] > (T)0) << k;
    dst[code] = __fadd_rn(dst[code], wgt);
  }
}

// Block-wide compaction: list[0..count) = the nodes i < N with mask[i] != 0,
// ascending; returns count in every thread.  scratch holds 33 ints.  Every
// thread of the block must call it (tid in [0, nt), nt a multiple of 32); it
// ends with a barrier.
__device__ int compact_mask(const uint8_t* mask, int N, int* list,
                            int* scratch, int tid, int nt) {
  const int lane = tid & 31, warp = tid >> 5, n_warps = (nt + 31) >> 5;
  int base = 0;
  for (int start = 0; start < N; start += nt) {
    const int i = start + tid;
    const bool keep = i < N && mask[i] != 0;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) scratch[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int run = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int c = scratch[w];
        scratch[w] = run;
        run += c;
      }
      scratch[32] = run;
    }
    __syncthreads();
    if (keep)
      list[base + scratch[warp] + __popc(ballot & ((1u << lane) - 1u))] = i;
    base += scratch[32];
    __syncthreads();  // scratch is rewritten by the next chunk
  }
  return base;
}

// dst[0..n) = src[0..n): block `blk` of `n_blocks` copies its own contiguous
// slice, as 16-byte vectors when both pointers allow it.
__device__ __forceinline__ void copy_slice(const float* src, float* dst,
                                           size_t n, int blk, int n_blocks,
                                           int tid, int nt) {
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15u) == 0;
  const size_t units = vec ? n / 4 : n;
  const size_t per = (units + n_blocks - 1) / n_blocks;
  const size_t start = (size_t)blk * per;
  const size_t lo = start < units ? start : units;
  const size_t hi = lo + per < units ? lo + per : units;
  if (vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (size_t k = lo + tid; k < hi; k += nt) d4[k] = s4[k];
    if (blk == n_blocks - 1)  // the tail that is not a whole vector
      for (size_t k = units * 4 + tid; k < n; k += nt) dst[k] = src[k];
  } else {
    for (size_t k = lo + tid; k < hi; k += nt) dst[k] = src[k];
  }
}

// out[k] = sum over blocks of part[blk][k], in block order (fixed, so the
// result does not depend on scheduling; no atomics).
__global__ void reduce_partials_kernel(const float* part, float* out,
                                       int n_blocks, size_t len) {
  const size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= len) return;
  float acc = 0.0f;
  for (int j = 0; j < n_blocks; ++j) acc = __fadd_rn(acc, part[(size_t)j * len + k]);
  out[k] = acc;
}

inline void reduce_partials(const float* part, float* out, int n_blocks,
                            size_t len, cudaStream_t stream) {
  const unsigned grid = (unsigned)((len + 255) / 256);
  reduce_partials_kernel<<<grid, 256, 0, stream>>>(part, out, n_blocks, len);
}

}  // namespace
}  // namespace pbit
