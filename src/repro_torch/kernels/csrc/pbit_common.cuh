// Device code shared by the port's p-bit kernels (sm_90a): the noise streams,
// the eqn-2 decision, clamp re-imposition, the visible-pattern histogram,
// colour-mask compaction and the fixed-order reduction of per-block partials.
//
// Included by sweep_sparse.cu (K1), pbit_update.cu (K2) and sweep_fused.cu
// (K3); each is built into its own library, so everything here has internal
// linkage.  Every float operation is an explicit round-to-nearest intrinsic
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
