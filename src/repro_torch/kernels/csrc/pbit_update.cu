// Dense chromatic-Gibbs half-sweep for NVIDIA Hopper (sm_90a): K2.
//
// Replaces the TPU kernel src/repro/kernels/pbit_update.py::pbit_half_sweep_pallas.
// One launch is one half-sweep: for every node i of the update mask and every
// chain b, I = sum_j W[i, j] * m[b, j] + h[i], then eqn 2 with the chain's
// beta and the given uniform u[b, i]; nodes outside the mask keep their spin.
//
// The product is the sequential float32 row reduction in ascending j, from
// +0.0, one __fadd_rn(__fmul_rn) per term (no tensor cores, no split-K, no
// FMA).  Spins are +-1, so every product is exact and adding a +-0.0 term to an
// accumulator that started at +0.0 never changes it: the sum equals the plain
// version's (kernels/ref.py::dense_neuron_input) and, on a Chimera chip, K1's
// ascending-slot sum, bit for bit.
//
// What bounds it on this card: launch latency at the chip's size.  The work,
// 2*N flops per updated (chain, node), is 25 Mflop per half-sweep at N=440,
// B=256 — microseconds of the card — and the caller launches once per
// half-sweep from a Python loop.  The design: a block takes 32 nodes of the
// colour's compacted update list (every block compacts the mask itself, so no
// host round trip) and 32 chains; W rows and source spins stream through
// shared memory in 32-wide j tiles, so each W element read is reused by the
// block's 32 chains and only rows of the updated colour are read.  Every read
// is of the input spins and every write goes to a separate output buffer: the
// update is synchronous (Jacobi) even when W couples nodes of one colour.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

namespace {

constexpr int kTileN = 32;  // compacted update nodes per block (one per lane)
constexpr int kWarps = 8;   // warps per block
constexpr int kTileB = 32;  // chains per block: kTileB / kWarps per thread
constexpr int kTileK = 32;  // source spins per shared-memory stage
constexpr int kChainsPerThread = kTileB / kWarps;
constexpr int kThreads = kTileN * kWarps;

struct HalfParams {
  const float* m;       // (B, N) spins, +-1
  float* out;           // (B, N)
  int B, N;
  const float* W;       // (N, N) row-major: W[i * N + j]
  const float* h;       // (N,) rows
  const float* gain;
  const float* off;
  const float* rg;
  const float* co;
  const uint8_t* mask;  // (N,) update set
  const float* beta;    // (B,) per-chain inverse temperature
  const float* u;       // (B, N) uniforms in (-1, 1)
};

__global__ void __launch_bounds__(kThreads) pbit_half_sweep_kernel(
    const HalfParams p) {
  extern __shared__ int upd[];  // [N] compacted update list
  __shared__ int scratch[33];
  __shared__ float Ws[kTileN][kTileK + 1];
  __shared__ float Ms[kTileB][kTileK + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int N = p.N, B = p.B;
  const int b0 = blockIdx.y * kTileB;
  const int n_upd = pbit::compact_mask(p.mask, N, upd, scratch, tid, kThreads);

  // nodes of this block's tile in the original order that keep their spin
  {
    const int i = blockIdx.x * kTileN + tx;
    if (i < N && !p.mask[i]) {
      for (int r = ty; r < kTileB; r += kWarps) {
        const int b = b0 + r;
        if (b < B) p.out[(size_t)b * N + i] = p.m[(size_t)b * N + i];
      }
    }
  }

  const int p0 = blockIdx.x * kTileN;  // this block's slice of the update list
  if (p0 >= n_upd) return;             // uniform across the block

  float acc[kChainsPerThread];
#pragma unroll
  for (int k = 0; k < kChainsPerThread; ++k) acc[k] = 0.0f;

  for (int j0 = 0; j0 < N; j0 += kTileK) {
    const int j = j0 + tx;
    for (int r = ty; r < kTileN; r += kWarps) {
      const int q = p0 + r;
      Ws[r][tx] = (q < n_upd && j < N) ? p.W[(size_t)upd[q] * N + j] : 0.0f;
    }
    for (int r = ty; r < kTileB; r += kWarps) {
      const int b = b0 + r;
      Ms[r][tx] = (b < B && j < N) ? p.m[(size_t)b * N + j] : 0.0f;
    }
    __syncthreads();
    // padded entries are +0.0 * x: adding them leaves acc unchanged
#pragma unroll 8
    for (int c = 0; c < kTileK; ++c) {
      const float w = Ws[tx][c];
#pragma unroll
      for (int k = 0; k < kChainsPerThread; ++k)
        acc[k] = __fadd_rn(acc[k], __fmul_rn(w, Ms[ty + k * kWarps][c]));
    }
    __syncthreads();
  }

  const int q = p0 + tx;
  if (q >= n_upd) return;
  const int i = upd[q];
  const float h_i = p.h[i], gain_i = p.gain[i], off_i = p.off[i];
  const float rg_i = p.rg[i], co_i = p.co[i];
#pragma unroll
  for (int k = 0; k < kChainsPerThread; ++k) {
    const int b = b0 + ty + k * kWarps;
    if (b >= B) continue;
    const float d = pbit::decision_u(acc[k], h_i, p.beta[b], gain_i, off_i,
                                     rg_i, co_i, p.u[(size_t)b * N + i]);
    p.out[(size_t)b * N + i] = d >= 0.0f ? 1.0f : -1.0f;
  }
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes one block needs (the compacted update list).
int pbit_half_sweep_smem_bytes(int N) { return N * (int)sizeof(int); }

int pbit_half_sweep_launch(const float* m, float* out, int B, int N,
                           const float* W, const float* h, const float* gain,
                           const float* off, const float* rg, const float* co,
                           const uint8_t* mask, const float* beta,
                           const float* u, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  HalfParams p;
  p.m = m; p.out = out; p.B = B; p.N = N; p.W = W; p.h = h; p.gain = gain;
  p.off = off; p.rg = rg; p.co = co; p.mask = mask; p.beta = beta; p.u = u;
  const int smem = pbit_half_sweep_smem_bytes(N);
  if (smem > 32 * 1024) {  // 48 KB less the static tiles
    cudaError_t err = cudaFuncSetAttribute(
        pbit_half_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N + kTileN - 1) / kTileN, (B + kTileB - 1) / kTileB);
  pbit_half_sweep_kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

const char* pbit_half_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
