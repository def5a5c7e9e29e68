// Sweep-resident dense p-bit sampling engine for NVIDIA Hopper (sm_90a): K3.
//
// Replaces the TPU kernel src/repro/kernels/sweep_fused.py::sweep_fused_pallas
// (body `_kernel` with sparse=False).  One launch runs S chromatic sweeps of a
// tile of chains whose spins stay in shared memory: eqn 1 is the dense product
// with the (N, N) couplings W, eqn 2 the tanh + noise + comparator, the noise
// the reference's own integer streams (counter hash or per-cell Galois LFSR,
// pbit_common.cuh, shared with K1 and K2), and optionally the first moment
// s_sum (N,), the second moment as the Gram matrix sum m^T m (N, N), and the
// visible-pattern histogram.
//
// What bounds it on this card: the pass over W every half-sweep.  At N=440 W
// is 774,400 bytes, more than a block's 232,448 bytes of shared memory, so it
// stays in device memory and is served from the 50 MB L2: each thread's sum is
// a chain of N dependent adds with one L2 load per term.  The arithmetic,
// 2*N flops per (chain, updated node), is far below the card's rate.  In a CD
// phase the Gram partials (n_blocks * N * N floats read and written per
// measured sweep) cost more than the sweeps.  The design:
//   * grid over chains as in K1: block `blk` owns chains [blk*tb, blk*tb+tb)
//     for all half-sweeps; the ragged last tile is the block's own bound.
//   * the product is the sequential float32 row reduction in ascending j from
//     +0.0 (__fadd_rn(__fmul_rn), no tensor cores, no split-K, no FMA): spins
//     are +-1, so it equals the plain version and, on a Chimera chip, K1's
//     ascending-slot sum bit for bit (zeros are additive identities).
//   * W is passed transposed (WT[j * N + i] = W[i, j]) so the threads of a
//     warp, one node each, read one j's couplings from neighbouring addresses.
//   * each colour's update list is compacted once per launch in shared memory;
//     only those rows are computed.
//   * a dense W may couple nodes of one colour, so a half-sweep cannot update
//     in place: spins are double-buffered and every read of a half-sweep is of
//     the previous buffer (synchronous, Jacobi, as the TPU kernel computes the
//     whole input before it writes).  Nodes outside the colour are carried.
//   * moments and histogram: per-block partials in device memory (one owner
//     thread per entry, sweep order) summed over blocks in block order by
//     pbit::reduce_partials — a fixed order, no atomics.  The Gram partial is
//     n_blocks * N * N floats: the wrapper's chain tiling bounds it.
//
// Plain C interface (loaded with ctypes); launches on the given stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

namespace {

using pbit::kNoiseLfsr;

struct Params {
  const float* m_in;          // (B, N) spins, +-1
  float* m_out;               // (B, N)
  int B, N, S;
  const float* WT;            // (N, N) transposed couplings
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
  const int* visible_idx;     // (n_visible,) or null
  int n_visible;
  int noise_mode;
  const uint32_t* noise_in;   // counter: (2,) = (seed, ctr0); lfsr: (B, C)
  uint32_t* noise_out;
  int C;                      // LFSR cells per chain
  const int* perm;            // (N,) node -> flat LFSR column, or null
  int decimation;
  uint32_t row0, col0;        // counter-hash coordinate offsets
  float* part_s;              // (n_blocks, N) or null
  float* part_c;              // (n_blocks, N, N) or null
  float* part_h;              // (n_blocks, 2^n_visible) or null
  int tb;                     // chains per block
};

__global__ void __launch_bounds__(1024) sweep_fused_kernel(const Params p) {
  // Layout of the dynamic shared memory; its size is computed once, by the
  // wrapper (kernels/sweep_fused.py::dense_smem_bytes), and passed in.
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
  const int NB = p.part_h ? (1 << p.n_visible) : 0;
  const size_t NN = (size_t)N * N;

  for (int k = tid; k < nb * N; k += nt)
    cur[k] = (float)pbit::sign_spin(p.m_in[(size_t)b0 * N + k]);
  if (lfsr)
    for (int k = tid; k < nb * C; k += nt) lf[k] = p.noise_in[(size_t)b0 * C + k];
  if (p.part_s)
    for (int i = tid; i < N; i += nt) p.part_s[(size_t)blk * N + i] = 0.0f;
  if (p.part_c)
    for (size_t k = tid; k < NN; k += nt) p.part_c[blk * NN + k] = 0.0f;
  if (p.part_h)
    for (int k = tid; k < NB; k += nt) p.part_h[(size_t)blk * NB + k] = 0.0f;
  const int n0 = pbit::compact_mask(p.mask0, N, list0, scratch, tid, nt);
  const int n1 = pbit::compact_mask(p.mask1, N, list1, scratch, tid, nt);

  uint32_t seed = 0, ctr0 = 0;
  if (!lfsr) {
    seed = p.noise_in[0];
    ctr0 = p.noise_in[1];
  }

  const int n_half = 2 * p.S;
  for (int j = 0; j < n_half; ++j) {
    const int s = j >> 1;  // sweep: indexes betas and measured
    const int c = j & 1;   // colour

    // clamps are re-imposed at the start of every sweep
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

    // nodes outside the colour keep their spin
    for (int k = tid; k < nb * N; k += nt)
      if (!mask[k % N]) nxt[k] = cur[k];

    // (chain, node) pairs of the colour; neighbouring threads take
    // neighbouring nodes of one chain
    for (int k = tid; k < nb * n_c; k += nt) {
      const int b = k / n_c;
      const int i = list[k - b * n_c];
      const float* row = cur + (size_t)b * N;
      const float* col = p.WT + i;
      float acc = 0.0f;
#pragma unroll 8
      for (int jj = 0; jj < N; ++jj)
        acc = __fadd_rn(acc, __fmul_rn(col[(size_t)jj * N], row[jj]));
      const uint32_t byte =
          lfsr ? pbit::lfsr_byte(lf + b * C, pbit::lfsr_tap(p.perm[i], C))
               : pbit::counter_byte(half_key, b0 + b, p.row0,
                                    pbit::counter_col_key(i, p.col0));
      const float beta = p.betas[(size_t)s * B + b0 + b];
      nxt[(size_t)b * N + i] = (float)pbit::sign_spin(pbit::decision(
          acc, p.h[i], beta, p.gain[i], p.off[i], p.rg[i], p.co[i], byte));
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;

    // statistics after the sweep's second half, weighted by measured[s]
    if (c == 1 && p.measured != nullptr) {
      const float wgt = p.measured[s];
      if (wgt != 0.0f) {
        if (p.part_s) {
          for (int i = tid; i < N; i += nt) {
            int sum = 0;
            for (int b = 0; b < nb; ++b) sum += (int)cur[(size_t)b * N + i];
            float* dst = p.part_s + (size_t)blk * N + i;
            *dst = __fadd_rn(*dst, __fmul_rn(wgt, (float)sum));
          }
          for (size_t e = tid; e < NN; e += nt) {
            const int i = (int)(e / N);
            const int jj = (int)(e - (size_t)i * N);
            int corr = 0;
            for (int b = 0; b < nb; ++b)
              corr += (int)cur[(size_t)b * N + i] * (int)cur[(size_t)b * N + jj];
            float* dc = p.part_c + blk * NN + e;
            *dc = __fadd_rn(*dc, __fmul_rn(wgt, (float)corr));
          }
        }
        if (p.part_h && tid == 0)
          pbit::hist_accumulate(cur, nb, N, p.visible_idx, p.n_visible, wgt,
                                p.part_h + (size_t)blk * NB);
        __syncthreads();  // the next half-sweep writes what was read
      }
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

}  // namespace

extern "C" {

// smem: one block's dynamic shared memory for `tb` chains, as the wrapper's
// dense_smem_bytes sizes the layout at the top of sweep_fused_kernel.
int sweep_fused_launch(
    const float* m_in, float* m_out, int B, int N, int S, const float* WT,
    const float* h, const float* gain, const float* off, const float* rg,
    const float* co, const uint8_t* mask0, const uint8_t* mask1,
    const float* betas, const uint8_t* clamp_mask, const float* clamp_values,
    const float* measured, const int* visible_idx, int n_visible,
    int noise_mode, const uint32_t* noise_in, uint32_t* noise_out, int C,
    const int* perm, int decimation, uint32_t row0, uint32_t col0,
    float* part_s, float* part_c, float* out_s, float* out_c, float* part_h,
    float* out_h, int tb, int threads, int smem, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Params p;
  p.m_in = m_in; p.m_out = m_out; p.B = B; p.N = N; p.S = S; p.WT = WT;
  p.h = h; p.gain = gain; p.off = off; p.rg = rg; p.co = co;
  p.mask0 = mask0; p.mask1 = mask1; p.betas = betas;
  p.clamp_mask = clamp_mask; p.clamp_values = clamp_values;
  p.measured = measured; p.visible_idx = visible_idx; p.n_visible = n_visible;
  p.noise_mode = noise_mode; p.noise_in = noise_in; p.noise_out = noise_out;
  p.C = C; p.perm = perm; p.decimation = decimation; p.row0 = row0;
  p.col0 = col0; p.part_s = part_s; p.part_c = part_c; p.part_h = part_h;
  p.tb = tb;

  const int n_blocks = (B + tb - 1) / tb;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sweep_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  sweep_fused_kernel<<<n_blocks, threads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (part_s) {
    pbit::reduce_partials(part_s, out_s, n_blocks, (size_t)N, stream);
    pbit::reduce_partials(part_c, out_c, n_blocks, (size_t)N * N, stream);
  }
  if (part_h)
    pbit::reduce_partials(part_h, out_h, n_blocks, (size_t)1 << n_visible,
                          stream);
  return (int)cudaGetLastError();
}

const char* sweep_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
