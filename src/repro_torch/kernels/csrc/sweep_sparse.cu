// Sweep-resident block-sparse p-bit sampling engine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sweep_fused.py::sweep_sparse_pallas
// (body `_kernel` with sparse=True).  One launch runs S chromatic sweeps (or a
// half-sweep window of them) with the spins of a tile of chains resident in
// shared memory as int8, the D-slot neighbour gather for eqn 1, tanh + noise +
// comparator for eqn 2, the reference's own integer noise streams (counter
// hash or per-cell Galois LFSR) generated in place, and optional first/second
// moments and visible-pattern histogram.
//
// What bounds it on this card: operations, not bytes.  Each input is read once
// and the spins are written once per launch; per flip the kernel does D
// shared-memory gathers with a multiply-add each, two 32-bit avalanche hashes,
// one tanhf and a handful of adds, and every half-sweep ends in a block-wide
// barrier.  The design keeps everything a flip needs on chip: spins in shared
// memory for the whole launch, a node's weights/indices in registers across
// the tile's chains, the LFSR registers of the tile in shared memory stepped
// once per half-sweep.
//
// Design (not a block-by-block carry-over of the TPU kernel):
//   * grid over chains: block `blk` owns chains [blk*tb, blk*tb+tb) for all
//     half-sweeps (chains never interact); threads stride over nodes.  The
//     ragged last tile is the block's own bound — padded chains do not exist.
//   * only nodes of the active colour mask compute and write, in place.  The
//     caller guarantees each mask is an independent set of the slot graph
//     (Chimera is 2-coloured; a node reads only other-colour neighbours and
//     its own zero-weight padding slots), so a half-sweep is race-free.
//   * moments/histogram: a GPU has no sequential grid to carry a scratch sum.
//     Each block accumulates its own partial rows in device memory (one owner
//     thread per entry, sweep order), and `reduce_partials` then sums the
//     blocks in block order — a fixed order, no atomics, reproducible.
//   * float decisions use explicit round-to-nearest intrinsics so nothing is
//     contracted into an FMA differently than the eager PyTorch version; build
//     without --use_fast_math (tanhf must stay the libdevice tanhf).
//   * the noise streams, the decision, clamps, histogram and the reduction are
//     shared with the dense kernels K2 and K3, and the half-sweep body and its
//     moments with K5 (pbit_common.cuh).
//
// K4, the double-buffered program stream, is the same kernel with Stream =
// true (`sweep_sparse_stream_launch`).  Replaces the TPU kernel
// src/repro/kernels/sweep_fused.py::sweep_sparse_stream_pallas (`_kernel` with
// stream=True): counter noise only, no moments or histogram; while the CURRENT
// program sweeps, the NEXT program's (D, N) slot weights and (N,) biases are
// copied into the staged output buffers.  Bound as K1 (operations) plus the
// staged bytes (2 x 4(D+1)N: 12 KB read and written at N=440, D=6).  Each block
// copies its own disjoint slice with 16-byte loads before its first barrier, so
// on the card the copy overlaps the other blocks' sweeps; the staged buffers are
// distinct from the current program's (the wrapper refuses aliasing), so the
// copy never races the sweep's reads.  The TPU kernel aliased the next-program
// inputs to the staged outputs; here the caller swaps a two-slot ring instead.
//
// Plain C interface (loaded with ctypes); every function launches on the given
// stream, allocates nothing, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

namespace {

using pbit::kNoiseLfsr;

struct Params {
  const float* m_in;          // (B, N) spins, +-1
  float* m_out;               // (B, N)
  int B, N, D, S;
  const int* nbr_idx;         // (D, N)
  const float* nbr_w;         // (D, N)
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
  int half_offset, n_half;
  float* part_s;              // (n_blocks, N) or null
  float* part_c;              // (n_blocks, D, N) or null
  float* part_h;              // (n_blocks, 2^n_visible) or null
  int tb;                     // chains per block
  const float* next_w;        // K4: (D, N) next program's slot weights
  const float* next_h;        // K4: (N,) next program's biases
  float* staged_w;            // K4: (D, N) copy of next_w
  float* staged_h;            // K4: (N,) copy of next_h
};

// DT > 0: the slot count is the compile-time constant DT (see
// pbit::slot_half_sweep); DT == 0: any slot count.  Stream: K4, which also
// stages the next program (see the head of this file).
template <int DT, bool Stream>
__global__ void __launch_bounds__(1024) sweep_sparse_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sp = reinterpret_cast<int8_t*>(smem);  // [tb][N] spins
  uint32_t* lf = reinterpret_cast<uint32_t*>(
      smem + pbit::tile_spin_bytes(p.tb, p.N));  // [tb][C]

  const int tid = threadIdx.x, nt = blockDim.x, blk = blockIdx.x;
  const int N = p.N, B = p.B, C = p.C;
  const int D = DT ? DT : p.D;
  const int b0 = blk * p.tb;
  const int nb = min(p.tb, B - b0);  // real chains of this tile
  const bool lfsr = p.noise_mode == kNoiseLfsr;
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;
  const int NB = p.part_h ? (1 << p.n_visible) : 0;

  for (int k = tid; k < nb * N; k += nt)
    sp[k] = pbit::spin_of(p.m_in[(size_t)b0 * N + k]);
  if (lfsr)
    for (int k = tid; k < nb * C; k += nt) lf[k] = p.noise_in[(size_t)b0 * C + k];
  if (p.part_s)
    for (int i = tid; i < N; i += nt) p.part_s[(size_t)blk * N + i] = 0.0f;
  if (p.part_c)
    for (int k = tid; k < D * N; k += nt) p.part_c[(size_t)blk * D * N + k] = 0.0f;
  if (p.part_h)
    for (int k = tid; k < NB; k += nt) p.part_h[(size_t)blk * NB + k] = 0.0f;

  uint32_t seed = 0, ctr0 = 0;
  if (!lfsr) {
    seed = p.noise_in[0];
    ctr0 = p.noise_in[1];
  }
  if (Stream) {  // before the first barrier: overlaps the other blocks' sweeps
    pbit::copy_slice(p.next_w, p.staged_w, (size_t)D * N, blk, gridDim.x, tid, nt);
    pbit::copy_slice(p.next_h, p.staged_h, (size_t)N, blk, gridDim.x, tid, nt);
  }
  __syncthreads();

  for (int j = 0; j < p.n_half; ++j) {
    const int g = p.half_offset + j;  // launch-relative half-sweep
    const int s = g >> 1;             // sweep: indexes betas and measured
    const int c = g & 1;              // colour

    // clamps are re-imposed at the start of every sweep, and once at the
    // start of a window that opens on the second half of a sweep
    if (has_clamp && (c == 0 || j == 0)) {
      pbit::impose_clamps(sp, nb, N, p.clamp_mask,
                          p.clamp_values + (size_t)b0 * N, tid, nt);
      __syncthreads();
    }

    pbit::SlotNoise noise{lfsr, 0u, b0, p.row0, p.col0, lf, C, p.perm};
    if (lfsr) {
      pbit::lfsr_step_tile(lf, nb * C, p.decimation, tid, nt);
      __syncthreads();
    } else {
      noise.half_key = pbit::counter_half_key(seed, ctr0 + (uint32_t)j);
    }
    pbit::slot_half_sweep<DT>(sp, nb, N, D, p.nbr_idx, p.nbr_w, p.h, p.gain,
                              p.off, p.rg, p.co, c ? p.mask1 : p.mask0,
                              p.betas + (size_t)s * B + b0, noise, tid, nt);
    __syncthreads();

    // statistics after the sweep's second half, weighted by measured[s]
    if (c == 1 && p.measured != nullptr) {
      const float wgt = p.measured[s];
      if (wgt != 0.0f) {
        if (p.part_s)
          pbit::accumulate_slot_moments(sp, nb, N, D, p.nbr_idx, wgt,
                                        p.part_s + (size_t)blk * N,
                                        p.part_c + (size_t)blk * D * N, tid,
                                        nt);
        if (p.part_h && tid == 0)
          pbit::hist_accumulate(sp, nb, N, p.visible_idx, p.n_visible, wgt,
                                p.part_h + (size_t)blk * NB);
        __syncthreads();  // the next half-sweep overwrites what was read
      }
    }
  }

  for (int k = tid; k < nb * N; k += nt)
    p.m_out[(size_t)b0 * N + k] = (float)sp[k];
  if (lfsr) {
    for (int k = tid; k < nb * C; k += nt) p.noise_out[(size_t)b0 * C + k] = lf[k];
  } else if (blk == 0 && tid == 0) {
    p.noise_out[0] = seed;
    p.noise_out[1] = ctr0 + (uint32_t)p.n_half;
  }
}

__global__ void tanh_probe_kernel(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = tanhf(x[i]);
}

// Shared-memory bytes of one block: the tile's int8 spins and, in LFSR mode,
// its registers.
size_t smem_bytes(int tb, int N, int C, int noise_mode) {
  size_t bytes = pbit::tile_spin_bytes(tb, N);
  if (noise_mode == kNoiseLfsr) bytes += (size_t)tb * (size_t)C * sizeof(uint32_t);
  return bytes;
}

// One launch of an instantiation, with the shared memory the tile needs (opted
// in above 48 KB).
cudaError_t launch(void (*kernel)(const Params), const Params& p, int n_blocks,
                   int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.tb, p.N, p.C, p.noise_mode);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's opt-in limit before choosing `tb`.
int sweep_sparse_smem_bytes(int tb, int N, int C, int noise_mode) {
  return (int)smem_bytes(tb, N, C, noise_mode);
}

int sweep_sparse_launch(
    const float* m_in, float* m_out, int B, int N, int D, int S,
    const int* nbr_idx, const float* nbr_w, const float* h, const float* gain,
    const float* off, const float* rg, const float* co, const uint8_t* mask0,
    const uint8_t* mask1, const float* betas, const uint8_t* clamp_mask,
    const float* clamp_values, const float* measured, const int* visible_idx,
    int n_visible, int noise_mode, const uint32_t* noise_in,
    uint32_t* noise_out, int C, const int* perm, int decimation,
    uint32_t row0, uint32_t col0, int half_offset, int n_half, float* part_s,
    float* part_c, float* out_s, float* out_c, float* part_h, float* out_h,
    int tb, int threads, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  Params p = {};
  p.m_in = m_in; p.m_out = m_out; p.B = B; p.N = N; p.D = D; p.S = S;
  p.nbr_idx = nbr_idx; p.nbr_w = nbr_w; p.h = h; p.gain = gain; p.off = off;
  p.rg = rg; p.co = co; p.mask0 = mask0; p.mask1 = mask1; p.betas = betas;
  p.clamp_mask = clamp_mask; p.clamp_values = clamp_values;
  p.measured = measured; p.visible_idx = visible_idx; p.n_visible = n_visible;
  p.noise_mode = noise_mode; p.noise_in = noise_in; p.noise_out = noise_out;
  p.C = C; p.perm = perm; p.decimation = decimation; p.row0 = row0;
  p.col0 = col0; p.half_offset = half_offset; p.n_half = n_half;
  p.part_s = part_s; p.part_c = part_c; p.part_h = part_h; p.tb = tb;

  const int n_blocks = (B + tb - 1) / tb;
  auto kernel = (D == 6) ? sweep_sparse_kernel<6, false>
                         : sweep_sparse_kernel<0, false>;
  cudaError_t err = launch(kernel, p, n_blocks, threads, stream);
  if (err != cudaSuccess) return (int)err;
  if (part_s) {
    pbit::reduce_partials(part_s, out_s, n_blocks, N, stream);
    pbit::reduce_partials(part_c, out_c, n_blocks, (size_t)D * N, stream);
  }
  if (part_h)
    pbit::reduce_partials(part_h, out_h, n_blocks, (size_t)1 << n_visible,
                          stream);
  return (int)cudaGetLastError();
}

// K4: K1 with counter noise and no statistics, staging (next_w, next_h) into
// (staged_w, staged_h) during the launch.
int sweep_sparse_stream_launch(
    const float* m_in, float* m_out, int B, int N, int D, int S,
    const int* nbr_idx, const float* nbr_w, const float* h, const float* gain,
    const float* off, const float* rg, const float* co, const uint8_t* mask0,
    const uint8_t* mask1, const float* betas, const uint8_t* clamp_mask,
    const float* clamp_values, const uint32_t* noise_in, uint32_t* noise_out,
    uint32_t row0, uint32_t col0, int half_offset, int n_half,
    const float* next_w, const float* next_h, float* staged_w,
    float* staged_h, int tb, int threads, void* stream_ptr) {
  Params p = {};
  p.m_in = m_in; p.m_out = m_out; p.B = B; p.N = N; p.D = D; p.S = S;
  p.nbr_idx = nbr_idx; p.nbr_w = nbr_w; p.h = h; p.gain = gain; p.off = off;
  p.rg = rg; p.co = co; p.mask0 = mask0; p.mask1 = mask1; p.betas = betas;
  p.clamp_mask = clamp_mask; p.clamp_values = clamp_values;
  p.noise_mode = 0; p.noise_in = noise_in; p.noise_out = noise_out;
  p.row0 = row0; p.col0 = col0; p.half_offset = half_offset;
  p.n_half = n_half; p.tb = tb;
  p.next_w = next_w; p.next_h = next_h; p.staged_w = staged_w;
  p.staged_h = staged_h;

  const int n_blocks = (B + tb - 1) / tb;
  auto kernel = (D == 6) ? sweep_sparse_kernel<6, true>
                         : sweep_sparse_kernel<0, true>;
  return (int)launch(kernel, p, n_blocks, threads,
                     reinterpret_cast<cudaStream_t>(stream_ptr));
}

// Diagnostic: y = tanhf(x), to check this build's tanhf against torch.tanh.
int tanh_probe(const float* x, float* y, int n, void* stream_ptr) {
  tanh_probe_kernel<<<(n + 255) / 256, 256, 0,
                      reinterpret_cast<cudaStream_t>(stream_ptr)>>>(x, y, n);
  return (int)cudaGetLastError();
}

const char* sweep_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
