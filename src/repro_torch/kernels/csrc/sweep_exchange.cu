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
// half-sweep and moments, from pbit_common.cuh; counter noise) on the
// halo-extended block [local | halo_up | halo_dn] of N = n_loc + 2H columns,
// whose halo columns are never updated, with the launch split at the exchange
// points into half-sweep windows [h0, h1)
// (`kernels/ref.py::halo_exchange_segments`).
// Before window e every band publishes its boundary (the columns `send_up` /
// `send_dn` of its first / last cell row) and then
//   * barrier: installs the values its neighbours just published;
//   * async:   installs the values they published at exchange e-1 (window 0
//              runs on the halo columns the caller primed), and after the
//              last window the values of the last exchange are installed, so
//              the output carries them into the next launch.
// Edge bands install zeros.  Noise is the counter hash at (chain + row0,
// column + col0[band]) with counter ctr0 + half-sweep index; the noise state
// comes back as ctr0 + 2S.  Optional: per-band moments (as K1's, over the
// extended columns), clamps (re-imposed at every sweep start and at a window
// that opens on a second half), or a staged copy of the next program.
//
// What bounds it on this card: operations, as K1 (per flip: D shared-memory
// gathers with a multiply-add, two 32-bit hashes, one tanhf), plus one grid
// barrier per exchange point; the boundary bytes are small (2·B·H per band
// per exchange, as int8).
//
// Design:
//   * grid: (band x chain tile), band-major; a block keeps its band's extended
//     spins for its `tb` chains in shared memory as int8 for the whole launch
//     (0 marks a halo column past the lattice's edge).
//   * exchange: each block writes its chains' boundary columns into a global
//     mailbox [slot][band][direction][chain][H], all blocks meet at a grid
//     barrier, and each block reads its neighbours' entries into its halo
//     columns.  Three slots rotate over the exchanges: under `async` a block
//     reads exchange e-1's slot after barrier e, and the slot is written again
//     only at exchange e+2, which no block reaches before every block has
//     passed barrier e+1 — after its read.
//   * the grid barrier is a counter in device memory (zeroed before the launch,
//     target (e+1)·blocks at exchange e): thread 0 of each block fences, adds
//     one and spins with a volatile read; mailbox reads are volatile too, so
//     they come from L2 and never from a stale L1 line.  Blocks that wait for
//     each other must all be resident: the launch is cooperative
//     (cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident),
//     and the wrapper sizes `tb` from the occupancy API so the grid fits.
//   * moments: per-block partials (integer sums with 0/1 weights), then a
//     fixed-order reduce over each band's tiles — no atomics, reproducible.
//
// Plain C interface (loaded with ctypes); every function launches on the given
// stream, allocates nothing, does not synchronise, and returns the CUDA error.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

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
    row[p.n_loc + j] =
        r > 0 ? read_mailbox(p, mailbox_at(p, slot, r - 1, 1, b0 + b, j))
              : (int8_t)0;
    row[p.n_loc + H + j] =
        r < p.R - 1
            ? read_mailbox(p, mailbox_at(p, slot, r + 1, 0, b0 + b, j))
            : (int8_t)0;
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

}  // namespace

extern "C" {

// How many blocks of `threads` threads and `smem` bytes of shared memory can
// be resident on the current device at once (the cooperative launch's
// ceiling), into *out.
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

int sweep_sparse_exchange_launch(
    const float* m_in, float* m_out, int R, int B, int N, int D, int S,
    int n_loc, int H, const int* nbr_idx, const float* nbr_w, const float* h,
    const float* gain, const float* off, const float* rg, const float* co,
    const uint8_t* mask0, const uint8_t* mask1, const float* betas,
    const int* send_up, const int* send_dn, const uint8_t* clamp_mask,
    const float* clamp_values, const float* measured,
    const uint32_t* noise_in, uint32_t* noise_out, uint32_t row0,
    const uint32_t* col0, const int* ex_pts, int n_ex, int async_mode,
    float* part_s, float* part_c, float* out_s, float* out_c,
    const float* next_w, const float* next_h, float* staged_w,
    float* staged_h, int8_t* mailbox, unsigned int* barrier, int tb,
    int threads, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  ExParams p = {};
  p.m_in = m_in; p.m_out = m_out; p.R = R; p.B = B; p.N = N; p.D = D;
  p.S = S; p.n_loc = n_loc; p.H = H; p.nbr_idx = nbr_idx; p.nbr_w = nbr_w;
  p.h = h; p.gain = gain; p.off = off; p.rg = rg; p.co = co;
  p.mask0 = mask0; p.mask1 = mask1; p.betas = betas; p.send_up = send_up;
  p.send_dn = send_dn; p.clamp_mask = clamp_mask;
  p.clamp_values = clamp_values; p.measured = measured;
  p.noise_in = noise_in; p.noise_out = noise_out; p.row0 = row0;
  p.col0 = col0; p.ex_pts = ex_pts; p.n_ex = n_ex; p.async_mode = async_mode;
  p.part_s = part_s; p.part_c = part_c; p.next_w = next_w; p.next_h = next_h;
  p.staged_w = staged_w; p.staged_h = staged_h; p.mailbox = mailbox;
  p.barrier = barrier; p.tb = tb; p.tiles = (B + tb - 1) / tb;

  const int n_blocks = R * p.tiles;
  const Kernel kernel = kernel_for(D, next_w != nullptr);
  const size_t smem = pbit::tile_spin_bytes(tb, N);
  cudaError_t err = opt_in_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(n_blocks), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  if (part_s) {  // each band's tiles, in tile order
    for (int r = 0; r < R; ++r) {
      pbit::reduce_partials(part_s + (size_t)r * p.tiles * N,
                            out_s + (size_t)r * N, p.tiles, N, stream);
      pbit::reduce_partials(part_c + (size_t)r * p.tiles * D * N,
                            out_c + (size_t)r * D * N, p.tiles,
                            (size_t)D * N, stream);
    }
  }
  return (int)cudaGetLastError();
}

const char* sweep_exchange_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
