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
//
// Plain C interface (loaded with ctypes); every function launches on the given
// stream, allocates nothing, does not synchronise, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kGaloisMask = 0x80200003u;
constexpr int kNoiseLfsr = 1;  // noise_mode: 0 counter hash, 1 Galois LFSR

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
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float byte_to_uniform(uint32_t b) {
  return __fdiv_rn(__fsub_rn((float)b, 127.5f), 128.0f);
}

__device__ __forceinline__ int8_t sign_spin(float x) {
  return x >= 0.0f ? (int8_t)1 : (int8_t)-1;
}

__host__ __device__ inline size_t spin_bytes(int tb, int N) {
  return (((size_t)tb * (size_t)N) + 15) & ~(size_t)15;
}

// DT > 0: the slot count is the compile-time constant DT and a node's slot
// weights/indices live in registers across the tile's chains.  DT == 0: any
// slot count, read from device memory (L1-cached) per chain.
template <int DT>
__global__ void __launch_bounds__(1024) sweep_sparse_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sp = reinterpret_cast<int8_t*>(smem);  // [tb][N] spins
  uint32_t* lf =
      reinterpret_cast<uint32_t*>(smem + spin_bytes(p.tb, p.N));  // [tb][C]

  const int tid = threadIdx.x, nt = blockDim.x, blk = blockIdx.x;
  const int N = p.N, B = p.B, C = p.C;
  const int D = DT ? DT : p.D;
  const int b0 = blk * p.tb;
  const int nb = min(p.tb, B - b0);  // real chains of this tile
  const bool lfsr = p.noise_mode == kNoiseLfsr;
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;
  const int NB = p.part_h ? (1 << p.n_visible) : 0;

  for (int k = tid; k < nb * N; k += nt)
    sp[k] = sign_spin(p.m_in[(size_t)b0 * N + k]);
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
  __syncthreads();

  for (int j = 0; j < p.n_half; ++j) {
    const int g = p.half_offset + j;  // launch-relative half-sweep
    const int s = g >> 1;             // sweep: indexes betas and measured
    const int c = g & 1;              // colour

    // clamps are re-imposed at the start of every sweep, and once at the
    // start of a window that opens on the second half of a sweep
    if (has_clamp && (c == 0 || j == 0)) {
      for (int k = tid; k < nb * N; k += nt) {
        const int i = k % N;
        if (p.clamp_mask[i]) sp[k] = sign_spin(p.clamp_values[(size_t)b0 * N + k]);
      }
      __syncthreads();
    }

    uint32_t half_key = 0;
    if (lfsr) {
      for (int k = tid; k < nb * C; k += nt) {
        uint32_t st = lf[k];
        for (int t = 0; t < p.decimation; ++t)
          st = (st >> 1) ^ ((st & 1u) ? kGaloisMask : 0u);
        lf[k] = st;
      }
      __syncthreads();
    } else {
      half_key = mix32(seed ^ ((ctr0 + (uint32_t)j) * 0x9E3779B9u));
    }

    const uint8_t* mask = c ? p.mask1 : p.mask0;
    for (int i = tid; i < N; i += nt) {
      if (!mask[i]) continue;
      int iv[DT ? DT : 1];
      float wv[DT ? DT : 1];
      if (DT) {
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          iv[d] = p.nbr_idx[(size_t)d * N + i];
          wv[d] = p.nbr_w[(size_t)d * N + i];
        }
      }
      const float h_i = p.h[i], gain_i = p.gain[i], off_i = p.off[i];
      const float rg_i = p.rg[i], co_i = p.co[i];
      uint32_t col_key = 0;
      int byte_shift = 0, cell = 0;
      bool reversed = false;
      if (lfsr) {
        const int col = p.perm[i];
        const int kk = col / C;
        cell = col - kk * C;
        byte_shift = 8 * (kk & 3);
        reversed = kk >= 4;
      } else {
        col_key = ((uint32_t)i + p.col0) * 0xC2B2AE3Du;
      }
      for (int b = 0; b < nb; ++b) {
        const int8_t* row = sp + (size_t)b * N;
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int ix = DT ? iv[d] : p.nbr_idx[(size_t)d * N + i];
          const float w = DT ? wv[d] : p.nbr_w[(size_t)d * N + i];
          acc = __fadd_rn(acc, __fmul_rn(w, (float)row[ix]));
        }
        const float I = __fadd_rn(acc, h_i);
        const float beta = p.betas[(size_t)s * B + b0 + b];
        const float act =
            tanhf(__fmul_rn(__fmul_rn(beta, gain_i), __fadd_rn(I, off_i)));
        uint32_t byte;
        if (lfsr) {
          byte = (lf[b * C + cell] >> byte_shift) & 0xFFu;
          if (reversed) byte = __brev(byte) >> 24;
        } else {
          const uint32_t row_key = ((uint32_t)(b0 + b) + p.row0) * 0x85EBCA77u;
          byte = mix32(half_key ^ row_key ^ col_key) & 0xFFu;
        }
        const float decision = __fadd_rn(
            __fadd_rn(act, __fmul_rn(rg_i, byte_to_uniform(byte))), co_i);
        sp[(size_t)b * N + i] = sign_spin(decision);
      }
    }
    __syncthreads();

    // statistics after the sweep's second half, weighted by measured[s]
    if (c == 1 && p.measured != nullptr) {
      const float wgt = p.measured[s];
      if (wgt != 0.0f) {
        if (p.part_s) {
          for (int i = tid; i < N; i += nt) {
            int sum = 0;
            for (int b = 0; b < nb; ++b) sum += sp[(size_t)b * N + i];
            float* dst = p.part_s + (size_t)blk * N + i;
            *dst = __fadd_rn(*dst, __fmul_rn(wgt, (float)sum));
            for (int d = 0; d < D; ++d) {
              const int ix = p.nbr_idx[(size_t)d * N + i];
              int corr = 0;
              for (int b = 0; b < nb; ++b)
                corr += sp[(size_t)b * N + i] * sp[(size_t)b * N + ix];
              float* dc = p.part_c + ((size_t)blk * D + d) * N + i;
              *dc = __fadd_rn(*dc, __fmul_rn(wgt, (float)corr));
            }
          }
        }
        if (p.part_h && tid == 0) {
          // one thread walks the tile's chains in order: two chains of a
          // tile may share a bin
          for (int b = 0; b < nb; ++b) {
            int code = 0;
            for (int k = 0; k < p.n_visible; ++k)
              code |= (sp[(size_t)b * N + p.visible_idx[k]] > 0) << k;
            float* dh = p.part_h + (size_t)blk * NB + code;
            *dh = __fadd_rn(*dh, wgt);
          }
        }
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

// out[k] = sum over blocks of part[blk][k], in block order (fixed, so the
// result does not depend on scheduling).
__global__ void reduce_partials_kernel(const float* part, float* out,
                                       int n_blocks, int len) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= len) return;
  float acc = 0.0f;
  for (int j = 0; j < n_blocks; ++j)
    acc = __fadd_rn(acc, part[(size_t)j * len + k]);
  out[k] = acc;
}

__global__ void tanh_probe_kernel(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = tanhf(x[i]);
}

void reduce_partials(const float* part, float* out, int n_blocks, int len,
                     cudaStream_t stream) {
  reduce_partials_kernel<<<(len + 255) / 256, 256, 0, stream>>>(part, out,
                                                               n_blocks, len);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block needs; the wrapper checks this against the
// card's opt-in limit before choosing `tb`.
int sweep_sparse_smem_bytes(int tb, int N, int C, int noise_mode) {
  size_t bytes = spin_bytes(tb, N);
  if (noise_mode == kNoiseLfsr) bytes += (size_t)tb * (size_t)C * sizeof(uint32_t);
  return (int)bytes;
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
  Params p;
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
  const int smem = sweep_sparse_smem_bytes(tb, N, C, noise_mode);
  auto kernel = (D == 6) ? sweep_sparse_kernel<6> : sweep_sparse_kernel<0>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_blocks, threads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (part_s) {
    reduce_partials(part_s, out_s, n_blocks, N, stream);
    reduce_partials(part_c, out_c, n_blocks, D * N, stream);
  }
  if (part_h) reduce_partials(part_h, out_h, n_blocks, 1 << n_visible, stream);
  return (int)cudaGetLastError();
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
