// Dense chromatic-Gibbs half-sweep for NVIDIA Hopper (sm_90a): K2.
//
// Replaces the TPU kernel src/repro/kernels/pbit_update.py::pbit_half_sweep_pallas.
// One launch is one half-sweep: for every node i of the update list and every
// chain b, I = sum_j W[i, j] * m[b, j] + h[i], then eqn 2 with the chain's
// beta and the given uniform u[b, i]; nodes outside the update set keep their
// spin.
//
// The product is the sequential float32 row reduction in ascending j, from
// +0.0 (no tensor cores, no split-K).  Each term is one __fmaf_rn(w, m, acc):
// spins are +-1, so w * m is exact and the fused multiply-add rounds once, as
// __fadd_rn(acc, w * m) does; adding a +-0.0 term to an accumulator that
// started at +0.0 never changes it.  So the sum equals the plain version's
// (kernels/ref.py::dense_neuron_input) and, on a Chimera chip, K1's
// ascending-slot sum, bit for bit.
//
// What bounds it on this card: the chain of N dependent adds of each (chain,
// node) — 440 at the chip's size, ~0.9 us — the staging of each block's rows
// from L2, and, at 256 chains, the issue of one FMA per term over 56k
// outputs.  The design:
//   * the caller hands in the compacted update list and the list of the
//     other nodes (built once per colour mask of a sweep function,
//     kernels/ops.py); the grid is sized from the update list, so every
//     block has updates; the plan (pbit_update.py::half_sweep_plan) picks
//     the largest block tile whose grid covers most of the SMs at both of
//     the paths' chain counts;
//   * a block takes `nodes` entries of the list and `chains` chains, and
//     stages their W rows and spin rows into shared memory once, a TMA bulk
//     copy a row (cp.async.bulk, one mbarrier for the block), then sums in
//     ascending order from shared memory with no further block barrier (the
//     staged body); where the rows do not fit or are not 16-byte aligned, it
//     stages them in double-buffered column tiles with cp.async copies of
//     16 bytes, or of 4 where rows are not aligned (the tiled body);
//   * a warp is 4 x 8 lanes (nodes x chains), each lane a register tile of
//     RN nodes x RB chains, fed by 16-byte shared loads of 4 columns issued
//     a group ahead; shared rows are padded to a stride of 4 mod 32 floats,
//     so the 8 chain rows a quarter-warp reads lie in distinct banks; what
//     the decision reads is loaded before the sum;
//   * the nodes outside the update set keep their spins: every block writes
//     its share of them for its chains, from its staged spin rows.
// Every read is of the input spins and every write goes to a separate output
// buffer: the update is synchronous (Jacobi) even when W couples nodes of one
// colour.
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

// What every call of one prepared half-sweep shares (kernels/pbit_update.py
// `_HalfStatic` mirrors it field for field).  Outside the anonymous
// namespace: the extern "C" entry points take it.
struct HalfStatic {
  const float* W;       // (N, N) row-major: W[i * N + j]
  const float* h;       // (N,) rows
  const float* gain;
  const float* off;
  const float* rg;
  const float* co;
  const int* index;     // (n_upd,) the update set's nodes, ascending
  const int* keep;      // (n_keep,) the other nodes, ascending
  int N, B, n_upd, n_keep;
  int reg_nodes, reg_chains;  // a lane's register tile
  int warps_b;                // warps of a block along its chains
  int threads;
  int grid_x, grid_y;         // list tiles, chain tiles
  int tiled;                  // 0: the staged body, 1: the tiled body
};

namespace {

constexpr int kLaneNodes = 4;    // lanes of a warp along the block's nodes
constexpr int kLaneChains = 8;   // lanes of a warp along its chains
constexpr int kMaxThreads = 128;
constexpr int kTileK = 128;      // columns a stage of the tiled body holds
// the staged body's mbarrier sits in front of its rows (16 bytes keep them
// 16-byte aligned)
constexpr int kBarBytes = 16;
constexpr int kRowPad = 4;       // a shared row's stride is 4 mod 32 floats

// shared-row stride in floats: the staged body holds whole rows, the tiled
// body kTileK columns; either is 4 mod 32
__host__ __device__ inline int row_stride(int tiled, int N) {
  if (tiled) return kTileK + kRowPad;
  const int n4 = (N + 3) & ~3;
  return n4 + (((kRowPad - n4) % 32) + 32) % 32;
}

__host__ __device__ inline int smem_bytes(int tiled, int rows, int N) {
  return tiled ? 2 * rows * row_stride(tiled, N) * (int)sizeof(float)
               : kBarBytes + rows * row_stride(tiled, N) * (int)sizeof(float);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Issue the 16- or 4-byte copies of columns [c0, c0 + width) of the block's
// rows to buf, buf + ld, ... (row r's column c0 at buf + r * ld): rows
// [0, tn) are W's rows of the block's list entries (lane r holds entry r's
// node in `node`), rows [tn, tn + tb) the spins of chains b0..  The spin
// rows go first: their addresses do not wait for the list.  A ragged edge
// repeats the last entry / chain (read, never stored).  Warps take rows,
// lanes columns.
__device__ __forceinline__ void stage(float* buf, int ld, int c0, int width,
                                      const HalfStatic& s, const float* m,
                                      int node, int b0, int tn, int tb,
                                      bool vec, int lane, int warp,
                                      int n_warps) {
  for (int k = warp; k < tn + tb; k += n_warps) {
    const int r = k < tb ? tn + k : k - tb;
    const float* src;
    if (r < tn)
      src = s.W + (size_t)__shfl_sync(0xFFFFFFFFu, node, r) * s.N;
    else
      src = m + (size_t)min(b0 + r - tn, s.B - 1) * s.N;
    src += c0;
    float* dst = buf + (size_t)r * ld;
    if (vec) {
      for (int j = 4 * lane; j < width; j += 128) cp_async16(dst + j, src + j);
    } else {
      for (int j = lane; j < width; j += 32) cp_async4(dst + j, src + j);
    }
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the phase of `parity` to complete.  A barrier that never
// completes (bytes expected that no copy brings) traps after ~2^26 polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0; !mbar_try_wait(bar, parity);)
    if (++polls == (1u << 26)) __trap();
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completing its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A lane's staged rows in shared memory.
template <int R>
struct Rows {
  const float* p[R];
};

// One column of the terms: acc[r][c] = fma(w[r], m[c], acc[r][c]).
template <int RN, int RB>
__device__ __forceinline__ void fma_column(float (&acc)[RN][RB],
                                           const float (&w)[RN],
                                           const float (&m)[RB]) {
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[r][c] = __fmaf_rn(w[r], m[c], acc[r][c]);
}

// The shared loads of columns [j, j + 8): two 16-byte loads a row.
template <int RN, int RB>
__device__ __forceinline__ void load8(float4 (&w4)[RN][2], float4 (&m4)[RB][2],
                                      const Rows<RN>& wr, const Rows<RB>& mr,
                                      int j) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < RN; ++r)
      w4[r][h] = *reinterpret_cast<const float4*>(wr.p[r] + j + 4 * h);
#pragma unroll
    for (int c = 0; c < RB; ++c)
      m4[c][h] = *reinterpret_cast<const float4*>(mr.p[c] + j + 4 * h);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The eight columns of load8, in ascending order.
template <int RN, int RB>
__device__ __forceinline__ void fma_group(float (&acc)[RN][RB],
                                          const float4 (&w4)[RN][2],
                                          const float4 (&m4)[RB][2]) {
  float w[RN], m[RB];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int r = 0; r < RN; ++r) w[r] = lane4(w4[r][k >> 2], k & 3);
#pragma unroll
    for (int c = 0; c < RB; ++c) m[c] = lane4(m4[c][k >> 2], k & 3);
    fma_column<RN, RB>(acc, w, m);
  }
}

// acc[r][c] += the terms of columns [c0, c0 + width) of the staged rows
// (c0 a multiple of 4, width >= 0), in ascending column order, one fused
// multiply-add each.  The next eight columns' shared loads are issued
// before the current eight's FMAs, so their latency hides behind the
// dependent chain (8 FMAs, 32 cycles, even with one chain a lane).
template <int RN, int RB>
__device__ __forceinline__ void accumulate(float (&acc)[RN][RB],
                                           const Rows<RN> wr,
                                           const Rows<RB> mr, int c0,
                                           int width) {
  const int groups = width >> 3;
  if (groups > 0) {
    float4 w4[RN][2], m4[RB][2];
    load8<RN, RB>(w4, m4, wr, mr, c0);
#pragma unroll 2
    for (int g = 1; g < groups; ++g) {
      float4 wn[RN][2], mn[RB][2];
      load8<RN, RB>(wn, mn, wr, mr, c0 + 8 * g);
      fma_group<RN, RB>(acc, w4, m4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < RN; ++r) w4[r][h] = wn[r][h];
#pragma unroll
        for (int c = 0; c < RB; ++c) m4[c][h] = mn[c][h];
      }
    }
    fma_group<RN, RB>(acc, w4, m4);
  }
  for (int j = c0 + 8 * groups; j < c0 + width; ++j) {
    float w[RN], m[RB];
#pragma unroll
    for (int r = 0; r < RN; ++r) w[r] = wr.p[r][j];
#pragma unroll
    for (int c = 0; c < RB; ++c) m[c] = mr.p[c][j];
    fma_column<RN, RB>(acc, w, m);
  }
}

template <int RN, int RB, bool Tiled>
__global__ void __launch_bounds__(kMaxThreads) pbit_half_sweep_kernel(
    const HalfStatic s, const float* __restrict__ m, float* __restrict__ out,
    const float* __restrict__ u, const float* __restrict__ beta,
    int beta_stride, int ld) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int tn = kLaneNodes * RN * (n_warps / s.warps_b);
  const int tb = kLaneChains * RB * s.warps_b;
  const int p0 = blockIdx.x * tn;  // this block's slice of the update list
  const int b0 = blockIdx.y * tb;
  const int N = s.N, B = s.B;
  // the tiled body's copies: 16 bytes where rows are 16-byte aligned (the
  // staged body's always are: the host checks)
  const bool vec =
      (N & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(s.W) | reinterpret_cast<uintptr_t>(m)) &
       15u) == 0;
  const bool busy = p0 < s.n_upd;  // uniform across the block
  // lane r < tn: the node of list entry p0 + r (tn <= 32)
  const int node =
      busy && lane < tn ? s.index[min(p0 + lane, s.n_upd - 1)] : 0;
  // this block's share of the kept nodes (its chains keep their spins
  // there), and the lane's first one
  const int kw = (s.n_keep + gridDim.x - 1) / gridDim.x;
  const int e_lo = blockIdx.x * kw, e_hi = min(s.n_keep, e_lo + kw);
  const int kept0 = e_lo + lane < e_hi ? s.keep[e_lo + lane] : 0;
  const int rows = min(tb, B - b0);

  // the staged body: its mbarrier, then its rows; lane r of warp 0 copies
  // W row r (its node is the lane's) and spin row r, one bulk copy each
  float* const rows_smem = Tiled ? smem : smem + kBarBytes / 4;
  const uint32_t bar = shared_addr(smem);
  if (busy) {
    if (!Tiled) {
      if (tid == 0) mbar_init(bar, 1);
      __syncthreads();
      if (warp == 0) {
        const uint32_t row_bytes = (uint32_t)N * sizeof(float);
        if (lane == 0) mbar_expect_tx(bar, (uint32_t)(tn + tb) * row_bytes);
        __syncwarp();
        if (lane < tb)
          bulk_copy(rows_smem + (size_t)(tn + lane) * ld,
                    m + (size_t)min(b0 + lane, B - 1) * N, row_bytes, bar);
        if (lane < tn)
          bulk_copy(rows_smem + (size_t)lane * ld, s.W + (size_t)node * N,
                    row_bytes, bar);
      }
    } else {
      stage(rows_smem, ld, 0, min(kTileK, N), s, m, node, b0, tn, tb, vec,
            lane, warp, n_warps);
      cp_async_commit();
    }
  }

  // the lane's rows: nodes interleave by lane group, chains by lane so that
  // a quarter-warp reads 8 consecutive spin rows
  const int wn = warp / s.warps_b, wb = warp - wn * s.warps_b;
  const int ln = lane >> 3, lb = lane & 7;
  int nl[RN], cl[RB];
#pragma unroll
  for (int r = 0; r < RN; ++r) nl[r] = wn * kLaneNodes * RN + r * kLaneNodes + ln;
#pragma unroll
  for (int c = 0; c < RB; ++c)
    cl[c] = wb * kLaneChains * RB + c * kLaneChains + lb;

  // what the decision reads does not depend on the sum: load it first (a
  // block with no updates reads node 0's, in bounds, and stores nothing)
  int node_r[RN];
  float h_r[RN], gain_r[RN], off_r[RN], rg_r[RN], co_r[RN], beta_c[RB];
  float u_rc[RN][RB];
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int i = __shfl_sync(0xFFFFFFFFu, node, nl[r]);
    node_r[r] = p0 + nl[r] < s.n_upd ? i : -1;
    h_r[r] = s.h[i];
    gain_r[r] = s.gain[i];
    off_r[r] = s.off[i];
    rg_r[r] = s.rg[i];
    co_r[r] = s.co[i];
#pragma unroll
    for (int c = 0; c < RB; ++c)
      u_rc[r][c] = u[(size_t)min(b0 + cl[c], B - 1) * N + i];
  }
#pragma unroll
  for (int c = 0; c < RB; ++c)
    beta_c[c] = beta[(size_t)min(b0 + cl[c], B - 1) * beta_stride];

  // without staged spin rows (no updates here, or column tiles) the kept
  // nodes are copied from device memory while the copies fly
  if (!busy || Tiled) {
    for (int e = e_lo + lane; e < e_hi; e += 32) {
      const int k = e == e_lo + lane ? kept0 : s.keep[e];
#pragma unroll 4
      for (int r = warp; r < rows; r += n_warps) {
        const size_t o = (size_t)(b0 + r) * N + k;
        out[o] = m[o];
      }
    }
  }
  if (!busy) return;

  float acc[RN][RB];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < RB; ++c) acc[r][c] = 0.0f;

  if (!Tiled) {
    mbar_wait(bar, 0);  // every row has landed, and is visible here
    // the kept nodes go out from the staged spin rows: stores only
    for (int e = e_lo + lane; e < e_hi; e += 32) {
      const int k = e == e_lo + lane ? kept0 : s.keep[e];
#pragma unroll 4
      for (int r = warp; r < rows; r += n_warps)
        out[(size_t)(b0 + r) * N + k] = rows_smem[(size_t)(tn + r) * ld + k];
    }
    Rows<RN> wr;
    Rows<RB> mr;
#pragma unroll
    for (int r = 0; r < RN; ++r) wr.p[r] = rows_smem + (size_t)nl[r] * ld;
#pragma unroll
    for (int c = 0; c < RB; ++c)
      mr.p[c] = rows_smem + (size_t)(tn + cl[c]) * ld;
    accumulate<RN, RB>(acc, wr, mr, 0, N);
  } else {
    const size_t buf_floats = (size_t)(tn + tb) * ld;
    const int tiles = (N + kTileK - 1) / kTileK;
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        const int c0 = (t + 1) * kTileK;
        stage(smem + ((t + 1) & 1) * buf_floats, ld, c0, min(kTileK, N - c0),
              s, m, node, b0, tn, tb, vec, lane, warp, n_warps);
      }
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed; tile t + 1 may be in flight
      __syncthreads();
      const float* buf = smem + (t & 1) * buf_floats;
      Rows<RN> wr;
      Rows<RB> mr;
#pragma unroll
      for (int r = 0; r < RN; ++r) wr.p[r] = buf + (size_t)nl[r] * ld;
#pragma unroll
      for (int c = 0; c < RB; ++c) mr.p[c] = buf + (size_t)(tn + cl[c]) * ld;
      accumulate<RN, RB>(acc, wr, mr, 0, min(kTileK, N - t * kTileK));
      __syncthreads();  // the buffer is restaged two tiles on
    }
  }

#pragma unroll
  for (int r = 0; r < RN; ++r) {
    if (node_r[r] < 0) continue;
#pragma unroll
    for (int c = 0; c < RB; ++c) {
      const int b = b0 + cl[c];
      if (b >= B) continue;
      const float d = pbit::decision_u(acc[r][c], h_r[r], beta_c[c],
                                       gain_r[r], off_r[r], rg_r[r], co_r[r],
                                       u_rc[r][c]);
      out[(size_t)b * N + node_r[r]] = d >= 0.0f ? 1.0f : -1.0f;
    }
  }
}

template <int RN, int RB, bool Tiled>
int launch_tile(const HalfStatic& s, const float* m, float* out,
                const float* u, const float* beta, int beta_stride,
                cudaStream_t stream) {
  const int ld = row_stride(Tiled, s.N);
  const int rows = kLaneNodes * RN * (s.threads / 32 / s.warps_b) +
                   kLaneChains * RB * s.warps_b;
  pbit_half_sweep_kernel<RN, RB, Tiled>
      <<<dim3(s.grid_x, s.grid_y), s.threads, smem_bytes(Tiled, rows, s.N),
         stream>>>(s, m, out, u, beta, beta_stride, ld);
  return (int)cudaGetLastError();
}

// Lets the instance launch with up to the card's opt-in shared memory: one
// setting for every plan, so preparing a smaller plan never lowers what a
// larger one prepared before it needs.
template <int RN, int RB, bool Tiled>
int allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(pbit_half_sweep_kernel<RN, RB, Tiled>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin);
}

// the register tiles the plan may pick: (2, 2), (2, 1), (1, 1)
int tile_code(const HalfStatic& s) {
  if (s.reg_nodes == 2 && s.reg_chains == 2) return 0;
  if (s.reg_nodes == 2 && s.reg_chains == 1) return 1;
  if (s.reg_nodes == 1 && s.reg_chains == 1) return 2;
  return -1;
}

}  // namespace

extern "C" {

// Dynamic shared-memory bytes one block needs: `rows` staged rows (list
// entries + chains) of N columns (tiled = 0) or two buffers of a column tile.
int pbit_half_sweep_smem_bytes(int tiled, int rows, int N) {
  return smem_bytes(tiled, rows, N);
}

// Once per prepared half-sweep: checks the tile and lets its kernel use the
// plan's shared memory.
// The staged body's bulk copies need 16-byte aligned rows.
int pbit_half_sweep_prepare(const HalfStatic* s, int smem) {
  const int code = tile_code(*s);
  if (code < 0 || s->threads > kMaxThreads || s->threads % 32 != 0 ||
      (s->threads / 32) % s->warps_b != 0 ||
      (!s->tiled &&
       ((s->N & 3) != 0 || (reinterpret_cast<uintptr_t>(s->W) & 15u) != 0)))
    return (int)cudaErrorInvalidValue;
  switch (code * 2 + (s->tiled ? 1 : 0)) {
    case 0: return allow_smem<2, 2, false>(smem);
    case 1: return allow_smem<2, 2, true>(smem);
    case 2: return allow_smem<2, 1, false>(smem);
    case 3: return allow_smem<2, 1, true>(smem);
    case 4: return allow_smem<1, 1, false>(smem);
    default: return allow_smem<1, 1, true>(smem);
  }
}

// beta: the chain b's inverse temperature is beta[b * beta_stride] (0 for
// one value shared by every chain, 1 for a (B,) vector).
int pbit_half_sweep_launch(const HalfStatic* s, const float* m, float* out,
                           const float* u, const float* beta, int beta_stride,
                           void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (!s->tiled && (reinterpret_cast<uintptr_t>(m) & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (tile_code(*s) * 2 + (s->tiled ? 1 : 0)) {
    case 0: return launch_tile<2, 2, false>(*s, m, out, u, beta, beta_stride, stream);
    case 1: return launch_tile<2, 2, true>(*s, m, out, u, beta, beta_stride, stream);
    case 2: return launch_tile<2, 1, false>(*s, m, out, u, beta, beta_stride, stream);
    case 3: return launch_tile<2, 1, true>(*s, m, out, u, beta, beta_stride, stream);
    case 4: return launch_tile<1, 1, false>(*s, m, out, u, beta, beta_stride, stream);
    case 5: return launch_tile<1, 1, true>(*s, m, out, u, beta, beta_stride, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* pbit_half_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
