// Sweep-resident block-sparse p-bit sampling engine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sweep_fused.py::sweep_sparse_pallas
// (body `_kernel` with sparse=True).  One launch runs S chromatic sweeps (or a
// half-sweep window of them) with the spins of a tile of chains resident in
// shared memory, the D-slot neighbour gather for eqn 1, tanh + noise +
// comparator for eqn 2, the reference's own integer noise streams (counter
// hash or per-cell Galois LFSR) generated in place, and optional first/second
// moments and visible-pattern histogram.
//
// What bounds it on this card: operations, not bytes.  Each input is read once
// and the spins are written once per launch; per flip the kernel does D
// shared-memory gathers with a multiply-add each, two 32-bit avalanche hashes,
// one tanhf and a handful of adds.  At the chip's shapes (440 spins, 256
// chains: two chains an SM) a half-sweep is one flip's dependent chain plus a
// barrier, so what costs is latency and whatever each thread repeats per
// half-sweep.  Two bodies, chosen by kernels/sweep_fused.py::sparse_plan:
//
//   * the resident body (`sweep_sparse_kernel_resident`; D = 6, up to 1024
//     spins): P threads per chain, P the larger colour rounded up to
//     a warp.  At launch start the block lists each colour's nodes in
//     ascending order (pbit::compact_mask) and thread (chain b, rank r) loads
//     the tables of list0[r] and list1[r] -- slot indices and weights, h,
//     gain, offset, noise gain and comparator offset, the node's noise key --
//     into registers, where they stay for the whole launch; it flips list0[r]
//     in even half-sweeps and list1[r] in odd ones, so no lane idles on the
//     other colour.  A chain's warps synchronise among themselves only (a
//     named barrier per chain, `bar.sync 1 + chain, P`), so one chain's
//     barrier wait overlaps another chain's flips; the noise byte depends
//     only on (half-sweep, chain, node) and is drawn before the gather.  The
//     only per-half-sweep device-memory load left is the next sweep's beta.
//     Spins are float in shared memory (the gather needs no conversion).
//   * the strided body (`sweep_sparse_kernel`; any D, any N that fits a
//     block, the lattices and the sharded engine's bands): threads stride
//     over all N nodes and skip those outside the colour, each thread walks
//     the tile's chains, a block-wide barrier ends every half-sweep
//     (pbit::slot_half_sweep, shared with K5); int8 spins.
//
// Common to both:
//   * grid over chains: block `blk` owns chains [blk*tb, blk*tb+tb) for all
//     half-sweeps (chains never interact).  The ragged last tile is the
//     block's own bound -- padded chains compute nothing.
//   * only nodes of the active colour mask compute and write, in place.  The
//     caller guarantees each mask is an independent set of the slot graph
//     (Chimera is 2-coloured; a node reads only other-colour neighbours and
//     its own zero-weight padding slots), so a half-sweep is race-free.
//   * moments/histogram: a GPU has no sequential grid to carry a scratch sum.
//     Each block accumulates its own partial rows in device memory (one owner
//     thread per entry, sweep order), and `reduce_partials` then sums the
//     blocks in block order -- a fixed order, no atomics, reproducible.
//   * float decisions use explicit round-to-nearest intrinsics so nothing is
//     contracted into an FMA differently than the eager PyTorch version; build
//     without --use_fast_math (tanhf must stay the libdevice tanhf).
//   * the noise streams, the decision, clamps, histogram and the reduction are
//     shared with the dense kernels K2 and K3 (pbit_common.cuh).
//
// K4, the double-buffered program stream, is the same kernel with Stream =
// true (`sweep_sparse_stream_launch`), either body.  Replaces the TPU kernel
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

// ---------------------------------------------------------------------------
// the resident body
// ---------------------------------------------------------------------------
constexpr int kResidentD = 6;  // the slot count the resident body takes
constexpr int kMaxChains = 15;  // named barriers 1..15 (0 is __syncthreads)
// Threads of a resident block.  At 1024 ptxas holds the body in 64 registers
// and spills; at 512, with at least one block an SM asked for explicitly, it
// keeps both nodes' tables in 126-128 registers (without the second bound it
// may aim at two blocks an SM and spill the tables to local memory: 1.7x the
// time).  So a chain has at most 512 lanes and N is at most 1024 (nvcc 12.9,
// sm_90a).
constexpr int kResidentThreads = 512;

// The P threads of local chain lb wait for each other (and order their
// shared-memory accesses); no other warp takes part.
__device__ __forceinline__ void chain_barrier(int lb, int P) {
  asm volatile("bar.sync %0, %1;" ::"r"(lb + 1), "r"(P) : "memory");
}

// One Galois LFSR step, and eight at once through jump8: stepping is linear
// over GF(2) and the bits above the low byte only shift in eight steps, so
// step^8(st) = (st >> 8) ^ step^8(st & 0xFF) = (st >> 8) ^ jump8[st & 0xFF].
__device__ __forceinline__ uint32_t lfsr_step1(uint32_t st) {
  return (st >> 1) ^ ((st & 1u) ? pbit::kGaloisMask : 0u);
}

__device__ __forceinline__ uint32_t lfsr_advance(uint32_t st, int decimation,
                                                 const uint32_t* jump8) {
  if (decimation == 8) return (st >> 8) ^ jump8[st & 0xFFu];  // the chip's
  // other decimations: rolled loops, so the hot loop's code stays small
  int t = 0;
#pragma unroll 1
  for (; t + 8 <= decimation; t += 8) st = (st >> 8) ^ jump8[st & 0xFFu];
#pragma unroll 1
  for (; t < decimation; ++t) st = lfsr_step1(st);
  return st;
}

// A node's tables, loaded once and held in registers for the whole launch.
// node and idx are flat indices into the tile's spins (the chain's row offset
// added).  key: counter noise, the hash's row key ^ column key; lfsr, the
// register's byte shift | reversed << 5 | cell << 6.
struct NodeRegs {
  int node;  // -1: this lane owns no node of the colour
  int idx[kResidentD];
  float w[kResidentD];
  float h, gain, off, rg, co;
  uint32_t key;
};

// Node i of chain b, whose row starts at flat index `row` of the tile.
__device__ __forceinline__ NodeRegs load_node(const Params& p, int i, int b,
                                              int row) {
  NodeRegs t{};
  t.node = -1;
  if (i < 0) return t;
  t.node = row + i;
  const int N = p.N;
#pragma unroll
  for (int d = 0; d < kResidentD; ++d) {
    t.idx[d] = row + p.nbr_idx[(size_t)d * N + i];
    t.w[d] = p.nbr_w[(size_t)d * N + i];
  }
  t.h = p.h[i];
  t.gain = p.gain[i];
  t.off = p.off[i];
  t.rg = p.rg[i];
  t.co = p.co[i];
  if (p.noise_mode == kNoiseLfsr) {
    const pbit::LfsrTap tap = pbit::lfsr_tap(p.perm[i], p.C);
    t.key = (uint32_t)tap.shift | ((uint32_t)tap.reversed << 5) |
            ((uint32_t)tap.cell << 6);
  } else {
    t.key = ((uint32_t)b + p.row0) * 0x85EBCA77u ^
            pbit::counter_col_key(i, p.col0);
  }
  return t;
}

__device__ __forceinline__ uint32_t lfsr_key_byte(uint32_t reg, uint32_t key) {
  uint32_t byte = (reg >> (key & 31u)) & 0xFFu;
  if (key & 32u) byte = __brev(byte) >> 24;
  return byte;
}

// The noise term of eqn 2, rg*u, from a noise byte: u = (byte - 127.5) / 128
// as a multiply by 2^-7, exact like the division (the operand is a multiple
// of 0.5 below 128 in magnitude).
__device__ __forceinline__ float noise_term(float rg, uint32_t byte) {
  return __fmul_rn(rg, __fmul_rn(__fsub_rn((float)byte, 127.5f), 0.0078125f));
}

// eqn 1 and eqn 2 for one node of one chain, in pbit::decision's order:
// acc from +0.0 over the slots in ascending d, I = acc + h, act =
// tanh((beta*gain) * (I + off)), (act + rg*u) + co >= 0.  bg = beta*gain,
// ru = rg*u (noise_term).  sp: the tile's spins.
__device__ __forceinline__ float flip(const float* sp, const NodeRegs& t,
                                      float bg, float ru) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < kResidentD; ++d)
    acc = __fadd_rn(acc, __fmul_rn(t.w[d], sp[t.idx[d]]));
  const float act =
      tanhf(__fmul_rn(bg, __fadd_rn(__fadd_rn(acc, t.h), t.off)));
  return __fadd_rn(__fadd_rn(act, ru), t.co) >= 0.0f ? 1.0f : -1.0f;
}

// The state one thread carries through the launch: its chain and rank, the
// tables of the two nodes it owns (one per colour), the current sweep's
// beta*gain for each, the next sweep's beta (prefetched a sweep ahead), the
// noise term of the next half-sweep's node (drawn during this one, beside the
// flip).
//
// LFSR registers: the chain's C registers live in shared memory,
// double-buffered: lf[(j & 1)][...] holds them as half-sweep j reads them;
// during half-sweep j the lanes r < C write lf[(j+1) & 1] from lf[j & 1],
// which no lane reads until the barrier that ends j.
template <bool Lfsr>
struct ResidentThread {
  const Params& p;
  float* sp;           // the tile's spins
  int row;             // flat index of this chain's first spin
  const int* list[2];  // the colours' ascending node lists
  int n[2];            // their lengths
  uint32_t* lf;        // shared registers, [2][tb][C]
  const uint32_t* jump8;
  int lb, r, P, b, tbC;
  bool live;           // a real chain (not past B in the ragged tile)
  bool over;           // a colour has more nodes than the chain has lanes
  bool reclamp;        // a clamped node lies in a colour mask
  uint32_t seed, ctr0;
  NodeRegs t[2];
  float bg[2], ru[2], beta, beta_nx;

  __device__ __forceinline__ uint32_t* regs(int j) const {
    return lf + (j & 1) * tbC + lb * p.C;
  }

  __device__ __forceinline__ void next_beta(int s) {
    beta = beta_nx;
    bg[0] = __fmul_rn(beta, t[0].gain);
    bg[1] = __fmul_rn(beta, t[1].gain);
    if (live && s + 1 < p.S) beta_nx = p.betas[(size_t)(s + 1) * p.B + b];
  }

  // Before launch-relative half-sweep j (colour Cc): counter noise draws the
  // owned node's noise term; LFSR noise steps the chain's registers into the
  // buffer half-sweep j reads.
  template <int Cc>
  __device__ __forceinline__ void draw(int j) {
    if (!Lfsr) {
      const uint32_t key = pbit::counter_half_key(seed, ctr0 + (uint32_t)j);
      ru[Cc] = noise_term(t[Cc].rg, pbit::mix32(key ^ t[Cc].key) & 0xFFu);
    } else if (live) {
      const uint32_t* cur = regs(j - 1);
      uint32_t* nxt = regs(j);
#pragma unroll 1
      for (int k = r; k < p.C; k += P)
        nxt[k] = lfsr_advance(cur[k], p.decimation, jump8);
    }
  }

  // launch-relative half-sweep j of colour Cc
  template <int Cc>
  __device__ __forceinline__ void half(int j) {
    const int s = (p.half_offset + j) >> 1;
    if (Cc == 0) {
      next_beta(s);
      // clamps are re-imposed at a sweep's start: only clamped nodes that a
      // colour updates can have moved (the rest were imposed at launch start)
      if (reclamp && j > 0) {
        if (live)
#pragma unroll 1
          for (int i = r; i < p.N; i += P)
            if (p.clamp_mask[i])
              sp[row + i] =
                  (float)pbit::sign_spin(p.clamp_values[(size_t)b * p.N + i]);
        chain_barrier(lb, P);
      }
    }
    // the next half-sweep's noise first: it waits for no other lane, and its
    // instructions fill the issue slots the flip's dependent chain leaves
    // idle (shared LFSR registers go to the buffer no lane reads in this
    // half-sweep; counter noise needs no guard at the launch's last one)
    if (!Lfsr || j + 1 < p.n_half) draw<1 - Cc>(j + 1);
    if (live && t[Cc].node >= 0) {
      if (Lfsr)
        ru[Cc] = noise_term(t[Cc].rg,
                            lfsr_key_byte(regs(j)[t[Cc].key >> 6], t[Cc].key));
      sp[t[Cc].node] = flip(sp, t[Cc], bg[Cc], ru[Cc]);
    }
    if (over && live) {  // ranks past the lanes: tables from device memory
      const uint32_t key = pbit::counter_half_key(seed, ctr0 + (uint32_t)j);
#pragma unroll 1
      for (int k = r + P; k < n[Cc]; k += P) {
        const NodeRegs nd = load_node(p, list[Cc][k], b, row);
        const uint32_t byte = Lfsr ? lfsr_key_byte(regs(j)[nd.key >> 6], nd.key)
                                   : pbit::mix32(key ^ nd.key) & 0xFFu;
        sp[nd.node] = flip(sp, nd, __fmul_rn(beta, nd.gain),
                           noise_term(nd.rg, byte));
      }
    }
    chain_barrier(lb, P);
  }
};

// After launch-relative half-sweep j, a sweep's second half: the block's
// moments and histogram partials, weighted by measured[s] (all chains of the
// block at once, behind block-wide barriers).
__device__ __forceinline__ void resident_stats(const Params& p, const float* sp,
                                               int nb, int j, int blk, int tid,
                                               int nt) {
  const float wgt = p.measured[(p.half_offset + j) >> 1];
  if (wgt == 0.0f) return;
  const int N = p.N, D = kResidentD, NB = p.part_h ? (1 << p.n_visible) : 0;
  __syncthreads();
  if (p.part_s)
    pbit::accumulate_slot_moments(sp, nb, N, D, p.nbr_idx, wgt,
                                  p.part_s + (size_t)blk * N,
                                  p.part_c + (size_t)blk * D * N, tid, nt);
  if (p.part_h && tid == 0)
    pbit::hist_accumulate(sp, nb, N, p.visible_idx, p.n_visible, wgt,
                          p.part_h + (size_t)blk * NB);
  __syncthreads();  // the next half-sweep overwrites what was read
}

// The resident body (see the head of this file).  Launch geometry: tb <=
// kMaxChains chains a block, P = blockDim.x / tb threads a chain (a multiple
// of 32), at most kResidentThreads threads, D = kResidentD; shared memory as
// smem_bytes(kResident, ...).  Lfsr: the noise kind (K4 takes counter noise).
template <bool Stream, bool Lfsr>
__global__ void __launch_bounds__(kResidentThreads, 1)
    sweep_sparse_kernel_resident(
    const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = p.N, B = p.B, C = p.C, tb = p.tb;
  float* sp = reinterpret_cast<float*>(smem);  // [tb][N] spins
  int* list0 = reinterpret_cast<int*>(sp + (size_t)tb * N);  // [N]
  int* list1 = list0 + N;                                     // [N]
  int* scratch = list1 + N;                                   // [33]
  uint32_t* jump8 = reinterpret_cast<uint32_t*>(scratch + 33);  // lfsr: [256]
  uint32_t* lf = jump8 + 256;                             // lfsr: [2][tb][C]

  const int tid = threadIdx.x, nt = blockDim.x, blk = blockIdx.x;
  const int P = nt / tb;
  const int b0 = blk * tb;
  const int nb = min(tb, B - b0);
  const bool has_clamp = p.clamp_mask != nullptr && p.clamp_values != nullptr;
  const int NB = p.part_h ? (1 << p.n_visible) : 0;
  const int D = kResidentD;
  const int j_last = p.n_half - 1;

  for (int k = tid; k < nb * N; k += nt)
    sp[k] = (float)pbit::spin_of(p.m_in[(size_t)b0 * N + k]);
  if (Lfsr) {
    // the launch's registers in the buffer of half-sweep -1
    for (int k = tid; k < nb * C; k += nt)
      lf[tb * C + k] = p.noise_in[(size_t)b0 * C + k];
    for (int k = tid; k < 256; k += nt) {
      uint32_t st = (uint32_t)k;
      for (int t = 0; t < 8; ++t) st = lfsr_step1(st);
      jump8[k] = st;
    }
  }
  if (p.part_s)
    for (int i = tid; i < N; i += nt) p.part_s[(size_t)blk * N + i] = 0.0f;
  if (p.part_c)
    for (int k = tid; k < D * N; k += nt) p.part_c[(size_t)blk * D * N + k] = 0.0f;
  if (p.part_h)
    for (int k = tid; k < NB; k += nt) p.part_h[(size_t)blk * NB + k] = 0.0f;
  if (Stream) {  // before the first barrier: overlaps the other blocks' sweeps
    pbit::copy_slice(p.next_w, p.staged_w, (size_t)D * N, blk, gridDim.x, tid, nt);
    pbit::copy_slice(p.next_h, p.staged_h, (size_t)N, blk, gridDim.x, tid, nt);
  }
  // clamps are imposed at every launch's first half-sweep; a clamped node
  // that no colour updates keeps its value for the whole launch
  bool reclamp = false;
  if (has_clamp) {
    pbit::impose_clamps(sp, nb, N, p.clamp_mask, p.clamp_values + (size_t)b0 * N,
                        tid, nt);
    int any = 0;
    for (int i = tid; i < N; i += nt)
      any |= p.clamp_mask[i] && (p.mask0[i] || p.mask1[i]);
    reclamp = __syncthreads_or(any);
  }
  const int n0 = pbit::compact_mask(p.mask0, N, list0, scratch, tid, nt);
  const int n1 = pbit::compact_mask(p.mask1, N, list1, scratch, tid, nt);

  const int lb = tid / P;
  ResidentThread<Lfsr> th{p};
  th.lb = lb;
  th.r = tid - lb * P;
  th.P = P;
  th.b = b0 + lb;
  th.tbC = tb * C;
  th.live = lb < nb;
  th.sp = sp;
  th.row = (th.live ? lb : 0) * N;
  th.list[0] = list0;
  th.list[1] = list1;
  th.n[0] = n0;
  th.n[1] = n1;
  th.lf = lf;
  th.jump8 = jump8;
  th.over = max(n0, n1) > P;
  th.reclamp = reclamp;
  th.seed = Lfsr ? 0u : p.noise_in[0];
  th.ctr0 = Lfsr ? 0u : p.noise_in[1];
  th.t[0] = load_node(p, th.live && th.r < n0 ? list0[th.r] : -1, th.b, th.row);
  th.t[1] = load_node(p, th.live && th.r < n1 ? list1[th.r] : -1, th.b, th.row);
  th.ru[0] = th.ru[1] = 0.0f;
  // the first sweep's beta; a window that opens on an odd half-sweep takes
  // its sweep's beta*gain now and prefetches the next sweep's
  const int s0 = p.half_offset >> 1;
  th.beta = th.beta_nx = 0.0f;
  th.bg[0] = th.bg[1] = 0.0f;
  if (th.live) th.beta_nx = p.betas[(size_t)s0 * B + th.b];
  if (p.half_offset & 1) {
    th.next_beta(s0);
    th.template draw<1>(0);
  } else {
    th.template draw<0>(0);
  }
  __syncthreads();

  const bool take_stats = p.measured != nullptr;
  int j = 0;
  if (p.half_offset & 1) {
    th.template half<1>(j);
    if (take_stats) resident_stats(p, sp, nb, j, blk, tid, nt);
    ++j;
  }
  for (; j + 1 < p.n_half; j += 2) {
    th.template half<0>(j);
    th.template half<1>(j + 1);
    if (take_stats) resident_stats(p, sp, nb, j + 1, blk, tid, nt);
  }
  if (j < p.n_half) th.template half<0>(j);
  __syncthreads();

  for (int k = tid; k < nb * N; k += nt)
    p.m_out[(size_t)b0 * N + k] = sp[k];
  if (Lfsr) {
    const uint32_t* last = lf + (j_last & 1) * tb * C;
    for (int k = tid; k < nb * C; k += nt) p.noise_out[(size_t)b0 * C + k] = last[k];
  } else if (blk == 0 && tid == 0) {
    p.noise_out[0] = th.seed;
    p.noise_out[1] = th.ctr0 + (uint32_t)p.n_half;
  }
}

__global__ void tanh_probe_kernel(const float* x, float* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = tanhf(x[i]);
}

constexpr int kResident = 1;  // the bodies (sparse_plan): 0 strided, 1 resident

// Shared-memory bytes of one block.  Strided body: the tile's int8 spins and,
// in LFSR mode, its registers.  Resident body: the tile's float spins, the two
// colour lists, the compaction scratch and, in LFSR mode, the eight-step
// table and two buffers of the tile's registers.
size_t smem_bytes(int body, int tb, int N, int C, int noise_mode) {
  const bool lfsr = noise_mode == kNoiseLfsr;
  if (body == kResident)
    return 4 * ((size_t)tb * N + 2 * (size_t)N + 33) +
           (lfsr ? 4 * (256 + 2 * (size_t)tb * C) : 0);
  size_t bytes = pbit::tile_spin_bytes(tb, N);
  if (lfsr) bytes += (size_t)tb * (size_t)C * sizeof(uint32_t);
  return bytes;
}

// One launch of an instantiation, with the shared memory the tile needs (opted
// in above 48 KB).
cudaError_t launch(void (*kernel)(const Params), const Params& p, int body,
                   int n_blocks, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(body, p.tb, p.N, p.C, p.noise_mode);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<n_blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernel of a body: the resident body takes D = kResidentD and at most
// kMaxChains chains a block (the wrapper's plan keeps to both).
template <bool Stream>
cudaError_t launch_body(Params& p, int body, int threads,
                        cudaStream_t stream) {
  const int n_blocks = (p.B + p.tb - 1) / p.tb;
  if (body == kResident) {
    if (p.D != kResidentD || p.tb > kMaxChains || threads > kResidentThreads ||
        threads % (32 * p.tb) != 0)
      return cudaErrorInvalidValue;
    return launch(p.noise_mode == kNoiseLfsr
                      ? sweep_sparse_kernel_resident<Stream, true>
                      : sweep_sparse_kernel_resident<Stream, false>,
                  p, body, n_blocks, threads, stream);
  }
  return launch(p.D == 6 ? sweep_sparse_kernel<6, Stream>
                         : sweep_sparse_kernel<0, Stream>,
                p, body, n_blocks, threads, stream);
}

}  // namespace

extern "C" {

// Shared-memory bytes one block of `body` needs (the wrapper's plan computes
// the same and checks it against the card's opt-in limit).
int sweep_sparse_smem_bytes(int body, int tb, int N, int C, int noise_mode) {
  return (int)smem_bytes(body, tb, N, C, noise_mode);
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
    int body, int tb, int threads, void* stream_ptr) {
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
  cudaError_t err = launch_body<false>(p, body, threads, stream);
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
    float* staged_h, int body, int tb, int threads, void* stream_ptr) {
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

  return (int)launch_body<true>(p, body, threads,
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
