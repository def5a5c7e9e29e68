// SoA Chimera-lattice vertical half-step for NVIDIA Hopper (sm_90a): K6.
//
// Replaces the TPU kernel
// src/repro/kernels/lattice_update.py::lattice_vertical_update_pallas.  On
// (B, R, C, k) float32 planes, for every vertical node (b, r, c, i):
//   I = h[r, c, i] + wv_dnin[r, c, i] * m_v_up[b, r, c, i]
//       + wv_up[r, c, i] * m_v_dn[b, r, c, i]
//       + sum_j W_vh[r, c, i, j] * m_h[b, r, c, j]         (ascending j)
//   m_v' = sgn(tanh(gain * I) + u)  where parity[r, c] == color, else m_v,
// added left to right as the TPU kernel adds them (and as
// kernels/ref.py::lattice_vertical_update_ref does), one
// __fadd_rn(__fmul_rn) per term so nothing is contracted into an FMA
// differently from the plain version (and -fmad=false; tanhf is libdevice's).
//
// What bounds it on this card: bytes.  Per node it reads five plane values
// (m_v, m_v_up, m_v_dn, u and its share of m_h) and writes one, for some
// 2k + 6 flops: at B=256, R=C=64, k=4 that is six planes of 16.8 MB, about
// 101 MB per call, 30 us at 3.35 TB/s.  The design streams each plane once:
// one thread per (b, r, c, i), neighbouring threads on neighbouring
// addresses (coalesced), the cell's k horizontal spins shared by its k threads
// through L1, the (R, C, ...) coupler planes — 1/B of the traffic — re-read
// per chain from L2.  The grid covers the nodes exactly and masks the ragged
// edge itself: no R % block_r precondition (the TPU kernel asserted one).
//
// Plain C interface (loaded with ctypes): launches on the given stream,
// allocates nothing, does not synchronise, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "pbit_common.cuh"

namespace {

constexpr int kThreads = 256;

struct LatticeParams {
  const float* m_v;       // (B, R, C, k)
  const float* m_h;       // (B, R, C, k)
  const float* m_v_up;    // (B, R, C, k) spin of (r-1, c)
  const float* m_v_dn;    // (B, R, C, k) spin of (r+1, c)
  const float* W_vh;      // (R, C, k, k)
  const float* wv_up;     // (R, C, k)
  const float* wv_dnin;   // (R, C, k)
  const float* h;         // (R, C, k)
  const float* gain;      // (R, C, k)
  const float* u;         // (B, R, C, k)
  const int* parity;      // (R, C)
  float* out;             // (B, R, C, k)
  size_t total;           // B * R * C * k
  int cells;              // R * C
  int k;
  int color;
};

__global__ void __launch_bounds__(kThreads)
    lattice_vertical_update_kernel(const LatticeParams p) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= p.total) return;
  const int k = p.k;
  const size_t node = idx % ((size_t)p.cells * k);  // (r, c, i)
  const int cell = (int)(node / k);                  // (r, c)
  if (p.parity[cell] != p.color) {
    p.out[idx] = p.m_v[idx];
    return;
  }
  const float* w = p.W_vh + node * k;
  const float* mh = p.m_h + (idx - (idx % k));       // the cell's k spins
  // the reference kernel's order: the vertical terms onto h, then W_vh's
  float I = __fadd_rn(p.h[node], __fmul_rn(p.wv_dnin[node], p.m_v_up[idx]));
  I = __fadd_rn(I, __fmul_rn(p.wv_up[node], p.m_v_dn[idx]));
#pragma unroll 4
  for (int j = 0; j < k; ++j) I = __fadd_rn(I, __fmul_rn(w[j], mh[j]));
  const float act = tanhf(__fmul_rn(p.gain[node], I));
  p.out[idx] = (float)pbit::sign_spin(__fadd_rn(act, p.u[idx]));
}

}  // namespace

extern "C" {

int lattice_vertical_update_launch(
    const float* m_v, const float* m_h, const float* m_v_up,
    const float* m_v_dn, const float* W_vh, const float* wv_up,
    const float* wv_dnin, const float* h, const float* gain, const float* u,
    const int* parity, float* out, int B, int R, int C, int k, int color,
    void* stream_ptr) {
  LatticeParams p;
  p.m_v = m_v; p.m_h = m_h; p.m_v_up = m_v_up; p.m_v_dn = m_v_dn;
  p.W_vh = W_vh; p.wv_up = wv_up; p.wv_dnin = wv_dnin; p.h = h;
  p.gain = gain; p.u = u; p.parity = parity; p.out = out;
  p.cells = R * C;
  p.k = k;
  p.color = color;
  p.total = (size_t)B * (size_t)p.cells * (size_t)k;
  const unsigned grid = (unsigned)((p.total + kThreads - 1) / kThreads);
  lattice_vertical_update_kernel<<<grid, kThreads, 0,
                                   reinterpret_cast<cudaStream_t>(stream_ptr)>>>(p);
  return (int)cudaGetLastError();
}

const char* lattice_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
