// The window pass of the chirp search's zoom branch in one kernel
// (``ria_tpu_torch/sync/chirp.py::ChirpDetector._zoom``, wrapper
// ``ria_tpu_torch/sync/zoom_kernel.py``), for x [B, n] float32:
//
//   zb[b, k]  = sum_{d < 16} x[b, 16 k + d] * rot[16 k + d]   complex64 [B, nb]
//               for k < nblk = n / 16, and 0 for nblk <= k < nb: the zero
//               padding of the FFT of length nb that follows;
//   blk[b, k] = sum_{d < 16} x[b, 16 k + d]^2                  float32 [B, nblk].
//
// It replaces no TPU kernel.  The JAX package leaves these operations to XLA,
// which fuses them; PyTorch on the card runs them as four passes over the
// window (the mix writes a complex64 copy of it, a box-sum reads that back,
// x * x writes a float32 copy, a second box-sum reads that) and two more for
// the FFT's padding: some 1.7 GB moved at 256 channels of 207,328 samples for
// work that reads 0.21 GB.  This kernel reads each sample once.
//
// Bound: memory.  B n 4 bytes read, B (8 nb + 4 nblk) written, the ramp
// (16 nblk complex64) read once: 260.8 MB at B = 256, n = 207,328, nb =
// 16,384, 77.8 us at 3.35 TB/s.  It does 6 floating-point operations a
// sample, 1.5 a byte read, far under the card's ratio of operations to bytes.
//
// Design:
// - one thread per group of 16 samples (one k), 128 threads a block on
//   neighbouring groups, so a warp's stores fill whole lines;
// - a block walks kRows rows with its groups' 16 ramp values in registers:
//   the 1.66 MB ramp, the same for every row, is read once per kRows rows
//   (from L2), not once a row;
// - a group's samples come in four 16-byte loads where the row starts on a
//   16-byte boundary (the pointer aligned and n % 4 == 0), else in 16 scalar
//   loads; the grid is (nb / 128, B / kRows) blocks, so B = 256 fills the
//   132 SMs several times over and B = 1 still spreads over 128 blocks;
// - the arithmetic is PyTorch's on the card: each product rounded alone
//   (x re, x im, as the complex product of x + 0j with the ramp gives them,
//   and x x), no fused multiply-add, and each group's 16 products added in
//   the order of PyTorch's reduction over an inner axis of 16 (warp shuffles
//   at offsets 8, 4, 2, 1 in ``block_x_reduce`` of ATen's Reduce.cuh, as
//   torch 2.11 builds it), so that product d first meets product d + 8:
//     (((p0 + p8) + (p4 + p12)) + ((p2 + p10) + (p6 + p14)))
//       + (((p1 + p9) + (p5 + p13)) + ((p3 + p11) + (p7 + p15))).
//   The outputs then equal the four PyTorch operations' but for the sign of
//   a zero; a group of zeros gives 0.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kD = 16;         // samples a group (``_ZOOM_DECIM`` of sync/chirp.py)
constexpr int kThreads = 128;  // groups a block
constexpr int kRows = 8;       // rows a block walks

// The sum of 16 products in PyTorch's order (see the note above).
__device__ __forceinline__ float tree16(const float (&p)[kD]) {
  float a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = __fadd_rn(p[i], p[i + 8]);
  float b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __fadd_rn(a[i], a[i + 4]);
  return __fadd_rn(__fadd_rn(b[0], b[2]), __fadd_rn(b[1], b[3]));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
zoom_front_kernel(const float* __restrict__ x, const float4* __restrict__ rot,
                  float2* __restrict__ zb, float* __restrict__ blk, int B, int n, int nblk,
                  int nb) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= nb) return;
  const int b0 = blockIdx.y * kRows;
  const int b1 = min(b0 + kRows, B);
  if (k >= nblk) {  // the FFT's zero padding
    for (int b = b0; b < b1; ++b) zb[static_cast<size_t>(b) * nb + k] = make_float2(0.f, 0.f);
    return;
  }
  // The group's ramp: 16 complex64 values, two to a 16-byte load.
  float re[kD], im[kD];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    const float4 v = __ldg(rot + static_cast<size_t>(k) * (kD / 2) + i);
    re[2 * i] = v.x;
    im[2 * i] = v.y;
    re[2 * i + 1] = v.z;
    im[2 * i + 1] = v.w;
  }
#pragma unroll 2
  for (int b = b0; b < b1; ++b) {
    const float* row = x + static_cast<size_t>(b) * n + static_cast<size_t>(k) * kD;
    float s[kD];
    if (kVec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
      for (int i = 0; i < kD / 4; ++i) {
        const float4 v = __ldg(row4 + i);
        s[4 * i] = v.x;
        s[4 * i + 1] = v.y;
        s[4 * i + 2] = v.z;
        s[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < kD; ++d) s[d] = __ldg(row + d);
    }
    float pr[kD], pi[kD], pe[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      pr[d] = __fmul_rn(s[d], re[d]);
      pi[d] = __fmul_rn(s[d], im[d]);
      pe[d] = __fmul_rn(s[d], s[d]);
    }
    zb[static_cast<size_t>(b) * nb + k] = make_float2(tree16(pr), tree16(pi));
    blk[static_cast<size_t>(b) * nblk + k] = tree16(pe);
  }
}

}  // namespace

// x [B, n] float32 (rows n apart), rot [16 (n / 16)] complex64 on a 16-byte
// boundary, zb [B, nb] complex64 and blk [B, n / 16] float32, all on the
// current device; nb >= n / 16.  Launches on ``stream`` and returns the
// launch's cudaError_t (0 when it was taken).
extern "C" int ria_zoom_front(const float* x, const void* rot, void* zb, float* blk, int B,
                              int n, int nb, void* stream) {
  const int nblk = n / kD;
  if (B <= 0 || nb <= 0) return 0;
  const dim3 grid((nb + kThreads - 1) / kThreads, (B + kRows - 1) / kRows);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float4*>(rot);
  auto* z = static_cast<float2*>(zb);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    zoom_front_kernel<true><<<grid, kThreads, 0, s>>>(x, r, z, blk, B, n, nblk, nb);
  } else {
    zoom_front_kernel<false><<<grid, kThreads, 0, s>>>(x, r, z, blk, B, n, nblk, nb);
  }
  return static_cast<int>(cudaGetLastError());
}
