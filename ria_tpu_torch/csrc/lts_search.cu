// The light preamble's LTS search (``ria_tpu_torch/wave/ofdm.py::
// LTSDetector``, wrapper ``ria_tpu_torch/sync/lts_kernel.py``) in four kernels
// around the correlation's cuFFT transform pair, which stays in ``torch.fft``.
// For windows x [B, n] float32 (rows ``ld`` apart), the LTS of L samples,
// lags = n - L and nfft the correlation's FFT length:
//
//   lts_pad     the zero tail [n, nfft) of the complex64 FFT input [B, nfft]
//               (what does not depend on the window: it opens the search);
//   lts_front   a block a row, reading each sample once: (x, 0) into the FFT
//               input's first n slots, the squares' float64 prefix sums, each
//               rounded to float32 (P), the sliding energies
//               e[j] = P[j + L - 1] - P[j - 1] (P[-1] = 0) for j < lags,
//               e [B, lde] float32, and each row's amax of them, emax [B];
//   lts_pick    a block a row, after the FFT pair and the product with the
//               template's spectrum, on cuFFT's unscaled inverse xc [B, nfft]:
//               the normalised correlation
//               corr = |xc / nfft| / sqrt(max(max(e, 1e-6 emax) ref, 1e-12))
//               over the lags, its first lag above the threshold and its
//               argmax in one sweep, then the decision: the local peak, the
//               92% walk-back twice, the first significant tap and its lobe,
//               the CFO from the two repeats and the repeats' count;
//   lts_decide  the detection and the int32 start (what closes the search).
//
// They replace no TPU kernel: the JAX package leaves the search to XLA, which
// fuses it.  PyTorch on the card ran it as some 95 kernels a call around the
// FFT pair: at 1,024 windows of 48,000 samples (nfft 65,536) its passes over
// [1,024, 48,000-65,536] buffers (the square, the complex cast and pad, the
// product, the inverse's scale, the float64 scan and its casts, the
// normalisation's seven elementwise passes) moved ~9.9 GB, 3.8 ms of an
// NVIDIA H100's time.
//
// Bound: memory.  lts_pad writes B (nfft - n) 8 bytes; lts_front reads B n 4
// bytes and writes B n 8 + B lags 4 (197 + 393 + 192 MB at the cell: 233 us at
// 3.35 TB/s); lts_pick reads B lags 12 bytes (576 MB, 172 us).  lts_front's
// prefix sum carries a serial chain of float64 additions through every chunk
// of its row (``aten_order.cuh``), so a row's block also waits on latency.
//
// Design:
// - the outputs equal the plain search's (``LTSDetector.search_plain``) on
//   the card bit for bit, so the search decides as it did: every value is
//   formed by the operations ATen uses, in ATen's order:
//   * the squares as ``torch.square`` rounds them (x * x), the prefix sums
//     (``utils/device.wide_cumsum``: float64, each prefix rounded to float32)
//     in the order of ATen's innermost-dimension scan (``Scan`` of
//     ``aten_order.cuh``, shared with ``sc_search.cu`` and ``chirp_fine.cu``;
//     the wrapper computes its chunk from the number of rows and the row's
//     length as ATen does);
//   * the inverse FFT's 1 / nfft as ATen applies it after cuFFT's unscaled
//     inverse: a complex64 product with (1 / nfft, 0), each part's first
//     product fused into an FMA as nvcc contracts ATen's multiply (``cmul``);
//     a power of two, so the value is exact and only zeros' signs depend on
//     the form; |z| is hypotf and arg z atan2f, as ATen's;
//   * separate multiplies, subtractions, IEEE divisions and square roots
//     everywhere else (no fast-math, no other contraction); NaN-propagating
//     max, clamp and argmax (the first index on ties), as ATen's;
// - lts_front keeps a row's squares, then their prefixes, in shared memory
//   (188 KB and 13 KB of the scan's chains at n = 48,000: one block an SM), so
//   each sample is read from memory once; a window too long for shared memory
//   keeps them in a global scratch instead.  Its loads are 16-byte vectors, four
//   a thread in flight, where a row starts on a 16-byte boundary (else scalars);
// - lts_pick holds nothing of the row: the sweep reads each lag's xc and e
//   once, in 16-byte vectors, and keeps only each thread's first lag above the
//   threshold and its argmax, so a few kilobytes of shared memory let several
//   blocks share an SM and one row's decision overlap another row's sweep.
//   The decision re-forms the few hundred values it reads (the local peak's
//   ``sym`` lags, the walk-back's, the tap's and its lobe's, the repeats') by
//   the same arithmetic, so they equal the sweep's;
// - every kernel launches on the caller's stream; the wrapper allocates every
//   buffer.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "aten_order.cuh"

namespace {

constexpr int kFrontThreads = 512;   // threads a block of lts_front
constexpr int kPickThreads = 512;    // threads a block of lts_pick
constexpr int kUnroll = 4;           // 16-byte loads a thread of lts_front keeps in flight
constexpr unsigned kFull = 0xffffffffu;

// The constants of a detector, float32 as ATen rounds the Python scalars
// (``wave/ofdm.py::lts_consts``, from the scalars the plain search reads).
enum Const {
  kFloorRatio,     // the -60 dB energy floor, against the row's largest
  kRefEnergy,      // LTS template energy / 2
  kEMin,           // the least energy times the template's
  kPrevRatio,      // the 92% rule
  kTapRatio,       // the first significant tap's least share of the peak
  kRepeatRatio,    // a repeat's least share of the peak (the CFO's gate, the burst marker)
  kThreshold,      // the detection threshold
  kFs,             // sample rate
  kInvTwoPiSym,    // _rdiv's reciprocal of 2 pi sym
  kScale,          // 1 / nfft, the inverse FFT's scale
  kNumConsts
};

// ---------------------------------------------------------------------------
// ATen's complex arithmetic (the rest of its elementwise arithmetic and its
// scan order are ``aten_order.cuh``'s).  ``sc_search.cu`` holds the
// same three helpers and ``ofdm_demap.cu`` the same ``cmul`` and ``cabs``: a
// change to one copy is a change to every copy, until they move into
// ``aten_order.cuh`` together.

// c10::complex<float>'s product a * b, (ar br - ai bi) + (ar bi + ai br) i,
// as nvcc compiles it in ATen's multiply: each part's first product fused.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// |z| as ATen's abs of a complex64 takes it (thrust::abs, which is hypotf).
__device__ __forceinline__ float cabs(float2 z) { return hypotf(z.x, z.y); }

__device__ __forceinline__ float carg(float2 z) { return atan2f(z.y, z.x); }

// ---------------------------------------------------------------------------
// Reductions over a block of T threads (every thread gets the result) and a
// warp

template <int T>
__device__ float block_amax(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = amax_step(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < T / 32; ++w) r = amax_step(r, red[w]);
  __syncthreads();
  return r;
}

template <int T>
__device__ int block_min(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = red[0];
  for (int w = 1; w < T / 32; ++w) r = min(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    if (ahead(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

template <int T>
__device__ void block_argmax(float& v, int& i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  v = redv[0];
  i = redi[0];
  for (int w = 1; w < T / 32; ++w)
    if (ahead(redv[w], redi[w], v, i)) { v = redv[w]; i = redi[w]; }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// lts_pad, lts_front

__global__ void lts_pad_kernel(float2* __restrict__ buf, int B, int n, int nfft) {
  const int step = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  // Two slots a 16-byte store from the first even slot at or after n.
  const int pairs = nfft / 2, p0 = (n + 1) / 2;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    float2* row = buf + static_cast<size_t>(b) * nfft;
    if ((n & 1) && first == 0) row[n] = make_float2(0.f, 0.f);
    float4* row4 = reinterpret_cast<float4*>(row);
    for (int k = p0 + first; k < pairs; k += step) row4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

struct FrontShape {
  int n, ld, L, lags, lde, nfft, log_x, row_bytes;
  bool vec;   // rows on 16-byte boundaries
};

// A row's squares (then prefixes) and the scan's chains: where they start.
inline __host__ __device__ int front_off_chain(int n) { return (n * 4 + 15) & ~15; }

__global__ void __launch_bounds__(kFrontThreads, 1)
lts_front_kernel(const float* __restrict__ x, float2* __restrict__ buf, float* __restrict__ e,
                 float* __restrict__ emax, char* __restrict__ scratch, FrontShape sh) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float red[kFrontThreads / 32];
  __shared__ Scan job[1];
  const int b = blockIdx.x;
  char* base = scratch ? scratch + static_cast<size_t>(b) * sh.row_bytes : smem;
  float* sq = reinterpret_cast<float*>(base);
  double* chain = reinterpret_cast<double*>(base + front_off_chain(sh.n));
  const float* row = x + static_cast<size_t>(b) * sh.ld;
  float2* out = buf + static_cast<size_t>(b) * sh.nfft;

  // (x, 0) into the FFT input, x * x into sq.
  int done = 0;
  if (sh.vec) {
    const int n4 = sh.n / 4;
    const float4* row4 = reinterpret_cast<const float4*>(row);
    float4* out4 = reinterpret_cast<float4*>(out);
    float4* sq4 = reinterpret_cast<float4*>(sq);
    for (int k0 = threadIdx.x; k0 < n4; k0 += kUnroll * kFrontThreads) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kFrontThreads;
        if (k < n4) v[u] = __ldg(row4 + k);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kFrontThreads;
        if (k < n4) {
          out4[2 * k] = make_float4(v[u].x, 0.f, v[u].y, 0.f);
          out4[2 * k + 1] = make_float4(v[u].z, 0.f, v[u].w, 0.f);
          sq4[k] = make_float4(fmul(v[u].x, v[u].x), fmul(v[u].y, v[u].y),
                               fmul(v[u].z, v[u].z), fmul(v[u].w, v[u].w));
        }
      }
    }
    done = 4 * n4;
  }
  for (int j = done + threadIdx.x; j < sh.n; j += kFrontThreads) {
    const float v = __ldg(row + j);
    out[j] = make_float2(v, 0.f);
    sq[j] = fmul(v, v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double* ch = chain;
    make_scan(job[0], sq, sq, 1, sh.n, sh.log_x, ch, 0);
  }
  __syncthreads();
  scan_jobs<kFrontThreads>(job, 1, 1);

  // The sliding energies over L samples: the prefixes with a 0 in front.
  float* erow = e + static_cast<size_t>(b) * sh.lde;
  float acc = -INFINITY;
  for (int j = threadIdx.x; j < sh.lags; j += kFrontThreads) {
    const float v = fsub(sq[j + sh.L - 1], j ? sq[j - 1] : 0.f);
    erow[j] = v;
    acc = amax_step(acc, v);
  }
  const float m = block_amax<kFrontThreads>(acc, red);
  if (threadIdx.x == 0) emax[b] = m;
}

// ---------------------------------------------------------------------------
// lts_pick, lts_decide

struct PickShape {
  int lags, lde, nfft, sym, echo, lobe;
};

__global__ void __launch_bounds__(kPickThreads)
lts_pick_kernel(const float2* __restrict__ xc, const float* __restrict__ e,
                const float* __restrict__ emax, const float* __restrict__ consts,
                int* __restrict__ pos_out, int* __restrict__ det_out, int* __restrict__ rep_out,
                float* __restrict__ val_out, float* __restrict__ cfo_out, PickShape sh) {
  __shared__ float redv[kPickThreads / 32];
  __shared__ int redi[kPickThreads / 32];
  const int b = blockIdx.x;
  const float2* xr = xc + static_cast<size_t>(b) * sh.nfft;
  const float* er = e + static_cast<size_t>(b) * sh.lde;
  const float floor_e = fmul(consts[kFloorRatio], emax[b]);
  const float ref = consts[kRefEnergy], e_min = consts[kEMin], thr = consts[kThreshold];
  const float2 scale = make_float2(consts[kScale], 0.f);
  const int last = sh.lags - 1;
  auto corr_of = [&](float2 u, float ev) {
    return __fdiv_rn(cabs(cmul(u, scale)),
                     __fsqrt_rn(clamp_min(fmul(nan_max(ev, floor_e), ref), e_min)));
  };
  auto corr_at = [&](int k) { return corr_of(xr[k], er[k]); };

  // The sweep: each thread's first lag above the threshold and its argmax.
  int first = INT_MAX, at = INT_MAX;
  float best = -INFINITY;
  auto visit = [&](float v, int k) {
    if (k < first && v > thr) first = k;
    if (ahead(v, k, best, at)) { best = v; at = k; }
  };
  const int q = sh.lags / 4;
  const float4* x4 = reinterpret_cast<const float4*>(xr);
  const float4* e4 = reinterpret_cast<const float4*>(er);
#pragma unroll 2
  for (int k4 = threadIdx.x; k4 < q; k4 += kPickThreads) {
    const float4 a = __ldg(x4 + 2 * k4), c = __ldg(x4 + 2 * k4 + 1), w = __ldg(e4 + k4);
    const int k = 4 * k4;
    visit(corr_of(make_float2(a.x, a.y), w.x), k);
    visit(corr_of(make_float2(a.z, a.w), w.y), k + 1);
    visit(corr_of(make_float2(c.x, c.y), w.z), k + 2);
    visit(corr_of(make_float2(c.z, c.w), w.w), k + 3);
  }
  for (int k = 4 * q + threadIdx.x; k < sh.lags; k += kPickThreads) visit(corr_at(k), k);
  first = block_min<kPickThreads>(first, redi);
  block_argmax<kPickThreads>(best, at, redv, redi);

  // The peak: the argmax of the sym lags from the first above the threshold,
  // else the row's.
  int pos = at;
  if (first != INT_MAX) {
    const int hi = min(first + sh.sym - 1, last);
    float v = -INFINITY;
    int i = INT_MAX;
    for (int k = first + threadIdx.x; k <= hi; k += kPickThreads) {
      const float c = corr_at(k);
      if (ahead(c, k, v, i)) { v = c; i = k; }
    }
    block_argmax<kPickThreads>(v, i, redv, redi);
    pos = i;
  }
  if (threadIdx.x >= 32) return;

  // The rest on one warp, each lane forming the same values.
  const int lane = threadIdx.x;
  float val = corr_at(pos);
  for (int r = 0; r < 2; ++r) {
    const int prev = max(pos - sh.sym, 0);
    const float pv = corr_at(prev);
    if (pos >= sh.sym && pv >= fmul(val, consts[kPrevRatio])) { pos = prev; val = pv; }
  }
  const bool det = val > thr;
  // The first lag within ``echo`` before the peak that clears the tap's share
  // of it (the earliest lag searched when none does), then its lobe's argmax.
  const float tap = fmul(consts[kTapRatio], val);
  const int lo = max(pos - sh.echo, 0);
  int edge = lo;
  for (int base = lo; base <= pos; base += 32) {
    const int k = base + lane;
    const unsigned m = __ballot_sync(kFull, k <= pos && corr_at(k) >= tap);
    if (m) {
      edge = base + __ffs(m) - 1;
      break;
    }
  }
  const int hi = min(edge + sh.lobe - 1, last);
  float v = -INFINITY;
  int i = INT_MAX;
  for (int k = edge + lane; k <= hi; k += 32) {
    const float c = corr_at(k);
    if (ahead(c, k, v, i)) { v = c; i = k; }
  }
  warp_argmax(v, i);
  if (det) pos = min(i, pos);
  val = corr_at(pos);

  // The CFO from the phase between the two repeats; a third marks a burst.
  const int pos2 = min(pos + sh.sym, last);
  const float2 x1 = cmul(xr[pos], scale), x2 = cmul(xr[pos2], scale);
  const float dphi = carg(cmul(x2, make_float2(x1.x, -x1.y)));
  const float half = fmul(consts[kRepeatRatio], val);
  const float cfo = corr_at(pos2) >= half ? fmul(fmul(dphi, consts[kFs]), consts[kInvTwoPiSym])
                                          : 0.f;
  const float val3 = corr_at(min(pos + 2 * sh.sym, last));
  if (lane == 0) {
    pos_out[b] = pos;
    det_out[b] = det;
    rep_out[b] = val3 >= half ? 3 : 2;
    val_out[b] = val;
    cfo_out[b] = cfo;
  }
}

__global__ void lts_decide_kernel(const int* __restrict__ pos, const int* __restrict__ det,
                                  bool* __restrict__ detected, int* __restrict__ lts_start, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  detected[b] = det[b] != 0;
  lts_start[b] = det[b] ? pos[b] : -1;
}

}  // namespace

// Each entry launches on ``stream`` and returns the launch's cudaError_t (0
// when it was taken).  Pointers are device pointers on the current device;
// the shapes and layouts are the wrapper's (``sync/lts_kernel.py``).

// buf [B, nfft] complex64 on a 16-byte boundary, nfft even: zero from n on.
extern "C" int ria_lts_pad(void* buf, int B, int n, int nfft, void* stream) {
  if (B <= 0 || n >= nfft) return 0;
  const int pairs = nfft / 2 - (n + 1) / 2;
  const dim3 grid(max(1, min((pairs + 1023) / 1024, 64)), min(B, 65535));
  lts_pad_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(buf), B, n, nfft);
  return static_cast<int>(cudaGetLastError());
}

// x [B, n] float32 rows ld apart; buf [B, nfft] complex64 gets (x, 0) in its
// first n slots; e [B, lde] float32 (lde a multiple of 4) the sliding
// energies of the first lags = n - L lags, emax [B] their amax.  A row's
// squares and chains take row_bytes: in shared memory when smem_bytes > 0,
// else in ``scratch``, B row_bytes bytes.
extern "C" int ria_lts_front(const float* x, void* buf, float* e, float* emax, void* scratch,
                             int B, int n, int ld, int L, int lde, int nfft, int log_x,
                             int row_bytes, int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const FrontShape sh{n, ld, L, n - L, lde, nfft, log_x, row_bytes,
                      ld % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  char* sc = smem_bytes > 0 ? nullptr : static_cast<char*>(scratch);
  if (int err = allow_smem(lts_front_kernel, smem_bytes)) return err;
  lts_front_kernel<<<B, kFrontThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<float2*>(buf), e, emax, sc, sh);
  return static_cast<int>(cudaGetLastError());
}

// xc [B, nfft] complex64, the correlation before its 1 / nfft; e [B, lde] and
// emax [B] from lts_front; consts [kNumConsts] float32; ints [3, B] int32
// gets each row's position, detection and repeats, floats [2, B] float32 its
// correlation and CFO.
extern "C" int ria_lts_pick(const void* xc, const float* e, const float* emax,
                            const float* consts, int* ints, float* floats, int B, int lags,
                            int lde, int nfft, int sym, int echo, int lobe, void* stream) {
  if (B <= 0) return 0;
  const PickShape sh{lags, lde, nfft, sym, echo, lobe};
  lts_pick_kernel<<<B, kPickThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(xc), e, emax, consts, ints, ints + B, ints + 2 * B, floats,
      floats + B, sh);
  return static_cast<int>(cudaGetLastError());
}

// ints [3, B] from lts_pick; detected [B] bool, lts_start [B] int32.
extern "C" int ria_lts_decide(const int* ints, void* detected, int* lts_start, int B,
                              void* stream) {
  if (B <= 0) return 0;
  lts_decide_kernel<<<(B + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      ints, ints + B, static_cast<bool*>(detected), lts_start, B);
  return static_cast<int>(cudaGetLastError());
}
