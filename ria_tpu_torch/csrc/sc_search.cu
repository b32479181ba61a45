// The Schmidl-Cox preamble search (``ria_tpu_torch/wave/ofdm.py::
// SchmidlCoxDetector``, wrapper ``ria_tpu_torch/sync/sc_kernel.py``) in five
// kernels around the search's two cuFFT transform pairs, which stay in
// ``torch.fft``.  For windows x [B, n] float32 (rows ``ld`` apart):
//
//   sc_pad     the zero padding of the two FFT inputs below (what does not
//              depend on the window: it opens the search);
//   sc_coarse  the coarse search, one block a row reading each sample once:
//              the mix by the centre-frequency ramp and box-sum of groups of
//              8 (zb), the lag-N/2 products (zc) and energies (|zb|^2), their
//              sliding sums P, R1 and R2, the metric M = |P| / sqrt(R1 R2)
//              over its -60 dB floor, its argmax, and the coarse CFO at the
//              peak: peak [B] int32, peak_val [B], cfo [B];
//   sc_slice   the LTS slice at the peak, complex64, as the FFT takes it;
//   sc_pick    after the correlation's inverse FFT: the slice's sliding
//              energy, the normalised correlation, the masked argmax, the
//              92% rule and the LTS position, and the segment whose analytic
//              signal gives the fine CFO; lts_pos [B] int32, lts_val [B];
//   sc_decide  the fine CFO wrap-resolved against the coarse one, and the
//              detection: detected [B] bool, lts_start [B] int32, cfo_hz [B].
//
// They replace no TPU kernel: the JAX package leaves the search to XLA, which
// fuses it.  PyTorch on the card ran it as some 90 small kernels and 173 host
// operators a call: with 1,024-2,048 windows a call the search was the
// largest part of the OFDM chains that the program controls, on the device
// (2.5-3.7 ms) and in the host's dispatch (3.3-3.9 ms).
//
// Bound: memory, in principle.  sc_coarse reads B n 4 bytes once (214 MB at
// B = 2,048, n = 26,160: 64 us at 3.35 TB/s; the 209 KB ramp stays in L2);
// sc_slice writes the padded slice (B nfft 8 bytes); sc_pick reads the
// correlation's first R - L lags and the slice (B (8 (R - L) + 4 R) bytes) and
// writes the segment.  In practice sc_coarse and sc_pick are bound by
// latency: ATen's prefix sums carry a running total through every chunk of
// 2T elements (log2(2T) + 1 float64 additions a chunk, in order), so each row
// holds a serial chain of some 360-680 additions a sum, and a block's phases
// (load, scan, chain, metric) follow one another.
//
// Design:
// - the outputs equal the PyTorch operations' on the card bit for bit, so the
//   search decides as it did: every value is formed by the operations ATen
//   uses, in ATen's order:
//   * the box-sum of 8 products in the order of ATen's reduction over an
//     inner axis of 8 (warp shuffles at offsets 4, 2, 1 in
//     ``block_x_reduce``, each term first added to 0):
//     ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7));
//   * a complex product as c10::complex's, with the real part's first product
//     and the imaginary part's first product fused into an FMA, as nvcc
//     contracts ATen's multiply (``cmul``); |z| is hypotf and arg z atan2f,
//     as ATen's;
//   * every prefix sum (``utils/device.wide_cumsum``: float64, each prefix
//     rounded to float32) in the order of ATen's innermost-dimension scan
//     (``tensor_kernel_scan_innermost_dim`` of ATen/native/cuda/ScanUtils.cuh):
//     the row in chunks of 2T, T = 2^log_x threads chosen from the number of
//     rows and the row's length (passed in by the wrapper, which computes it
//     as ATen does), each chunk scanned by Sklansky's network after the
//     running total was added to its first element (``Scan`` of
//     ``aten_order.cuh``, which ``chirp_fine.cu`` shares).
//     That order is ATen's private code (torch 2.11 on the card):
//     tests/test_torch_sc_kernel.py holds the installed header's text of
//     those functions to the text followed here, and the card tests hold the
//     five outputs to the plain search's;
//   * separate multiplies, adds, IEEE divisions and square roots everywhere
//     else (no fast-math, no other contraction), NaN-propagating max, clamp
//     and argmax (first index on ties) as ATen's;
// - sc_coarse keeps a row's zb, zc, |zb|^2 and prefix sums in shared memory
//   (64 KB for the QAM64 cell's rows, 96 KB for the DQPSK cell's: three and
//   two blocks an SM), so each sample is read from memory once; a window too
//   long for shared memory keeps them in a global scratch instead;
// - the prefix sums are parallel but for their chains: Sklansky's value for an
//   element is its carry-free part (the network's partial sums, which do not
//   depend on the running total) plus the chunk's running prefix at the
//   element's top bit, so every chunk's partial sums are formed at once, a
//   warp's lanes each holding E = 8-32 consecutive elements in 16-byte loads
//   (partial sums within a lane, then a shuffle butterfly across the chunk's
//   lanes), and only the chains are serial: one thread a chain, all four of
//   sc_coarse's side by side, a chunk's inputs read before its additions;
// - sc_pick copies the slice and the correlation's lags into shared memory
//   asynchronously (cp.async), the lags while the slice's prefix sum runs;
// - the rows load in 16-byte vectors where a row starts on a 16-byte boundary
//   (else in scalars), two groups of 8 samples a thread in flight.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "aten_order.cuh"

namespace {

constexpr int kDec = 8;          // samples a group: ``_SC_DEC`` of wave/ofdm.py
constexpr int kThreads = 256;    // threads a block of sc_coarse and sc_pick
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJobs = 3;      // prefix sums run at once

// The constants of a detector, float32 as ATen rounds the Python scalars
// (``wave/ofdm.py::sc_consts``, from the scalars the plain search reads).
enum Const {
  kRotHalfRe, kRotHalfIm,   // exp(2j pi frac(fc (N/2) / fs)), complex64
  kFs,                      // sample rate
  kInvPiN,                  // 1 / (pi N)
  kMaxCfo,                  // fs / N
  kFloorRatio,              // the -60 dB energy floor
  kRrMin,                   // the least R1 R2
  kRefEnergy,               // LTS template energy / 2
  kEMin,                    // the least slice energy times the template's
  kPrevRatio,               // the 92% rule
  kRotSymRe, kRotSymIm,     // exp(2j pi frac(fc sym / fs)), complex64
  kSpacing,                 // fs / sym
  kInvTwoPi,                // 1 / (2 pi)
  kInvSpacing,              // 1 / spacing
  kRMin,                    // the least |r| that gives a fine CFO
  kSyncThreshold,           // the SC metric's threshold
  kLtsThreshold,            // the LTS correlation's threshold
  kNumConsts
};

// ---------------------------------------------------------------------------
// ATen's complex arithmetic and block reductions (the rest of its elementwise
// arithmetic and its scan order are ``aten_order.cuh``'s)

// c10::complex<float>'s product a * b, (ar br - ai bi) + (ar bi + ai br) i,
// as nvcc compiles it in ATen's multiply: each part's first product fused.
// ATen multiplies a tensor by a Python scalar as scalar * tensor.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// |z| as ATen's abs of a complex64 takes it (thrust::abs, which is hypotf).
__device__ __forceinline__ float cabs(float2 z) { return hypotf(z.x, z.y); }

__device__ __forceinline__ float carg(float2 z) { return atan2f(z.y, z.x); }

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(fsub(a.x, b.x), fsub(a.y, b.y));
}

// The block's amax of each thread's ``v`` (every thread gets it).
__device__ float block_amax(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = amax_step(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = amax_step(r, red[w]);
  __syncthreads();
  return r;
}

// The block's argmax of each thread's (v, i) (every thread gets it).
__device__ void block_argmax(float& v, int& i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (ahead(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  v = redv[0];
  i = redi[0];
  for (int w = 1; w < kWarps; ++w)
    if (ahead(redv[w], redi[w], v, i)) { v = redv[w]; i = redi[w]; }
  __syncthreads();
}


// ---------------------------------------------------------------------------
// sc_coarse

// The box-sum of 8 products, ATen's order (see the note at the top).
__device__ __forceinline__ float sum8(const float (&p)[kDec]) {
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = fadd(fadd(0.f, p[i]), fadd(0.f, p[i + 4]));
  return fadd(fadd(a[0], a[2]), fadd(a[1], a[3]));
}

__device__ __forceinline__ void load_group(const float* row, const float4* rot, int k, bool vec,
                                           float (&s)[kDec], float4 (&r)[kDec / 2]) {
  if (vec) {
    const float4* row4 = reinterpret_cast<const float4*>(row) + 2 * k;
    const float4 a = __ldg(row4), b = __ldg(row4 + 1);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  } else {
#pragma unroll
    for (int d = 0; d < kDec; ++d) s[d] = __ldg(row + kDec * k + d);
  }
#pragma unroll
  for (int i = 0; i < kDec / 2; ++i) r[i] = __ldg(rot + (kDec / 2) * k + i);
}

__device__ __forceinline__ float2 mix_group(const float (&s)[kDec], const float4 (&r)[kDec / 2]) {
  float pr[kDec], pi[kDec];
#pragma unroll
  for (int i = 0; i < kDec / 2; ++i) {
    pr[2 * i] = fmul(s[2 * i], r[i].x);
    pi[2 * i] = fmul(s[2 * i], r[i].y);
    pr[2 * i + 1] = fmul(s[2 * i + 1], r[i].z);
    pi[2 * i + 1] = fmul(s[2 * i + 1], r[i].w);
  }
  return make_float2(sum8(pr), sum8(pi));
}

struct CoarseShape {
  int B, n, ld, half, cp, log_x1, log_x2;   // half = N/2 / 8, cp = cp_len / 8
  int off_a, off_r2, off_chain, row_bytes;  // a row's arrays, in bytes
  bool vec;                                 // rows on 16-byte boundaries
};

// Three blocks an SM at the cells' batches (chunks of at most 256 elements;
// a batch of few windows takes wider chunks, and lanes of 16 or 32 elements).
__global__ void __launch_bounds__(kThreads, 3)
sc_coarse_kernel(const float* __restrict__ x, const float4* __restrict__ rot,
                 const float* __restrict__ consts, int* __restrict__ peak,
                 float* __restrict__ peak_val, float* __restrict__ cfo_out,
                 char* __restrict__ scratch, CoarseShape sh) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float redv[kWarps];
  __shared__ int redi[kWarps];
  __shared__ Scan jobs[kMaxJobs];
  const int b = blockIdx.x;
  char* base = scratch ? scratch + static_cast<size_t>(b) * sh.row_bytes : smem;
  float2* z = reinterpret_cast<float2*>(base);                  // zb, then zc, then P's prefix
  float* a = reinterpret_cast<float*>(base + sh.off_a);         // |zb|^2, then R1's prefix
  float* r2 = reinterpret_cast<float*>(base + sh.off_r2);       // R2's prefix
  double* chain = reinterpret_cast<double*>(base + sh.off_chain);
  const float* row = x + static_cast<size_t>(b) * sh.ld;
  const int n1 = sh.n / kDec, h = sh.half, n2 = n1 - h;

  // The mix and box-sum (zb) and |zb|^2, two groups a thread in flight.
  for (int k0 = threadIdx.x; k0 < n1; k0 += 2 * kThreads) {
    const int k1 = k0 + kThreads;
    float s0[kDec], s1[kDec];
    float4 r0[kDec / 2], r1[kDec / 2];
    load_group(row, rot, k0, sh.vec, s0, r0);
    if (k1 < n1) load_group(row, rot, k1, sh.vec, s1, r1);
    const float2 z0 = mix_group(s0, r0);
    z[k0] = z0;
    const float m0 = cabs(z0);
    a[k0] = fmul(m0, m0);
    if (k1 < n1) {
      const float2 z1 = mix_group(s1, r1);
      z[k1] = z1;
      const float m1 = cabs(z1);
      a[k1] = fmul(m1, m1);
    }
  }
  __syncthreads();
  // zc[k] = conj(zb[k]) zb[k + h], in place: a tile's reads before its writes.
  for (int t0 = 0; t0 < n2; t0 += 4 * kThreads) {
    float2 c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = t0 + i * kThreads + threadIdx.x;
      if (k < n2) {
        const float2 p = z[k];
        c[i] = cmul(make_float2(p.x, -p.y), z[k + h]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = t0 + i * kThreads + threadIdx.x;
      if (k < n2) z[k] = c[i];
    }
  }
  __syncthreads();
  // P's prefix (real and imaginary parts) in place, R2's (|zb|^2 from h)
  // into r2, and R1's in place over |zb|^2 once R2's are written.
  if (threadIdx.x == 0) {
    double* ch = chain;
    int lane = make_scan(jobs[0], reinterpret_cast<float*>(z), reinterpret_cast<float*>(z), 2,
                         n2, sh.log_x2, ch, 0);
    lane = make_scan(jobs[1], a + h, r2, 1, n2, sh.log_x2, ch, lane);
    make_scan(jobs[2], a, a, 1, n1, sh.log_x1, ch, lane);
  }
  __syncthreads();
  scan_jobs<kThreads>(jobs, 3, 2);

  // Sliding sums over h groups: the prefixes with a 0 in front.
  const int m = n1 - 2 * h + 1;  // lags of P, R1 and R2 alike
  auto rr_at = [&](int k) {
    const float r1v = fsub(a[k + h - 1], k ? a[k - 1] : 0.f);
    const float r2v = fsub(r2[k + h - 1], k ? r2[k - 1] : 0.f);
    return fmul(r1v, r2v);
  };
  auto p_at = [&](int k) {
    return csub(z[k + h - 1], k ? z[k - 1] : make_float2(0.f, 0.f));
  };
  float acc = -INFINITY;
  for (int k = threadIdx.x; k < m; k += kThreads) acc = amax_step(acc, rr_at(k));
  const float floor_rr = fmul(consts[kFloorRatio], block_amax(acc, redv));
  const float rr_min = consts[kRrMin];
  float best = 0.f;
  int at = 0x7fffffff;
  bool have = false;
#pragma unroll 4
  for (int k = sh.cp + threadIdx.x; k < m; k += kThreads) {
    const float mk = __fdiv_rn(cabs(p_at(k)),
                               __fsqrt_rn(clamp_min(nan_max(rr_at(k), floor_rr), rr_min)));
    if (!have || ahead(mk, k, best, at)) { best = mk; at = k; have = true; }
  }
  if (!have) { best = -INFINITY; at = 0x7fffffff; }
  block_argmax(best, at, redv, redi);
  if (threadIdx.x == 0) {
    const float2 pp = cmul(make_float2(consts[kRotHalfRe], consts[kRotHalfIm]), p_at(at));
    const float c = fmul(fmul(carg(pp), consts[kFs]), consts[kInvPiN]);
    const float mx = consts[kMaxCfo];
    peak[b] = (at - sh.cp) * kDec;
    peak_val[b] = best;
    cfo_out[b] = clamp(c, -mx, mx);
  }
}

// ---------------------------------------------------------------------------
// sc_slice, sc_pad, sc_pick, sc_decide

// The LTS slice's start, as the plain search clamps it.
__device__ __forceinline__ int slice_start(int peak, int n, int R) {
  return min(max(peak, 0), max(n - R, 0));
}

__global__ void sc_pad_kernel(float2* __restrict__ slc, float* __restrict__ seg, int R,
                              int nfft, int seg_len, int seg_nfft) {
  float2* a = slc + static_cast<size_t>(blockIdx.y) * nfft;
  float* c = seg + static_cast<size_t>(blockIdx.y) * seg_nfft;
  const int step = gridDim.x * blockDim.x;
  for (int j = R + blockIdx.x * blockDim.x + threadIdx.x; j < nfft; j += step)
    a[j] = make_float2(0.f, 0.f);
  for (int j = seg_len + blockIdx.x * blockDim.x + threadIdx.x; j < seg_nfft; j += step)
    c[j] = 0.f;
}

__global__ void sc_slice_kernel(const float* __restrict__ x, const int* __restrict__ peak,
                                float2* __restrict__ slc, int n, int ld, int R, int nfft) {
  const int b = blockIdx.y;
  const float* row = x + static_cast<size_t>(b) * ld + slice_start(peak[b], n, R);
  float2* out = slc + static_cast<size_t>(b) * nfft;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < R; j += gridDim.x * blockDim.x)
    out[j] = make_float2(row[j], 0.f);
}

// sc_pick's shared memory: the slice's R floats, the correlation's R - L
// lags (complex64), then the scan's chains.
inline __host__ __device__ int pick_off_xc(int R) { return (R * 4 + 15) & ~15; }
inline __host__ __device__ int pick_off_chain(int R, int lags) {
  return pick_off_xc(R) + ((lags * 8 + 15) & ~15);
}

struct PickShape {
  int n, ld, R, L, sym, nfft, seg_len, seg_nfft, log_x;
};

__global__ void __launch_bounds__(kThreads)
sc_pick_kernel(const float* __restrict__ x, const float2* __restrict__ xc,
               const int* __restrict__ peak, const float* __restrict__ consts,
               int* __restrict__ lts_pos, float* __restrict__ lts_val,
               float* __restrict__ seg, PickShape sh) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float redv[kWarps];
  __shared__ int redi[kWarps];
  __shared__ Scan jobs[1];
  __shared__ int seg_at;
  const int b = blockIdx.x;
  const int lags = sh.R - sh.L;
  // The slice's squares, then their prefix; the correlation's first lags,
  // copied in while the prefix sums run; the scan's chains.
  float* cs = reinterpret_cast<float*>(smem);
  float2* xcs = reinterpret_cast<float2*>(smem + pick_off_xc(sh.R));
  double* chain = reinterpret_cast<double*>(smem + pick_off_chain(sh.R, lags));
  const int pk = peak[b];
  const int lo = slice_start(pk, sh.n, sh.R);
  const float* row = x + static_cast<size_t>(b) * sh.ld;
  const float2* xr = xc + static_cast<size_t>(b) * sh.nfft;
  for (int j = threadIdx.x; j < sh.R; j += kThreads) __pipeline_memcpy_async(cs + j, row + lo + j, 4);
  __pipeline_commit();
  for (int k = 2 * threadIdx.x; k < lags; k += 2 * kThreads)
    __pipeline_memcpy_async(xcs + k, xr + k, k + 1 < lags ? 16 : 8);
  __pipeline_commit();
  __pipeline_wait_prior(1);
  __syncthreads();
  for (int j = threadIdx.x; j < sh.R; j += kThreads) cs[j] = fmul(cs[j], cs[j]);
  if (threadIdx.x == 0) {
    double* ch = chain;
    make_scan(jobs[0], cs, cs, 1, sh.R, sh.log_x, ch, 0);
  }
  __syncthreads();
  scan_jobs<kThreads>(jobs, 1, 1);
  __pipeline_wait_prior(0);
  __syncthreads();

  auto e_at = [&](int k) { return fsub(cs[k + sh.L - 1], k ? cs[k - 1] : 0.f); };
  float acc = -INFINITY;
  for (int k = threadIdx.x; k < lags; k += kThreads) acc = amax_step(acc, e_at(k));
  const float floor_e = fmul(consts[kFloorRatio], block_amax(acc, redv));
  const float ref = consts[kRefEnergy], e_min = consts[kEMin];
  auto corr_at = [&](int k) {
    return __fdiv_rn(cabs(xcs[k]),
                     __fsqrt_rn(clamp_min(fmul(nan_max(e_at(k), floor_e), ref), e_min)));
  };
  const int lo_rel = pk - lo;
  const int hi_rel = pk + 4 * sh.sym + sh.sym / 2 - lo;
  float best = 0.f;
  int at = 0x7fffffff;
  bool have = false;
#pragma unroll 4
  for (int k = threadIdx.x; k < lags; k += kThreads) {
    const float v = (k >= lo_rel && k <= hi_rel) ? corr_at(k) : -1.0f;
    if (!have || ahead(v, k, best, at)) { best = v; at = k; have = true; }
  }
  if (!have) { best = -INFINITY; at = 0x7fffffff; }
  block_argmax(best, at, redv, redi);
  if (threadIdx.x == 0) {
    int pos = at;
    float val = best;
    const int prev = max(pos - sh.sym, 0);
    const float prev_val = corr_at(prev);
    if (pos >= sh.sym && prev_val >= fmul(val, consts[kPrevRatio])) {
      pos = prev;
      val = prev_val;
    }
    const int p = lo + pos;
    lts_pos[b] = p;
    lts_val[b] = val;
    seg_at = min(max(p, 0), max(sh.n - sh.seg_len, 0));
  }
  __syncthreads();
  const float* src = row + seg_at;
  float* dst = seg + static_cast<size_t>(b) * sh.seg_nfft;
  for (int j = threadIdx.x; j < sh.seg_len; j += kThreads) dst[j] = src[j];
}

__global__ void sc_decide_kernel(const float2* __restrict__ r, const float* __restrict__ peak_val,
                                 const float* __restrict__ cfo, const int* __restrict__ lts_pos,
                                 const float* __restrict__ lts_val,
                                 const float* __restrict__ consts, bool* __restrict__ detected,
                                 int* __restrict__ lts_start, float* __restrict__ cfo_hz, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float2 rr = cmul(make_float2(consts[kRotSymRe], consts[kRotSymIm]), r[b]);
  const float spacing = consts[kSpacing];
  const float fine = fmul(fmul(-carg(rr), spacing), consts[kInvTwoPi]);
  const float k = rintf(fmul(fsub(cfo[b], fine), consts[kInvSpacing]));
  const float c = cabs(rr) > consts[kRMin] ? fadd(fine, fmul(k, spacing)) : cfo[b];
  const bool det = peak_val[b] > consts[kSyncThreshold] && lts_val[b] > consts[kLtsThreshold];
  detected[b] = det;
  lts_start[b] = det ? lts_pos[b] : -1;
  cfo_hz[b] = det ? c : 0.f;
}

}  // namespace

// Each entry launches on ``stream`` and returns the launch's cudaError_t (0
// when it was taken).  Pointers are device pointers on the current device;
// the shapes and layouts are the wrapper's (``sync/sc_kernel.py``).

// slc [B, nfft] complex64, seg [B, seg_nfft] float32: zero past R and seg_len.
extern "C" int ria_sc_pad(void* slc, float* seg, int B, int R, int nfft, int seg_len,
                          int seg_nfft, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid(2, B);
  sc_pad_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(slc), seg, R, nfft, seg_len, seg_nfft);
  return static_cast<int>(cudaGetLastError());
}

// x [B, n] float32 rows ld apart; rot [8 (n / 8)] complex64 on a 16-byte
// boundary; consts [kNumConsts] float32; peak [B] int32, peak_val and cfo [B]
// float32.  A row's arrays take row_bytes (a, r2 and the chains at the given
// byte offsets): in shared memory when smem_bytes > 0, else in ``scratch``,
// B row_bytes bytes.
extern "C" int ria_sc_coarse(const float* x, const void* rot, const float* consts, int* peak,
                             float* peak_val, float* cfo, void* scratch, int B, int n, int ld,
                             int half, int cp, int log_x1, int log_x2, int off_a, int off_r2,
                             int off_chain, int row_bytes, int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const CoarseShape sh{B, n, ld, half, cp, log_x1, log_x2, off_a, off_r2, off_chain, row_bytes,
                       ld % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float4*>(rot);
  char* sc = smem_bytes > 0 ? nullptr : static_cast<char*>(scratch);
  if (int err = allow_smem(sc_coarse_kernel, smem_bytes)) return err;
  sc_coarse_kernel<<<B, kThreads, smem_bytes, s>>>(x, r, consts, peak, peak_val, cfo, sc, sh);
  return static_cast<int>(cudaGetLastError());
}

// slc [B, nfft] complex64: x's R samples from each row's LTS slice start.
extern "C" int ria_sc_slice(const float* x, const int* peak, void* slc, int B, int n, int ld,
                            int R, int nfft, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((R + 1023) / 1024, B);
  sc_slice_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, peak, static_cast<float2*>(slc), n, ld, R, nfft);
  return static_cast<int>(cudaGetLastError());
}

// xc [B, nfft] complex64, the correlation; lts_pos [B] int32, lts_val [B]
// float32; seg [B, seg_nfft] float32 gets each row's segment (its padding is
// sc_pad's).  smem_bytes: the slice's R floats and its scan's chains.
extern "C" int ria_sc_pick(const float* x, const void* xc, const int* peak, const float* consts,
                           int* lts_pos, float* lts_val, float* seg, int B, int n, int ld, int R,
                           int L, int sym, int nfft, int seg_len, int seg_nfft, int log_x,
                           int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const PickShape sh{n, ld, R, L, sym, nfft, seg_len, seg_nfft, log_x};
  if (int err = allow_smem(sc_pick_kernel, smem_bytes)) return err;
  sc_pick_kernel<<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float2*>(xc), peak, consts, lts_pos, lts_val, seg, sh);
  return static_cast<int>(cudaGetLastError());
}

// r [B] complex64, the LTS pair's product; detected [B] bool, lts_start [B]
// int32, cfo_hz [B] float32.
extern "C" int ria_sc_decide(const void* r, const float* peak_val, const float* cfo,
                             const int* lts_pos, const float* lts_val, const float* consts,
                             void* detected, int* lts_start, float* cfo_hz, int B, void* stream) {
  if (B <= 0) return 0;
  sc_decide_kernel<<<(B + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(r), peak_val, cfo, lts_pos, lts_val, consts,
      static_cast<bool*>(detected), lts_start, cfo_hz, B);
  return static_cast<int>(cudaGetLastError());
}
