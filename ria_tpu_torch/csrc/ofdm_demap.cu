// The OFDM demodulator's demap stage in one kernel
// (``ria_tpu_torch/wave/ofdm.py::OFDMDemodulator.from_bins``, span
// ``demod.demap``; plain version ``OFDMDemodulator.demap_plain``, wrapper
// ``ria_tpu_torch/wave/demap_kernel.py``), for the equalised data symbols
// eq [B, S, D] complex64 and each carrier's noise variance nv [B, S, D]
// float32, both read through their strides (the common-phase equaliser's nv
// is [B, 1, D] broadcast over the symbols):
//
//   per carrier, the EMA of |eq| over the symbols and the EMA of its squared
//   deviation from that EMA, each taken before the symbol's own step (alpha
//   0.3; the first from |eq| of symbol 0, the second from 0); the effective
//   noise variance nv ce (1 + 10 var / max(ema^2, 1e-6)); and the DQPSK
//   demapper (against the previous symbol, symbol 0 against 1) or the QAM64
//   one, each LLR clipped to +-20 with a least magnitude of 0.01:
//   soft [B, S D bps] float32, bit k of carrier d of symbol s at (s D + d) bps + k.
//
// It replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses it.  PyTorch on the card ran it as 94-119 small kernels a call
// (two log-depth scans of two multiplies, an add and two concatenations a
// step, the arithmetic between them, the demapper's stack and clips): 0.47-0.54
// ms of device time and about 2.5 ms of the host's dispatch a call in the
// benchmark's OFDM cells, for work that moves 21-34 MB.
//
// Bound: memory.  eq read once (8 B S D a row), nv once (4 B D a row when
// broadcast, else 4 B S D), soft written once (4 B S D bps): 21.5 MB at the
// DQPSK cell's B = 1,024, S = 22, D = 59 (6.4 us at 3.35 TB/s) and 33.8 MB at
// the QAM64 cell's B = 2,048, S = 9, D = 51 (10.1 us).  The arithmetic is some
// 50-100 operations a value (atan2f, sinf, hypotf, divisions), far under the
// card's ratio of operations to bytes.
//
// Design:
// - one thread a carrier of a row, 128 threads a block on neighbouring
//   carriers, so a warp's loads of one symbol and its stores of one symbol's
//   LLRs fall on neighbouring addresses;
// - a carrier's two EMA sequences stay in registers for S <= 32 (arrays of 16
//   or 32, their scans unrolled: both cells); a longer frame keeps them in the
//   carrier's own output slots (bits 0 and 1 of each symbol), which its LLRs
//   overwrite last, from the last symbol down;
// - the demapper runs in a loop over the symbols that is not unrolled, each
//   symbol's factor from the chains formed before it in a local array: the
//   same code unrolled over the frame took 31.9 us alone at the DQPSK cell's
//   shape but 60.9 us inside a chain call (its long unrolled code, it seems,
//   fetched anew after the chain's other kernels), the loop 30.8 and 29.7 (an
//   NVIDIA H100, torch 2.11).  Spreading a block's symbols over 4x as many
//   threads, the chains in shared memory, ran slower (37.3 us alone), and
//   carrying each symbol's |eq| down to the next as its reference's gained
//   nothing;
// - the outputs equal the PyTorch operations' on the card bit for bit, so the
//   decoder sees the same LLRs: every value is formed as ATen forms it, each
//   operation rounded alone:
//   * each EMA is ``_affine_scan``'s Hillis-Steele prefix over the affine maps
//     s_n = 0.7 s_(n-1) + 0.3 x_n (the first map's constant holding 0.7 times
//     the start), not a serial recurrence, which rounds otherwise: at the step
//     of offset o every element n >= o becomes A_n b_(n-o) + b_n, and A_n,
//     the product of maps n-o+1 .. n, is then the same for every such n, 0.7
//     at the first step and the square of the step before's after it, as
//     PyTorch's A tensor rounds it; a thread updates its elements from the
//     last down, so b_(n-o) is still the step's input when element n reads it;
//   * a complex product as c10::complex's, each part's first product fused
//     into an FMA as nvcc contracts ATen's multiply; |z| is hypotf and arg z
//     atan2f, sinf and sqrtf as ATen calls them; 2 / x is 1 / x times 2
//     (``Tensor.__rdiv__``); Python scalars rounded to float32 as ATen rounds
//     them; no other contraction, no fast-math;
//   * clamp and clamp_min keep a NaN, as ATen's.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int kThreads = 128;  // carriers a block

// The stage's scalars, as ``wave/ofdm.py`` names them, rounded to float32
// (tests/test_torch_demap_kernel.py holds each to its Python value).
constexpr float kAlpha = 0.3f;           // MAG_EMA_ALPHA
constexpr float kDecay = 0.7f;           // 1 - MAG_EMA_ALPHA
constexpr float kAdaptiveK = 10.0f;      // CARRIER_ADAPTIVE_K
constexpr float kEmaSqMin = 1e-06f;      // the least ema^2 of the instability ratio
constexpr float kMaxLlr = 20.0f;         // MAX_LLR
constexpr float kMinLlrMag = 0.01f;      // MIN_LLR_MAG
constexpr float kWeakMag = 1e-06f;       // DQPSK: |diff| under which a carrier's LLRs are 0
constexpr float kMagMin = 1e-09f;        // DQPSK: the least |diff| of the second bit's ratio
constexpr float kQuarterPi = 0.7853982f; // DQPSK: pi / 4
constexpr float kQam64D4 = 0.6172134f;   // QAM64: 4 / sqrt(42)
constexpr float kQam64D2 = 0.3086067f;   // QAM64: 2 / sqrt(42)

enum Mod { kDqpsk = 0, kQam64 = 1 };

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

// c10::complex<float>'s product a * b as nvcc compiles it in ATen's multiply.
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fmaf_rn(a.x, b.x, -__fmul_rn(a.y, b.y)),
                     __fmaf_rn(a.x, b.y, __fmul_rn(a.y, b.x)));
}

// |z| as ATen's abs of a complex64 takes it (thrust::abs, which is hypotf).
__device__ __forceinline__ float cabs(float2 z) { return hypotf(z.x, z.y); }

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// ``_demap``'s clip: torch.clamp to +-MAX_LLR, then a magnitude under
// MIN_LLR_MAG raised to it with the value's sign (+ for a zero of either sign).
__device__ __forceinline__ float clip(float v) {
  const float c = v != v ? v : fminf(fmaxf(v, -kMaxLlr), kMaxLlr);
  return fabsf(c) < kMinLlrMag ? (c >= 0.0f ? kMinLlrMag : -kMinLlrMag) : c;
}

// A carrier's two EMA sequences (the affine maps' constants, then the states
// after each step): in registers for kS > 0 (S <= kS).
template <int kS>
struct Chains {
  float e[kS], v[kS];
  __device__ __forceinline__ Chains(float*, int) {}
  __device__ __forceinline__ float& ema(int n) { return e[n]; }
  __device__ __forceinline__ float& var(int n) { return v[n]; }
};

// ... and for a longer frame in the carrier's output slots of each symbol:
// bit 0 holds the EMA, bit 1 the variance, until that symbol's LLRs.
template <>
struct Chains<0> {
  float* slot;
  int step;  // floats from one symbol's slots to the next's: D bps
  __device__ __forceinline__ Chains(float* s, int st) : slot(s), step(st) {}
  __device__ __forceinline__ float& ema(int n) { return slot[static_cast<size_t>(n) * step]; }
  __device__ __forceinline__ float& var(int n) { return slot[static_cast<size_t>(n) * step + 1]; }
};

// ``_affine_scan`` over a chain's constants b_0 .. b_(S-1), in place (see the
// note above): the states after each step.  In registers (kS > 0) each step is
// a template of its own, so that every index is known when it compiles; it
// runs over all kS elements, and those past S never reach an element under S.
template <int kS, int kOff, class Elem>
__device__ __forceinline__ void scan_steps(Elem b, float a) {
  if constexpr (kOff < kS) {
#pragma unroll
    for (int n = kS - 1; n >= kOff; --n) b(n) = fadd(fmul(a, b(n - kOff)), b(n));
    scan_steps<kS, 2 * kOff>(b, fmul(a, a));
  }
}

template <int kS, class Elem>
__device__ __forceinline__ void affine_scan(Elem b, int S) {
  if constexpr (kS > 0) {
    scan_steps<kS, 1>(b, kDecay);
  } else {
    float a = kDecay;
    for (int off = 1; off < S; off *= 2) {
      for (int n = S - 1; n >= off; --n) b(n) = fadd(fmul(a, b(n - off)), b(n));
      a = fmul(a, a);
    }
  }
}

template <int kBps, int kS>
__global__ void __launch_bounds__(kThreads)
ofdm_demap_kernel(const float2* __restrict__ eq, const float* __restrict__ nv,
                  float* __restrict__ soft, int rows, int S, int D, int eq_b, int eq_s,
                  int eq_d, int nv_b, int nv_s, int nv_d, float ce) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows * D) return;
  const int row = t / D;
  const int d = t - row * D;
  const float2* x = eq + static_cast<size_t>(row) * eq_b + static_cast<size_t>(d) * eq_d;
  const float* w = nv + static_cast<size_t>(row) * nv_b + static_cast<size_t>(d) * nv_d;
  const int step = D * kBps;
  float* out = soft + static_cast<size_t>(row) * S * step + d * kBps;
  const int N = kS ? kS : S;

  Chains<kS> c(out, step);
  auto ema = [&](int n) -> float& { return c.ema(n); };
  auto var = [&](int n) -> float& { return c.var(n); };

  // The magnitude EMA's constants 0.3 |eq_n|, the first plus 0.7 |eq_0|;
  // |eq_n| waits in the variance's place.
  const float m0 = cabs(x[0]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float m = (kS == 0 || n < S) ? cabs(x[static_cast<size_t>(n) * eq_s]) : 0.0f;
    ema(n) = fmul(m, kAlpha);
    var(n) = m;
  }
  ema(0) = fadd(ema(0), fmul(m0, kDecay));
  affine_scan<kS>(ema, S);

  // The variance EMA's constants 0.3 (|eq_n| - ema before n)^2, from 0.
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float dev = fsub(var(n), n ? ema(n - 1) : m0);
    var(n) = fmul(fmul(dev, dev), kAlpha);
  }
  var(0) = fadd(var(0), fmul(0.0f, kDecay));
  affine_scan<kS>(var, S);

  // Each symbol's effective noise variance and LLRs, from the last symbol
  // down (a longer frame's symbol n reads the states after n - 1 from its
  // slots before its own are written), in a loop that is not unrolled (see
  // the note above).  In registers, each symbol's factor 1 + 10 var /
  // max(ema^2, 1e-6) is formed first, into a local array.
  auto factor = [](float ema_b, float var_b) {
    return fadd(fmul(fdiv(var_b, clamp_min(fmul(ema_b, ema_b), kEmaSqMin)), kAdaptiveK), 1.0f);
  };
  float g[kS ? kS : 1];
  if constexpr (kS > 0) {
#pragma unroll
    for (int n = 0; n < kS; ++n) g[n] = factor(n ? ema(n - 1) : m0, n ? var(n - 1) : 0.0f);
  }
#pragma unroll 1
  for (int n = S - 1; n >= 0; --n) {
    float f;
    if constexpr (kS > 0) {
      f = g[n];
    } else {
      f = factor(n ? ema(n - 1) : m0, n ? var(n - 1) : 0.0f);
    }
    const float nve = fmul(fmul(w[static_cast<size_t>(n) * nv_s], ce), f);
    const float2 cur = x[static_cast<size_t>(n) * eq_s];
    float* o = out + static_cast<size_t>(n) * step;
    if (kBps == 2) {
      const float2 prev = n ? x[static_cast<size_t>(n - 1) * eq_s] : make_float2(1.0f, 0.0f);
      const float2 diff = cmul(cur, make_float2(prev.x, -prev.y));
      const float power = fmul(cabs(cur), cabs(prev));
      const float diff_nv = fmul(nve, 2.0f);
      const float mag = cabs(diff);
      const float scale = fmul(sqrtf(fdiv(power, diff_nv)), 2.0f);
      const float phase = atan2f(diff.y, diff.x);
      float l0 = clip(fmul(scale, sinf(fadd(phase, kQuarterPi))));
      float l1 = clip(fdiv(fmul(scale, fsub(fabsf(diff.x), fabsf(diff.y))),
                           clamp_min(mag, kMagMin)));
      if (mag < kWeakMag) l0 = l1 = 0.0f;
      *reinterpret_cast<float2*>(o) = make_float2(l0, l1);
    } else {
      const float s = fmul(fdiv(1.0f, nve), 2.0f);
      const float tI = fsub(fabsf(cur.x), kQam64D4);
      const float tQ = fsub(fabsf(cur.y), kQam64D4);
      const float2 b01 = make_float2(clip(fmul(-s, cur.x)), clip(fmul(s, tI)));
      const float2 b23 = make_float2(clip(fmul(s, fsub(fabsf(tI), kQam64D2))),
                                     clip(fmul(-s, cur.y)));
      const float2 b45 = make_float2(clip(fmul(s, tQ)),
                                     clip(fmul(s, fsub(fabsf(tQ), kQam64D2))));
      reinterpret_cast<float2*>(o)[0] = b01;
      reinterpret_cast<float2*>(o)[1] = b23;
      reinterpret_cast<float2*>(o)[2] = b45;
    }
  }
}

template <int kBps>
cudaError_t launch(const float2* eq, const float* nv, float* soft, int rows, int S, int D,
                   const int* st, float ce, cudaStream_t stream) {
  const int blocks = static_cast<int>((static_cast<long long>(rows) * D + kThreads - 1) / kThreads);
#define RIA_DEMAP_LAUNCH(KS)                                                              \
  ofdm_demap_kernel<kBps, KS><<<blocks, kThreads, 0, stream>>>(                           \
      eq, nv, soft, rows, S, D, st[0], st[1], st[2], st[3], st[4], st[5], ce)
  if (S <= 16) {
    RIA_DEMAP_LAUNCH(16);
  } else if (S <= 32) {
    RIA_DEMAP_LAUNCH(32);
  } else {
    RIA_DEMAP_LAUNCH(0);
  }
#undef RIA_DEMAP_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// eq [rows, S, D] complex64 (strides eq_b, eq_s, eq_d in complex64 elements),
// nv [rows, S, D] float32 (strides nv_b, nv_s, nv_d; nv_s = 0 when broadcast
// over the symbols), soft [rows, S D bps] float32 contiguous (bps 2 for
// ``mod`` 0, DQPSK, 6 for 1, QAM64), all on the current device; ``ce_bits``
// the float32 bits of the modulation's CE margin.  Rows start on 8-byte
// boundaries.  Launches on ``stream`` and returns the launch's cudaError_t (0
// when it was taken; cudaErrorInvalidValue for a modulation it lacks).
extern "C" int ria_ofdm_demap(const void* eq, const float* nv, float* soft, int rows, int S,
                              int D, int eq_b, int eq_s, int eq_d, int nv_b, int nv_s, int nv_d,
                              int mod, int ce_bits, void* stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return 0;
  float ce;
  std::memcpy(&ce, &ce_bits, sizeof ce);
  const int st[6] = {eq_b, eq_s, eq_d, nv_b, nv_s, nv_d};
  const auto* e = static_cast<const float2*>(eq);
  const auto s = static_cast<cudaStream_t>(stream);
  if (mod == kDqpsk) return static_cast<int>(launch<2>(e, nv, soft, rows, S, D, st, ce, s));
  if (mod == kQam64) return static_cast<int>(launch<6>(e, nv, soft, rows, S, D, st, ce, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
