// The fine stage of the chirp search's zoom branch
// (``ria_tpu_torch/sync/chirp.py::ChirpDetector._refine_peak`` and ``_median``,
// wrapper ``ria_tpu_torch/sync/fine_kernel.py``) in three kernels around the
// refinement's two matmuls, which stay cuBLAS's (``torch.matmul`` on the
// slice this writes, as the plain path calls it):
//
//   chirp_refine_front  a block a row: the row's slice start, clamped
//                       (start [B] int32), the slice x[b, start : start + L]
//                       copied out (y [B, L] float32, the matmuls' operand),
//                       and the slice's window energies win [B, 2R + 1]:
//                       win[j] = P[chirp_len + j - 1] - P[j - 1] (P[-1] = 0),
//                       P the float64 prefix sums of the float32 squares,
//                       each rounded to float32;
//   chirp_refine_pick   a warp a row, after the matmuls' cr, ci [B, 2R + 1]:
//                       |c|^2 over the floored energy, its argmax and square
//                       root (lag [B] int32 = start + j, val [B] float32);
//   median_select       a block a row of x [B, m] float32: the mean of its
//                       two middle values, (m - 1) / 2 and m / 2, as the
//                       plain path takes them from ``torch.sort``.
//
// They replace no TPU kernel: the JAX package leaves the refinement and the
// median to XLA, which fuses them.  PyTorch on the card ran each refinement
// as some 30 kernels (an int64 index of [B, L] and its gather, the squares
// widened to float64, scanned and narrowed back, a dozen small ones around
// the matmuls) and the median as a segmented radix sort of every row: on an
// NVIDIA H100, 1.09 ms of device work a call at 256 windows of 207,328
// samples, 1.20 ms at 128 of 606,688.
//
// Bound: memory.  chirp_refine_front reads each row's L floats and writes
// them once (B L 8 bytes: 49.2 MB at B = 256, L = 24,048, 14.7 us at 3.35
// TB/s); chirp_refine_pick moves 3 (2R + 1) floats a row; median_select
// reads B m 4 bytes (11.7 MB at B = 256, m = 11,458; 18.6 MB at B = 128, m =
// 36,418).  The front's prefix sum carries a serial chain of float64
// additions through every chunk of the row (``aten_order.cuh``), so it is
// bound by latency more than by bytes at these sizes.
//
// Design:
// - the outputs equal the plain path's on the card bit for bit, so the search
//   decides as it did: the slice as ``torch.gather`` copies it, the squares
//   as ``y * y`` rounds them, the prefix sums in ATen's innermost-dimension
//   scan order (``Scan`` of ``aten_order.cuh``, shared with ``sc_search.cu``;
//   the wrapper computes the scan's geometry as ATen does for B rows of L),
//   each operation of the pick rounded alone as ATen's kernels round them (no
//   fast-math, no contraction: |c|^2 is three roundings, the division IEEE's,
//   the square root correctly rounded; max, clamp and argmax as ATen's);
// - chirp_refine_front stages the row's squares in shared memory (96 KB at L
//   = 24,048: two blocks an SM) while it writes the slice out, eight loads a
//   thread in flight; the scan's first pass and its chains cover the whole
//   row, but its last pass runs only on the warps whose lanes hold the 98
//   prefixes that the window energies read (the row's first 2R and last
//   2R + 1);
// - median_select ranks by the key of ``torch.sort``'s radix sort (CUB's: the
//   float's bits made order-preserving, -0 ranked with +0, a NaN of either
//   sign by its bits), and selects rank (m - 1) / 2 exactly by four passes
//   of 8-bit digits, most significant first: each pass a histogram of the
//   digit over the keys that share the digits found so far (a warp's lanes
//   of one digit added at once, ``__match_any_sync``), and the digit whose
//   bin holds the rank.  Rank m / 2 is the same key while the key's count
//   reaches past the first rank, else the least key above it (one more
//   pass).  The sort is stable, so a zero's sign is the sign of the zero of
//   that rank among the row's zeros in the row's order (one more pass, only
//   when a selected key is zero's).  A row that fits in shared memory is
//   staged there (46 KB at m = 11,458, 146 KB at 36,418), else every pass
//   reads it from memory.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include "aten_order.cuh"

namespace {

constexpr int kThreads = 256;      // threads a block of chirp_refine_front
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;         // loads a thread of chirp_refine_front keeps in flight
constexpr int kPickRows = 4;       // rows, a warp each, a block of chirp_refine_pick
constexpr int kSelThreads = 1024;  // threads a block of median_select
constexpr int kSelWarps = kSelThreads / 32;
constexpr unsigned kZeroKey = 0x80000000u;  // the sort key of +0 and -0

// ---------------------------------------------------------------------------
// chirp_refine_front

struct FrontShape {
  int n, ld, L, chirp_len, nwin, log_x;
};

// The lane of a scan job that holds element e (``scan_lane``'s map inverted).
__device__ __forceinline__ int lane_of(const Scan& s, int e) {
  const int log_g = s.log_c - s.log_e;
  return ((e >> s.log_c) << log_g) + ((e & ((1 << s.log_c) - 1)) >> s.log_e);
}

// One lane of a one-part job, at the job's lane width (``scan_pass``'s choice).
__device__ __forceinline__ void scan_lane_at(const Scan& s, int lane, bool last_pass) {
  if (s.log_e == 3) scan_lane<8, 1>(s, lane, last_pass, 0);
  else if (s.log_e == 4) scan_lane<16, 1>(s, lane, last_pass, 0);
  else scan_lane<32, 1>(s, lane, last_pass, 0);
}

__global__ void __launch_bounds__(kThreads, 2)
chirp_refine_front_kernel(const float* __restrict__ x, const int* __restrict__ pos,
                          int* __restrict__ start, float* __restrict__ y,
                          float* __restrict__ win, FrontShape sh) {
  extern __shared__ __align__(16) char smem[];
  __shared__ Scan job;
  const int b = blockIdx.x;
  const int R = (sh.nwin - 1) / 2;
  // torch.clamp(coarse_pos - R, 0, n - L), then ``window_slice``'s clamp.
  const int st = min(max(pos[b] - R, 0), max(sh.n - sh.L, 0));
  float* sq = reinterpret_cast<float*>(smem);
  double* chain = reinterpret_cast<double*>(smem + ((sh.L * 4 + 15) & ~15));
  const float* src = x + static_cast<size_t>(b) * sh.ld + st;
  float* dst = y + static_cast<size_t>(b) * sh.L;

  // The slice out, and its squares into shared memory.
  for (int j0 = threadIdx.x; j0 < sh.L; j0 += kUnroll * kThreads) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      v[u] = j < sh.L ? __ldg(src + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kThreads;
      if (j < sh.L) {
        dst[j] = v[u];
        sq[j] = fmul(v[u], v[u]);
      }
    }
  }
  if (threadIdx.x == 0) {
    start[b] = st;
    double* ch = chain;
    make_scan(job, sq, sq, 1, sh.L, sh.log_x, ch, 0);
  }
  __syncthreads();

  // The prefix sums in place: every chunk's partial sums and the chain of
  // running totals, then the prefixes of the lanes that hold P[0 .. 2R - 1]
  // and P[chirp_len - 1 .. L - 1], whole warps at a time (their butterflies
  // span a warp).
  scan_pass<kThreads>(&job, 0, 1, false);
  __syncthreads();
  scan_chain(&job, 1);
  __syncthreads();
  const int head0 = lane_of(job, 0) >> 5;
  const int head1 = sh.nwin > 1 ? lane_of(job, sh.nwin - 2) >> 5 : head0 - 1;
  const int tail0 = max(lane_of(job, sh.chirp_len - 1) >> 5, head1 + 1);
  const int tail1 = lane_of(job, sh.L - 1) >> 5;
  const int heads = head1 - head0 + 1, warps = heads + max(tail1 - tail0 + 1, 0);
  for (int k = threadIdx.x >> 5; k < warps; k += kWarps) {
    const int w = k < heads ? head0 + k : tail0 + (k - heads);
    scan_lane_at(job, 32 * w + (threadIdx.x & 31), true);
  }
  __syncthreads();

  // win[j] = csum[chirp_len + j] - csum[j], csum the prefixes with a 0 in front.
  float* out = win + static_cast<size_t>(b) * sh.nwin;
  for (int j = threadIdx.x; j < sh.nwin; j += kThreads)
    out[j] = fsub(sq[sh.chirp_len + j - 1], j ? sq[j - 1] : 0.f);
}

// ---------------------------------------------------------------------------
// chirp_refine_pick

__global__ void __launch_bounds__(32 * kPickRows)
chirp_refine_pick_kernel(const float* __restrict__ cr, const float* __restrict__ ci,
                         const float* __restrict__ win, const int* __restrict__ start,
                         int* __restrict__ lag, float* __restrict__ val, int B, int nwin,
                         float floor_ratio, float energy, float denom_min) {
  const int b = blockIdx.x * kPickRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // a whole warp
  const size_t o = static_cast<size_t>(b) * nwin;
  // win_floor = floor_ratio * amax(win).
  float acc = -INFINITY;
  for (int j = lane; j < nwin; j += 32) acc = amax_step(acc, win[o + j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = amax_step(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  const float floor_w = fmul(acc, floor_ratio);
  // corr2 = (cr cr + ci ci) / clamp_min(maximum(win, win_floor) energy, denom_min),
  // its argmax (first index on ties) and its square root there.
  float best = -INFINITY;
  int at = 0x7fffffff;
  for (int j = lane; j < nwin; j += 32) {
    const float a = cr[o + j], c = ci[o + j];
    const float m2 = fadd(fmul(a, a), fmul(c, c));
    const float q = __fdiv_rn(m2, clamp_min(fmul(nan_max(win[o + j], floor_w), energy), denom_min));
    if (at == 0x7fffffff || ahead(q, j, best, at)) {
      best = q;
      at = j;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, at, off);
    if (oi != 0x7fffffff && (at == 0x7fffffff || ahead(ov, oi, best, at))) {
      best = ov;
      at = oi;
    }
  }
  if (lane == 0) {
    lag[b] = start[b] + at;
    val[b] = __fsqrt_rn(best);
  }
}

// ---------------------------------------------------------------------------
// median_select

// The sort's key of a float: its bits made order-preserving as CUB's radix
// sort twiddles them (negatives all flipped, positives their sign bit set),
// -0 taken as +0 (CUB ranks the two alike).
__device__ __forceinline__ unsigned sort_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a key; zero's key gives +0.
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

struct SelectShared {
  int hist[256];
  int scan[kSelWarps];
  unsigned digit, key;
  int below, count;
  float zero;
};

// A row's element i, from shared memory where the row is staged.
template <bool kStaged>
__device__ __forceinline__ float row_at(const float* row, const float* staged, int i) {
  return kStaged ? staged[i] : __ldg(row + i);
}

// The block's exclusive prefix of each thread's ``v`` (every thread gets its own).
__device__ int block_exclusive(int v, int* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) scan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = scan[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    scan[lane] = t;
  }
  __syncthreads();
  const int before = (warp ? scan[warp - 1] : 0) + inc - v;
  __syncthreads();
  return before;
}

// The key of rank ``rank`` among the row's m keys, by four 8-bit digits;
// ``rank`` becomes the rank among the keys equal to it, and ``count`` their
// number.
template <bool kStaged>
__device__ unsigned select_key(const float* row, const float* staged, int m, int& rank,
                               int& count, SelectShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned prefix = 0u, mask = 0u;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += kSelThreads) sh.hist[d] = 0;
    __syncthreads();
    for (int i0 = warp * 32; i0 < m; i0 += kSelThreads) {  // whole warps
      const int i = i0 + lane;
      const unsigned k = i < m ? sort_key(row_at<kStaged>(row, staged, i)) : 0u;
      const bool in = i < m && (k & mask) == prefix;
      const unsigned d = in ? (k >> shift) & 0xffu : 0x100u;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[d], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // the bin that holds the rank: 8 bins a lane
      int c[8], s = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        c[t] = sh.hist[8 * lane + t];
        s += c[t];
      }
      int inc = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      int acc = inc - s;
      if (acc <= rank && rank < inc) {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (rank >= acc && rank < acc + c[t]) {
            sh.digit = 8 * lane + t;
            sh.below = acc;
            sh.count = c[t];
          }
          acc += c[t];
        }
      }
    }
    __syncthreads();
    prefix |= sh.digit << shift;
    mask |= 0xffu << shift;
    rank -= sh.below;
    count = sh.count;
    __syncthreads();
  }
  return prefix;
}

// The least key of the row above ``key`` (there is one).
template <bool kStaged>
__device__ unsigned next_key(const float* row, const float* staged, int m, unsigned key,
                             SelectShared& sh) {
  unsigned least = 0xffffffffu;
  for (int i = threadIdx.x; i < m; i += kSelThreads) {
    const unsigned k = sort_key(row_at<kStaged>(row, staged, i));
    if (k > key && k < least) least = k;
  }
  least = __reduce_min_sync(0xffffffffu, least);
  if ((threadIdx.x & 31) == 0) sh.scan[threadIdx.x >> 5] = static_cast<int>(least);
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned v = static_cast<unsigned>(sh.scan[threadIdx.x]);
    v = __reduce_min_sync(0xffffffffu, v);
    if (threadIdx.x == 0) sh.key = v;
  }
  __syncthreads();
  const unsigned out = sh.key;
  __syncthreads();
  return out;
}

// The zero of rank ``rank`` among the row's zeros, in the row's order: its
// sign is the stable sort's.
template <bool kStaged>
__device__ float zero_of_rank(const float* row, const float* staged, int m, int rank,
                              SelectShared& sh) {
  const int per = (m + kSelThreads - 1) / kSelThreads;
  const int t = threadIdx.x;
  const int lo = min(t * per, m), hi = min(lo + per, m);
  int zeros = 0;
  for (int i = lo; i < hi; ++i) zeros += sort_key(row_at<kStaged>(row, staged, i)) == kZeroKey;
  int at = block_exclusive(zeros, sh.scan);
  if (at <= rank && rank < at + zeros) {
    for (int i = lo; i < hi; ++i) {
      const float v = row_at<kStaged>(row, staged, i);
      if (sort_key(v) == kZeroKey && at++ == rank) {
        sh.zero = v;
        break;
      }
    }
  }
  __syncthreads();
  const float out = sh.zero;
  __syncthreads();
  return out;
}

template <bool kStaged>
__global__ void __launch_bounds__(kSelThreads)
median_select_kernel(const float* __restrict__ x, float* __restrict__ out, int m, int ld,
                     bool vec) {
  extern __shared__ __align__(16) float staged[];
  __shared__ SelectShared sh;
  const float* row = x + static_cast<size_t>(blockIdx.x) * ld;
  if (kStaged) {
    int i0 = 0;
    if (vec) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
      float4* staged4 = reinterpret_cast<float4*>(staged);
      for (int i = threadIdx.x; i < m / 4; i += kSelThreads) staged4[i] = __ldg(row4 + i);
      i0 = m / 4 * 4;
    }
    for (int i = i0 + threadIdx.x; i < m; i += kSelThreads) staged[i] = __ldg(row + i);
    __syncthreads();
  }
  const int k1 = (m - 1) / 2, k2 = m / 2;
  int r1 = k1, count = 0;
  const unsigned key1 = select_key<kStaged>(row, staged, m, r1, count, sh);
  // Rank k2 = k1 + 1 (an even count) is key1 again while key1's count reaches
  // it, else the least key above key1, of which it is the first.
  unsigned key2 = key1;
  int r2 = r1 + 1;
  if (k2 == k1) {
    r2 = r1;
  } else if (r2 >= count) {
    key2 = next_key<kStaged>(row, staged, m, key1, sh);
    r2 = 0;
  }
  const float a = key1 == kZeroKey ? zero_of_rank<kStaged>(row, staged, m, r1, sh) : key_float(key1);
  float b = a;
  if (k2 != k1)
    b = key2 == kZeroKey ? zero_of_rank<kStaged>(row, staged, m, r2, sh) : key_float(key2);
  // 0.5 * (s[k1] + s[k2]), as the plain path forms it.
  if (threadIdx.x == 0) out[blockIdx.x] = fmul(0.5f, fadd(a, b));
}

float as_float(int bits) {
  float f;
  std::memcpy(&f, &bits, sizeof f);
  return f;
}

}  // namespace

// Each entry launches on ``stream`` and returns the launch's cudaError_t (0
// when it was taken).  Pointers are device pointers on the current device;
// the shapes and layouts are the wrapper's (``sync/fine_kernel.py``).

// x [B, n] float32 rows ld apart; pos [B] int32, the coarse peaks; start [B]
// int32; y [B, L] float32; win [B, nwin] float32, nwin = 2R + 1 = L -
// chirp_len + 1.  smem_bytes: the row's L squares and the scan's chains.
extern "C" int ria_chirp_refine_front(const float* x, const int* pos, int* start, float* y,
                                      float* win, int B, int n, int ld, int L, int chirp_len,
                                      int nwin, int log_x, int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const FrontShape sh{n, ld, L, chirp_len, nwin, log_x};
  if (int err = allow_smem(chirp_refine_front_kernel, smem_bytes)) return err;
  chirp_refine_front_kernel<<<B, kThreads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      x, pos, start, y, win, sh);
  return static_cast<int>(cudaGetLastError());
}

// cr, ci, win [B, nwin] float32; start [B] int32; lag [B] int32, val [B]
// float32.  The three scalars come as the bits of their float32 values: the
// energy floor's ratio to the greatest window energy, the template's energy
// and the least denominator.
extern "C" int ria_chirp_refine_pick(const float* cr, const float* ci, const float* win,
                                     const int* start, int* lag, float* val, int B, int nwin,
                                     int floor_bits, int energy_bits, int min_bits,
                                     void* stream) {
  if (B <= 0) return 0;
  chirp_refine_pick_kernel<<<(B + kPickRows - 1) / kPickRows, 32 * kPickRows, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      cr, ci, win, start, lag, val, B, nwin, as_float(floor_bits), as_float(energy_bits),
      as_float(min_bits));
  return static_cast<int>(cudaGetLastError());
}

// x [B, m] float32 rows ld apart, m >= 1; out [B] float32.  smem_bytes: the
// row's m floats when it is staged in shared memory, else 0.
extern "C" int ria_median_select(const float* x, float* out, int B, int m, int ld,
                                 int smem_bytes, void* stream) {
  if (B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > 0) {
    const bool vec = ld % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (int err = allow_smem(median_select_kernel<true>, smem_bytes)) return err;
    median_select_kernel<true><<<B, kSelThreads, smem_bytes, s>>>(x, out, m, ld, vec);
  } else {
    median_select_kernel<false><<<B, kSelThreads, 0, s>>>(x, out, m, ld, false);
  }
  return static_cast<int>(cudaGetLastError());
}
