// ATen's orders, shared by the port's CUDA kernels whose outputs equal
// PyTorch's own operations on the card bit for bit (``sc_search.cu``,
// ``chirp_fine.cu``): its elementwise arithmetic (each operation rounded
// alone; max, clamp and argmax NaN-propagating, as ATen's kernels form them)
// and its prefix sums, ``utils/device.wide_cumsum`` (float64, each prefix
// rounded to float32), in the order of ATen's innermost-dimension scan
// (``tensor_kernel_scan_innermost_dim`` of ATen/native/cuda/ScanUtils.cuh,
// torch 2.11 on the card).  That order is ATen's private code:
// tests/test_torch_sc_kernel.py holds the installed header's text of those
// functions to the text followed here, and the card tests hold each kernel's
// outputs to PyTorch's.  Last, the launch helper both sources share.
//
// A source includes it once, outside any namespace; everything here has
// internal linkage.  A library's name hashes this header with its source
// (``utils/native_build.library_path``), so an edit here rebuilds both.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

// ---------------------------------------------------------------------------
// ATen's elementwise arithmetic

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }

// torch.maximum, torch.amax's step, torch.clamp_min and torch.clamp: NaN
// propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}
__device__ __forceinline__ float amax_step(float acc, float v) {
  return (acc != acc || acc > v) ? acc : v;
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// torch.argmax's order: NaN above all, then the value, then the lower index.
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  if (a != a) return b != b ? ia < ib : true;
  return a == b ? ia < ib : a > b;
}

// ---------------------------------------------------------------------------
// Prefix sums in the order of ATen's innermost-dimension scan.
//
// ATen scans a row in chunks of C = 2T elements.  A chunk's first element
// gets the running total c added (x0 + c); then, for m = 0 .. log2(C) - 1,
// every element i with bit m set adds the value at i's block start + 2^m - 1
// (Sklansky).  Unrolled, element i's value is its chain over the set bits of
// i in ascending order, ((x_i + A_m1) + A_m2) + ..., A_m the sum of the 2^m
// elements left of the bits below m, each such block summed as a pairwise
// tree; only the block at the chunk's start holds c.  So the value is W_i,
// the chain without its top bit's term (free of c), plus G_t, the chunk's
// prefix through element 2^t - 1 for i's top bit t, and
//   G_0 = x_0 + c,  G_{t+1} = S_t + G_t  (S_t the tree sum of [2^t, 2^{t+1})),
// the next chunk's c being G_{log2 C}.  Pass 1 forms every chunk's x_0 and S_t
// at once, pass 2 runs each job's chain of chunks on one thread, pass 3 forms
// every W_i and adds its G.  A lane holds E consecutive elements; the G = C / E
// lanes of a chunk share a warp.  float64 additions are commutative, so only
// the grouping matters, and elements past the row are 0, as ATen loads them.

struct Scan {
  const float* in;    // element j's part q at in[j * parts + q]
  float* out;         // its prefix, rounded to float32, at out[j * parts + q]
  double* chain;      // [parts][chunks][log_c + 1]
  int parts, n, log_c, log_e;
  int lane0, lanes;   // the job's lanes, a whole number of warps
};

__device__ __forceinline__ int scan_chunks(const Scan& s) {
  return (s.n + (1 << s.log_c) - 1) >> s.log_c;
}

// Sklansky's network inside a lane's E elements; the group at a chunk's start
// skips each element's top bit, whose term holds the running total.
template <int E>
__device__ __forceinline__ void lane_network(double (&v)[E], bool chunk_start) {
#pragma unroll
  for (int m = 0; (1 << m) < E; ++m) {
#pragma unroll
    for (int i = E - 1; i >= 0; --i) {
      if (((i >> m) & 1) && !(chunk_start && (i >> m) == 1)) {
        v[i] = __dadd_rn(v[i], v[((i >> (m + 1)) << (m + 1)) + (1 << m) - 1]);
      }
    }
  }
}

// One lane of a job: its E elements from ``base``, parts p0 .. p0 + P - 1 at
// once (all the job's parts when P == parts: then in 16-byte vectors).
template <int E, int P>
__device__ __forceinline__ void scan_lane(const Scan& s, int lane, bool last_pass, int p0) {
  constexpr int kLogE = E == 8 ? 3 : (E == 16 ? 4 : 5);
  const int log_g = s.log_c - kLogE;            // lanes a chunk: 2^log_g <= 32
  const int chunk = lane >> log_g, g = lane & ((1 << log_g) - 1);
  const int nchunks = scan_chunks(s);
  const int base = (chunk << s.log_c) + g * E;
  const bool whole = base + E <= s.n && P == s.parts;
  double v[P][E];
  const float* src = s.in + static_cast<size_t>(base) * s.parts + p0;
  if (whole && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < E * P / 4; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(src + 4 * k);
      const float w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) v[(4 * k + r) % P][(4 * k + r) / P] = w[r];
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
#pragma unroll
      for (int q = 0; q < P; ++q)
        v[q][e] = base + e < s.n ? static_cast<double>(src[e * s.parts + q]) : 0.0;
  }
#pragma unroll
  for (int q = 0; q < P; ++q) lane_network<E>(v[q], g == 0);
  const bool real = chunk < nchunks;
  // The butterfly over the chunk's lanes: at step b the lane 2^b holds the
  // sum of the groups [2^b, 2^{b+1}), and each lane with bit b set receives
  // the sum of the 2^b groups left of it.
  double sib[P][5];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    double* slot = s.chain + (static_cast<size_t>(p0 + q) * nchunks + chunk) * (s.log_c + 1);
    if (!last_pass && real && g == 0) {
      slot[0] = v[q][0];
#pragma unroll
      for (int t = 0; t < kLogE; ++t) slot[1 + t] = v[q][(2 << t) - 1];
    }
    double total = v[q][E - 1];
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if (b < log_g) {
        const double other = __shfl_xor_sync(0xffffffffu, total, 1 << b);
        if (!last_pass && real && g == (1 << b)) slot[1 + kLogE + b] = total;
        sib[q][b] = other;
        total = __dadd_rn(total, other);
      }
    }
  }
  if (!last_pass || !real) return;
  // W_j: the lane's own bits' terms (in v), then the group bits' but the
  // top one, ascending; then the chunk's prefix G at j's top bit.
  const int top_g = g ? 31 - __clz(g) : -1;
  double g_top[P];
  const double* slots[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    slots[q] = s.chain + (static_cast<size_t>(p0 + q) * nchunks + chunk) * (s.log_c + 1);
    g_top[q] = g ? slots[q][kLogE + top_g] : 0.0;
  }
  auto prefix = [&](int e, int q) {
    double acc = v[q][e];
#pragma unroll
    for (int b = 0; b < 5; ++b)
      if (b < top_g && ((g >> b) & 1)) acc = __dadd_rn(acc, sib[q][b]);
    const double r = g ? __dadd_rn(acc, g_top[q])
                       : (e ? __dadd_rn(acc, slots[q][31 - __clz(e)]) : slots[q][0]);
    return __double2float_rn(r);
  };
  float* dst = s.out + static_cast<size_t>(base) * s.parts + p0;
  if (whole && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < E * P / 4; ++k) {
      const int i = 4 * k;
      reinterpret_cast<float4*>(dst)[k] =
          make_float4(prefix(i / P, i % P), prefix((i + 1) / P, (i + 1) % P),
                      prefix((i + 2) / P, (i + 2) % P), prefix((i + 3) / P, (i + 3) % P));
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (base + e < s.n)
#pragma unroll
        for (int q = 0; q < P; ++q) dst[e * s.parts + q] = prefix(e, q);
  }
}

// A chunk of C takes lanes of max(8, C / 32) elements; a block of kThreads
// threads walks the lanes.
template <int kThreads>
__device__ __forceinline__ void scan_pass(const Scan* jobs, int j0, int j1, bool last_pass) {
  const int first = jobs[j0].lane0, total = jobs[j1 - 1].lane0 + jobs[j1 - 1].lanes;
  for (int lane = first + threadIdx.x; lane < total; lane += kThreads) {
    int k = j0;
    while (k + 1 < j1 && lane >= jobs[k + 1].lane0) ++k;  // warp-uniform
    const Scan& s = jobs[k];
    const int l = lane - s.lane0;
    if (s.log_e == 3) {
      if (s.parts == 2) scan_lane<8, 2>(s, l, last_pass, 0);
      else scan_lane<8, 1>(s, l, last_pass, 0);
    } else if (s.log_e == 4) {
      if (s.parts == 2) scan_lane<16, 2>(s, l, last_pass, 0);
      else scan_lane<16, 1>(s, l, last_pass, 0);
    } else {
      for (int q = 0; q < s.parts; ++q) scan_lane<32, 1>(s, l, last_pass, q);
    }
  }
}

// The running totals of one part's chunks: a chunk's inputs read at once,
// then its chain of additions.
template <int LC>
__device__ __forceinline__ void chain_part(double* chain, int nchunks) {
  constexpr int W = LC + 1;
  double c = 0.0;
  for (int ch = 0; ch < nchunks; ++ch) {
    double* slot = chain + static_cast<size_t>(ch) * W;
    double in[W];
#pragma unroll
    for (int t = 0; t < W; ++t) in[t] = slot[t];
    double g = __dadd_rn(in[0], c);
    slot[0] = g;
#pragma unroll
    for (int t = 0; t < LC; ++t) {
      g = __dadd_rn(in[1 + t], g);
      if (t + 1 < LC) slot[1 + t] = g;
    }
    c = g;
  }
}

// Pass 2: each part of each job on one thread, the threads in different warps.
__device__ __forceinline__ void scan_chain(const Scan* jobs, int njobs) {
  if (threadIdx.x & 31) return;
  int w = threadIdx.x >> 5;
  for (int k = 0; k < njobs; ++k) {
    const Scan& s = jobs[k];
    if (w >= s.parts) { w -= s.parts; continue; }
    const int nchunks = scan_chunks(s);
    double* chain = s.chain + static_cast<size_t>(w) * nchunks * (s.log_c + 1);
    switch (s.log_c) {
      case 5: chain_part<5>(chain, nchunks); break;
      case 6: chain_part<6>(chain, nchunks); break;
      case 7: chain_part<7>(chain, nchunks); break;
      case 8: chain_part<8>(chain, nchunks); break;
      case 9: chain_part<9>(chain, nchunks); break;
      default: chain_part<10>(chain, nchunks);
    }
    return;
  }
}

// Scans ``njobs`` jobs at once with a block of kThreads threads, their chains
// side by side (a job's parts at most kThreads / 32 in all); a job's in and
// out may alias.  The jobs from ``late`` on write their prefixes after the
// others' are written, so one of them may overwrite another's input.
template <int kThreads>
__device__ void scan_jobs(const Scan* jobs, int njobs, int late) {
  scan_pass<kThreads>(jobs, 0, njobs, false);
  __syncthreads();
  scan_chain(jobs, njobs);
  __syncthreads();
  scan_pass<kThreads>(jobs, 0, late, true);
  __syncthreads();
  if (late < njobs) {
    scan_pass<kThreads>(jobs, late, njobs, true);
    __syncthreads();
  }
}

// A job over ``n`` elements of ``parts`` parts with ATen's chunk
// 2^(log_x + 1), its lanes from ``lane0``; returns the next job's first lane.
// ``chain`` advances past it.
__device__ int make_scan(Scan& s, const float* in, float* out, int parts, int n, int log_x,
                         double*& chain, int lane0) {
  s.in = in;
  s.out = out;
  s.parts = parts;
  s.n = n;
  s.log_c = log_x + 1;
  s.log_e = max(3, s.log_c - 5);
  s.chain = chain;
  const int nchunks = scan_chunks(s);
  chain += static_cast<size_t>(parts) * nchunks * (s.log_c + 1);
  const int lanes = nchunks << (s.log_c - s.log_e);
  s.lane0 = lane0;
  s.lanes = (lanes + 31) & ~31;
  return lane0 + s.lanes;
}

// ---------------------------------------------------------------------------
// Launches

// Lets a kernel take ``bytes`` of dynamic shared memory where a launch asks
// for more than 48 KB: the attribute raised once for each kernel, device and
// larger size.
template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;
  std::lock_guard<std::mutex> lock(mu);
  int& have = allowed[{reinterpret_cast<const void*>(kernel), dev}];
  if (bytes <= have) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) have = bytes;
  return static_cast<int>(err);
}

}  // namespace
