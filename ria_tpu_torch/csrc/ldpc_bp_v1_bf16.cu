// Kernel K2's bf16 build: normalized min-sum LDPC belief propagation for
// NVIDIA Hopper, in the per-degree-slot form and in the arithmetic of the
// TPU kernel itself.
//
// Replaces ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder_v1 as the TPU
// runs it: bfloat16 (nearest even) where that kernel rounds -- the factor,
// once a block (ldpc_pallas.py:264-265); the channel LLRs at the first
// gather and the posteriors at every gather (:256-259, :316, :335), so that
// both g - c2v and the parity read the rounded g; each check message
// entering the scatter (:267-274).  The clamp, the sums and the check
// update stay float32.  What it computes is fec/ldpc.py::plain_v1 with
// precision="bf16", bit for bit: K2's two-pass tie-count update and its
// slot-group sums, llr + (((0 + s_0) + s_1) + ... + s_6), each s_d from 0.0
// in ascending check order.
//
// Layout and schedule are those of K2's float32 build (csrc/ldpc_bp_v1.cu,
// whose notes this file does not repeat, with every lever at its design
// value): one block of 512 threads per codeword, thread c owns check c and
// one or two variable jobs, each owner's edges in registers, messages stored
// in the order they are summed, sentinel edges, two barriers an iteration
// with the next check update run before the vote, the v2c in registers
// between the update's two passes, the row brought in by one bulk copy, 32
// registers a thread so that 4 blocks share an SM.  A first bf16 build (git
// 137700e) compiled that source with a rounding wherever the TPU kernel
// rounds, 28 of them on the heaviest variable's chain of adds and one per
// edge at each gather, and ran 6-20% slower than the float32 build.  This
// design takes every rounding off the variable pass's chain, from one fact:
// a check's messages take two magnitudes, m1f = min1 x factor and tief
// (min1 or min2 by the tie count, x factor), each with a sign, and rounding
// to nearest even is symmetric in sign.  So:
//   - Round at the store.  The update rounds m1f and tief once (one
//     conversion packs both) and stores each message as bfloat16 bits with
//     its sign flipped in: that message rounded, bit for bit.  The messages
//     keep K2's 4-slot units, a slot group starting a fresh unit, two units
//     to a 16-byte cell (ldpc_kernel.k2_layout(..., "bf16")), so a group
//     closes at the middle or the end of a cell and the heaviest variable at
//     R1_4 loads 4 cells where the float32 build loads 7; a variable of at
//     most 2 edges is a word job, one 4-byte word (the sum of 1 or 2
//     messages does not depend on their grouping).  Each lane is converted
//     exactly by a shift; the zero lanes add +0.0 to a sum that started from
//     +0.0 and change no bit.
//   - Recompute the float32 message in the gather.  g - c2v takes the
//     unrounded message: the owner keeps its check's state (m1f, tief, the
//     bits of the slots equal to min1 and the sign bits) in 3 registers from
//     the update to the next gather and rebuilds each c2v from it.  The
//     products are those the update formed with __fmul_rn, so no multiply
//     remains to be fused into g - c2v (an FMA there would be the
//     interpreted Pallas K2's contraction, not plain_v1).  The registers
//     come from the channel LLRs, read from shared memory in the variable
//     pass, and the factor, read and rounded in the update (with either in
//     registers the build spills).
//   - Round each posterior once, where the variable pass writes it, into a
//     float32 array the gather reads, with +0.0 added: that turns a rounded
//     -0.0 (a posterior in (-2**-134, 0)) into +0.0 and changes no other
//     value.  K2 reads the rounded g's sign as g < 0 (false for -0.0), in
//     the parity and, through v2c = g - c2v, in the check's sign bits; with
//     no -0.0 among the g, nor then among the v2c (a difference is -0.0
//     only from -0.0), both are sign bits, read without a compare.  Where
//     g or c2v is a zero, g - c2v and its clamp are the same value either
//     way.
//   - The sentinel: variable n reads +inf in both arrays and its message
//     rebuilt from the state is finite, so +inf - c2v still clamps to 50;
//     its stores go to a trash cell that no job sums.
//
// Shared memory (bytes from its start, the offsets every table holds): the
// channel LLRs [n + 4] (+inf at n), the float32 posteriors [n + 4], their
// roundings [n + 4] (+inf at n), the bfloat16 messages [slots + 8] (the
// last cell takes no-edge stores): 19.7 KB a block at R1_4.  A job packs v
// | first << 10 | ends << 23: its first cell (16 bytes) and bit u of ends
// set where unit u closes a group, or, with no ends, its word (4 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;   // one thread per check; m <= 486 for every rate
constexpr int kMaxDeg = 7;      // check degree D = 7 for every rate
constexpr float kClamp = 50.0f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bits [pos, pos + len) of x.  Opaque to the compiler, so that it unpacks a
// packed table word where it is used instead of hoisting every field out of
// the iteration loop into registers of its own.
__device__ __forceinline__ unsigned field(unsigned x, unsigned pos, unsigned len) {
  unsigned r;
  asm volatile("bfe.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(pos), "r"(len));
  return r;
}

// Byte offsets in shared memory: the channel LLR [n + 4] at 0, the
// posteriors [n + 4], their roundings [n + 4] (floats), the messages
// [slots + 8] (bfloat16); the end.
__host__ __device__ __forceinline__ unsigned post_base(int n) { return 4u * (n + 4); }
__host__ __device__ __forceinline__ unsigned postr_base(int n) { return 8u * (n + 4); }
__host__ __device__ __forceinline__ unsigned msg_base(int n) { return 12u * (n + 4); }
__host__ __device__ __forceinline__ unsigned smem_end(int n, int slots) {
  return msg_base(n) + 2u * (slots + 8);
}

// The T `bytes` bytes into `base` (a shared array).
template <typename T>
__device__ __forceinline__ T& at(void* base, unsigned bytes) {
  return *reinterpret_cast<T*>(reinterpret_cast<char*>(base) + bytes);
}

// The float32 value of bfloat16 bits in the low or high half of a word:
// exact.
__device__ __forceinline__ float lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// x rounded to bfloat16, nearest even: its bits, and their float32 value.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rounded(float x) { return lo(bf16_bits(x)); }

// A check's state between its update and the next gather, in registers.
struct State {
  float m1f, tief;  // min1 x factor; the tied slots' magnitude x factor (unrounded)
  unsigned bits;    // bit d: |v2c(d)| == min1 | bit 8 + d: c2v(d) < 0
};

// Table slot d of check `tid`: the byte offsets from the start of shared
// memory of its variable's rounded posterior and of its message slot
// (<< 16); the sentinel variable n and the trash slot where the check has
// no edge.
__device__ __forceinline__ unsigned edge_word(const short* row, const short* epos, int d, int D,
                                              int m, int tid, int n, int slots) {
  unsigned v = static_cast<unsigned>(n), e = static_cast<unsigned>(slots);
  if (tid < m && d < D) {
    v = static_cast<unsigned short>(row[d * m + tid]);
    e = static_cast<unsigned short>(epos[d * m + tid]);
  }
  return (postr_base(n) + 4u * v) | (msg_base(n) + 2u * e) << 16;
}

// Zero the job's cells or word: their lanes that hold no message stay +0.
// The job's first cell (16 bytes) or, with no ends, its word (4 bytes) is
// field 10..22, from the start of shared memory.
__device__ __forceinline__ void zero_cells(int job, char* smem, int stride) {
  if (job < 0) return;
  unsigned ends = field(job, 23, 8);
  if (!ends) at<unsigned>(smem, 4u * field(job, 10, 13)) = 0u;
  uint4* cell = reinterpret_cast<uint4*>(smem) + field(job, 10, 13);
  for (; ends; ends >>= 2, cell += stride) *cell = make_uint4(0u, 0u, 0u, 0u);
}

// post[v] = llr + (((0 + s_0) + s_1) + ...): each slot group summed from
// 0.0 in stored (ascending check) order, closed at the unit its ends bit
// marks; and its rounding.  The channel LLR is read from shared memory, to
// keep registers for the state.
__device__ __forceinline__ void variable_sum(int job, char* smem, int stride, int n) {
  // No job: its sign bit, tested where it is used (field() is opaque), so
  // that no predicate is kept across the iteration, which would spill.
  if (field(job, 31, 1)) return;
  const uint4* cell = reinterpret_cast<const uint4*>(smem) + field(job, 10, 13);
  float acc = 0.0f, s = 0.0f;
  unsigned ends = field(job, 23, 8);
  if (!ends) {  // a word job: one or two messages, whose sum no grouping changes
    const unsigned w = at<unsigned>(smem, 4u * field(job, 10, 13));
    acc += lo(w);
    acc += hi(w);
  }
#pragma unroll 1
  for (; ends; ends >>= 2, cell += stride) {
    const uint4 a = *cell;
    s += lo(a.x);
    s += hi(a.x);
    s += lo(a.y);
    s += hi(a.y);
    if (ends & 1u) {
      acc += s;
      s = 0.0f;
    }
    s += lo(a.z);
    s += hi(a.z);
    s += lo(a.w);
    s += hi(a.w);
    if (ends & 2u) {
      acc += s;
      s = 0.0f;
    }
  }
  const unsigned v = 4u * field(job, 0, 10);
  const float p = at<float>(smem, v) + acc;
  at<float>(smem, post_base(n) + v) = p;
  at<float>(smem, postr_base(n) + v) = rounded(p) + 0.0f;  // -0.0 -> +0.0
}

__global__ void __launch_bounds__(kThreads, 4)
ldpc_bp_v1_bf16_kernel(const float* __restrict__ llr, const float* __restrict__ factors,
                       const short* __restrict__ row, const short* __restrict__ epos,
                       const int* __restrict__ jobs, float* __restrict__ llr_out,
                       unsigned char* __restrict__ info_out, unsigned char* __restrict__ ok_out,
                       int* __restrict__ iters_out, int n, int m, int k, int D, int slots,
                       int stride, int max_iters) {
  extern __shared__ __align__(16) char smem[];
  float* chan = reinterpret_cast<float*>(smem);
  __shared__ __align__(8) uint64_t row_ready;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const uint32_t bar = smem_u32(&row_ready);
  if (tid == 0) {
    const unsigned bytes = static_cast<unsigned>(n) * sizeof(float);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_u32(chan)),
        "l"(llr + static_cast<size_t>(b) * n), "r"(bytes), "r"(bar)
        : "memory");
  }

  // While the row flies: the owner's edges, the thread's jobs (their cells
  // rebased to the start of shared memory), its zeroed cells.
  const bool owner = tid < m;
  unsigned edge[kMaxDeg];
#pragma unroll
  for (int d = 0; d < kMaxDeg; ++d) edge[d] = edge_word(row, epos, d, D, m, tid, n, slots);
  float v2c[kMaxDeg];
  // Cells and words rebased to the start of shared memory.
  const int cell_base = static_cast<int>(msg_base(n) / 16) << 10;
  const int word_base = static_cast<int>(msg_base(n) / 4) << 10;
  int job0 = jobs[tid];
  int job1 = jobs[kThreads + tid];
  job0 += job0 < 0 ? 0 : field(job0, 23, 8) ? cell_base : word_base;
  job1 += job1 < 0 ? 0 : field(job1, 23, 8) ? cell_base : word_base;
  zero_cells(job0, smem, stride);
  zero_cells(job1, smem, stride);
  if (tid == 0) {
    chan[n] = INFINITY;
    at<float>(smem, postr_base(n) + 4u * n) = INFINITY;
    at<uint4>(smem, msg_base(n) + 2u * slots) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();  // zeroed messages, the sentinels and the initialised mbarrier
  {
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar)
          : "memory");
  }

  // Pass 2 of the check update over the owner's v2c (pass 1 gave min1 and
  // the sign bits), then the state and each c2v = +-(excl x factor),
  // rounded, to its message slot: (+-1 x excl) x factor rounds the same, as
  // negation is exact, and __fmul_rn is never fused into an FMA.  The
  // factor is read (and rounded) where it is used, to keep a register.
  State st{0.0f, 0.0f, 0u};
  auto update = [&](float min1, unsigned sign) {
    const float fac = rounded(factors[b]);
    unsigned is_min = 0u;  // bit d: |v2c(d)| == min1
    float min2 = INFINITY;
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      const float a = fabsf(v2c[d]);
      if (a == min1)
        is_min |= 1u << d;
      else
        min2 = fminf(min2, a);
    }
    const float m1f = __fmul_rn(min1, fac);
    const float tief = __fmul_rn(__popc(is_min) > 1 ? min1 : min2, fac);
    // Bit d: c2v(d) is negative (the sign parity without edge d's sign).
    const unsigned odd = sign ^ ((__popc(sign) & 1) ? (1u << kMaxDeg) - 1u : 0u);
    st = State{m1f, tief, is_min | odd << 8};
    const __nv_bfloat162 r = __floats2bfloat162_rn(m1f, tief);
    const unsigned r1 = __bfloat16_as_ushort(r.x), rt = __bfloat16_as_ushort(r.y);
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      const unsigned mag = (is_min >> d) & 1u ? rt : r1;
      at<unsigned short>(smem, field(edge[d], 16, 16)) =
          static_cast<unsigned short>(mag ^ ((odd >> d) & 1u) << 15);
    }
  };

  // Check update of iteration 1 from the channel LLRs gathered and rounded.
  if (owner && max_iters > 0) {
    float min1 = INFINITY;
    unsigned sign = 0u;
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      const float x = rounded(at<float>(smem, field(edge[d], 0, 16) - postr_base(n)));
      v2c[d] = x;
      min1 = fminf(min1, fabsf(x));
      if (x < 0.0f) sign |= 1u << d;
    }
    update(min1, sign);
  }
  __syncthreads();  // messages of iteration 1 published

  int iters = 0;
  int ok = 0;
  for (int it = 0; it < max_iters; ++it) {
    // 1. Posteriors: channel LLR + the variable's slot groups, and their
    //    rounding.
    variable_sum(job0, smem, stride, n);
    variable_sum(job1, smem, stride, n);
    __syncthreads();

    // 2. Gather onto each edge: v2c from the rounded posterior and the
    //    float32 c2v rebuilt from the state, the parity and pass 1 (min1,
    //    signs).
    unsigned parity = 0u, sign = 0u;
    float min1 = INFINITY;
    if (owner) {
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        const float g = at<float>(smem, field(edge[d], 0, 16));
        const float mag = (st.bits >> d) & 1u ? st.tief : st.m1f;
        const float c2v = (st.bits >> (8 + d)) & 1u ? -mag : mag;
        const float x = fminf(fmaxf(g - c2v, -kClamp), kClamp);
        v2c[d] = x;
        parity ^= __float_as_uint(g);  // bit 31: g < 0, as g is never -0.0
        min1 = fminf(min1, fabsf(x));
        sign |= (__float_as_uint(x) >> 31) << d;  // x < 0, as x is never -0.0
      }
    }
    parity >>= 31;
    iters = it + 1;
    const bool next = owner && it + 1 < max_iters;
    // 3. The next iteration's check update and the block-wide OR of the
    //    syndromes, as in the float32 build: iteration 1 votes first, later
    //    ones update speculatively before the vote.
    if (it == 0) {
      if (!__syncthreads_or(static_cast<int>(parity))) {
        ok = 1;
        break;
      }
      if (next) update(min1, sign);
      __syncthreads();
    } else {
      if (next) update(min1, sign);
      if (!__syncthreads_or(static_cast<int>(parity))) {
        ok = 1;
        break;
      }
    }
  }

  // No iteration leaves the channel LLR.
  const float* post = reinterpret_cast<float*>(smem + (max_iters > 0 ? post_base(n) : 0u));
  float* out = llr_out + static_cast<size_t>(b) * n;
  for (int v = tid; v < n; v += kThreads) out[v] = post[v];
  unsigned char* info = info_out + static_cast<size_t>(b) * k;
  for (int v = tid; v < k; v += kThreads) info[v] = post[v] < 0.0f ? 1 : 0;
  if (tid == 0) {
    ok_out[b] = static_cast<unsigned char>(ok);
    iters_out[b] = iters;
  }
}

size_t smem_bytes(int n, int slots) { return smem_end(n, slots); }

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is synchronised or allocated.
// `llr` must be 16-byte aligned (the bulk copy's rule); n a multiple of 4;
// the tables those of ldpc_kernel.k2_layout(..., "bf16").
extern "C" int ria_ldpc_bp_v1_bf16_decode(const float* llr, const float* factors,
                                          const short* row, const short* epos, const int* jobs,
                                          float* llr_out, unsigned char* info_out,
                                          unsigned char* ok_out, int* iters_out, int B, int n,
                                          int m, int k, int D, int slots, int stride,
                                          int max_iters, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || n % 4 != 0 || n > 1023 || m <= 0 || m > kThreads || D <= 0 ||
      D > kMaxDeg || k < 0 || k > n || max_iters < 0 || slots <= 0 || slots % 8 != 0 ||
      smem_end(n, slots) > 65535 || msg_base(n) / 4 + slots / 2 > 8191 || stride < 0 ||
      stride > kThreads || reinterpret_cast<uintptr_t>(llr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, slots);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ldpc_bp_v1_bf16_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ldpc_bp_v1_bf16_kernel<<<B, kThreads, smem, stream>>>(llr, factors, row, epos, jobs, llr_out,
                                                        info_out, ok_out, iters_out, n, m, k,
                                                        D, slots, stride, max_iters);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled kernel uses for a code of n variables and `slots`
// message slots: out[0] registers per thread, out[1] local (spill) bytes per
// thread, out[2] shared bytes per block, out[3] blocks resident per SM.
extern "C" int ria_ldpc_bp_v1_bf16_resources(int n, int slots, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ldpc_bp_v1_bf16_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(n, slots);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ldpc_bp_v1_bf16_kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = blocks;
  return 0;
}
