// Kernel K1's bf16 build: normalized min-sum LDPC belief propagation for
// NVIDIA Hopper in the arithmetic of the TPU kernel itself.
//
// Replaces ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder as the TPU runs
// it: its gather and scatter matmuls take bfloat16 operands and accumulate
// in float32, so three values are rounded to bfloat16 (nearest even) where
// they read them (ldpc_pallas.py:84-92): the channel LLR at the first
// gather, the posterior at each gather, and each check message entering the
// scatter.  What it computes is ria_tpu/fec/ldpc.py::make_decoder_vf(...,
// precision="bf16") and the port's plain decoder of that precision
// (fec/ldpc.py::LDPCDecoder.plain), bit for bit: the sums, the clamp of
// (rounded gather - float32 c2v), the factor and the check update stay
// float32, and the parity reads the float32 posterior's sign, as the
// reference's bf16 mode does.
//
// Layout and schedule are those of K1's float32 build (csrc/ldpc_bp.cu,
// whose notes this file does not repeat): one block of 512 threads per
// codeword, thread c owns check c and one or two variable jobs, messages
// stored in CSC order straight into the cells their variable sums, two
// barriers an iteration with the next check update run before the vote,
// sentinel edges with no mask tests, the row brought in by one bulk copy,
// 32 registers a thread so that 4 blocks share an SM.  What bounds it is
// the same: the instructions each iteration issues (at the A/B point 4
// blocks share an SM's schedulers) and their latency (the serial floor).
// A first bf16 build (git 137700e) compiled that source with a rounding
// wherever the TPU kernel's matmuls read a value, 16 of them on the
// heaviest variable's chain of adds and one per edge at each gather, and
// ran 4-9% slower than the float32 build.  This design takes every
// rounding off the variable pass's chain, from one fact: a check's messages
// take two magnitudes, m1f = min1 x factor and m2f = min2 x factor, each
// with a sign, and rounding to nearest even is symmetric in sign.  So:
//   - Round at the store.  The check update rounds m1f and m2f once (one
//     conversion packs both) and stores each message as bfloat16 bits with
//     its sign flipped in: that message rounded, bit for bit.  The messages
//     are 2 bytes, 8 to a 16-byte cell (ldpc_kernel.k1_layout(..., "bf16")),
//     and a variable of at most 2 edges (R1_4's 486 of degree 1) is a word
//     job: its messages fill one 4-byte word.  The variable pass converts
//     each lane exactly (a shift) and sums in ascending edge order from
//     0.0, as K1 does; the heaviest variable at R1_4 loads 2 cells where the
//     float32 build loads 4, a degree-1 variable one word where it loads a
//     cell.  Zero lanes are +0.0 and change no bit of the sum.
//   - Recompute the float32 message in the gather.  g - c2v takes the
//     unrounded message, which the cells no longer hold: the owner keeps
//     its check's state (m1f, m2f, the first argmin and the sign bits) in 3
//     registers from the update to the next gather, and rebuilds each c2v
//     from it, where the float32 build loads each edge's message back.  The
//     products are those the update formed with __fmul_rn, so no multiply
//     remains to be fused into g - c2v.  (Kept in shared memory instead, the
//     state's 128-bit load and store cost more than they saved: 4% slower
//     at the A/B point, measured.)
//   - Round each posterior once.  The variable pass writes the float32
//     posterior (the output) and, n + 4 floats on, its bfloat16 rounding as
//     a float32, which every gather reads instead of rounding it per edge.
//     The parity reads the rounded value's sign bit: it is the float32
//     posterior's, since rounding to nearest even keeps the sign and a
//     posterior llr + s, its sum s started from +0.0, is never -0.0.
//   - The sentinel: variable n reads +inf in both arrays, and its message
//     rebuilt from the state is finite, so +inf - c2v still clamps to 50;
//     its stores go to a trash cell that no job sums.
//
// Shared memory (bytes): the float32 posteriors [n + 4] (the channel LLR
// until the first variable pass; +inf at n), their roundings [n + 4] (+inf
// at n), the bfloat16 messages [slots + 8] (the last cell takes no-edge
// stores): 12.1 KB a block at R1_4.  Each owner keeps its edges in
// registers as byte offsets: of its variable's rounded posterior from post
// | of its message slot << 16.

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
  float m1f, m2f;   // min1 x factor, min2 x factor (unrounded)
  unsigned bits;    // the first argmin | the message sign bits << 8
};

// Cell q of a job is 16-byte cell first + q * stride of the message array;
// a word job (0 cells) has 4-byte word first.
__device__ __forceinline__ uint4* job_cells(int job, unsigned short* msgs) {
  return reinterpret_cast<uint4*>(msgs) + field(job, 15, 16);
}
__device__ __forceinline__ unsigned& job_word(int job, unsigned short* msgs) {
  return reinterpret_cast<unsigned*>(msgs)[field(job, 15, 16)];
}

// Zero the job's cells or word: their lanes that hold no message stay +0.
__device__ __forceinline__ void zero_cells(int job, unsigned short* msgs, int stride) {
  if (job < 0) return;
  const int cells = field(job, 10, 5);
  if (cells == 0) job_word(job, msgs) = 0u;
  uint4* cell = job_cells(job, msgs);
  for (int q = 0; q < cells; ++q) cell[q * stride] = make_uint4(0u, 0u, 0u, 0u);
}

// post[v] = llr + the variable's messages, in ascending edge order, and its
// rounding n + 4 floats on.
__device__ __forceinline__ void variable_sum(int job, float llr, unsigned short* msgs, int stride,
                                             float* post, int n) {
  if (job < 0) return;
  const int cells = field(job, 10, 5);
  float s = 0.0f;
  if (cells == 0) {
    const unsigned w = job_word(job, msgs);
    s += lo(w);
    s += hi(w);
  } else {
    const uint4* cell = job_cells(job, msgs);
#pragma unroll 1
    for (int q = 0; q < cells; ++q) {
      const uint4 a = cell[q * stride];
      s += lo(a.x);
      s += hi(a.x);
      s += lo(a.y);
      s += hi(a.y);
      s += lo(a.z);
      s += hi(a.z);
      s += lo(a.w);
      s += hi(a.w);
    }
  }
  const unsigned v = field(job, 0, 10);
  const float p = llr + s;
  post[v] = p;
  post[n + 4 + v] = rounded(p);
}

// The check update, streamed over the owner's edges in ascending slot order
// (K1's: the same comparisons in the same order), then emit() keeps the
// state and stores each message, rounded, to its CSC slot.
struct MinSum {
  float min1 = INFINITY, min2 = INFINITY;
  unsigned amin = kMaxDeg, sign = 0u;

  __device__ __forceinline__ void absorb(float v2c, int d) {
    const float a = fabsf(v2c);
    const bool lower = a < min1;
    const float second = fminf(min2, a);
    min2 = lower ? min1 : second;
    min1 = fminf(min1, a);
    amin = lower ? static_cast<unsigned>(d) : amin;
    if (v2c < 0.0f) sign |= 1u << d;
  }

  // c2v(d) = +-(min x factor): __fmul_rn is never fused into an FMA, and
  // the rounding of -x is the rounding of x with its sign bit flipped.
  __device__ __forceinline__ void emit(const unsigned (&edge)[kMaxDeg], float fac,
                                       unsigned short* msgs, State& state) const {
    const float m1f = __fmul_rn(min1, fac);
    const float m2f = __fmul_rn(min2, fac);
    // Bit d: c2v(d) is negative (the sign product without edge d's sign).
    const unsigned odd = sign ^ ((__popc(sign) & 1) ? (1u << kMaxDeg) - 1u : 0u);
    state = State{m1f, m2f, amin | odd << 8};
    const __nv_bfloat162 r = __floats2bfloat162_rn(m1f, m2f);
    const unsigned r1 = __bfloat16_as_ushort(r.x), r2 = __bfloat16_as_ushort(r.y);
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      const unsigned mag = d == static_cast<int>(amin) ? r2 : r1;
      at<unsigned short>(msgs, field(edge[d], 16, 16)) =
          static_cast<unsigned short>(mag ^ ((odd >> d) & 1u) << 15);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 4)
ldpc_bp_bf16_kernel(const float* __restrict__ llr, const float* __restrict__ factors,
                    const short* __restrict__ row, const short* __restrict__ epos,
                    const int* __restrict__ jobs, float* __restrict__ llr_out,
                    unsigned char* __restrict__ info_out, unsigned char* __restrict__ ok_out,
                    int* __restrict__ iters_out, int n, int m, int k, int D, int slots,
                    int stride, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* post = smem;  // [n + 4], then the rounded posteriors [n + 4]
  unsigned short* msgs = reinterpret_cast<unsigned short*>(smem + 2 * (n + 4));
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
        "[%3];" ::"r"(smem_u32(post)),
        "l"(llr + static_cast<size_t>(b) * n), "r"(bytes), "r"(bar)
        : "memory");
  }

  // While the row flies: the owner's edges (a slot with no edge holds the
  // sentinel), the thread's jobs, its zeroed cells.
  const bool owner = tid < m;
  // Byte offsets: of the variable's rounded posterior in post | of the
  // message slot in msgs << 16.
  unsigned edge[kMaxDeg];
#pragma unroll
  for (int d = 0; d < kMaxDeg; ++d) {
    unsigned v = static_cast<unsigned>(n), e = static_cast<unsigned>(slots);
    if (owner && d < D) {
      v = static_cast<unsigned short>(row[d * m + tid]);
      e = static_cast<unsigned short>(epos[d * m + tid]);
    }
    edge[d] = (static_cast<unsigned>(n) + 4u + v) * 4u | (e * 2u) << 16;
  }
  const int job0 = jobs[tid];
  const int job1 = jobs[kThreads + tid];
  const float fac = factors[b];
  zero_cells(job0, msgs, stride);
  zero_cells(job1, msgs, stride);
  if (tid == 0) {
    post[n] = INFINITY;
    post[2 * n + 4] = INFINITY;
    reinterpret_cast<uint4*>(msgs)[slots / 8] = make_uint4(0u, 0u, 0u, 0u);
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
  const float llr0 = job0 < 0 ? 0.0f : post[field(job0, 0, 10)];
  const float llr1 = job1 < 0 ? 0.0f : post[field(job1, 0, 10)];

  // Check update of iteration 1 from the channel LLRs gathered and rounded.
  State st{0.0f, 0.0f, 0u};
  if (owner && max_iters > 0) {
    MinSum acc;
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d)
      acc.absorb(rounded(at<float>(post, field(edge[d], 0, 16) - (n + 4) * 4u)), d);
    acc.emit(edge, fac, msgs, st);
  }
  __syncthreads();  // messages of iteration 1 published

  int iters = 0;
  int ok = 0;
  for (int it = 0; it < max_iters; ++it) {
    // 1. Posteriors: channel LLR + the variable's cells, and their rounding.
    variable_sum(job0, llr0, msgs, stride, post, n);
    variable_sum(job1, llr1, msgs, stride, post, n);
    __syncthreads();

    // 2. Gather onto each edge: v2c from the rounded posterior and the
    //    float32 c2v rebuilt from the state, the parity and the running
    //    min-sum.
    unsigned parity = 0u;
    MinSum acc;
    if (owner) {
      const unsigned amin = st.bits & 0xffu;
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        const float g = at<float>(post, field(edge[d], 0, 16));
        const float mag = d == static_cast<int>(amin) ? st.m2f : st.m1f;
        const float c2v = (st.bits >> (8 + d)) & 1u ? -mag : mag;
        acc.absorb(fminf(fmaxf(g - c2v, -kClamp), kClamp), d);
        parity ^= __float_as_uint(g);  // bit 31: the xor of the posteriors' signs
      }
      parity >>= 31;
    }
    iters = it + 1;
    const bool next = owner && it + 1 < max_iters;
    // 3. The next iteration's check update and the block-wide OR of the
    //    syndromes, as in the float32 build.
    if (it == 0) {
      if (!__syncthreads_or(static_cast<int>(parity))) {
        ok = 1;
        break;
      }
      if (next) acc.emit(edge, fac, msgs, st);
      __syncthreads();
    } else {
      if (next) acc.emit(edge, fac, msgs, st);
      if (!__syncthreads_or(static_cast<int>(parity))) {
        ok = 1;
        break;
      }
    }
  }

  float* out = llr_out + static_cast<size_t>(b) * n;
  for (int v = tid; v < n; v += kThreads) out[v] = post[v];
  unsigned char* info = info_out + static_cast<size_t>(b) * k;
  for (int v = tid; v < k; v += kThreads) info[v] = post[v] < 0.0f ? 1 : 0;
  if (tid == 0) {
    ok_out[b] = static_cast<unsigned char>(ok);
    iters_out[b] = iters;
  }
}

size_t smem_bytes(int n, int slots) {
  return static_cast<size_t>(2 * (n + 4)) * sizeof(float) +
         static_cast<size_t>(slots + 8) * sizeof(unsigned short);
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is synchronised or allocated.
// `llr` must be 16-byte aligned (the bulk copy's rule); n a multiple of 4;
// the tables those of ldpc_kernel.k1_layout(..., "bf16").
extern "C" int ria_ldpc_bp_bf16_decode(const float* llr, const float* factors, const short* row,
                                       const short* epos, const int* jobs, float* llr_out,
                                       unsigned char* info_out, unsigned char* ok_out,
                                       int* iters_out, int B, int n, int m, int k, int D,
                                       int slots, int stride, int max_iters,
                                       cudaStream_t stream) {
  if (B <= 0 || n <= 0 || n % 4 != 0 || n > 1023 || m <= 0 || m > kThreads || D <= 0 ||
      D > kMaxDeg || k < 0 || k > n || max_iters < 0 || slots <= 0 || slots % 8 != 0 ||
      slots > 32760 || stride < 0 || stride > kThreads ||
      reinterpret_cast<uintptr_t>(llr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, slots);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(ldpc_bp_bf16_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ldpc_bp_bf16_kernel<<<B, kThreads, smem, stream>>>(llr, factors, row, epos, jobs, llr_out,
                                                     info_out, ok_out, iters_out, n, m, k, D,
                                                     slots, stride, max_iters);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled kernel uses for a code of n variables and `slots`
// message slots: out[0] registers per thread, out[1] local (spill) bytes per
// thread, out[2] shared bytes per block, out[3] blocks resident per SM.
extern "C" int ria_ldpc_bp_bf16_resources(int n, int slots, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ldpc_bp_bf16_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(n, slots);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ldpc_bp_bf16_kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = blocks;
  return 0;
}
