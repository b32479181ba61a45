// Kernel K1: normalized min-sum LDPC belief propagation for NVIDIA Hopper.
//
// Replaces ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder, the Pallas TPU
// kernel that runs the whole BP loop per 128-row tile with its messages
// resident in VMEM.  What it computes is ria_tpu/fec/ldpc.py::make_decoder_vf
// in float32, exactly:
//   - per-row min-sum factor; check update = sign product x (min1, or min2 on
//     the slot holding the first minimum, duplicates counted) x factor;
//   - posterior = channel LLR + sum of check messages on the variable;
//   - v2c = clamp(posterior gathered onto the edge - c2v, +-50); the initial
//     v2c is the channel LLR gathered, unclamped;
//   - syndrome from the signs of the gathered posteriors; no check before
//     iteration 1, so an all-zero row reports iterations = 1;
//   - a converged codeword freezes: its posterior and iteration count are
//     those of the converging iteration, else those of iteration max_iters;
//   - variables with no edges (161 in R3_4, 323 in R5_6) keep their channel
//     LLR.
// The TPU kernel's one-hot gather/scatter matmuls exist only to work around
// Mosaic's lowering limits; here gathers and the scatter are plain index
// loads from shared memory.  The tensor cores (wgmma) do not apply: the work
// is gathers, compares and exact f32 adds, with no product to feed them.
//
// Two builds of this source.  By default everything is float32.  Built with
// -DRIA_BF16_OPERANDS, it computes make_decoder_vf(..., precision="bf16"),
// the TPU kernel's own arithmetic: its matmuls take bfloat16 operands and
// accumulate in float32, so three values are rounded to bfloat16 (nearest
// even) where those matmuls read them, by operand(): the channel LLR at the
// first gather, the posterior at each gather, and each c2v as the variable
// sum adds it.  The sums, the clamp of (rounded gather - float32 c2v) and the
// factor stay float32, and the parity reads the float32 posterior's sign, as
// the reference's bf16 mode does (the TPU kernel reads the rounded gather's;
// the two differ only for |LLR| below bfloat16's smallest subnormal).  The
// plain PyTorch decoder of the same precision rounds at the same places, so
// each build equals it bit for bit.
//
// Layout: one thread block per codeword, 512 threads.  Thread c owns check c
// (m <= 486 for every rate) and one or two variable "jobs".  Shared memory
// holds the posteriors [n] and the check->variable messages in CSC order:
// each variable's messages in ascending edge order in 4-float cells, the
// last one padded with zeros (20.8 KB a block at R1_4).  The host builds,
// once per code (fec/ldpc_kernel.py::k1_layout), int16 tables [D][m] of each
// check's variables and message slots (the sentinel n / `slots` where a
// check has no edge) and the jobs [2][512] int32 (v | cells << 10 | first
// cell << 15).  Each owner loads its 7 (variable, slot) pairs once, from the
// [D][m] layout in coalesced loads, into registers as byte offsets.
//
// What bounds it on this card.  Not device-memory bytes or FLOPs: a
// codeword's state never leaves shared memory; a launch moves ~1.4 MB and
// does ~9 MOP at the main path's 256 codewords and 1 iteration.  What bounds
// it is the instructions each iteration issues (several blocks share an
// SM's four schedulers) and their latency (a codeword's iterations are
// sequential; one block alone takes ~1 us an iteration), and at 1 iteration
// the launch and the prologue.  What the design does about each:
//   - No indirection in the variable pass.  The owner stores each c2v
//     straight to its CSC slot, so a variable sums its own cells with
//     128-bit loads that do not depend on each other.  Cell q of a job is
//     cell first + q * stride, so a warp's loads touch neighbouring cells
//     and do not conflict.  The sum runs in ascending edge order from 0.0;
//     zero lanes before (a light variable starts on a lane that spreads
//     banks) or after its messages change no bit of it, so posteriors are
//     bit-identical to summing the variable's messages through a CSC index
//     list in edge order.
//   - A balanced variable pass: the host gives each thread the heaviest
//     remaining variable and, to the threads with the lightest, a second
//     light one, so no thread's chain of shared loads per iteration (one
//     per cell) is longer than the heaviest variable's degree: 4 loads at
//     R1_4, whose heaviest variable has 13 edges.
//   - Two barriers an iteration, where the plain schedule (check update |
//     variable pass | gather + parity | OR-vote) takes three:
//       variable pass | gather + parity + NEXT check update | OR-vote.
//     Hazard argument: after the gather the owner already runs the next
//     iteration's check update in registers and stores its c2v.  No barrier
//     is needed before that store: the messages are read by the variable
//     pass, which every thread finished before the barrier that precedes
//     the gather, and by the owner's own gather, which comes before its
//     store in program order.  The readers of the
//     new c2v (next variable pass) start only after __syncthreads_or, which
//     both publishes the stores and votes on the parities.  post[] is
//     written only in the variable pass, so on convergence the kernel breaks
//     with post[] and iters of the converging iteration, and the speculative
//     c2v are dropped.  Iteration 1 votes before its check update (three
//     barriers), so a codeword that converges at once, as the main path's
//     do, spends no update; the last iteration skips it.
//   - No mask tests: a check slot with no edge reads the sentinel variable
//     n, kept at +inf, and stores to a slot no job sums.  Its |v2c| (+inf
//     at the first gather, 50 after the clamp) is never below a real
//     edge's, so min1 and min2 over the check's >= 2 real edges keep their
//     values (a tie at 50 gives every real edge 50 either way), and its
//     positive sign changes no sign product and no parity.  The update is
//     branch-free (fminf and selects).
//   - 32 registers a thread, no spill: the check update is streamed over
//     the edges (no v2c array); between iterations an owner keeps no
//     message: its gather reads each edge's c2v back from the slot it stored
//     it in, which no other thread writes (the sentinel's shared slot may
//     hold any finite value: +inf minus it clamps to 50); table words are
//     unpacked where used (field()), not hoisted out of the loop.
//   - Every A/B codeword resident: __launch_bounds__(512, 4) holds a thread
//     to those 32 registers, so 4 blocks fit on an SM (65,536 registers) and
//     132 SMs hold 528 codewords, more than the A/B point's 512; shared
//     memory (4 x 20.8 KB) is not the limit.  Larger batches run in waves.
//   - The prologue overlaps its latencies: thread 0 starts the LLR row's
//     copy (2,592 bytes) as one bulk asynchronous copy (cp.async.bulk, the
//     1-D form of the Tensor Memory Accelerator) that completes on an
//     mbarrier, while every thread loads its tables and zeroes its own
//     cells.  The row lands in post[], which is the posterior of iteration
//     0 and the channel LLR the gather of iteration 1 reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#ifdef RIA_BF16_OPERANDS
#include <cuda_bf16.h>
#endif

namespace {

constexpr int kThreads = 512;   // one thread per check; m <= 486 for every rate
constexpr int kMaxDeg = 7;      // check degree D = 7 for every rate
constexpr float kClamp = 50.0f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Bits [pos, pos + len) of x.  Opaque to the compiler, so that it unpacks a
// packed table word where it is used instead of hoisting every field out of
// the iteration loop into registers of its own (which spills at 32).
__device__ __forceinline__ unsigned field(unsigned x, unsigned pos, unsigned len) {
  unsigned r;
  asm volatile("bfe.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(pos), "r"(len));
  return r;
}

// A matmul operand of the TPU kernel: rounded to bfloat16 in the bf16 build,
// unchanged in the float32 one.
__device__ __forceinline__ float operand(float x) {
#ifdef RIA_BF16_OPERANDS
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  return x;
#endif
}

// The float `bytes` bytes into `base` (a shared array).
__device__ __forceinline__ float& at(float* base, unsigned bytes) {
  return *reinterpret_cast<float*>(reinterpret_cast<char*>(base) + bytes);
}

// Cell q of a job is float4 cell first + q * stride of the message array.
__device__ __forceinline__ float4* job_cells(int job, float* c2v_s) {
  return reinterpret_cast<float4*>(c2v_s) + field(job, 15, 13);
}

// Zero the job's cells: their lanes that hold no message stay 0.
__device__ __forceinline__ void zero_cells(int job, float* c2v_s, int stride) {
  if (job < 0) return;
  float4* cell = job_cells(job, c2v_s);
  const int cells = field(job, 10, 5);
  for (int q = 0; q < cells; ++q) cell[q * stride] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// post[v] = llr + the variable's messages, in ascending edge order.
__device__ __forceinline__ void variable_sum(int job, float llr, float* c2v_s, int stride,
                                             float* post) {
  if (job < 0) return;
  const float4* cell = job_cells(job, c2v_s);
  const int cells = field(job, 10, 5);
  float s = 0.0f;
#pragma unroll 1
  for (int q = 0; q < cells; ++q) {
    const float4 a = cell[q * stride];
    s += operand(a.x);
    s += operand(a.y);
    s += operand(a.z);
    s += operand(a.w);
  }
  post[field(job, 0, 10)] = llr + s;
}

// The check update, streamed over the owner's edges in ascending slot order
// so that no v2c array is kept: absorb() takes one v2c (the running two
// minima, the first argmin and each edge's sign bit), then emit() stores
// each c2v to its CSC slot.  Same comparisons, in the same order, as a check
// update over a v2c array; the result does not depend on the order of the
// edges (ties give min2 == min1).
struct MinSum {
  float min1 = INFINITY, min2 = INFINITY;
  unsigned amin = kMaxDeg, sign = 0u;

  // Branch-free: min1 = fminf(min1, a) and min2 = (a < min1 ? min1 :
  // fminf(min2, a)) are what the if/else-if on strict < computes.
  __device__ __forceinline__ void absorb(float v2c, int d) {
    const float a = fabsf(v2c);
    const bool lower = a < min1;
    const float second = fminf(min2, a);
    min2 = lower ? min1 : second;
    min1 = fminf(min1, a);
    amin = lower ? static_cast<unsigned>(d) : amin;
    if (v2c < 0.0f) sign |= 1u << d;
  }

  // c2v(d) = +-(min x factor), rounded as the plain form (+-1 x min) x
  // factor rounds: negation is exact, and __fmul_rn is never fused into an
  // FMA.
  __device__ __forceinline__ void emit(const unsigned (&edge)[kMaxDeg], float fac,
                                       float* c2v_s) const {
    const float m1f = __fmul_rn(min1, fac);
    const float m2f = __fmul_rn(min2, fac);
    // Bit d: c2v(d) is negative (the sign product without edge d's sign).
    const unsigned odd = sign ^ ((__popc(sign) & 1) ? (1u << kMaxDeg) - 1u : 0u);
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      const float mag = d == static_cast<int>(amin) ? m2f : m1f;
      at(c2v_s, field(edge[d], 16, 16)) = (odd >> d) & 1u ? -mag : mag;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 4)
ldpc_bp_kernel(const float* __restrict__ llr, const float* __restrict__ factors,
               const short* __restrict__ row, const short* __restrict__ epos,
               const int* __restrict__ jobs, float* __restrict__ llr_out,
               unsigned char* __restrict__ info_out, unsigned char* __restrict__ ok_out,
               int* __restrict__ iters_out, int n, int m, int k, int D, int slots,
               int stride, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  float* post = smem;             // [n + 4]: channel LLR, then posteriors; +inf at n
  float* c2v_s = smem + n + 4;    // [slots + 4]: messages; the last 4 take no-edge stores
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
  // sentinel, see "No mask tests"), the thread's jobs, its zeroed cells.
  const bool owner = tid < m;
  unsigned edge[kMaxDeg];  // byte offsets: of the variable in post | of the slot << 16
#pragma unroll
  for (int d = 0; d < kMaxDeg; ++d) {
    unsigned v = static_cast<unsigned>(n), e = static_cast<unsigned>(slots);
    if (owner && d < D) {
      v = static_cast<unsigned short>(row[d * m + tid]);
      e = static_cast<unsigned short>(epos[d * m + tid]);
    }
    edge[d] = v * 4u | (e * 4u) << 16;
  }
  const int job0 = jobs[tid];
  const int job1 = jobs[kThreads + tid];
  const float fac = factors[b];
  zero_cells(job0, c2v_s, stride);
  zero_cells(job1, c2v_s, stride);
  if (tid == 0) {
    post[n] = INFINITY;
    reinterpret_cast<float4*>(c2v_s)[slots / 4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();  // zeroed messages, post[n] and the initialised mbarrier
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

  // Check update of iteration 1 from the channel LLRs gathered.
  if (owner && max_iters > 0) {
    MinSum acc;
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) acc.absorb(operand(at(post, field(edge[d], 0, 16))), d);
    acc.emit(edge, fac, c2v_s);
  }
  __syncthreads();  // c2v of iteration 1 published

  int iters = 0;
  int ok = 0;
  for (int it = 0; it < max_iters; ++it) {
    // 1. Posteriors: channel LLR + the variable's CSC segment.
    variable_sum(job0, llr0, c2v_s, stride, post);
    variable_sum(job1, llr1, c2v_s, stride, post);
    __syncthreads();

    // 2. Gather onto each edge: v2c, the parity and the running min-sum.
    unsigned parity = 0u;
    MinSum acc;
    if (owner) {
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        // This iteration's c2v, read back from the slot it was stored in.
        const float g = at(post, field(edge[d], 0, 16));
        const float c2v = at(c2v_s, field(edge[d], 16, 16));
        acc.absorb(fminf(fmaxf(operand(g) - c2v, -kClamp), kClamp), d);
        parity ^= g < 0.0f ? 1u : 0u;
      }
    }
    iters = it + 1;
    const bool next = owner && it + 1 < max_iters;
    // 3. The next iteration's check update and the block-wide OR of the
    //    syndromes; freeze and leave on convergence.  From iteration 2 on the
    //    update runs before the vote, speculatively (see the hazard note);
    //    iteration 1 votes first, so a codeword that converges at once (most
    //    of the main path's) spends no check update it will not use.
    if (it == 0) {
      if (!__syncthreads_or(static_cast<int>(parity))) {
        ok = 1;
        break;
      }
      if (next) acc.emit(edge, fac, c2v_s);
      __syncthreads();
    } else {
      if (next) acc.emit(edge, fac, c2v_s);
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
  return static_cast<size_t>(n + 4 + slots + 4) * sizeof(float);
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is synchronised or allocated.
// `llr` must be 16-byte aligned (the bulk copy's rule); n a multiple of 4.
extern "C" int ria_ldpc_bp_decode(const float* llr, const float* factors, const short* row,
                                  const short* epos, const int* jobs, float* llr_out,
                                  unsigned char* info_out, unsigned char* ok_out,
                                  int* iters_out, int B, int n, int m, int k, int D,
                                  int slots, int stride, int max_iters, cudaStream_t stream) {
  if (B <= 0 || n <= 0 || n % 4 != 0 || n > 1023 || m <= 0 || m > kThreads || D <= 0 ||
      D > kMaxDeg || k < 0 || k > n || max_iters < 0 || slots <= 0 || slots % 4 != 0 ||
      slots > 16380 || stride < 0 || stride > kThreads ||
      reinterpret_cast<uintptr_t>(llr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, slots);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ldpc_bp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ldpc_bp_kernel<<<B, kThreads, smem, stream>>>(llr, factors, row, epos, jobs, llr_out,
                                                info_out, ok_out, iters_out, n, m, k, D,
                                                slots, stride, max_iters);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled kernel uses for a code of n variables and `slots`
// message slots: out[0] registers per thread, out[1] local (spill) bytes per
// thread, out[2] shared bytes per block, out[3] blocks resident per SM.
extern "C" int ria_ldpc_bp_resources(int n, int slots, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ldpc_bp_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(n, slots);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ldpc_bp_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = blocks;
  return 0;
}
