// Kernel K2: normalized min-sum LDPC belief propagation for NVIDIA Hopper,
// in the per-degree-slot form.
//
// Replaces ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder_v1, the original
// Pallas TPU kernel kept for A/B against the fused one (K1, csrc/ldpc_bp.cu).
// It computes what K1 computes, ria_tpu/fec/ldpc.py::make_decoder_vf in
// float32 (per-row factor, clamp +-50, syndrome from the gathered posteriors'
// signs, no check before iteration 1, per-codeword freeze, edgeless variables
// keep their channel LLR), but in the TPU K2's own form, which fixes its bits:
//   - a two-pass check update: pass 1 takes min1 and the sign parity over
//     the check's slots, pass 2 counts the slots equal to min1 ("ties") and
//     takes min2 over the slots not equal to min1; a slot equal to min1 gets
//     min1 when ties > 1, else min2; every other slot gets min1; c2v =
//     ((+-1) x that) x factor;
//   - the posterior in slot groups: llr + (((0 + s_0) + s_1) + ... + s_6),
//     where s_d sums from 0.0, in ascending check order, the messages that
//     reach the variable through edge slot d.  (K1 sums a variable's
//     messages in one flat run; the two differ in the last bit.)
// The TPU kernel's one-hot dots exist only for Mosaic; here a gather is an
// index load from shared memory and the scatter a store.  Everything here
// is float32.  The TPU kernel's own arithmetic (bfloat16 operands and
// factor; fec/ldpc.py::plain_v1 with precision="bf16") is K2's bf16 build,
// csrc/ldpc_bp_v1_bf16.cu, a design of its own.
//
// Layout: one thread block per codeword, 512 threads.  Thread c owns check
// c (m <= 486 for every rate) and one or two variable "jobs".  Shared memory
// holds the posteriors [n + 4] and the check->variable messages [slots + 4]
// in the order K2 sums them: variable-major, then slot, then ascending check,
// each non-empty slot group starting a fresh 4-float cell and padded with
// zeros after it (25.9 KB a block at R1_4).  The host builds the tables once
// per code (fec/ldpc_kernel.py::k2_layout): int16 [D][m] of each check's
// variables and message slots, and the jobs [2][512] int32 (v | first cell
// << 10 | group ends << 23: bit q set where the job's cell q closes a group).
//
// What bounds it on this card.  Not device-memory bytes or FLOPs: a
// codeword's state never leaves shared memory; a launch moves ~1.4 MB and
// does ~9 MOP at the main path's 256 codewords and 1 iteration.  What
// bounds it is the instructions each iteration issues and their latency (a
// codeword's iterations are sequential), and at 1 iteration the launch and
// the prologue.  K2's first port (git 5fb6243) took 13.1 us an iteration
// alone on an H100, 12.7x K1: its every iteration re-read the tables from
// device memory in chains of dependent loads (the variable pass through
// per-slot index lists), tested a mask on every edge and took three
// barriers.  What this design does:
//   - No device memory inside the iteration loop.  Each owner loads its 7
//     edges once, in the prologue, into registers, as byte offsets from the
//     start of shared memory (its variable's posterior | its message slot
//     << 16); each thread loads its two jobs once.
//   - Messages stored in the order they are summed.  The owner stores each
//     c2v straight into the cell its variable reads, so the variable pass
//     needs no index list: it sums its own cells with 128-bit loads that do
//     not depend on each other, a lane at a time into the group sum s, and
//     at a cell whose `ends` bit is set adds s to the posterior's sum and
//     restarts s at 0.0.  That is K2's grouping term by term: zero lanes
//     before, inside or after a group add +0.0 to a sum that started from
//     +0.0, so is never -0.0, and change no bit; an empty group adds +0.0.
//     Cell q of a job is cell first + q * stride, so a warp's loads touch
//     neighbouring cells; the host deals the variables heaviest first, so
//     no thread's chain is longer than the heaviest variable's cells (7).
//   - No mask tests: a check slot with no edge reads the sentinel variable
//     n, kept at +inf, and its c2v goes to a shared trash cell that no job
//     sums.  Its |v2c| is +inf at the first check update (the gathered
//     LLRs, unclamped) and 50 after (+inf minus the trash cell's finite
//     value, clamped), never below a real edge's, and every check of every
//     rate has >= 2 real edges.  So min1 over the slots is min1 over the
//     real edges; the sentinel equals min1 only when every real edge sits at
//     50, where ties > 1 with or without it and every real edge gets min1
//     either way; otherwise it is not a tie and raises no min2 (a real edge
//     not equal to min1 is below it, and with ties == 1 there is one, since
//     there are >= 2 real edges).  Its positive sign changes no sign parity,
//     and its gathered +inf no syndrome bit.  The update is straight-line
//     code over the 7 slots.
//   - Two barriers an iteration, where the plain schedule (check update |
//     variable pass | gather + parity | OR-vote) takes three:
//       variable pass | gather + parity + NEXT check update | OR-vote.
//     Hazard argument, as K1's: after the gather the owner runs the next
//     iteration's check update and stores its c2v.  No barrier is needed
//     before those stores: the messages are read by the variable pass,
//     which every thread finished before the barrier that precedes the
//     gather, and by the owner's own gather, which comes before its stores
//     in program order; the trash cell's readers take any finite value.
//     The readers of the new c2v (the next variable pass) start only after
//     __syncthreads_or, which both publishes the stores and votes on the
//     parities.  Posteriors are written only in the variable pass, so on
//     convergence the kernel breaks with those of the converging iteration
//     and drops the speculative c2v.  Iteration 1 votes before its check
//     update (three barriers), so a codeword that converges at once, as the
//     main path's do, spends no update; the last iteration skips it.
//   - Pass 1 runs as the gather forms each v2c; the 7 v2c stay in
//     registers for pass 2, which records which slots equal min1 as a bit
//     mask, so the stores need neither the v2c nor a count loop.
//   - Every A/B codeword resident: __launch_bounds__(512, 4) holds a thread
//     to 32 registers, so 4 blocks fit on an SM (65,536 registers) and 132
//     SMs hold 528 codewords, more than the A/B point's 512.
//   - The prologue overlaps its latencies: thread 0 starts the LLR row's
//     copy as one bulk asynchronous copy (cp.async.bulk) that completes on
//     an mbarrier, while every thread loads its tables and zeroes its cells.
//
// The K2_* switches below each turn one of these levers off, for the
// measurements of `python -m ria_tpu_torch.tools.kernel_compare --kernel k2
// --define ...` (PERF.md); the defaults are the design.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K2_SPECULATE        // 0: vote before every check update (three barriers)
#define K2_SPECULATE 1
#endif
#ifndef K2_SENTINELS        // 0: a mask test on every edge instead of sentinel edges
#define K2_SENTINELS 1
#endif
#ifndef K2_V2C_REGS         // 0: the v2c in a slot-major shared plane between the passes
#define K2_V2C_REGS 1
#endif
#ifndef K2_TABLES_RESIDENT  // 0: read each edge from device memory where it is used
#define K2_TABLES_RESIDENT 1
#endif
#ifndef K2_MIN_BLOCKS       // blocks per SM asked of the compiler (4: <= 32 registers)
#define K2_MIN_BLOCKS 4
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
// the iteration loop into registers of its own.
__device__ __forceinline__ unsigned field(unsigned x, unsigned pos, unsigned len) {
  unsigned r;
  asm volatile("bfe.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(pos), "r"(len));
  return r;
}

// The float `bytes` bytes into `base` (a shared array).
__device__ __forceinline__ float& at(float* base, unsigned bytes) {
  return *reinterpret_cast<float*>(reinterpret_cast<char*>(base) + bytes);
}

// Table slot d of check `tid`: the byte offsets from the start of shared
// memory of its variable's posterior and of its message slot (<< 16); the
// sentinel variable n and the trash slot where the check has no edge.
__device__ __forceinline__ unsigned edge_word(const short* row, const short* epos, int d, int D,
                                              int m, int tid, int n, int slots) {
  unsigned v = static_cast<unsigned>(n), e = static_cast<unsigned>(slots);
  if (tid < m && d < D) {
    v = static_cast<unsigned short>(row[d * m + tid]);
    e = static_cast<unsigned short>(epos[d * m + tid]);
  }
  return v * 4u | ((static_cast<unsigned>(n) + 4u + e) * 4u) << 16;
}

// Zero the job's cells: their lanes that hold no message stay 0.
__device__ __forceinline__ void zero_cells(int job, float* smem, int stride) {
  if (job < 0) return;
  float4* cell = reinterpret_cast<float4*>(smem) + field(job, 10, 13);
  for (unsigned ends = field(job, 23, 8); ends; ends >>= 1, cell += stride)
    *cell = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// post[v] = llr + (((0 + s_0) + s_1) + ...): each slot group summed from
// 0.0 in stored (ascending check) order, closed at the cell its ends bit
// marks.
__device__ __forceinline__ void variable_sum(int job, float llr, float* smem, int stride) {
  if (job < 0) return;
  const float4* cell = reinterpret_cast<const float4*>(smem) + field(job, 10, 13);
  float acc = 0.0f, s = 0.0f;
#pragma unroll 1
  for (unsigned ends = field(job, 23, 8); ends; ends >>= 1, cell += stride) {
    const float4 a = *cell;
    s += a.x;
    s += a.y;
    s += a.z;
    s += a.w;
    if (ends & 1u) {
      acc += s;
      s = 0.0f;
    }
  }
  smem[field(job, 0, 10)] = llr + acc;
}

__global__ void __launch_bounds__(kThreads, K2_MIN_BLOCKS)
ldpc_bp_v1_kernel(const float* __restrict__ llr, const float* __restrict__ factors,
                  const short* __restrict__ row, const short* __restrict__ epos,
                  const int* __restrict__ jobs, float* __restrict__ llr_out,
                  unsigned char* __restrict__ info_out, unsigned char* __restrict__ ok_out,
                  int* __restrict__ iters_out, int n, int m, int k, int D, int slots,
                  int stride, int max_iters) {
  // post [n + 4] (channel LLR, then posteriors; +inf at n), then the
  // messages [slots + 4] (the last 4 take no-edge stores).
  extern __shared__ __align__(16) float smem[];
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
        "[%3];" ::"r"(smem_u32(smem)),
        "l"(llr + static_cast<size_t>(b) * n), "r"(bytes), "r"(bar)
        : "memory");
  }

  // While the row flies: the owner's edges, the thread's jobs (their cells
  // rebased to the start of shared memory), its zeroed cells.
  const bool owner = tid < m;
#if K2_TABLES_RESIDENT
  unsigned edge[kMaxDeg];
#pragma unroll
  for (int d = 0; d < kMaxDeg; ++d) edge[d] = edge_word(row, epos, d, D, m, tid, n, slots);
#define EDGE(d) edge[d]
#else
#define EDGE(d) edge_word(row, epos, d, D, m, tid, n, slots)
#endif
#if K2_SENTINELS
#define REAL(d) true
#else
  unsigned real = 0u;  // bit d: table slot d holds an edge
#pragma unroll
  for (int d = 0; d < kMaxDeg; ++d)
    if (field(EDGE(d), 0, 16) != static_cast<unsigned>(n) * 4u) real |= 1u << d;
#define REAL(d) ((real >> (d)) & 1u)
#endif
#if K2_V2C_REGS
  float v2c[kMaxDeg];
#define V2C(d) v2c[d]
#else
  float* plane = smem + n + 4 + slots + 4 + tid;  // [kMaxDeg][kThreads]
#define V2C(d) plane[(d) * kThreads]
#endif
  const int rebase = ((n + 4) / 4) << 10;
  int job0 = jobs[tid];
  int job1 = jobs[kThreads + tid];
  job0 += job0 < 0 ? 0 : rebase;
  job1 += job1 < 0 ? 0 : rebase;
  const float fac = factors[b];
  zero_cells(job0, smem, stride);
  zero_cells(job1, smem, stride);
  if (tid == 0) {
    smem[n] = INFINITY;
    reinterpret_cast<float4*>(smem + n + 4)[slots / 4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
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
  const float llr0 = job0 < 0 ? 0.0f : smem[field(job0, 0, 10)];
  const float llr1 = job1 < 0 ? 0.0f : smem[field(job1, 0, 10)];

  // Pass 2 of the check update over the owner's v2c (pass 1 gave min1 and
  // the sign bits), then each c2v = +-(excl x factor) to its message slot:
  // (+-1 x excl) x factor rounds the same, as negation is exact, and
  // __fmul_rn is never fused into an FMA.
  auto update = [&](float min1, unsigned sign) {
    unsigned is_min = 0u;  // bit d: |v2c(d)| == min1
    float min2 = INFINITY;
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      if (REAL(d)) {
        const float a = fabsf(V2C(d));
        if (a == min1)
          is_min |= 1u << d;
        else
          min2 = fminf(min2, a);
      }
    }
    const float m1f = __fmul_rn(min1, fac);
    const float tief = __fmul_rn(__popc(is_min) > 1 ? min1 : min2, fac);
    // Bit d: c2v(d) is negative (the sign parity without edge d's sign).
    const unsigned odd = sign ^ ((__popc(sign) & 1) ? (1u << kMaxDeg) - 1u : 0u);
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      if (REAL(d)) {
        const float mag = (is_min >> d) & 1u ? tief : m1f;
        at(smem, field(EDGE(d), 16, 16)) = (odd >> d) & 1u ? -mag : mag;
      }
    }
  };

  // Check update of iteration 1 from the channel LLRs gathered.
  if (owner && max_iters > 0) {
    float min1 = INFINITY;
    unsigned sign = 0u;
#pragma unroll
    for (int d = 0; d < kMaxDeg; ++d) {
      if (REAL(d)) {
        const float x = at(smem, field(EDGE(d), 0, 16));
        V2C(d) = x;
        min1 = fminf(min1, fabsf(x));
        if (x < 0.0f) sign |= 1u << d;
      }
    }
    update(min1, sign);
  }
  __syncthreads();  // c2v of iteration 1 published

  int iters = 0;
  int ok = 0;
  for (int it = 0; it < max_iters; ++it) {
    // 1. Posteriors: channel LLR + the variable's slot groups.
    variable_sum(job0, llr0, smem, stride);
    variable_sum(job1, llr1, smem, stride);
    __syncthreads();

    // 2. Gather onto each edge: v2c, the parity and pass 1 (min1, signs).
    unsigned parity = 0u, sign = 0u;
    float min1 = INFINITY;
    if (owner) {
#pragma unroll
      for (int d = 0; d < kMaxDeg; ++d) {
        if (REAL(d)) {
          // This iteration's c2v, read back from the slot it was stored in.
          const float g = at(smem, field(EDGE(d), 0, 16));
          const float x =
              fminf(fmaxf(g - at(smem, field(EDGE(d), 16, 16)), -kClamp), kClamp);
          V2C(d) = x;
          parity ^= g < 0.0f ? 1u : 0u;
          min1 = fminf(min1, fabsf(x));
          if (x < 0.0f) sign |= 1u << d;
        }
      }
    }
    iters = it + 1;
    const bool next = owner && it + 1 < max_iters;
    // 3. The next iteration's check update and the block-wide OR of the
    //    syndromes; freeze and leave on convergence.  From iteration 2 on
    //    the update runs before the vote, speculatively (see the hazard
    //    note); iteration 1 votes first.
    const bool vote_first = !K2_SPECULATE || it == 0;
    if (vote_first && !__syncthreads_or(static_cast<int>(parity))) {
      ok = 1;
      break;
    }
    if (next) update(min1, sign);
    if (vote_first) {
      __syncthreads();
    } else if (!__syncthreads_or(static_cast<int>(parity))) {
      ok = 1;
      break;
    }
  }
#undef EDGE
#undef REAL
#undef V2C

  float* out = llr_out + static_cast<size_t>(b) * n;
  for (int v = tid; v < n; v += kThreads) out[v] = smem[v];
  unsigned char* info = info_out + static_cast<size_t>(b) * k;
  for (int v = tid; v < k; v += kThreads) info[v] = smem[v] < 0.0f ? 1 : 0;
  if (tid == 0) {
    ok_out[b] = static_cast<unsigned char>(ok);
    iters_out[b] = iters;
  }
}

size_t smem_bytes(int n, int slots) {
  const size_t plane = K2_V2C_REGS ? 0 : static_cast<size_t>(kMaxDeg) * kThreads;
  return (static_cast<size_t>(n + 4 + slots + 4) + plane) * sizeof(float);
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is synchronised or allocated.
// `llr` must be 16-byte aligned (the bulk copy's rule); n a multiple of 4.
extern "C" int ria_ldpc_bp_v1_decode(const float* llr, const float* factors, const short* row,
                                     const short* epos, const int* jobs, float* llr_out,
                                     unsigned char* info_out, unsigned char* ok_out,
                                     int* iters_out, int B, int n, int m, int k, int D,
                                     int slots, int stride, int max_iters,
                                     cudaStream_t stream) {
  if (B <= 0 || n <= 0 || n % 4 != 0 || n > 1023 || m <= 0 || m > kThreads || D <= 0 ||
      D > kMaxDeg || k < 0 || k > n || max_iters < 0 || slots <= 0 || slots % 4 != 0 ||
      (n + slots + 8) * 4 > 65535 || (n + 4) / 4 + slots / 4 > 8191 || stride < 0 ||
      stride > kThreads || reinterpret_cast<uintptr_t>(llr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n, slots);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ldpc_bp_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ldpc_bp_v1_kernel<<<B, kThreads, smem, stream>>>(llr, factors, row, epos, jobs, llr_out,
                                                   info_out, ok_out, iters_out, n, m, k, D,
                                                   slots, stride, max_iters);
  return static_cast<int>(cudaGetLastError());
}

// What the compiled kernel uses for a code of n variables and `slots`
// message slots: out[0] registers per thread, out[1] local (spill) bytes per
// thread, out[2] shared bytes per block, out[3] blocks resident per SM.
extern "C" int ria_ldpc_bp_v1_resources(int n, int slots, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, ldpc_bp_v1_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = smem_bytes(n, slots);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ldpc_bp_v1_kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes + smem);
  out[3] = blocks;
  return 0;
}
