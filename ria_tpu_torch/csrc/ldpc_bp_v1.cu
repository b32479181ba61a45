// Kernel K2: normalized min-sum LDPC belief propagation for NVIDIA Hopper,
// in the per-degree-slot form.
//
// Replaces ria_tpu/fec/ldpc_pallas.py::make_pallas_decoder_v1, the original
// Pallas TPU kernel kept for A/B against the fused one (K1, csrc/ldpc_bp.cu).
// It computes what K1 computes, ria_tpu/fec/ldpc.py::make_decoder_vf in
// float32 (per-row factor, clamp +-50, syndrome from the gathered posteriors'
// signs, no check before iteration 1, per-codeword freeze, edgeless variables
// keep their channel LLR), but in the TPU K2's own form:
//   - messages as per-slot planes v2c[d][check] and c2v[d][check];
//   - a two-pass check update: pass 1 takes min1 and the sign parity over the
//     D slots, pass 2 counts the slots equal to min1 ("ties") and takes min2
//     over the slots not equal to min1; a slot equal to min1 gets min1 when
//     ties > 1, else min2; every other slot gets min1;
//   - the posterior as a slot-major sum: llr_in + sum over d = 0..D-1, in
//     order, of slot d's messages on the variable.
// The TPU kernel's one-hot dots exist only for Mosaic; here a gather is an
// index load from shared memory, and the per-slot scatter walks host-built
// per-slot variable->check lists (slot_ptr [D][n + 1], slot_chk [E]) with no
// atomics.  Unlike the TPU kernel it rounds neither the factor nor the
// gathered LLRs to bf16.
//
// How it differs from K1, where K1's note leaves choices open:
//   - 256 threads per codeword (K1: 512), striding over the m checks, so a
//     thread owns up to two checks at R1/4 (m = 486);
//   - both message planes live in shared memory, slot-major, so consecutive
//     threads touch consecutive checks of one slot (K1 keeps a check's
//     messages in its owner's registers and only c2v in shared memory);
//   - the check update is K2's tie-count form (K1: incremental two-minimum
//     with an argmin);
//   - the scatter order is slot-major (K1: ascending edge check * D + d).
// Shared memory: llr_in[n], post[n], v2c[D * m], c2v[D * m]:
// (2 * 648 + 2 * 7 * 486) * 4 = 32,400 B for R1/4.
// One iteration is three barriers, as in K1:
//   check update -> | slot-major posterior -> | gather, v2c, syndrome -> OR.
// __syncthreads_or over the per-thread parities (each the OR over every check
// the thread owns) ends the codeword.
//
// What bounds it on this card: per-iteration latency (three block barriers,
// dependent shared-memory loads) and shared-memory traffic (every message is
// stored and reloaded each iteration, where K1 keeps most in registers), not
// FLOPs or device-memory bytes: a codeword's state never leaves shared memory
// and the tables stay in L1/L2.  Making it fast is left to later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kClamp = 50.0f;

__global__ void __launch_bounds__(kThreads)
ldpc_bp_v1_kernel(const float* __restrict__ llr, const float* __restrict__ factors,
                  const int* __restrict__ row_idx,
                  const unsigned char* __restrict__ row_mask,
                  const int* __restrict__ slot_ptr, const int* __restrict__ slot_chk,
                  float* __restrict__ llr_out, unsigned char* __restrict__ info_out,
                  unsigned char* __restrict__ ok_out, int* __restrict__ iters_out,
                  int n, int m, int k, int D, int max_iters) {
  extern __shared__ float smem[];
  float* llr_in = smem;        // [n]
  float* post = llr_in + n;    // [n]
  float* v2c = post + n;       // [D][m]
  float* c2v = v2c + D * m;    // [D][m]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* row = llr + static_cast<size_t>(b) * n;
  for (int v = tid; v < n; v += blockDim.x) {
    const float x = row[v];
    llr_in[v] = x;
    post[v] = x;
  }
  __syncthreads();

  // Initial v2c: the channel LLR gathered onto each edge, 0 on padding slots.
  // Each thread reads back only the checks it writes, so no barrier follows.
  for (int c = tid; c < m; c += blockDim.x)
    for (int d = 0; d < D; ++d)
      v2c[d * m + c] = row_mask[c * D + d] ? llr_in[row_idx[c * D + d]] : 0.0f;

  const float fac = factors[b];
  int iters = 0;
  int ok = 0;
  for (int it = 0; it < max_iters; ++it) {
    // 1. Check update in K2's two-pass form, for every check this thread owns.
    for (int c = tid; c < m; c += blockDim.x) {
      const unsigned char* mask = row_mask + c * D;
      float min1 = INFINITY;
      unsigned neg = 0u;
      for (int d = 0; d < D; ++d) {
        if (mask[d]) {
          const float x = v2c[d * m + c];
          neg ^= x < 0.0f ? 1u : 0u;
          min1 = fminf(min1, fabsf(x));
        }
      }
      int ties = 0;
      float min2 = INFINITY;
      for (int d = 0; d < D; ++d) {
        if (mask[d]) {
          const float a = fabsf(v2c[d * m + c]);
          if (a == min1)
            ++ties;
          else
            min2 = fminf(min2, a);
        }
      }
      for (int d = 0; d < D; ++d) {
        float out = 0.0f;
        if (mask[d]) {
          const float x = v2c[d * m + c];
          const float excl = fabsf(x) == min1 ? (ties > 1 ? min1 : min2) : min1;
          const unsigned odd = neg ^ (x < 0.0f ? 1u : 0u);
          out = (odd ? -1.0f : 1.0f) * excl * fac;
        }
        c2v[d * m + c] = out;
      }
    }
    __syncthreads();

    // 2. Posterior: channel LLR + the slot sums, slot 0 first.
    for (int v = tid; v < n; v += blockDim.x) {
      float acc = 0.0f;
      for (int d = 0; d < D; ++d) {
        const int* ptr = slot_ptr + d * (n + 1);
        float s = 0.0f;
        const int e1 = ptr[v + 1];
        for (int e = ptr[v]; e < e1; ++e) s += c2v[d * m + slot_chk[e]];
        acc += s;
      }
      post[v] = llr_in[v] + acc;
    }
    __syncthreads();

    // 3. Gather the posterior onto each edge: next v2c and the check parity.
    unsigned parity = 0u;
    for (int c = tid; c < m; c += blockDim.x) {
      unsigned p = 0u;
      for (int d = 0; d < D; ++d) {
        if (row_mask[c * D + d]) {
          const float g = post[row_idx[c * D + d]];
          v2c[d * m + c] = fminf(fmaxf(g - c2v[d * m + c], -kClamp), kClamp);
          p ^= g < 0.0f ? 1u : 0u;
        }
      }
      parity |= p;
    }
    iters = it + 1;
    // 4. Block-wide OR of every owned check's parity; 5. freeze and leave.
    if (!__syncthreads_or(static_cast<int>(parity))) {
      ok = 1;
      break;
    }
  }

  float* out = llr_out + static_cast<size_t>(b) * n;
  for (int v = tid; v < n; v += blockDim.x) out[v] = post[v];
  unsigned char* info = info_out + static_cast<size_t>(b) * k;
  for (int v = tid; v < k; v += blockDim.x) info[v] = post[v] < 0.0f ? 1 : 0;
  if (tid == 0) {
    ok_out[b] = static_cast<unsigned char>(ok);
    iters_out[b] = iters;
  }
}

}  // namespace

// C entry point, bound with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is synchronised or allocated.
extern "C" int ria_ldpc_bp_v1_decode(const float* llr, const float* factors,
                                     const int* row_idx,
                                     const unsigned char* row_mask,
                                     const int* slot_ptr, const int* slot_chk,
                                     float* llr_out, unsigned char* info_out,
                                     unsigned char* ok_out, int* iters_out, int B,
                                     int n, int m, int k, int D, int max_iters,
                                     cudaStream_t stream) {
  if (B <= 0 || n <= 0 || m <= 0 || D <= 0 || k < 0 || k > n || max_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(2 * n + 2 * D * m) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ldpc_bp_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ldpc_bp_v1_kernel<<<B, kThreads, smem, stream>>>(
      llr, factors, row_idx, row_mask, slot_ptr, slot_chk, llr_out, info_out,
      ok_out, iters_out, n, m, k, D, max_iters);
  return static_cast<int>(cudaGetLastError());
}
