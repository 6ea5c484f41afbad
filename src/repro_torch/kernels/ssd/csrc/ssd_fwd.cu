// Mamba2 SSD chunked scan for Hopper (sm_90a), from a zero state.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/ssd/chunked.py (launched by `ssd_chunked_hmajor`,
// wrapped by src/repro/kernels/ssd/ops.py::ssd_scan).  It computes what that
// kernel computes, chunk by chunk of Q steps, with xw = dt * x and
// la = dt * A formed here in float32:
//
//   cla      = cumsum(la)                     (in order, float64)
//   y_t      = sum_{s<=t} (C_t . B_s) e^{cla_t - cla_s} xw_s + e^{cla_t} C_t . S
//   S'       = e^{cla_Q} S + sum_t (B_t e^{cla_Q - cla_t}) xw_t^T
//
// starting from S = 0.  Every exponent is a difference that is <= 0 (cla
// does not increase), formed only where s <= t, so no factor overflows and
// a chunk whose decay underflows e^{cla} to 0 gives 0, never NaN.  Head h
// reads B/C group h / (H / G) in place, with no repetition.
//
// The cumulative sum is kept in float64.  Per-step log decays reach tens, so
// cla runs to thousands inside a chunk, and a float32 difference of two such
// sums loses its low digits: e^{cla_t - cla_s} then carries a relative error
// of about |cla| * 6e-8, which the products amplify (a float32 cumsum put the
// chunked form's worst output error at zamba2's serve shape well past
// 2e-4 + 2e-4 |y| against a float64 run; see PERF.md).  Differences are
// formed in float64 and rounded once, before expf.  It costs Q float64 adds
// per chunk, run in order by one thread while the others load the chunk,
// and one float64 subtraction per score.
//
// Layout: the model's (B, S, H, P) for x and (B, S, G, N) for B and C,
// walked by (batch, sequence) strides, so the wrapper needs no transposes;
// dt (B, S, H) and A (H,) float32; y (B, S, H, P) and the final state
// (B, H, N, P) float32.  Types of x, B, C: float32 or bfloat16.
//
// Design.  The TPU grid (B, H, n_chunks) carries the (N, P) state across its
// sequential chunk axis in VMEM.  GPU blocks run in no order, so one
// 256-thread block owns a (b, h) and loops over the chunks itself, keeping
// the state in shared memory.  A chunk's x (Q x P), B and C (both stored
// transposed, N x Q), the state and the masked (Q x Q) score tile all stay
// in shared memory (182 KB at the largest sizes, set with
// cudaFuncSetAttribute); the zero-filled padding up to the largest sizes
// lets the inner loops run without bounds checks.  Three products follow,
// each thread keeping a register tile: the scores C B^T with the decay mask
// (8 x 8 per thread, only tiles on or below the diagonal), y (8 x 4 per
// thread, the s loop cut at the diagonal) and the state update (4 x 4).
// All arithmetic is float32 FMA on the CUDA cores.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores).  At zamba2-2.7b's prefill (B=8, S=512, H=80, P=64, G=1, N=64,
// Q=128, float32 x, B, C) the function moves x, y, dt, B, C and the state
// once: 182 MB, 54 us.  The output does not depend on the chunk length,
// and the least work over chunk lengths is at Q = 6: 18.0 k operations per
// step and head (the causal halves of C B^T and of the score product, C S,
// the state update and its decay), 5.89 GFLOP, 88 us at the float32 rate.
// So it is bound by operations.  At Q = 128, as the TPU kernel runs it, the
// same terms come to 2.11 M multiply-adds per chunk and head, 10.8 GFLOP.
// What the design does about it: it skips the tiles above the diagonal,
// reads each input once, keeps every intermediate on chip, and writes y
// once; tensor cores (wgmma on TF32 or bf16 tiles), TMA and a shorter chunk
// are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int QMAX = 128;  // chunk length
constexpr int NMAX = 64;   // state dim
constexpr int PMAX = 64;   // head dim
constexpr int SMEM_FLOATS = QMAX * PMAX      // sX
                          + 2 * NMAX * QMAX  // sBt, sCt
                          + NMAX * PMAX      // sS
                          + QMAX * QMAX      // sMt
                          + 2 * QMAX         // sCla (float64)
                          + QMAX;            // sDt
constexpr size_t SMEM_BYTES = size_t(SMEM_FLOATS) * sizeof(float);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ssd_fwd_kernel(const T* __restrict__ xh, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ bm,
               const T* __restrict__ cm, float* __restrict__ y,
               float* __restrict__ state_out, int S, int H, int P, int G, int N, int Q,
               long long xh_sb, long long xh_ss, long long bm_sb, long long bm_ss,
               long long cm_sb, long long cm_ss) {
  extern __shared__ __align__(16) float smem[];
  float* sX = smem;                 // QMAX x PMAX: xw, row t
  float* sBt = sX + QMAX * PMAX;    // NMAX x QMAX: B transposed
  float* sCt = sBt + NMAX * QMAX;   // NMAX x QMAX: C transposed
  float* sS = sCt + NMAX * QMAX;    // NMAX x PMAX: the carried state
  float* sMt = sS + NMAX * PMAX;    // QMAX x QMAX: masked scores, [s][t]
  // QMAX doubles: cumulative log decay (the offset is a multiple of 4 floats)
  double* sCla = reinterpret_cast<double*>(sMt + QMAX * QMAX);
  float* sDt = reinterpret_cast<float*>(sCla + QMAX);  // QMAX: step sizes

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const float a_h = A[h];

  // Zero everything once: the padding beyond (Q, N, P) stays zero, and the
  // state starts at zero.
  for (int i = tid; i < SMEM_FLOATS; i += NTHREADS) smem[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is consumed (and the fill done)
    for (int t = tid; t < Q; t += NTHREADS) sDt[t] = dt[(size_t(b) * S + c0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {
      double c = 0.0;
      for (int t = 0; t < Q; ++t) {
        c += double(__fmul_rn(sDt[t], a_h));  // la = dt * A in float32, summed in float64
        sCla[t] = c;
      }
    }
    for (int idx = tid; idx < Q * P; idx += NTHREADS) {
      const int t = idx / P, p = idx % P;
      const float x = to_f32(xh[b * xh_sb + (c0 + t) * xh_ss + size_t(h) * P + p]);
      sX[t * PMAX + p] = __fmul_rn(x, sDt[t]);
    }
    for (int idx = tid; idx < N * Q; idx += NTHREADS) {
      const int n = idx / Q, t = idx % Q;
      sBt[n * QMAX + t] = to_f32(bm[b * bm_sb + (c0 + t) * bm_ss + size_t(g) * N + n]);
      sCt[n * QMAX + t] = to_f32(cm[b * cm_sb + (c0 + t) * cm_ss + size_t(g) * N + n]);
    }
    __syncthreads();

    // Scores M[t][s] = (C_t . B_s) e^{cla_t - cla_s} for s <= t, else 0,
    // stored as sMt[s][t].  This thread: rows t0..t0+7, columns s0..s0+7.
    {
      const int t0 = tx * 8, s0 = ty * 8;
      if (s0 <= t0 + 7 && t0 < Q && s0 < Q) {
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[8], bv[8];
          load8(sCt + n * QMAX + t0, cv);
          load8(sBt + n * QMAX + s0, bv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = s0 + j;
            float m = 0.f;
            if (s <= t && t < Q) m = acc[i][j] * expf(float(sCla[t] - sCla[s]));
            sMt[s * QMAX + t] = m;
          }
        }
      }
    }
    __syncthreads();

    // y_t = sum_{s<=t} M[t][s] xw_s + e^{cla_t} (C_t . S).  This thread:
    // rows t0..t0+7, columns p0..p0+3.
    {
      const int t0 = ty * 8, p0 = tx * 4;
      if (t0 < Q && p0 < P) {
        float acc[8][4], inter[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = inter[i][j] = 0.f;
        const int s_end = min(t0 + 8, Q);
        for (int s = 0; s < s_end; ++s) {
          float mv[8], xv[4];
          load8(sMt + s * QMAX + t0, mv);
          load4(sX + s * PMAX + p0, xv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(mv[i], xv[j], acc[i][j]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[8], sv[4];
          load8(sCt + n * QMAX + t0, cv);
          load4(sS + n * PMAX + p0, sv);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int t = t0 + i;
          if (t < Q) {
            const float dec = expf(float(sCla[t]));
            float* yrow = y + ((size_t(b) * S + c0 + t) * H + h) * P;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (p0 + j < P) yrow[p0 + j] = fmaf(inter[i][j], dec, acc[i][j]);
          }
        }
      }
    }

    // S' = e^{cla_Q} S + sum_t (B_t e^{cla_Q - cla_t}) xw_t^T.  This thread:
    // rows n0..n0+3, columns p0..p0+3.
    {
      const int n0 = ty * 4, p0 = tx * 4;
      const double cl_last = sCla[Q - 1];
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (n0 < N && p0 < P) {
        for (int t = 0; t < Q; ++t) {
          const float w = expf(float(cl_last - sCla[t]));
          float bv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) bv[i] = sBt[(n0 + i) * QMAX + t] * w;
          load4(sX + t * PMAX + p0, xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
        }
      }
      const float dec = expf(float(cl_last));
      __syncthreads();  // every read of the old state (for y) is done
      if (n0 < N && p0 < P) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* sp = sS + (n0 + i) * PMAX + p0 + j;
            *sp = fmaf(*sp, dec, acc[i][j]);
          }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * P; idx += NTHREADS) {
    const int n = idx / P, p = idx % P;
    state_out[((size_t(b) * H + h) * N + n) * P + p] = sS[n * PMAX + p];
  }
}

template <typename T>
cudaError_t launch(const void* xh, const void* dt, const void* A, const void* bm, const void* cm,
                   void* y, void* state, int B, int S, int H, int P, int G, int N, int Q,
                   long long xh_sb, long long xh_ss, long long bm_sb, long long bm_ss,
                   long long cm_sb, long long cm_ss, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(H, B);
  ssd_fwd_kernel<T><<<grid, NTHREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(xh), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(state), S, H, P, G, N, Q, xh_sb, xh_ss, bm_sb, bm_ss, cm_sb, cm_ss);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of xh, bm, cm: 0 = float32, 1 = bfloat16; dt, A, y and the state are
// float32.  Strides are in elements.  Returns the cudaError_t of the launch
// (0 on success); the kernel runs on `stream` and is not waited for.
int ssd_fwd(const void* xh, const void* dt, const void* A, const void* bm, const void* cm,
            void* y, void* state, int B, int S, int H, int P, int G, int N, int Q,
            long long xh_sb, long long xh_ss, long long bm_sb, long long bm_ss,
            long long cm_sb, long long cm_ss, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || Q < 1 || Q > QMAX || S % Q != 0 ||
      P < 1 || P > PMAX || N < 1 || N > NMAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xh, dt, A, bm, cm, y, state, B, S, H, P, G, N, Q, xh_sb, xh_ss, bm_sb,
                         bm_ss, cm_sb, cm_ss, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xh, dt, A, bm, cm, y, state, B, S, H, P, G, N, Q, xh_sb, xh_ss,
                                 bm_sb, bm_ss, cm_sb, cm_ss, s);
  return cudaErrorInvalidValue;
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
