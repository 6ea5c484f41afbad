// RWKV6 WKV chunked scan for Hopper (sm_90a), from a zero state.
//
// Replaces the Pallas TPU kernel `_rwkv6_kernel` in
// src/repro/kernels/rwkv6/chunked.py (launched by `rwkv6_chunked_hmajor`,
// wrapped by src/repro/kernels/rwkv6/ops.py::rwkv6_mix).  It computes what
// that kernel computes, chunk by chunk of Q steps, per channel p:
//
//   clw      = cumsum(logw)                 (in order, float32)
//   prev     = clw - logw                   (= clw_{t-1})
//   o_t      = (r_t ⊙ e^{prev_t}) · S
//            + sum_{s<t} (sum_p r_tp k_sp e^{prev_tp - clw_sp}) v_s
//            + (r_t ⊙ u ⊙ k_t) · v_t
//   S'       = diag(e^{clw_Q}) S + (k ⊙ e^{clw_Q - clw})^T v
//
// starting from S = 0.  The intra-chunk term is evaluated in the direct
// (Q, Q, P) form, as in the TPU kernel: every exponent is a difference that
// is <= 0 (clw does not increase), formed only where s < t, never the
// factorised e^{clw} e^{-clw} product that overflows under strong decay
// (logw = -5 reaches e^{160} in one chunk).
//
// Layout: the model's (B, S, H, P), contiguous; r, k, v float32 or
// bfloat16; logw and u float32; the output (B, S, H, P) and the final state
// (B, H, P, P) float32.
//
// Design.  The TPU grid (B, H, n_chunks) carries the (P, P) state across its
// sequential chunk axis in VMEM.  GPU blocks run in no order, so one
// 256-thread block owns a (b, h) and loops over the chunks itself, keeping
// the state in shared memory.  A chunk's r, k, v, prev and clw (Q x P,
// rows padded to P + 1 floats so that threads reading different rows of one
// column hit different banks), the state and the (Q x Q) score matrix (the
// u bonus on its diagonal) stay in shared memory: 62 KB at Q=32, P=64.  The
// per-channel cumulative sum runs one thread per channel, in order.  After
// the scores, r and k are scaled in place by e^{prev} and e^{clw_Q - clw}
// (one exponential per element rather than one per product), and the
// output and the state update each give a thread one element at a time,
// with consecutive threads on consecutive columns.  All arithmetic is
// float32 on the CUDA cores.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s float32 without tensor
// cores).  At rwkv6-3b's prefill (B=8, S=512, H=40, P=64, Q=32, float32
// inputs) the function moves r, k, v, logw, the output and the state once:
// 215 MB, 64 us; the least work over chunk lengths (at Q = 5: the two
// (Q,P)x(P,P) products, the causal score and output terms and the state's
// decay) is 2.94 GFLOP, 44 us at the float32 rate.  So it is bound by
// bytes.  What the design does about it: it reads each
// input once, keeps every intermediate on chip, and writes the output once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int QMAX = 64;  // chunk length
constexpr int PMAX = 64;  // head dim

__host__ __device__ constexpr size_t smem_floats(int Q, int P) {
  return size_t(5) * Q * (P + 1)  // sR, sK, sV, sPrev, sClw
       + size_t(P) * (P + 1)      // sS
       + size_t(Q) * (Q + 1)      // sA
       + P;                       // sU
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
rwkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ logw, const float* __restrict__ u,
                 float* __restrict__ out, float* __restrict__ state_out, int S, int H, int P,
                 int Q) {
  extern __shared__ __align__(16) float smem[];
  const int LD = P + 1;
  const int QLD = Q + 1;
  float* sR = smem;              // Q x LD: r, then r * e^{prev}
  float* sK = sR + Q * LD;       // Q x LD: k, then k * e^{clw_Q - clw}
  float* sV = sK + Q * LD;       // Q x LD
  float* sPrev = sV + Q * LD;    // Q x LD: logw, then clw - logw
  float* sClw = sPrev + Q * LD;  // Q x LD: cumulative log decay
  float* sS = sClw + Q * LD;     // P x LD: the carried state, [p][o]
  float* sA = sS + P * LD;       // Q x QLD: scores, the u bonus on the diagonal
  float* sU = sA + Q * QLD;      // P

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  for (int i = tid; i < P * LD; i += NTHREADS) sS[i] = 0.f;
  for (int p = tid; p < P; p += NTHREADS) sU[p] = u[size_t(h) * P + p];

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is consumed (and the state zeroed)
    for (int idx = tid; idx < Q * P; idx += NTHREADS) {
      const int t = idx / P, p = idx % P;
      const size_t off = ((size_t(b) * S + c0 + t) * H + h) * P + p;
      sR[t * LD + p] = to_f32(r[off]);
      sK[t * LD + p] = to_f32(k[off]);
      sV[t * LD + p] = to_f32(v[off]);
      sPrev[t * LD + p] = logw[off];
    }
    __syncthreads();

    // Per-channel cumulative log decay, in order.
    for (int p = tid; p < P; p += NTHREADS) {
      float c = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float lw = sPrev[t * LD + p];
        c += lw;
        sClw[t * LD + p] = c;
        sPrev[t * LD + p] = c - lw;
      }
    }
    __syncthreads();

    // A[t][s] = sum_p r_tp k_sp e^{prev_tp - clw_sp} for s < t,
    // A[t][t] = sum_p r_tp u_p k_tp, 0 above the diagonal.
    for (int idx = tid; idx < Q * Q; idx += NTHREADS) {
      const int t = idx / Q, s = idx % Q;
      const float* rt = sR + t * LD;
      float acc = 0.f;
      if (s < t) {
        const float* ks = sK + s * LD;
        const float* pt = sPrev + t * LD;
        const float* cs = sClw + s * LD;
        for (int p = 0; p < P; ++p) acc = fmaf(rt[p] * ks[p], expf(pt[p] - cs[p]), acc);
      } else if (s == t) {
        const float* kt = sK + t * LD;
        for (int p = 0; p < P; ++p) acc = fmaf(rt[p] * sU[p], kt[p], acc);
      }
      sA[t * QLD + s] = acc;
    }
    __syncthreads();

    // r <- r e^{prev} (inter-chunk term), k <- k e^{clw_Q - clw} (state).
    const float* cl_last = sClw + (Q - 1) * LD;
    for (int idx = tid; idx < Q * P; idx += NTHREADS) {
      const int t = idx / P, p = idx % P;
      sR[t * LD + p] *= expf(sPrev[t * LD + p]);
      sK[t * LD + p] *= expf(cl_last[p] - sClw[t * LD + p]);
    }
    __syncthreads();

    // o_t = (r_t e^{prev_t}) . S + sum_{s<=t} A[t][s] v_s.
    for (int idx = tid; idx < Q * P; idx += NTHREADS) {
      const int t = idx / P, o = idx % P;
      const float* rt = sR + t * LD;
      float inter = 0.f;
      for (int p = 0; p < P; ++p) inter = fmaf(rt[p], sS[p * LD + o], inter);
      const float* at = sA + t * QLD;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra = fmaf(at[s], sV[s * LD + o], intra);
      out[((size_t(b) * S + c0 + t) * H + h) * P + o] = inter + intra;
    }
    __syncthreads();  // every read of the old state is done

    // S' = diag(e^{clw_Q}) S + (k e^{clw_Q - clw})^T v.
    for (int idx = tid; idx < P * P; idx += NTHREADS) {
      const int p = idx / P, o = idx % P;
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) acc = fmaf(sK[t * LD + p], sV[t * LD + o], acc);
      float* sp = sS + p * LD + o;
      *sp = fmaf(*sp, expf(cl_last[p]), acc);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * P; idx += NTHREADS) {
    const int p = idx / P, o = idx % P;
    state_out[((size_t(b) * H + h) * P + p) * P + o] = sS[p * LD + o];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
                   void* out, void* state, int B, int S, int H, int P, int Q,
                   cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem_floats(QMAX, PMAX) * sizeof(float)));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(H, B);
  const size_t smem = smem_floats(Q, P) * sizeof(float);
  rwkv6_fwd_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(logw), static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(state), S, H, P, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of r, k, v: 0 = float32, 1 = bfloat16; logw, u, the output and the
// state are float32.  Returns the cudaError_t of the launch (0 on success);
// the kernel runs on `stream` and is not waited for.
int rwkv6_fwd(const void* r, const void* k, const void* v, const void* logw, const void* u,
              void* out, void* state, int B, int S, int H, int P, int Q, int dtype,
              void* stream) {
  if (B < 1 || S < 1 || H < 1 || Q < 1 || Q > QMAX || S % Q != 0 || P < 1 || P > PMAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, logw, u, out, state, B, S, H, P, Q, s);
  if (dtype == 1) return launch<__nv_bfloat16>(r, k, v, logw, u, out, state, B, S, H, P, Q, s);
  return cudaErrorInvalidValue;
}

const char* rwkv6_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
