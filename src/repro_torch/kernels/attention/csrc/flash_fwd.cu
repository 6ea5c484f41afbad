// Flash-attention forward for Hopper (sm_90a), causal / sliding-window GQA:
// the float32 path, on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/attention/flash.py (launched by `flash_attention_hmajor`,
// wrapped by src/repro/kernels/attention/ops.py::flash_attention).  It
// computes what that kernel computes: online softmax with a float32 running
// max, sum and accumulator; q scaled by 1/sqrt(hd) in float32; masked scores
// set to -1e30 (not -inf, so a row that is fully masked inside a live block
// gets p = exp(0) = 1 there and is wiped later by exp(m_prev - m_new) = 0,
// exactly as in the Pallas kernel, and never produces NaN); KV blocks above
// the causal diagonal or below the window are skipped, not masked; the final
// divide clamps l at 1e-30; q head h reads KV head h / (H / K), with no
// repetition of K or V.
//
// Layout: the model's (B, S, heads, hd), contiguous, so no transposes are
// needed around the launch.  Types: float32 in and out, in float32 FMAs,
// which hold the float32 tolerance that bf16 or TF32 products cannot; bf16
// inputs go to the tensor-core kernel in flash_fwd_sm90.cu.  Head dims 16, 32, 64, 80 (zamba2-2.7b)
// and 128.  At hd 80 a lane keeps NC = 3 output columns (the third guarded
// by d < HD), a row stages as 20 float32 16-byte vectors, and `-Xptxas -v`
// reports 230 registers, no spills, on sm_90a.
//
// Design.  The TPU kernel's grid (B, H, S/blk_q, S/blk_k) carries the
// softmax state across its sequential last grid axis in VMEM scratch.
// Thread blocks on the GPU run in no order, so here one thread block owns a
// (b, h, q-block) and loops over only the live KV blocks itself; the loop's
// first and last block come from the causal and window bounds of flash.py.
// The q block (at most 128 rows) is staged once in shared memory as float32,
// already scaled.  K and V are staged 32 keys at a time (one key per lane).
// Eight warps each own up to 16 q rows (rows warp, warp + 8, ...): a lane
// computes its key's score against all 16 rows with float4 shared-memory
// reads, the row max is a warp reduction, each lane keeps a partial row sum
// (the correction factor is uniform across a row, so the partials add up at
// the end), and the P.V product reads P back from a per-warp shared tile
// while each lane accumulates hd/32 output columns in registers.  All
// arithmetic is float32 FMA on the CUDA cores: simple and exact enough for
// the float32 tolerance.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16).  At the
// granite-3-8b prefill shape (B=8, S=512, H=32, K=8, hd=128) in float32 the
// function must move q, k, v and o once: 168 MB, 50 us; and do 4*hd per
// live (q, k) pair, about 2*B*H*S^2*hd = 17.2 GFLOP causal, 17 us at the
// bf16 tensor rate.  So it is bound by bytes at the card's peak, and by
// operations for this design, which runs on the 67 TFLOP/s float32 CUDA
// cores and reads
// shared memory about once per four FMAs.  What the design does about it:
// it skips dead blocks (half the work at causal), reads each q tile once and
// each K/V tile once per q block, and never materialises the S x S scores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_ROWS = 16;                     // q rows per warp
constexpr int MAX_BLK_Q = NWARPS * MAX_ROWS;     // 128
constexpr int TK = 32;                           // keys per staged chunk
constexpr float NEG_INF = -1e30f;

template <typename T> struct Vec;                // elements in 16 bytes
template <> struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

// Stage `nrows` rows of HD elements (row r at src + r * src_stride) into
// shared memory as float32 times `mul`, row stride `ld`; rows >= `valid`
// are zero-filled and never read from device memory.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, size_t src_stride,
                                           int nrows, int valid, float mul) {
  constexpr int V = Vec<T>::N;
  constexpr int PER_ROW = HD / V;
  for (int idx = threadIdx.x; idx < nrows * PER_ROW; idx += NTHREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * V;
    float tmp[V];
    if (r < valid) {
      load16(src + r * src_stride + c, tmp);
#pragma unroll
      for (int i = 0; i < V; ++i) tmp[i] *= mul;
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) tmp[i] = 0.f;
    }
    float* d = dst + r * ld + c;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(d + i) = make_float4(tmp[i], tmp[i + 1], tmp[i + 2], tmp[i + 3]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return (size_t(MAX_BLK_Q) * HD + TK * (HD + 4) + TK * HD + NWARPS * MAX_ROWS * TK) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int H, int KH, int blk_q, int blk_k, int causal,
                 int window, float scale) {
  constexpr int NC = (HD + 31) / 32;   // output columns per lane
  constexpr int KLD = HD + 4;          // padded K row: conflict-free float4 reads
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // MAX_BLK_Q x HD, scaled q
  float* sK = sQ + MAX_BLK_Q * HD;     // TK x KLD
  float* sV = sK + TK * KLD;           // TK x HD
  float* sP = sV + TK * HD;            // NWARPS x MAX_ROWS x TK

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q_start = blockIdx.x * blk_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const size_t q_row0 = (size_t(b) * S + q_start) * H + h;   // in rows of HD

  stage_rows<T, HD>(sQ, HD, q + q_row0 * HD, size_t(H) * HD, MAX_BLK_Q, blk_q, scale);

  // Live KV blocks (flash.py's `live`): k_start <= q_start + blk_q - 1 when
  // causal, and k_start + blk_k - 1 >= q_start - window + 1 with a window.
  int j_hi = S / blk_k - 1;
  if (causal) j_hi = min(j_hi, (q_start + blk_q - 1) / blk_k);
  int j_lo = 0;
  if (window > 0) {
    const int num = q_start - window + 2 - blk_k;
    if (num > 0) j_lo = (num + blk_k - 1) / blk_k;
  }
  const int kv_lo = j_lo * blk_k;
  const int kv_hi = (j_hi + 1) * blk_k;

  float m[MAX_ROWS], l[MAX_ROWS], acc[MAX_ROWS][NC];
#pragma unroll
  for (int i = 0; i < MAX_ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  float* myP = sP + warp * MAX_ROWS * TK;

  for (int c0 = kv_lo; c0 < kv_hi; c0 += TK) {
    __syncthreads();  // the previous chunk is consumed (and sQ is staged)
    const size_t kv_row0 = (size_t(b) * S + c0) * KH + kh;
    const int nvalid = min(TK, kv_hi - c0);
    stage_rows<T, HD>(sK, KLD, k + kv_row0 * HD, size_t(KH) * HD, TK, nvalid, 1.f);
    stage_rows<T, HD>(sV, HD, v + kv_row0 * HD, size_t(KH) * HD, TK, nvalid, 1.f);
    __syncthreads();

    // Scores of this lane's key against the warp's rows.
    float s[MAX_ROWS];
#pragma unroll
    for (int i = 0; i < MAX_ROWS; ++i) s[i] = 0.f;
    const float* kr = sK + lane * KLD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int i = 0; i < MAX_ROWS; ++i) {
        const float4 qq = *reinterpret_cast<const float4*>(sQ + (warp + NWARPS * i) * HD + d);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // Mask, online softmax update, P to shared memory.
    const int kpos = c0 + lane;
#pragma unroll
    for (int i = 0; i < MAX_ROWS; ++i) {
      const int qpos = q_start + warp + NWARPS * i;
      bool valid = kpos < kv_hi;
      if (causal) valid = valid && qpos >= kpos;
      if (window > 0) valid = valid && qpos < kpos + window;
      const float sv = valid ? s[i] : NEG_INF;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float p = expf(sv - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + p;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
      myP[i * TK + lane] = p;
    }
    __syncwarp();

    // acc += P . V over the chunk's keys.
#pragma unroll 4
    for (int t = 0; t < TK; ++t) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c * 32 + lane;
        vv[c] = (d < HD) ? sV[t * HD + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < MAX_ROWS; ++i) {
        const float p = myP[i * TK + t];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MAX_ROWS; ++i) {
    float ls = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    const int r = warp + NWARPS * i;
    if (r < blk_q) {
      const float denom = fmaxf(ls, 1e-30f);
      T* orow = o + (q_row0 + size_t(r) * H) * HD;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = c * 32 + lane;
        if (d < HD) store(orow + d, acc[i][c] / denom);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KH, int blk_q, int blk_k, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(S / blk_q, H, B);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, blk_q, blk_k, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                        int S, int H, int KH, int blk_q, int blk_k, int causal, int window,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KH, blk_q, blk_k, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KH, blk_q, blk_k, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KH, blk_q, blk_k, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, H, KH, blk_q, blk_k, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KH, blk_q, blk_k, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// float32 q, k, v, o.  window <= 0 means no window.  Returns the cudaError_t
// of the launch (0 on success); the kernel runs on `stream` and is not
// waited for.
int flash_fwd(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
              int KH, int hd, int blk_q, int blk_k, int causal, int window, float scale,
              void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0 || blk_q < 1 || blk_q > MAX_BLK_Q ||
      blk_k < 1 || S % blk_q != 0 || S % blk_k != 0)
    return cudaErrorInvalidValue;
  return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KH, blk_q, blk_k, causal, window, scale,
                            static_cast<cudaStream_t>(stream));
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
