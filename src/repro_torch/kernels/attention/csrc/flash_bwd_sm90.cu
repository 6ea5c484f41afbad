// Flash-attention backward for Hopper tensor cores (sm_90a): bf16, causal.
//
// Replaces no TPU kernel: the Pallas flash kernel (src/repro/kernels/
// attention/flash.py) has no backward pass, and the JAX trainer
// differentiates attention_xla, whose counterpart here is
// layers.attention_torch.  This is the gradient of flash_fwd_sm90.cu's
// function (causal GQA, scores scaled by 1/sqrt(hd) after the product) from
// q, k, v, the forward's output o, the per-row log-sum-exp that its stats
// variant writes, and dO.  Three kernels run on one stream
// (FlashAttention-2's deterministic split):
//   delta: D = rowsum(dO * O) for each (b, h, row), float32;
//   dK/dV: a block for 128 keys of one (b, kv head) walks the q tiles of 64
//          rows from the diagonal to the end, for each of the H / KH query
//          heads that share the kv head, and keeps dK and dV in registers,
//          so the heads' gradients are summed inside the kernel;
//   dQ:    a block for 128 q rows of one (b, h) walks the key tiles of 64
//          keys up to the diagonal and keeps dQ in registers.
// No atomics: every element of a gradient is summed by one warpgroup in a
// fixed order, so two runs give the same bits.  The price is that both
// kernels compute S = Q.K^T and dP = dO.V^T.
//
// Arithmetic (that of attention_torch's autograd, or finer): S and dP
// accumulate in float32; P = 2^(S * scale * log2(e) - lse * log2(e)) in
// float32; dS = P * (dP - D) in float32.  P enters dV = P^T.dO in bf16, as
// the torch path's p.to(bf16) does.  dS enters dK = dS^T.Q and dQ = dS.K as
// two bf16 terms, hi = bf16(dS) and lo = bf16(dS - hi), each product
// accumulated in float32: 16 significant bits of dS where the torch path
// keeps 24, both far below the final bf16 rounding of dq and dk, which take
// the factor 1/sqrt(hd) in float32 at the end.  Nine products a (q tile, key
// tile) pair: S and dP twice, dV once, dK and dQ twice each.
//
// Layout: the model's (B, S, heads, hd), contiguous, through the forward's
// 4-D TMA tensor maps (128-byte swizzle; rows past S and head-dim columns
// past hd read as zeros; hd 80 pads to 128).  lse and D are float32
// (B, H, s_pad), s_pad = S rounded up to 128, every row written (D is 0
// past S), so that a tile's 64 values arrive with one bulk copy.  Rows past
// S carry dO = 0 and D = 0, so they add nothing; gradients are stored only
// for rows below S.
//
// Design.  A block holds two consumer warpgroups of 64 rows of the work
// tile.  The work tile's two operands (dK/dV: K and V; dQ: Q and dO) are
// loaded once; the streamed tiles (dK/dV: Q, dO, lse and D; dQ: K and V)
// pass through a ring of NSTAGES stages, each arrival counted on an
// mbarrier.  A consumer warpgroup computes its two score-shaped products
// with wgmma from shared memory (both operands K-major; dK/dV computes
// S^T = K.Q^T and dP^T = V.dO^T, keys as rows, so that P^T and dS^T come out
// in the layout of wgmma's A operand in registers), the elementwise part in
// registers (masked only in tiles that cross the diagonal), and accumulates
// with wgmma taking A from registers and B (dO, Q or K, whose reduction rows
// are not contiguous) from shared memory with the transpose flag; dK/dV
// issues dV = P^T.dO before it makes dS^T, so that the two overlap.  The two
// warpgroups overlap each other's products and elementwise work (taking
// turns to issue, as the forward does, measured no faster).
//
// Registers decide the block's shape.  dQ needs about 160 a thread and has
// a producer warpgroup (one thread issues every TMA load): 384 threads, for
// which ptxas allocates at most 168 a thread (setmaxnreg, which the kernels
// execute as the forward does, does not raise what ptxas allocates).  dK/dV
// needs about 240 (dK and dV alone take 128), which spilled 300 bytes a
// thread at 168 and took 1.4x as long; so it has no producer warpgroup, and
// thread 0 issues the loads between its products, NSTAGES - 1 tiles ahead:
// 256 threads, 255 registers at most, 242 used.  Blocks are launched
// heaviest first (dK/dV: the first key tiles; dQ: the last q tiles).  Every
// mbarrier wait traps after about 10 s of spinning.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the least
// backward is five products the size of the forward's two, 4 * hd a causal
// (q, key) pair each, 2.5x the forward's operations: at granite's train call
// (4, 4096, 32, 8, 128) 1.37e12, 1.39 ms; the bytes (q, k, v, o, dO, dq,
// dk, dv, lse) are 0.67 GB, 0.20 ms.  So operations bound it.

#include "flash_sm90.cuh"

namespace {

constexpr int NCONSUMERS = 256;               // two warpgroups of 64 rows
constexpr int NTHREADS = NCONSUMERS + 128;    // and one producer warpgroup
constexpr int BM = 128;                       // rows of a work tile
constexpr int BN = 64;                        // rows of a streamed tile
constexpr int NSTAGES = 3;                    // ring depth
constexpr int S_ALIGN = 128;                  // lse and D rows: s_pad, a multiple of this
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdTile {
  static constexpr int HDP = (HD + 63) / 64 * 64;           // the head dim padded
  static constexpr int NKS = HD / 16;                       // k-steps over the head dim
  static constexpr int NCH = HDP / 64;                      // 128-byte head-dim chunks
  static constexpr int M_CHUNK = BM * 128;                  // bytes of a work-tile chunk
  static constexpr int N_CHUNK = BN * 128;                  // bytes of a streamed chunk
  static constexpr int M_BYTES = NCH * M_CHUNK;             // one work-tile operand
  static constexpr int N_BYTES = NCH * N_CHUNK;             // one streamed operand
  static constexpr int STAGE_BYTES = 2 * N_BYTES;
  static constexpr int VEC_BYTES = 2 * BN * 4;              // lse and D of one stage
  static constexpr int VEC_OFFSET = 2 * M_BYTES + NSTAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = VEC_OFFSET + NSTAGES * VEC_BYTES;
  // The work tile's operands, the ring, lse and D of each stage, then
  // 1 + 2 * NSTAGES mbarriers; 1024 bytes of slack for aligning the base to
  // the 128-byte swizzle's 1024-byte period.
  static constexpr int SMEM = BAR_OFFSET + 8 * (1 + 2 * NSTAGES) + 1024;
};

// One bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completion counted on `bar` in bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// dS as two bf16 A-fragment words: hi = bf16(dS), lo = bf16(dS - hi).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// A (64 x BN) score-shaped product, D = A.B^T over the head dim, both
// operands K-major in shared memory (one commit group with the other).
template <int HD>
__device__ __forceinline__ void issue_scores(float (&d)[BN / 2], uint32_t a_tile, int a_chunk,
                                             uint32_t b_tile) {
  using T = BwdTile<HD>;
#pragma unroll
  for (int k = 0; k < T::NKS; ++k)
    wgmma_ss_n64(d, smem_desc(a_tile + (k / 4) * a_chunk + (k % 4) * 32, 16, 1024),
                 smem_desc(b_tile + (k / 4) * T::N_CHUNK + (k % 4) * 32, 16, 1024), k > 0);
}

// acc (64 x HD) += A (64 x BN, bf16 words in registers) . B, B the streamed
// tile (BN rows, MN-major: its reduction rows are not contiguous).
template <int HD>
__device__ __forceinline__ void issue_acc(float (&acc)[HD / 2], const uint32_t (&a)[BN / 4],
                                          uint32_t b_tile) {
  using T = BwdTile<HD>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<HD>(acc, &a[4 * kk], smem_desc(b_tile + kk * 16 * 128, T::N_CHUNK, 1024));
}

// rows (64 x HD accumulator, rows row0 and row0 + 8 of this thread) * scale
// in bf16 to out[(row * heads + head) * HD], rows below S only.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[HD / 2],
                                           float scale, int b, int S, int heads, int head,
                                           int row0, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + ((size_t(b) * S + row) * heads + head) * HD);
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8)
      dst[n8 * 4 + lane % 4] =
          pack_bf16(acc[n8 * 4 + 2 * r] * scale, acc[n8 * 4 + 2 * r + 1] * scale);
  }
}

// D[(b * H + h) * s_pad + s] = sum over the head dim of o * dO, one warp a row,
// 0 for s past S.
__global__ void flash_bwd_delta_kernel(const __nv_bfloat16* o, const __nv_bfloat16* dout,
                                       float* delta, int B, int S, int H, int hd, int s_pad) {
  const long long row = (long long)(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * H * s_pad) return;
  const int s = int(row % s_pad);
  const int h = int((row / s_pad) % H);
  const int b = int(row / s_pad / H);
  float acc = 0.f;
  if (s < S) {
    const size_t off = ((size_t(b) * S + s) * H + h) * hd;
    const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(o + off);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(dout + off);
    for (int i = lane; i < hd / 2; i += 32) {
      const float2 a = __bfloat1622float2(po[i]), c = __bfloat1622float2(pd[i]);
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- dK and dV ----------------------------------------------------------------
//
// Fragments as in flash_fwd_sm90.cu: thread `lane` of warp `w` of a consumer
// warpgroup holds rows w*16 + lane/4 and + 8; element i of an N-column
// accumulator lies in row +8 when (i & 2), column (i / 4) * 8 + (lane % 4) * 2
// + (i & 1); the same layout, read as pairs, is wgmma's A operand.  Here the
// rows are keys and the columns of S^T and dP^T are q rows.

template <int HD>
__global__ void __launch_bounds__(NCONSUMERS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, const float* lse,
                      const float* delta, __nv_bfloat16* dk, __nv_bfloat16* dv, int B, int S,
                      int H, int KH, float scale_log2, float scale) {
  using T = BwdTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = base, sV = sK + T::M_BYTES;         // NCH chunks of BM x 64 each
  const uint32_t sRing = sV + T::M_BYTES;                  // per stage: Q, then dO
  const uint32_t sVec = base + T::VEC_OFFSET;              // per stage: lse, then D
  // The same through a generic pointer: plain loads, which the compiler may
  // schedule among the arithmetic (after the stage's mbarrier wait).
  const float* vec_ptr = reinterpret_cast<const float*>(smem_raw + (sVec - smem_u32(smem_raw)));
  const uint32_t kv_full = base + T::BAR_OFFSET;
  const uint32_t full = kv_full + 8, empty = full + 8 * NSTAGES;

  // Block t: key tile t / (B * KH), the first key tiles (the most q tiles) first.
  const int G = H / KH;
  const int kt = blockIdx.x / (B * KH);
  const int b = (blockIdx.x % (B * KH)) / KH, kh = blockIdx.x % KH;
  const int k0 = kt * BM;
  const int s_pad = (S + S_ALIGN - 1) / S_ALIGN * S_ALIGN;
  const int qt0 = k0 / BN;                                 // the diagonal's q tile
  const int n_q = (S + BN - 1) / BN - qt0;                 // q tiles a head
  const int n_iter = G * n_q;                              // heads outer, q tiles inner

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONSUMERS / 32);           // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues the loads: K and V once, and iteration it's Q, dO, lse
  // and D into stage it % NSTAGES, NSTAGES - 1 iterations ahead.
  const bool loader = threadIdx.x == 0;
  auto load = [&](int it) {
    const int s = it % NSTAGES;
    const int h = kh * G + it / n_q;
    const int q0 = (qt0 + it % n_q) * BN;
    const uint32_t st = sRing + s * T::STAGE_BYTES;
    mbar_expect_tx(full + 8 * s, T::STAGE_BYTES + T::VEC_BYTES);
    for (int c = 0; c < T::NCH; ++c) {
      tma_load_4d(st + c * T::N_CHUNK, &tm_q, full + 8 * s, c * 64, h, q0, b);
      tma_load_4d(st + T::N_BYTES + c * T::N_CHUNK, &tm_do, full + 8 * s, c * 64, h, q0, b);
    }
    const size_t row = (size_t(b) * H + h) * s_pad + q0;
    bulk_load(sVec + s * T::VEC_BYTES, lse + row, BN * 4, full + 8 * s);
    bulk_load(sVec + s * T::VEC_BYTES + BN * 4, delta + row, BN * 4, full + 8 * s);
  };
  if (loader) {
    mbar_expect_tx(kv_full, 2 * T::M_BYTES);
    for (int c = 0; c < T::NCH; ++c) {
      tma_load_4d(sK + c * T::M_CHUNK, &tm_k, kv_full, c * 64, kh, k0, b);
      tma_load_4d(sV + c * T::M_CHUNK, &tm_v, kv_full, c * 64, kh, k0, b);
    }
    for (int it = 0; it < NSTAGES - 1 && it < n_iter; ++it) load(it);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int key_first = k0 + wg * 64;                      // this warpgroup's keys
  const int key0 = key_first + ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // and key0 + 8
  const uint32_t k_wg = sK + wg * 64 * 128, v_wg = sV + wg * 64 * 128;
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % NSTAGES;
    const int q0 = (qt0 + it % n_q) * BN;
    const uint32_t sq = sRing + s * T::STAGE_BYTES, sdo = sq + T::N_BYTES;
    const float* vec = vec_ptr + s * 2 * BN;
    // K's and V's addresses through an opaque copy, so that their wgmma
    // descriptors are made in the loop, not held in registers across it.
    uint32_t kb = k_wg, vb = v_wg;
    asm volatile("" : "+r"(kb), "+r"(vb));
    float st[BN / 2], dpt[BN / 2];
    mbar_wait(full + 8 * s, (it / NSTAGES) & 1);
    wgmma_fence();
    issue_scores<HD>(st, kb, T::M_CHUNK, sq);              // S^T = K.Q^T
    issue_scores<HD>(dpt, vb, T::M_CHUNK, sdo);            // dP^T = V.dO^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T, in place of S^T, and its bf16 A fragment; a tile masks only where
    // some q row precedes some key.  dV += P^T.dO runs while dS^T is made.
    const bool mask = q0 < key_first + 63;
    uint32_t pa[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {                     // columns j*8 + (lane%4)*2 + e
      const int col = j * 8 + (lane % 4) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(vec + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        st[i] = ex2(fmaf(st[i], scale_log2, -((e & 1) ? l2.y : l2.x) * LOG2E));
        if (mask && q0 + col + (e & 1) < key0 + ((e & 2) ? 8 : 0)) st[i] = 0.f;
      }
      pa[2 * j] = pack_bf16(st[4 * j], st[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
    }
    fence_regs(dv_acc);
    fence_regs(pa);
    wgmma_fence();
    issue_acc<HD>(dv_acc, pa, sdo);
    wgmma_commit();

    uint32_t hi[BN / 4], lo[BN / 4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 dd = *reinterpret_cast<const float2*>(vec + BN + j * 8 + (lane % 4) * 2);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dd.y : dd.x));
      split_bf16(ds[0], ds[1], hi[2 * j], lo[2 * j]);
      split_bf16(ds[2], ds[3], hi[2 * j + 1], lo[2 * j + 1]);
    }
    fence_regs(dk_acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_acc<HD>(dk_acc, hi, sq);                         // dK += dS^T.Q, hi then lo
    issue_acc<HD>(dk_acc, lo, sq);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(hi);
    fence_regs(lo);
    release(empty + 8 * s, lane);
    // Iteration it + NSTAGES - 1 into the stage of iteration it - 1, once
    // both warpgroups are done with it (the other may still be in iteration it).
    const int next = it + NSTAGES - 1;
    if (loader && next < n_iter) {
      if (next >= NSTAGES) mbar_wait(empty + 8 * (next % NSTAGES), ((next / NSTAGES) - 1) & 1);
      load(next);
    }
    __syncwarp();
  }

  store_rows<HD>(dk, dk_acc, scale, b, S, KH, kh, key0, lane);
  store_rows<HD>(dv, dv_acc, 1.f, b, S, KH, kh, key0, lane);
}

// ---- dQ -----------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, const float* lse,
                    const float* delta, __nv_bfloat16* dq, int B, int S, int H, int KH,
                    float scale_log2, float scale) {
  using T = BwdTile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sDO = sQ + T::M_BYTES;         // NCH chunks of BM x 64 each
  const uint32_t sRing = sDO + T::M_BYTES;                 // per stage: K, then V
  const uint32_t qo_full = base + T::BAR_OFFSET;
  const uint32_t full = qo_full + 8, empty = full + 8 * NSTAGES;

  // Block t: q tile n_qt - 1 - t / (B * H), the last q tiles (the most key tiles) first.
  const int n_qt = (S + BM - 1) / BM;
  const int qt = n_qt - 1 - int(blockIdx.x / (B * H));
  const int b = (blockIdx.x % (B * H)) / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int q0 = qt * BM;
  const int s_pad = (S + S_ALIGN - 1) / S_ALIGN * S_ALIGN;
  const int n_iter = (min(q0 + BM, S) - 1) / BN + 1;       // key tiles up to the diagonal

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < NSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NCONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NCONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONSUMERS) {
      mbar_expect_tx(qo_full, 2 * T::M_BYTES);
      for (int c = 0; c < T::NCH; ++c) {
        tma_load_4d(sQ + c * T::M_CHUNK, &tm_q, qo_full, c * 64, h, q0, b);
        tma_load_4d(sDO + c * T::M_CHUNK, &tm_do, qo_full, c * 64, h, q0, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % NSTAGES;
        const uint32_t st = sRing + s * T::STAGE_BYTES;
        if (it >= NSTAGES) mbar_wait(empty + 8 * s, ((it / NSTAGES) - 1) & 1);
        mbar_expect_tx(full + 8 * s, T::STAGE_BYTES);
        for (int c = 0; c < T::NCH; ++c) {
          tma_load_4d(st + c * T::N_CHUNK, &tm_k, full + 8 * s, c * 64, kh, it * BN, b);
          tma_load_4d(st + T::N_BYTES + c * T::N_CHUNK, &tm_v, full + 8 * s, c * 64, kh, it * BN,
                      b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row_first = q0 + wg * 64;                      // this warpgroup's q rows
  const int row0 = row_first + ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // and row0 + 8
  const uint32_t q_wg = sQ + wg * 64 * 128, do_wg = sDO + wg * 64 * 128;
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = (size_t(b) * H + h) * s_pad + row0 + 8 * r;
    lse2[r] = lse[at] * LOG2E;
    dd[r] = delta[at];
  }
  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
  mbar_wait(qo_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % NSTAGES;
    const int key_first = it * BN;
    const uint32_t sk = sRing + s * T::STAGE_BYTES, sv = sk + T::N_BYTES;
    uint32_t qb = q_wg, dob = do_wg;                       // opaque, as in dK/dV
    asm volatile("" : "+r"(qb), "+r"(dob));
    float sc[BN / 2], dp[BN / 2];
    mbar_wait(full + 8 * s, (it / NSTAGES) & 1);
    wgmma_fence();
    issue_scores<HD>(sc, qb, T::M_CHUNK, sk);              // S = Q.K^T
    issue_scores<HD>(dp, dob, T::M_CHUNK, sv);             // dP = dO.V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS; a tile masks only where some key follows some q row.
    const bool mask = key_first + BN - 1 > row_first;
    uint32_t hi[BN / 4], lo[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = ((i + e) >> 1) & 1;
        float p = ex2(fmaf(sc[i + e], scale_log2, -lse2[r]));
        if (mask && key_first + ((i + e) / 4) * 8 + (lane % 4) * 2 + e > row0 + 8 * r) p = 0.f;
        ds[e] = p * (dp[i + e] - dd[r]);
      }
      split_bf16(ds[0], ds[1], hi[i / 2], lo[i / 2]);
    }

    fence_regs(dq_acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
    issue_acc<HD>(dq_acc, hi, sk);                         // dQ += dS.K, hi then lo
    issue_acc<HD>(dq_acc, lo, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(hi);
    fence_regs(lo);
    release(empty + 8 * s, lane);
  }

  store_rows<HD>(dq, dq_acc, scale, b, S, H, h, row0, lane);
}

// ---- host side ----------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S, int H,
           int KH, float scale, cudaStream_t stream) {
  using T = BwdTile<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int s_pad = (S + S_ALIGN - 1) / S_ALIGN * S_ALIGN;
  const long long rows = (long long)B * H * s_pad;
  flash_bwd_delta_kernel<<<int((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, B, S,
      H, HD, s_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dK/dV streams Q and dO in BN-row tiles over BM-key work tiles; dQ the reverse.
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, S, H, HD, BN) || !make_map(&mk, k, B, S, KH, HD, BM) ||
      !make_map(&mv, v, B, S, KH, HD, BM) || !make_map(&mdo, dout, B, S, H, HD, BN))
    return ERR_TENSOR_MAP;
  const float scale_log2 = scale * LOG2E;
  const int n_tiles = (S + BM - 1) / BM;                   // key tiles or q tiles
  flash_bwd_dkdv_kernel<HD><<<B * KH * n_tiles, NCONSUMERS, T::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, S, H, KH, scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (!make_map(&mq, q, B, S, H, HD, BM) || !make_map(&mk, k, B, S, KH, HD, BN) ||
      !make_map(&mv, v, B, S, KH, HD, BN) || !make_map(&mdo, dout, B, S, H, HD, BM))
    return ERR_TENSOR_MAP;
  flash_bwd_dq_kernel<HD><<<B * H * n_tiles, NTHREADS, T::SMEM, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<__nv_bfloat16*>(dq), B, S, H, KH, scale_log2,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, o, dout and dq (B, S, H, hd), k, v, dk and dv (B, S, KH, hd), all
// contiguous and 16-byte aligned; lse (the forward's stats) and delta (scratch)
// float32 (B, H, s_pad), s_pad = S rounded up to 128.  Causal; hd in
// {64, 80, 128}; scale = 1/sqrt(hd) as in the forward.  Returns 0 on success,
// a cudaError_t of a launch, or 1000 when a tensor map cannot be made; the
// kernels run on `stream` and are not waited for.
int flash_bwd_sm90(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int KH, int hd, float scale, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (hd) {
    case 64: return launch<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KH, scale, s);
    case 80: return launch<80>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KH, scale, s);
    case 128: return launch<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KH, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of either kernel at head dim hd (0 if
// hd is not taken).
int flash_bwd_sm90_smem_bytes(int hd) {
  switch (hd) {
    case 64: return BwdTile<64>::SMEM;
    case 80: return BwdTile<80>::SMEM;
    case 128: return BwdTile<128>::SMEM;
    default: return 0;
  }
}

const char* flash_bwd_sm90_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled is missing or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
