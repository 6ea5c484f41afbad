// RWKV6 WKV chunked scan for Hopper tensor cores (sm_90a), from a zero state.
//
// Replaces the Pallas TPU kernel `_rwkv6_kernel` in
// src/repro/kernels/rwkv6/chunked.py (launched by `rwkv6_chunked_hmajor`,
// wrapped by src/repro/kernels/rwkv6/ops.py::rwkv6_mix).  It computes what
// that kernel computes, per channel p, with C the cumulative log decay over a
// chunk (kept times log2(e), so that the SFU's 2^x applies) and C_{-1} = 0:
//
//   o_t = (r_t ⊙ 2^{C_{t-1}}) · S
//       + sum_{s<t} (sum_p r_tp k_sp 2^{C_{t-1,p} - C_{s,p}}) v_s + (r_t ⊙ u ⊙ k_t) · v_t
//   S'  = diag(2^{C_L}) S + (k ⊙ 2^{C_L - C})^T v
//
// starting from S = 0, chunk by chunk.  The output does not depend on the
// chunk length, so the kernel runs chunks of L = 64 steps whatever chunk the
// caller names; steps past S are TMA zero-fill (r = k = v = 0, logw = 0),
// which leaves the state as it is.  Every exponent is <= 0: C does not
// increase (a float32 sum of non-positive terms cannot grow), and no
// exponential of a positive number is ever formed.
//
// Sub-chunk anchoring.  A chunk is cut into NSUB sub-chunks of SUB steps, and
// A_m = C_{SUB m - 1} is the cumulative decay at the end of sub-chunk m - 1
// (A_0 = 0, A_NSUB = C_{L-1}).  For t in sub-chunk i and s in sub-chunk j < i
// the score factors through the anchor A_{j+1}:
//   2^{C_{t-1} - C_s} = 2^{C_{t-1} - A_i} · 2^{A_i - A_{j+1}} · 2^{A_{j+1} - C_s}
// with every factor <= 1.  So, with
//   rho_t  = r_t ⊙ 2^{C_{t-1} - A_i}            (one exponential per element of r)
//   kt_s   = k_s ⊙ 2^{A_{j+1} - C_s}            (one exponential per element of k)
//   X_{im} = 2^{A_i - A_m}, 0 <= m < i <= NSUB  (a table of P exponentials per pair)
// the off-diagonal score blocks are plain products,
//   score[t in i, s in j] = (rho ⊙ X_{i,j+1}) · kt_s^T       (rows at or before
//   the anchor are zeroed in the operand, never exponentiated),
// the inter-chunk operand is r ⊙ 2^{C_{t-1}} = rho ⊙ X_{i,0}, and the state
// update's is k ⊙ 2^{C_L - C} = kt ⊙ X_{NSUB,j+1} (direct in the last
// sub-chunk).  The diagonal SUB x SUB blocks (s < t inside one sub-chunk, and
// the u bonus on their diagonal) are summed in the direct form on the CUDA
// cores, one exponential per (t, s, p).
//
// Products on the tensor cores at float32 accuracy.  Every product is a
// split-TF32 wgmma (m64nNk8, float32 accumulators): a = hi + lo with hi = a
// with its low 13 mantissa bits cleared and lo = tf32(a - hi), and
// a.b = hi.hi + hi.lo + lo.hi.  One TF32 product alone misses the 2e-4
// tolerance (PERF.md).  With bfloat16 r, k, v, v is exact in TF32, so a
// product whose B operand is v takes two wgmmas (hi.v + lo.v), chosen at
// compile time by the input type.  wgmma takes 32-bit operands K-major only:
//   inter (t, o)  = (rho X)(t, p) . S^T(o, p)     S^T written from the state's registers
//   score (t, s)  = (rho X)(t, p) . kt(s, p)      kt written split, K-major
//   intra (t, o) += A(t, s) . V^T(o, s)           A from registers, V^T written transposed
//   S     (p, o)  = (kt X)^T(p, t) . V^T(o, t)    A from registers
// Every A operand is built in registers one k-step at a time.
//
// Layout: r, k, v (B, S, H, P) float32 or bfloat16, logw (B, S, H, P)
// float32, all contiguous and read through 4-D TMA tensor maps over
// (P, H, S, B), 128-byte swizzle, box 64 steps; u (H, P) float32; the output
// (B, S, H, P) and the final state (B, H, P, P) float32.  P <= 64 and a
// multiple of 4 (float32) or 8 (bfloat16): TMA's 16-byte strides.  TMA
// zero-fills the box past P or S.
//
// Design.  One block of one warpgroup owns one (b, h) and walks its chunks;
// warp w holds rows 16w .. 16w + 15 of every 64-row product.  Per chunk:
// (1) wait for the chunk's TMA loads; the cumulative log decay as a warp scan
// per channel (lane pair: one channel, two halves of the chunk), written in
// place of logw, and the X table; (2) kt (split, K-major) and the u bonus
// of each step; (3) one k-step (8 channels) at a time: rho for the thread's
// fragment entries, the inter product and the NSUB - 1 score products issued
// as one commit group from one fragment buffer, and behind the group, on the
// CUDA cores, a share of the diagonal blocks, summed directly into the
// A-fragment entries of the thread's rows, before the group is waited for;
// (4) V^T written over S^T's buffer; (5) A . V (the score accumulators moved
// into the A-fragment layout by shuffles) and the state update, one commit
// group per k-step from two fragment buffers in turn; (6) the output by
// predicated stores from registers, the next chunk's TMA loads issued into
// the freed stage, S^T written for the next chunk.  The state stays in
// registers (32 floats a thread).  Float32 inputs use a 2-stage ring (192
// KB, one block per SM); bfloat16 inputs one stage (100 KB), so that two
// blocks share an SM and cover each other's loads and waits.  Every
// shared-memory load of (3) is unconditional (rows clamped, then a select):
// a conditional load compiled to a branch with its address recomputed
// inside, and cost a third of the loop.  The loop of (3) is not unrolled
// (unrolled, it spilled); the loop of (5) is, since the score accumulators
// it reads are indexed by its k-step.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 495 TFLOP/s dense TF32): at
// rwkv6-3b's prefill (B=8, S=512, H=40, P=64) the function moves r, k, v,
// logw, u, the output and the state once: 152 MB with bfloat16 r, k, v
// (45 us), 215 MB with float32 (64 us); its least operations (chip_smoke.py's
// rwkv6_work, at the best chunk length) are 2.94 GFLOP, three times that
// in split TF32 is 18 us: bytes bound it.  The kernel's exponentials, most of
// them in the diagonal blocks (about 31 K per chunk and head at SUB = 16),
// run on the SFU at 16 a clock per SM.  Where its time goes is measured by
// tools/rwkv6_sm90_ablate.py (PERF.md).
//
// Every mbarrier wait traps after about 10 s of spinning, so that a fault in
// the pipeline ends the launch with an error instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;                          // steps per chunk
constexpr int SUB = 16;                        // steps per sub-chunk
constexpr int NSUB = L / SUB;
constexpr int KROWS = L - SUB;                 // rows of kt the score products read
constexpr int NX = NSUB * (NSUB + 1) / 2;      // X table rows: X_{im}, 0 <= m < i <= NSUB
constexpr int WAVE = 4;                        // products of a k-step in one commit group
constexpr int NWAVE = (NSUB + WAVE - 1) / WAVE;  // groups per k-step: inter and NSUB - 1 scores
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NTHREADS = 128;                  // one warpgroup
constexpr unsigned FULL = 0xffffffffu;

// Shared memory, in bytes from a 1024-aligned base.  A float32 operand of 64
// columns is two chunks of 32 columns (128-byte rows, the 128-byte
// swizzle's row); a bfloat16 one is one chunk of 64 columns.
constexpr int TILE = L * 128;                  // 64 rows of 128 bytes

template <typename T>
struct Smem {
  static constexpr int IN = L * 64 * int(sizeof(T));   // r, k or v of one chunk
  static constexpr int NSTAGE = sizeof(T) == 4 ? 2 : 1;
  static constexpr int R = 0, K = IN, V = 2 * IN, LW = 3 * IN;  // LW: logw, then C
  static constexpr int STAGE = 3 * IN + 2 * TILE;
  static constexpr int KT = NSTAGE * STAGE;             // kt hi: two chunks of KROWS rows
  static constexpr int KT_CHUNK = KROWS * 128;
  static constexpr int KT_LO = 2 * KT_CHUNK;            //   then kt lo
  static constexpr int SV = KT + 4 * KT_CHUNK;          // S^T hi, lo; V^T hi, lo in turn
  static constexpr int SV_LO = 2 * TILE;
  static constexpr int XT = SV + 4 * TILE;               // X table, 64 floats a row
  static constexpr int UV = XT + NX * 256;               // u of the head, 64 floats
  static constexpr int BONUS = UV + 256;                 // sum_p r_tp u_p k_tp of each step t
  static constexpr int BAR = BONUS + 256;
  static constexpr int BYTES = BAR + 8 * NSTAGE + 1024;  // + slack to align the base
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One 4-D TMA tile load, completion counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Two floats to global memory when `pred` holds (a predicated store, not a
// branch).
__device__ __forceinline__ void st_global_if(float* ptr, float a, float b, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %3, 0;\n"
      "@p st.global.v2.f32 [%0], {%1, %2};\n}\n"
      :: "l"(ptr), "f"(a), "f"(b), "r"(int(pred)) : "memory");
}

// Generic-proxy accesses to shared memory ordered with wgmma's and TMA's.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor, K-major, 128-byte swizzle: SBO is
// the stride between 8-row groups (1024 bytes), LBO is unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t((addr & 0x3FFFF) >> 4)) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// The descriptor of a tile, made where it is used: the empty asm keeps the
// compiler from hoisting every k-step's 64-bit descriptor out of the loops
// into registers.
__device__ __forceinline__ uint64_t desc_at(uint32_t tile) {
  uint64_t d = smem_desc(tile);
  asm volatile("" : "+l"(d));
  return d;
}

// What to add to a tile's descriptor for k-step k (8 columns of 4 bytes) of
// a K-major operand whose 32-column chunks lie `chunk` bytes apart.
__device__ __forceinline__ constexpr uint64_t kstep(int k, int chunk) {
  return uint64_t((k / 4) * chunk + (k % 4) * 32) >> 4;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a wgmma operand across
// the asynchronous region (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D(64 x N) += A(64 x 8) . B(N x 8)^T, tf32, A in registers (four words a
// thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
// (N = 8: the score blocks at SUB = 8, tools/rwkv6_sm90_ablate.py's sub8.)
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- split TF32 ---------------------------------------------------------------

__device__ __forceinline__ float tf32_hi(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xffffe000u);
}
__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}
// The A fragment words of a: hi into f[e], lo into f[4 + e].
__device__ __forceinline__ void split_into(float a, uint32_t* f, int e) {
  const float hi = tf32_hi(a);
  f[e] = __float_as_uint(hi);
  f[4 + e] = __float_as_uint(tf32_rna(a - hi));  // a - hi is exact
}
__device__ __forceinline__ float4 hi4(float4 v) {
  return make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
}
__device__ __forceinline__ float4 lo4(float4 v, float4 h) {
  return make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z),
                     tf32_rna(v.w - h.w));
}

// 2^x by the SFU's approximation (relative error about 2^-22; below 2^-126
// it flushes to 0).  Every exponent is log2-scaled and <= 0.
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The decay factor of a diagonal-block term.  The exponent of an entry on or
// above the diagonal (replaced afterwards) may be positive, so it is clamped
// to 0 unless the entry lies below the diagonal by construction.
template <bool CLAMP>
__device__ __forceinline__ float diag_decay(float x) { return decay(CLAMP ? fminf(x, 0.f) : x); }

// ---- shared-memory layouts ------------------------------------------------------

// Byte offset of element (row, col) of a float32 K-major operand made of
// 32-column chunks `chunk` bytes apart, in the 128-byte swizzle (16-byte
// unit u of a row stored at u ^ (row & 7)).
__device__ __forceinline__ uint32_t swz(int row, int col, int chunk) {
  return (col >> 5) * chunk + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}
// The same for a bfloat16 tile of 64 columns (128-byte rows of 8 units).
__device__ __forceinline__ uint32_t swz_bf16(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Channels col .. col + 3 (col a multiple of 4) of row `row` of an input
// tile as TMA left it, in float32 (bfloat16 converts exactly).
template <typename T>
__device__ __forceinline__ float4 ld4(const uint8_t* tile, int row, int col);
template <>
__device__ __forceinline__ float4 ld4<float>(const uint8_t* tile, int row, int col) {
  return *reinterpret_cast<const float4*>(tile + swz(row, col, TILE));
}
template <>
__device__ __forceinline__ float4 ld4<__nv_bfloat16>(const uint8_t* tile, int row, int col) {
  const uint2 w = *reinterpret_cast<const uint2*>(tile + swz_bf16(row, col));
  return make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
}
template <typename T>
__device__ __forceinline__ float ld1(const uint8_t* tile, int row, int col);
template <>
__device__ __forceinline__ float ld1<float>(const uint8_t* tile, int row, int col) {
  return *reinterpret_cast<const float*>(tile + swz(row, col, TILE));
}
template <>
__device__ __forceinline__ float ld1<__nv_bfloat16>(const uint8_t* tile, int row, int col) {
  const uint16_t w = *reinterpret_cast<const uint16_t*>(tile + swz_bf16(row, col));
  return __uint_as_float(uint32_t(w) << 16);
}

__device__ __forceinline__ float ldf(const uint8_t* tile, int row, int col) {
  return *reinterpret_cast<const float*>(tile + swz(row, col, TILE));
}
__device__ __forceinline__ float4 ldf4(const uint8_t* tile, int row, int col) {
  return *reinterpret_cast<const float4*>(tile + swz(row, col, TILE));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// X_{im} = 2^{A_i - A_m} of channel p (1 when m == i).
__device__ __forceinline__ float xval(const float* xt, int i, int m, int p) {
  return m == i ? 1.f : xt[(i * (i - 1) / 2 + m) * 64 + p];
}

// ---- work ---------------------------------------------------------------------
//
// Fragments (wgmma's accumulator layout): thread `lane` of warp w holds rows
// r = w*16 + lane/4 and r + 8; its element i of an N-column accumulator lies
// in row r + 8 when (i & 2), column (i / 4) * 8 + (lane % 4) * 2 + (i & 1).
// A tf32 A fragment of k-step kk holds (r, 8kk + lane%4), (r + 8, same),
// (r, 8kk + lane%4 + 4), (r + 8, same).

// Is diagonal slot (row e, column slot cs) of a thread ever inside a
// diagonal block?  Column slots: cs -> 16w + {q, q + 4, 8 + q, 12 + q}.
__device__ __forceinline__ constexpr bool diag_slot(int e, int cs) {
  return e == 0 ? cs < 2 : (SUB == 16 || cs >= 2);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2)
rwkv6_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_r,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_lw, const float* __restrict__ u,
                      float* __restrict__ out, float* __restrict__ state_out, int S, int H,
                      int P) {
  using M = Smem<T>;
  constexpr bool EXACT_V = sizeof(T) == 2;  // bfloat16 v is exact in TF32: no V^T lo
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, generic
  const uint32_t full = base + M::BAR;
  float* const xt = reinterpret_cast<float*>(gbase + M::XT);
  float* const uv = reinterpret_cast<float*>(gbase + M::UV);
  float* const bonus = reinterpret_cast<float*>(gbase + M::BONUS);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8;   // fragment rows
  // Their sub-chunks (at SUB = 16 both are sub-chunk `warp`, which lets the
  // compiler share the loads of the two rows).
  const int i0 = SUB == 16 ? warp : r0 / SUB, i1 = SUB == 16 ? warp : r1 / SUB;
  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int n_chunks = (S + L - 1) / L;

  // Chunk c's TMA loads into stage c % NSTAGE, counted on its barrier.
  auto issue = [&](int c) {
    const int s = c % M::NSTAGE;
    const uint32_t stage = base + s * M::STAGE, bar = full + 8 * s;
    mbar_expect_tx(bar, M::STAGE);
    if (sizeof(T) == 4) {
      for (int half = 0; half < 2; ++half) {
        tma_load_4d(stage + M::R + half * TILE, &tm_r, bar, 32 * half, h, c * L, b);
        tma_load_4d(stage + M::K + half * TILE, &tm_k, bar, 32 * half, h, c * L, b);
        tma_load_4d(stage + M::V + half * TILE, &tm_v, bar, 32 * half, h, c * L, b);
      }
    } else {
      tma_load_4d(stage + M::R, &tm_r, bar, 0, h, c * L, b);
      tma_load_4d(stage + M::K, &tm_k, bar, 0, h, c * L, b);
      tma_load_4d(stage + M::V, &tm_v, bar, 0, h, c * L, b);
    }
    for (int half = 0; half < 2; ++half)
      tma_load_4d(stage + M::LW + half * TILE, &tm_lw, bar, 32 * half, h, c * L, b);
  };

  if (tid == 0) {
    for (int s = 0; s < M::NSTAGE; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < M::NSTAGE && c < n_chunks; ++c) issue(c);
  // S^T = 0 for the first chunk; u of the head, 0 past P.
  for (int i = tid; i < 4 * TILE / 16; i += NTHREADS)
    reinterpret_cast<float4*>(gbase + M::SV)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < 64) uv[tid] = tid < P ? u[size_t(h) * P + tid] : 0.f;
  fence_async_smem();

  float st[32];                                     // S (p, o), the carried state
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % M::NSTAGE;
    uint8_t* const stage = gbase + s * M::STAGE;
    const uint8_t* const rin = stage + M::R;        // the chunk's r, k, v as TMA left them
    const uint8_t* const kin = stage + M::K;
    const uint8_t* const vin = stage + M::V;
    uint8_t* const cw = stage + M::LW;              // logw, then C
    mbar_wait(full + 8 * s, (c / M::NSTAGE) & 1);

    // (1) C = log2(e) cumsum(logw) in place, and the X table.  Warp w takes
    // channels 16w .. 16w + 15; lanes l and l + 16 take steps 0..31 and
    // 32..63 of channel 16w + (l & 15).
    {
      const int p = 16 * warp + (lane & 15), hf = lane >> 4;
      float cs[32];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc += ldf(cw, 32 * hf + i, p);
        cs[i] = acc;
      }
      const float off = __shfl_sync(FULL, acc, lane & 15);   // the first half's total
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        cs[i] = (hf ? cs[i] + off : cs[i]) * LOG2E;
        *reinterpret_cast<float*>(cw + swz(32 * hf + i, p, TILE)) = cs[i];
      }
      float an[NSUB + 1];                              // A_m of the channel
      an[0] = 0.f;
#pragma unroll
      for (int m = 1; m <= NSUB; ++m) {
        const int step = SUB * m - 1;
        an[m] = __shfl_sync(FULL, cs[step & 31], (lane & 15) + 16 * (step >> 5));
      }
#pragma unroll
      for (int i = 1; i <= NSUB; ++i)
#pragma unroll
        for (int m = 0; m < i; ++m) {
          const int e = i * (i - 1) / 2 + m;
          if ((e & 1) == hf) xt[e * 64 + p] = decay(an[i] - an[m]);
        }
    }
    __syncthreads();

    // (2) kt = k 2^{A_{j+1} - C} (split, K-major) for the rows the score
    // products read, and the u bonus of each step (two threads a step).
    {
      const int t = tid >> 1, c0 = 32 * (tid & 1);
      float acc = 0.f;
#pragma unroll
      for (int p = c0; p < c0 + 32; p += 4) {
        const float4 rv = ld4<T>(rin, t, p), kv = ld4<T>(kin, t, p);
        const float4 uu = *reinterpret_cast<const float4*>(uv + p);
        acc = fmaf(rv.x * uu.x, kv.x, acc);
        acc = fmaf(rv.y * uu.y, kv.y, acc);
        acc = fmaf(rv.z * uu.z, kv.z, acc);
        acc = fmaf(rv.w * uu.w, kv.w, acc);
      }
      acc += __shfl_xor_sync(FULL, acc, 1);
      if (c0 == 0) bonus[t] = acc;
    }
    for (int it = tid; it < KROWS * 16; it += NTHREADS) {
      const int row = it >> 4, p = (it & 15) * 4;
      const int a = (row / SUB) * SUB + SUB - 1;
      const float4 kv = ld4<T>(kin, row, p), cv = ldf4(cw, row, p), av = ldf4(cw, a, p);
      const float4 v = make_float4(kv.x * decay(av.x - cv.x), kv.y * decay(av.y - cv.y),
                                   kv.z * decay(av.z - cv.z), kv.w * decay(av.w - cv.w));
      const float4 hv = hi4(v);
      *reinterpret_cast<float4*>(gbase + M::KT + swz(row, p, M::KT_CHUNK)) = hv;
      *reinterpret_cast<float4*>(gbase + M::KT + M::KT_LO + swz(row, p, M::KT_CHUNK)) = lo4(v, hv);
    }
    fence_async_smem();
    __syncthreads();

    // (3) On the tensor cores, one k-step (8 channels) at a time: the inter
    // product (rho X_{i,0}) . S^T and the NSUB - 1 score blocks
    // (rho X_{i,j+1}) . kt_j^T, with rho = r 2^{C_{t-1} - A_i} formed for the
    // k-step's fragment entries; up to WAVE products form one commit group,
    // issued from one fragment buffer.  Behind each group, on the CUDA cores,
    // a share of the diagonal blocks in the direct form, straight into the
    // A-fragment entries of the thread's rows: d[e][cs] = A(t_e, s_cs),
    // t_e = r0 / r1, s_cs = 16w + {q, q+4, 8+q, 12+q} (the u bonus from (2)
    // where s = t); only then is the group waited for and its buffer refilled.
    float oacc[32];
    float sacc[NSUB - 1][SUB / 2];
    float d[2][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NSUB - 1; ++j)
#pragma unroll
      for (int i = 0; i < SUB / 2; ++i) sacc[j][i] = 0.f;
    {
      uint32_t fr[WAVE][8];                             // a group's A operands; hi 0..3, lo 4..7
      const int tt[2] = {r0, r1};
      const int sc[4] = {16 * warp + q, 16 * warp + q + 4, 16 * warp + 8 + q, 16 * warp + 12 + q};
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int cs = 0; cs < 4; ++cs) d[e][cs] = 0.f;
      // Rows of C and of the X table that the thread reads, clamped, so that
      // every load is unconditional (a conditional load became a branch):
      // C_{t-1} (r1 - 1 >= 7), the anchor A_i, X_{i,.}.
      const int tm0 = r0 > 0 ? r0 - 1 : 0;
      const int ar[2] = {i0 > 0 ? SUB * i0 - 1 : 0, i1 > 0 ? SUB * i1 - 1 : 0};
      const int xr[2] = {i0 * (i0 - 1) / 2, i1 * (i1 - 1) / 2};
      // Not unrolled: no register array is indexed by kk, and one copy of the
      // body keeps the registers of one k-step live (unrolled, it spilled).
#pragma unroll 1
      for (int kk = 0; kk < 8; ++kk) {
        float rho[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 1) ? r1 : r0, i = (e & 1) ? i1 : i0;
          const int p = 8 * kk + q + ((e & 2) ? 4 : 0);
          const float cm = ldf(cw, (e & 1) ? r1 - 1 : tm0, p);
          const float an = ldf(cw, ar[e & 1], p);
          rho[e] = ld1<T>(rin, t, p) * decay((t > 0 ? cm : 0.f) - (i > 0 ? an : 0.f));
        }
#pragma unroll
        for (int wv = 0; wv < NWAVE; ++wv) {
          if (kk > 0 || wv > 0) {
            wgmma_wait<0>();                            // the last group is done with fr
#pragma unroll
            for (int n = 0; n < WAVE; ++n) fence_regs(fr[n]);
          }
          // Product n of the wave: 0 is the inter product, j + 1 score block j.
#pragma unroll
          for (int n = 0; n < WAVE; ++n) {
            const int prod = wv * WAVE + n;
            if (prod >= NSUB) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = (e & 1) ? i1 : i0;
              const int p = 8 * kk + q + ((e & 2) ? 4 : 0);
              // X_{i,prod} (a row of the table whatever i is; 1 when prod = i)
              const float xv = xt[(xr[e & 1] + prod) * 64 + p];
              const float a = rho[e] * (prod == i ? 1.f : xv);
              split_into(i >= prod ? a : 0.f, fr[n], e);
            }
          }
          fence_regs(oacc);
#pragma unroll
          for (int j = 0; j < NSUB - 1; ++j) fence_regs(sacc[j]);
#pragma unroll
          for (int n = 0; n < WAVE; ++n) fence_regs(fr[n]);
          wgmma_fence();
#pragma unroll
          for (int n = 0; n < WAVE; ++n) {
            const int prod = wv * WAVE + n;
            if (prod >= NSUB) continue;
            if (prod == 0) {
              const uint64_t ds = desc_at(base + M::SV), dsl = desc_at(base + M::SV + M::SV_LO);
              wgmma_rs(oacc, &fr[n][0], ds + kstep(kk, TILE));       // inter hi.hi
              wgmma_rs(oacc, &fr[n][0], dsl + kstep(kk, TILE));      // inter hi.lo
              wgmma_rs(oacc, &fr[n][4], ds + kstep(kk, TILE));       // inter lo.hi
            } else {
              const int j = prod - 1;
              const uint64_t dk = desc_at(base + M::KT + SUB * j * 128),
                             dkl = desc_at(base + M::KT + M::KT_LO + SUB * j * 128);
              float(&g)[SUB / 2] = sacc[j < NSUB - 1 ? j : 0];
              wgmma_rs(g, &fr[n][0], dk + kstep(kk, M::KT_CHUNK));    // score hi.hi
              wgmma_rs(g, &fr[n][0], dkl + kstep(kk, M::KT_CHUNK));   // score hi.lo
              wgmma_rs(g, &fr[n][4], dk + kstep(kk, M::KT_CHUNK));    // score lo.hi
            }
          }
          wgmma_commit();

          // The diagonal blocks over this wave's share of the k-step's channels.
#pragma unroll
          for (int p = 8 * kk + 8 * wv / NWAVE; p < 8 * kk + 8 * (wv + 1) / NWAVE; p += 4) {
            const float4 rv[2] = {ld4<T>(rin, r0, p), ld4<T>(rin, r1, p)};
            const float4 c0 = ldf4(cw, tm0, p);
            const float4 cv[2] = {r0 > 0 ? c0 : make_float4(0.f, 0.f, 0.f, 0.f),
                                  ldf4(cw, r1 - 1, p)};
#pragma unroll
            for (int cs = 0; cs < 4; ++cs) {
              const float4 kv = ld4<T>(kin, sc[cs], p), ck = ldf4(cw, sc[cs], p);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                if (!diag_slot(e, cs)) continue;
                // Below the diagonal by construction (SUB = 16: rows 8..15 of
                // the sub-chunk, columns 0..7): no clamp needed.
                const bool below = SUB == 16 && e == 1 && cs < 2;
#pragma unroll
                for (int ch = 0; ch < 4; ++ch) {
                  const float x = comp(cv[e], ch) - comp(ck, ch);
                  const float w = below ? diag_decay<false>(x) : diag_decay<true>(x);
                  d[e][cs] = fmaf(comp(rv[e], ch) * comp(kv, ch), w, d[e][cs]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bn = bonus[tt[e]];
#pragma unroll
        for (int cs = 0; cs < 4; ++cs)
          d[e][cs] = !diag_slot(e, cs) || sc[cs] > tt[e] ? 0.f : sc[cs] == tt[e] ? bn : d[e][cs];
      }
      wgmma_wait<0>();
      fence_regs(oacc);
#pragma unroll
      for (int j = 0; j < NSUB - 1; ++j) fence_regs(sacc[j]);
#pragma unroll
      for (int n = 0; n < WAVE; ++n) fence_regs(fr[n]);
    }
    __syncthreads();                                    // S^T is read: its buffer takes V^T

    // (4) V^T (split unless v is bfloat16) over S^T's buffer: thread block
    // (t 4tb..+3, o 4pb..+3) of each 32-column half; the (tb, pb) of a
    // quarter warp are chosen so that neither the reads nor the writes
    // conflict on a bank.
    {
      const int k8 = lane & 7, gq = warp * 4 + (lane >> 3);
      const int tb = 8 * (gq >> 3) + k8, pb = k8 ^ (gq & 7);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 x[4];
#pragma unroll
        for (int jr = 0; jr < 4; ++jr) x[jr] = ld4<T>(vin, 4 * tb + jr, 32 * half + 4 * pb);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int o = 32 * half + 4 * pb + i;
          const uint32_t off = (tb >> 3) * TILE + o * 128 + (((tb & 7) ^ (o & 7)) << 4);
          const float4 xv = make_float4(comp(x[0], i), comp(x[1], i), comp(x[2], i), comp(x[3], i));
          if (EXACT_V) {
            *reinterpret_cast<float4*>(gbase + M::SV + off) = xv;
          } else {
            const float4 hv = hi4(xv);
            *reinterpret_cast<float4*>(gbase + M::SV + off) = hv;
            *reinterpret_cast<float4*>(gbase + M::SV + M::SV_LO + off) = lo4(xv, hv);
          }
        }
      }
    }
    fence_async_smem();
    __syncthreads();

    // (5) intra = A . V, A's k-step kk (columns 8kk .. 8kk + 7): the score
    // block's accumulators moved into the A-fragment layout by shuffles below
    // the diagonal block, the diagonal entries on it, 0 above.  Beside it, in
    // the same commit group, the state update S' = 2^{C_L} S + khat^T . V with
    // khat = kt X_{NSUB,j+1} (k 2^{C_L - C} in the last sub-chunk).
    {
      const uint64_t dv = desc_at(base + M::SV), dvl = desc_at(base + M::SV + M::SV_LO);
      const int src0 = (lane & ~3) | (q >> 1), src1 = src0 + 2;
      const bool odd = q & 1;
      const float dec0 = xval(xt, NSUB, 0, r0), dec1 = xval(xt, NSUB, 0, r1);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] *= (i & 2) ? dec1 : dec0;
      const uint8_t* const kth = gbase + M::KT;
      const uint8_t* const ktl = gbase + M::KT + M::KT_LO;
      // kt (t, p) at t = 8kk + q + 4h lies 1024 kk bytes past (q + 4h, p).
      uint32_t kb[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) kb[e][hh] = swz(q + 4 * hh, e ? r1 : r0, M::KT_CHUNK);
      uint32_t fa[2][2][8];                             // intra, then state; hi 0..3, lo 4..7
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t(&f)[2][8] = fa[kk & 1];
        if (kk >= 2) {
          wgmma_wait<1>();                              // step kk - 2 is done with f
          fence_regs(f[0]);
          fence_regs(f[1]);
        }
        const int jb = 8 * kk / SUB, m = (8 * kk % SUB) / 8;
        float cand[4] = {0.f, 0.f, 0.f, 0.f};
        if (jb < NSUB - 1) {
          const int jg = jb < NSUB - 1 ? jb : 0;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float e0 = __shfl_sync(FULL, sacc[jg][4 * m + 2 * rr], src0);
            const float e1 = __shfl_sync(FULL, sacc[jg][4 * m + 2 * rr + 1], src0);
            const float f0 = __shfl_sync(FULL, sacc[jg][4 * m + 2 * rr], src1);
            const float f1 = __shfl_sync(FULL, sacc[jg][4 * m + 2 * rr + 1], src1);
            cand[rr] = odd ? e1 : e0;
            cand[2 + rr] = odd ? f1 : f0;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e & 1, ch = e >> 1;
          const int ib = SUB == 16 ? warp : 2 * warp + rr;
          const float dg = kk == 2 * warp ? d[rr][ch] : d[rr][2 + ch];
          split_into(jb < ib ? cand[e] : (jb == ib ? dg : 0.f), f[0], e);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = (e & 1) ? r1 : r0;
          const int t = 8 * kk + q + ((e & 2) ? 4 : 0);
          float a;
          if (jb < NSUB - 1) {
            const uint32_t off = kb[e & 1][e >> 1] + 1024 * kk;
            a = (*reinterpret_cast<const float*>(kth + off) + *reinterpret_cast<const float*>(ktl + off)) *
                xval(xt, NSUB, jb + 1, p);
          } else {
            a = ld1<T>(kin, t, p) * decay(ldf(cw, L - 1, p) - ldf(cw, t, p));
          }
          split_into(a, f[1], e);
        }
        fence_regs(oacc);
        fence_regs(st);
        fence_regs(f[0]);
        fence_regs(f[1]);
        wgmma_fence();
        wgmma_rs(oacc, &f[0][0], dv + kstep(kk, TILE));             // intra hi.hi
        if (!EXACT_V) wgmma_rs(oacc, &f[0][0], dvl + kstep(kk, TILE));  // intra hi.lo
        wgmma_rs(oacc, &f[0][4], dv + kstep(kk, TILE));             // intra lo.hi
        wgmma_rs(st, &f[1][0], dv + kstep(kk, TILE));               // state hi.hi
        if (!EXACT_V) wgmma_rs(st, &f[1][0], dvl + kstep(kk, TILE));    // state hi.lo
        wgmma_rs(st, &f[1][4], dv + kstep(kk, TILE));               // state lo.hi
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(oacc);
#pragma unroll
      for (int b2 = 0; b2 < 2; ++b2) {
        fence_regs(fa[b2][0]);
        fence_regs(fa[b2][1]);
      }
    }

    // (6) The output, rows t < S and columns o < P.
    {
      const int t0 = c * L + r0;
      float* const o0 = out + ((size_t(b) * S + t0) * H + h) * P + q * 2;
      float* const o1 = o0 + size_t(8) * H * P;
      const bool ok0 = t0 < S, ok1 = t0 + 8 < S;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int o = (i / 4) * 8 + q * 2;
        st_global_if(((i & 2) ? o1 : o0) + (i / 4) * 8, oacc[i], oacc[i + 1],
                     ((i & 2) ? ok1 : ok0) && o < P);
      }
    }
    fence_async_smem();
    __syncthreads();                                    // the stage and V^T are consumed
    if (tid == 0 && c + M::NSTAGE < n_chunks) issue(c + M::NSTAGE);
    // S^T of the new state, split, for the next chunk's inter product:
    // element i of st is S (p, o), p = r0 (+ 8 when i & 2), o = o0 + 8 (i / 4)
    // with o0 = 2q + (i & 1), and S^T (o, p) lies 1024 (i / 4) bytes past
    // S^T (o0, p).
    uint32_t sb[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) sb[e][bb] = swz(2 * q + bb, e ? r1 : r0, TILE);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint32_t off = sb[(i >> 1) & 1][i & 1] + 1024 * (i / 4);
      const float hv = tf32_hi(st[i]);
      *reinterpret_cast<float*>(gbase + M::SV + off) = hv;
      *reinterpret_cast<float*>(gbase + M::SV + M::SV_LO + off) = tf32_rna(st[i] - hv);
    }
    fence_async_smem();
  }

  // The final state, rows p < P and columns o < P.
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int p = r0 + ((i & 2) ? 8 : 0);
    const int o = (i / 4) * 8 + q * 2;
    if (p < P && o < P)
      *reinterpret_cast<float2*>(state_out + ((size_t(b) * H + h) * P + p) * P + o) =
          make_float2(st[i], st[i + 1]);
  }
}

// ---- host side --------------------------------------------------------------

constexpr int ERR_TENSOR_MAP = 1000;  // returned when a tensor map cannot be made

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A contiguous (B, S, H, P) tensor of `esize`-byte elements seen as
// (P, H, S, B); box (128 bytes of P, 1, 64, 1) with the 128-byte swizzle;
// out-of-bounds elements read as 0.
bool make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type, int esize, int B,
              int S, int H, int P) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(P), cuuint64_t(H), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t row = cuuint64_t(P) * esize;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {cuuint32_t(128 / esize), 1, L, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* logw, const void* u,
           void* out, void* state, int B, int S, int H, int P, cudaStream_t stream) {
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mr, mk, mv, mlw;
  if (!make_map(&mr, r, type, sizeof(T), B, S, H, P) ||
      !make_map(&mk, k, type, sizeof(T), B, S, H, P) ||
      !make_map(&mv, v, type, sizeof(T), B, S, H, P) ||
      !make_map(&mlw, logw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, S, H, P))
    return ERR_TENSOR_MAP;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rwkv6_fwd_sm90_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  rwkv6_fwd_sm90_kernel<T><<<B * H, NTHREADS, Smem<T>::BYTES, stream>>>(
      mr, mk, mv, mlw, static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<float*>(state), S, H, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v (B, S, H, P) contiguous, float32 (dtype 0) or bfloat16 (dtype 1),
// 16-byte aligned; logw (B, S, H, P) and u (H, P) contiguous float32; out
// (B, S, H, P) and state (B, H, P, P) contiguous float32.  P in 4..64, a
// multiple of 4 (float32) or 8 (bfloat16).  Returns 0, a cudaError_t of the
// launch, or 1000 when a tensor map cannot be made; the kernel runs on
// `stream` and is not waited for.
int rwkv6_fwd_sm90(const void* r, const void* k, const void* v, const void* logw, const void* u,
                   void* out, void* state, int B, int S, int H, int P, int dtype, void* stream) {
  const int align = dtype == 1 ? 8 : 4;
  if (B < 1 || S < 1 || H < 1 || P < 4 || P > 64 || P % align || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, logw, u, out, state, B, S, H, P, s);
  return launch<__nv_bfloat16>(r, k, v, logw, u, out, state, B, S, H, P, s);
}

// Blocks of the kernel for r, k, v of `dtype` that one SM holds at once (0
// on an error).
int rwkv6_fwd_sm90_blocks_per_sm(int dtype) {
  int n = 0;
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(rwkv6_fwd_sm90_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<__nv_bfloat16>::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, rwkv6_fwd_sm90_kernel<__nv_bfloat16>, NTHREADS, Smem<__nv_bfloat16>::BYTES);
  } else {
    err = cudaFuncSetAttribute(rwkv6_fwd_sm90_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<float>::BYTES);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rwkv6_fwd_sm90_kernel<float>,
                                                          NTHREADS, Smem<float>::BYTES);
  }
  return err == cudaSuccess ? n : 0;
}

// Dynamic shared memory of one block, bytes, for r, k, v of `dtype`.
int rwkv6_fwd_sm90_smem_bytes(int dtype) {
  return dtype == 1 ? Smem<__nv_bfloat16>::BYTES : Smem<float>::BYTES;
}

const char* rwkv6_fwd_sm90_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled is missing or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
