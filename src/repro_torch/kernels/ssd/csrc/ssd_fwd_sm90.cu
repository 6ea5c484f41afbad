// Mamba2 SSD chunked scan for Hopper tensor cores (sm_90a), from a zero state.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` in
// src/repro/kernels/ssd/chunked.py (launched by `ssd_chunked_hmajor`,
// wrapped by src/repro/kernels/ssd/ops.py::ssd_scan).  It computes what that
// kernel computes, with xw = dt * x and la = dt * A formed here in float32:
//
//   cla      = cumsum(la)                     (over a chunk, float64)
//   y_t      = sum_{s<=t} (C_t . B_s) e^{cla_t - cla_s} xw_s + e^{cla_t} C_t . S
//   S'       = e^{cla_L} S + sum_t (B_t e^{cla_L - cla_t}) xw_t^T
//
// starting from S = 0, chunk by chunk.  The output does not depend on the
// chunk length, so the kernel runs chunks of L = 64 steps whatever chunk the
// caller names (64 is wgmma's row count, and a 64-step chunk of every operand
// fits in shared memory).  Every exponent is a float64 difference <= 0
// (cla does not increase) rounded once to float32: a float32 cumulative
// sum misses 2e-4 at zamba2-2.7b's serve shape (PERF.md).  cla is kept
// times log2(e), so that the SFU's 2^x applies.
// Head h reads B/C group h / (H / G).
//
// Layout: x (B, S, H, P), B and C (B, S, G, N) in float32, read through 4-D
// TMA tensor maps over (P, H, S, B) and (N, G, S, B) with the caller's
// (batch, sequence) strides; dt (B, S, H) and A (H,) float32; y (B, S, H, P),
// written through a TMA map, and the final state (B, H, N, P) float32.
// N, P <= 64 and multiples of 4 (TMA's 16-byte strides); TMA zero-fills the
// box past N, P or S on loads and drops it on stores.
//
// Products on the tensor cores at float32 accuracy.  Every product is a
// split-TF32 wgmma (m64n32k8, float32 accumulators): a = hi + lo with
// hi = a with its low 13 mantissa bits cleared and lo = tf32(a - hi), and
// a.b = hi.hi + hi.lo + lo.hi (the lo.lo term is below 2^-20 |a b|).  One
// TF32 product alone misses the 2e-4 tolerance (PERF.md).  wgmma takes 32-bit
// operands K-major only, so:
//   G   (t, s) = C (t, n) . B (s, n)         both straight from TMA
//   y   (t, p) = C (t, n) . S^T (p, n)       S^T written from the state's registers
//             + M (t, s) . xw^T (p, s)       M = G masked and decayed, A from registers
//   S   (n, p) = (B w)^T (n, t) . xw^T (p, t)    A from registers
// with xw^T written transposed (and split) by the pass that scales x by dt.
//
// Design.  A block is persistent and walks work units of (batch b, group g,
// up to five heads of g; a unit past the group's last head repeats that head
// and stores nothing for it).
// Three warpgroups: a producer whose one working thread keeps TMA loads in
// flight (a ring of 2 stages of C and B per chunk, a ring of 2 x tiles per
// (chunk, head); mbarriers count the bytes), and two consumer warpgroups,
// which split every head's P columns between them (y[:, p] and S[:, p] read
// only xw[:, p]).  Per chunk the consumers split C (warpgroup 0) and B
// (warpgroup 1) into hi / lo in shared memory, each computes half of
// G = C.B^T's columns and leaves them in shared memory in wgmma's A-fragment
// order, so G is computed once per unit and chunk, not once per head.  Then
// for each head of the unit: the transposing pass x -> dt x -> (hi, lo) of
// xw^T and the state's S^T; C.S; M built one k-step at a time beside the
// tensor cores (two fragment buffers in turn, each step's products issued as
// soon as its fragment is ready); M.xw; y into shared memory and out by one
// TMA store per warpgroup; (B w)^T built and the state updated the same way.
// The state's accumulators stay in registers across chunks (16 floats a
// thread and head); the heads' loop is not unrolled, so that one copy of its
// body fits the instruction cache (five copies of it ran slower), and the
// states rotate through st[0] instead.  The cumulative decays of the unit's
// heads over a chunk are float64 warp scans, warp j of the eight taking head
// j, done beside C.B^T with dt loaded before the split.
// Exponentials: 2^{cla_t}, 2^{cla_L - cla_t} and 2^{cla_L} once per step and
// head, one per score element on or below the diagonal (a warp skips the
// k-steps right of its rows).
//
// Bound on an H100 SXM (3.35 TB/s HBM, 495 TFLOP/s dense TF32): at
// zamba2-2.7b's prefill (B=8, S=512, H=80, P=64, G=1, N=64) the function
// moves x, y, dt, B, C and the state once, 182 MB, 54 us; its least
// operations (chip_smoke.py's ssd_bound_ms, at the best chunk length) are
// 5.89 GFLOP, three times that in split TF32 is 36 us: bytes bound it.  The
// kernel's own tensor work, at L = 64 with C.B^T shared by five heads, is
// 25.8 GFLOP (52 us at peak).  Where its time goes is measured by
// tools/ssd_sm90_ablate.py (PERF.md).
//
// Registers: setmaxnreg gives each consumer thread 240 and the producer 24.
// The descriptor bases and the thread's coordinates go through empty asm
// statements where they are used, so that ptxas recomputes the addresses
// made from them instead of holding them across heads: it spilled before.
// Every mbarrier wait traps after about 10 s of spinning, so that a fault in
// the pipeline ends the launch with an error instead of hanging the card.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;                          // steps per chunk
constexpr double LOG2E = 1.4426950408889634;
constexpr int MAX_HEADS = 5;                   // heads per work unit
constexpr int NCONSUMERS = 256;                // two warpgroups, 32 columns of P each
constexpr int NTHREADS = NCONSUMERS + 128;     // and one producer warpgroup
constexpr int NST = 2;                         // C/B ring depth
constexpr int NXS = 2;                         // x ring depth

// Shared memory, in bytes from a 1024-aligned base.  A "tile" is 64 rows of
// 32 floats (128 bytes, the 128-byte swizzle's row), a "half" 32 such rows.
constexpr int TILE = L * 128;                  // 8192
constexpr int HALF = 32 * 128;                 // 4096
constexpr int GRP_STAGE = 4 * TILE;            // C (n 0..31, 32..63), then B
constexpr int X_OFF = NST * GRP_STAGE;         // x: two tiles (p 0..31, 32..63) per slot
constexpr int X_SLOT = 2 * TILE;
constexpr int LO_OFF = X_OFF + NXS * X_SLOT;   // C_lo, then B_lo (the hi parts stay in the stage)
constexpr int WG_OFF = LO_OFF + 4 * TILE;      // per consumer warpgroup:
constexpr int XWT = 0;                         //   xw^T hi (p 32 rows; t 0..31, 32..63)
constexpr int XWT_LO = 2 * HALF;               //   xw^T lo
constexpr int ST = 4 * HALF;                   //   S^T hi (p 32 rows; n 0..31, 32..63)
constexpr int ST_LO = 6 * HALF;                //   S^T lo
constexpr int WG_BYTES = 8 * HALF;
constexpr int GFR_OFF = WG_OFF + 2 * WG_BYTES;  // G in A-fragment order (float4 per thread
constexpr int GFR_BYTES = 4 * 8 * 32 * 16;      //   and k-step), read by both warpgroups
constexpr int SCAN_OFF = GFR_OFF + GFR_BYTES;
// One scan record per head of a unit: cla (64 doubles, times log2(e)), dt,
// 2^{cla_t}, 2^{cla_L - cla_t} (64 floats each), 2^{cla_L}.
constexpr int SC_DT = 512, SC_ECLA = 768, SC_W = 1024, SC_DECAY = 1280;
constexpr int SCAN_BYTES = 1536;
constexpr int BAR_OFF = SCAN_OFF + MAX_HEADS * SCAN_BYTES;
constexpr int NBARS = 2 * NST + 2 * NXS;
constexpr int SMEM = BAR_OFF + 8 * NBARS + 1024;   // + slack to align the base

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
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

// One 4-D TMA tile store from shared memory, in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
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
// into registers (which made the kernel spill).
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

// D(64 x 32) (+)= A(64 x 8) . B(32 x 8)^T, tf32, both in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D(64 x 32) += A(64 x 8) . B(32 x 8)^T, tf32, A in registers (four words a
// thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
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
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = tf32_hi(a);
  lo = tf32_rna(a - hi);  // a - hi is exact
}
__device__ __forceinline__ float4 hi4(float4 v) {
  return make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
}
__device__ __forceinline__ float4 lo4(float4 v, float4 h) {
  return make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z),
                     tf32_rna(v.w - h.w));
}

// 2^x by the SFU's approximation (relative error about 2^-22; below 2^-126
// it flushes to 0).  The exponents are log2-scaled: cla is kept times log2(e).
__device__ __forceinline__ float decay(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (row, col) of a K-major operand made of 32-column
// chunks `chunk` bytes apart, in the 128-byte swizzle (16-byte unit u of a
// row stored at u ^ (row & 7)).
__device__ __forceinline__ uint32_t swz(int row, int col, int chunk) {
  return (col >> 5) * chunk + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
}

// ---- work ---------------------------------------------------------------------
//
// Fragments (wgmma's accumulator layout): thread `lane` of warp w of a
// consumer warpgroup holds rows r = w*16 + lane/4 and r + 8; its element i
// of an N-column accumulator lies in row r + 8 when (i & 2), column
// (i / 4) * 8 + (lane % 4) * 2 + (i & 1).  A tf32 A fragment of k-step kk
// holds (r, 8kk + lane%4), (r + 8, same), (r, 8kk + lane%4 + 4), (r + 8, same).

struct Unit {
  int b, g, h0, n_valid;  // heads h0 .. h0 + n_valid - 1 of group g are this unit's
};

__device__ __forceinline__ Unit unit_of(int u, int G, int Hg) {
  constexpr int K = MAX_HEADS;
  const int n_sets = (Hg + K - 1) / K;
  Unit w;
  const int set = u % n_sets;
  const int bg = u / n_sets;
  w.g = bg % G;
  w.b = bg / G;
  w.h0 = w.g * Hg + set * K;
  w.n_valid = min(K, Hg - set * K);
  return w;
}

// A unit's head j: past the group's last head a unit repeats that head and
// stores nothing for it.
__device__ __forceinline__ int head_of(const Unit& w, int j) { return w.h0 + min(j, w.n_valid - 1); }

// The cumulative log decay of one (chunk, head), by one warp: lane l holds
// steps 2l and 2l + 1 (dt already loaded, 0 past S).
__device__ __forceinline__ void scan_chunk(uint8_t* rec, float dt0, float dt1, float a_h, int lane) {
  const float la0 = __fmul_rn(dt0, a_h), la1 = __fmul_rn(dt1, a_h);
  double incl = double(la0) + double(la1);
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double c0 = (excl + double(la0)) * LOG2E, c1 = (excl + double(la0) + double(la1)) * LOG2E;
  const double last = __shfl_sync(0xffffffffu, c1, 31);
  double* cla = reinterpret_cast<double*>(rec);
  float* dt = reinterpret_cast<float*>(rec + SC_DT);
  float* ecla = reinterpret_cast<float*>(rec + SC_ECLA);
  float* w = reinterpret_cast<float*>(rec + SC_W);
  cla[2 * lane] = c0;
  cla[2 * lane + 1] = c1;
  dt[2 * lane] = dt0;
  dt[2 * lane + 1] = dt1;
  ecla[2 * lane] = decay(float(c0));
  ecla[2 * lane + 1] = decay(float(c1));
  w[2 * lane] = decay(float(last - c0));
  w[2 * lane + 1] = decay(float(last - c1));
  if (lane == 0) *reinterpret_cast<float*>(rec + SC_DECAY) = decay(float(last));
}

// dt of steps t0 + 2 lane and t0 + 2 lane + 1 of head h (0 past S).
__device__ __forceinline__ void load_dt(const float* __restrict__ dt, int b, int h, int t0, int S,
                                        int H, int lane, float& d0, float& d1) {
  const int t = t0 + 2 * lane;
  d0 = t < S ? dt[(size_t(b) * S + t) * H + h] : 0.f;
  d1 = t + 1 < S ? dt[(size_t(b) * S + t + 1) * H + h] : 0.f;
}

__global__ void __launch_bounds__(NTHREADS, 1)
ssd_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ dt,
                    const float* __restrict__ A, float* __restrict__ state_out, int B, int S,
                    int H, int P, int G, int N) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, generic
  const uint32_t grp_full = base + BAR_OFF;
  const uint32_t grp_empty = grp_full + 8 * NST;
  const uint32_t x_full = grp_empty + 8 * NST;
  const uint32_t x_empty = x_full + 8 * NXS;
  constexpr int K = MAX_HEADS;
  const int Hg = H / G;
  const int n_chunks = (S + L - 1) / L;
  const int n_units = B * G * ((Hg + K - 1) / K);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(grp_full + 8 * s, 1);
      mbar_init(grp_empty + 8 * s, NCONSUMERS / 32);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < NXS; ++s) {
      mbar_init(x_full + 8 * s, 1);
      mbar_init(x_empty + 8 * s, NCONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `gi` counts chunks through the C/B ring (stage gi % NST), `xi` (chunk,
  // head) tiles through the x ring; a barrier's phase k completes with the
  // k-th use of its buffer, so a wait names the parity of k.
  if (threadIdx.x >= NCONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == NCONSUMERS) {
      int gi = 0, xi = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const Unit w = unit_of(u, G, Hg);
        for (int c = 0; c < n_chunks; ++c, ++gi) {
          const int s = gi % NST;
          if (gi >= NST) mbar_wait(grp_empty + 8 * s, ((gi / NST) - 1) & 1);
          const uint32_t stage = base + s * GRP_STAGE;
          mbar_expect_tx(grp_full + 8 * s, GRP_STAGE);
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(stage + half * TILE, &tm_c, grp_full + 8 * s, half * 32, w.g, c * L, w.b);
            tma_load_4d(stage + 2 * TILE + half * TILE, &tm_b, grp_full + 8 * s, half * 32, w.g,
                        c * L, w.b);
          }
          for (int j = 0; j < K; ++j, ++xi) {
            const int xs = xi % NXS;
            if (xi >= NXS) mbar_wait(x_empty + 8 * xs, ((xi / NXS) - 1) & 1);
            const uint32_t slot = base + X_OFF + xs * X_SLOT;
            mbar_expect_tx(x_full + 8 * xs, X_SLOT);
            for (int half = 0; half < 2; ++half)
              tma_load_4d(slot + half * TILE, &tm_x, x_full + 8 * xs, half * 32, head_of(w, j),
                          c * L, w.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns columns 32 wg .. 32 wg + 31 of P ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int r = warp * 16 + lane / 4;              // fragment rows r and r + 8
  const uint32_t wbase = base + WG_OFF + wg * WG_BYTES;
  uint8_t* const gw = gbase + WG_OFF + wg * WG_BYTES;
  const uint32_t lo_c = base + LO_OFF, lo_b = base + LO_OFF + 2 * TILE;

  int gi = 0, xi = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const Unit w = unit_of(u, G, Hg);
    float st[K][16];                                // S (n, 32 columns of p) of each head
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < 16; ++i) st[j][i] = 0.f;

    for (int c = 0; c < n_chunks; ++c, ++gi) {
      const int s = gi % NST;
      const uint32_t stage = base + s * GRP_STAGE;
      uint8_t* const gstage = gbase + s * GRP_STAGE;
      bar_sync(1, NCONSUMERS);                      // both warpgroups are done with the last chunk
      // Warp j of the eight scans head j of the unit over this chunk; its dt
      // is loaded here, so that the split and C.B^T below hide the latency.
      const int sj = wg * 4 + warp;
      float d0 = 0.f, d1 = 0.f, ah = 0.f;
      if (sj < K) {
        const int hs = head_of(w, sj);
        load_dt(dt, w.b, hs, c * L, S, H, lane, d0, d1);
        ah = A[hs];
      }
      mbar_wait(grp_full + 8 * s, (gi / NST) & 1);
      {
        // Split C (warpgroup 0) or B (warpgroup 1): hi in place, lo beside.
        uint8_t* raw = gstage + wg * 2 * TILE;
        uint8_t* lo = gbase + LO_OFF + wg * 2 * TILE;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int off = (tid + 128 * i) * 16;
          const float4 v = *reinterpret_cast<const float4*>(raw + off);
          const float4 h = hi4(v);
          *reinterpret_cast<float4*>(raw + off) = h;
          *reinterpret_cast<float4*>(lo + off) = lo4(v, h);
        }
        fence_async_smem();
        bar_sync(1, NCONSUMERS);
        // G = C . B^T, columns s = 32 wg .. 32 wg + 31 here
        float gacc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) gacc[i] = 0.f;
        const uint32_t b_wg = stage + 2 * TILE + wg * 32 * 128, blo_wg = lo_b + wg * 32 * 128;
        const uint64_t dc = desc_at(stage), dcl = desc_at(lo_c), db = desc_at(b_wg),
                       dbl = desc_at(blo_wg);
        fence_regs(gacc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          wgmma_ss_n32(gacc, dc + kstep(k, TILE), db + kstep(k, TILE), k > 0);
          wgmma_ss_n32(gacc, dc + kstep(k, TILE), dbl + kstep(k, TILE), 1);
          wgmma_ss_n32(gacc, dcl + kstep(k, TILE), db + kstep(k, TILE), 1);
        }
        wgmma_commit();
        if (sj < K) scan_chunk(gbase + SCAN_OFF + sj * SCAN_BYTES, d0, d1, ah, lane);
        wgmma_wait<0>();
        fence_regs(gacc);
        // Into A-fragment layout (column c of a row lies in lane (c % 8) / 2 of
        // the quad, element c % 2), k-steps 4 wg .. 4 wg + 3, for both warpgroups.
        const int src0 = (lane & ~3) | (q >> 1), src1 = src0 + 2;
        const bool odd = q & 1;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float a[4];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float e0 = __shfl_sync(0xffffffffu, gacc[4 * kk + 2 * rr], src0);
            const float e1 = __shfl_sync(0xffffffffu, gacc[4 * kk + 2 * rr + 1], src0);
            const float f0 = __shfl_sync(0xffffffffu, gacc[4 * kk + 2 * rr], src1);
            const float f1 = __shfl_sync(0xffffffffu, gacc[4 * kk + 2 * rr + 1], src1);
            a[rr] = odd ? e1 : e0;
            a[2 + rr] = odd ? f1 : f0;
          }
          *reinterpret_cast<float4*>(gbase + GFR_OFF + ((warp * 8 + 4 * wg + kk) * 32 + lane) * 16) =
              make_float4(a[0], a[1], a[2], a[3]);
        }
        bar_sync(1, NCONSUMERS);
      }

#pragma unroll 1
      for (int j = 0; j < K; ++j, ++xi) {
        // Fresh copies of the thread's coordinates: the shared-memory offsets
        // made from them are recomputed for each head instead of being held
        // in registers across heads and chunks (which made the kernel spill).
        int coord[4] = {r, q, lane, warp};
        asm volatile("" : "+r"(coord[0]), "+r"(coord[1]), "+r"(coord[2]), "+r"(coord[3]));
        const int r = coord[0], q = coord[1], lane = coord[2], warp = coord[3];
        const int h = head_of(w, j);
        const bool store = j < w.n_valid;
        uint8_t* const rec = gbase + SCAN_OFF + j * SCAN_BYTES;
        const double* cla = reinterpret_cast<const double*>(rec);
        const float* dtv = reinterpret_cast<const float*>(rec + SC_DT);
        const float* ecla = reinterpret_cast<const float*>(rec + SC_ECLA);
        const float* wv = reinterpret_cast<const float*>(rec + SC_W);
        if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // y's store
        bar_sync(2 + wg, 128);                      // this warpgroup is done with the last head
        const int xs = xi % NXS;
        mbar_wait(x_full + 8 * xs, (xi / NXS) & 1);
        float yacc[16];
        uint32_t fr[2][8];                            // two k-steps' A fragments: hi 0..3, lo 4..7
        {
          // xw^T = (dt x)^T, split: thread block (t 4tb..+3, p 4pb..+3); the
          // (tb, pb) of a quarter warp are chosen so that neither the reads
          // nor the writes conflict on a bank.
          {
            const uint8_t* xsl = gbase + X_OFF + xs * X_SLOT + wg * TILE;
            const int k8 = lane & 7, gq = warp * 4 + (lane >> 3);
            const int tb = 8 * (gq >> 3) + k8, pb = k8 ^ (gq & 7);
            float v[4][4];
#pragma unroll
            for (int jr = 0; jr < 4; ++jr) {
              const int t = 4 * tb + jr;
              const float4 xv =
                  *reinterpret_cast<const float4*>(xsl + t * 128 + ((pb ^ (t & 7)) << 4));
              const float d = dtv[t];
              v[jr][0] = __fmul_rn(xv.x, d);
              v[jr][1] = __fmul_rn(xv.y, d);
              v[jr][2] = __fmul_rn(xv.z, d);
              v[jr][3] = __fmul_rn(xv.w, d);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int p = 4 * pb + i;
              const uint32_t off = (tb >> 3) * HALF + p * 128 + (((tb & 7) ^ (p & 7)) << 4);
              const float4 xv = make_float4(v[0][i], v[1][i], v[2][i], v[3][i]);
              const float4 hv = hi4(xv);
              *reinterpret_cast<float4*>(gw + XWT + off) = hv;
              *reinterpret_cast<float4*>(gw + XWT_LO + off) = lo4(xv, hv);
            }
          }
          // S^T of this head (as it stands before this chunk), split.
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int n = r + ((i & 2) ? 8 : 0);
            const int p = (i / 4) * 8 + q * 2 + (i & 1);
            const uint32_t off = swz(p, n, HALF);
            float hv, lv;
            split(st[0][i], hv, lv);
            *reinterpret_cast<float*>(gw + ST + off) = hv;
            *reinterpret_cast<float*>(gw + ST_LO + off) = lv;
          }
          fence_async_smem();
        }
        bar_sync(2 + wg, 128);
        __syncwarp();
        if (lane == 0) mbar_arrive(x_empty + 8 * xs);

        {
          // y = e^{cla_t} (C . S) + M . xw.  C . S goes first; M is built
          // beside it, one k-step at a time into two fragment buffers in turn,
          // and each step's three products are issued (and committed) as soon
          // as its fragment is ready.  The heads' states leave no registers
          // for a second accumulator, so C . S is scaled in the y accumulator
          // before the first M . xw product.
#pragma unroll
          for (int i = 0; i < 16; ++i) yacc[i] = 0.f;
          {
            const uint64_t dc = desc_at(stage), dcl = desc_at(lo_c), ds = desc_at(wbase + ST),
                           dsl = desc_at(wbase + ST_LO);
            fence_regs(yacc);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              wgmma_ss_n32(yacc, dc + kstep(k, TILE), ds + kstep(k, HALF), k > 0);
              wgmma_ss_n32(yacc, dc + kstep(k, TILE), dsl + kstep(k, HALF), 1);
              wgmma_ss_n32(yacc, dcl + kstep(k, TILE), ds + kstep(k, HALF), 1);
            }
          }
          // M = G 2^{cla_t - cla_s} for s <= t, else 0, split; a warp's k-steps
          // right of its rows' diagonal are all 0.
          {
            const double cr0 = cla[r], cr1 = cla[r + 8];
            const float4* gfr =
                reinterpret_cast<const float4*>(gbase + GFR_OFF) + warp * 8 * 32 + lane;
            const uint64_t dx = desc_at(wbase + XWT), dxl = desc_at(wbase + XWT_LO);
            wgmma_commit();
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              uint32_t(&f)[8] = fr[kk & 1];
              if (kk >= 2) {
                wgmma_wait<1>();                      // step kk - 2 is done with f
                fence_regs(f);
              }
              if (kk <= 2 * warp + 1) {
                const float4 g4 = gfr[kk * 32];
                const float ga[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int t = r + ((e & 1) ? 8 : 0);
                  const int sc = 8 * kk + q + ((e & 2) ? 4 : 0);
                  const double ct = (e & 1) ? cr1 : cr0;
                  const float m = sc <= t ? ga[e] * decay(float(ct - cla[sc])) : 0.f;
                  float hv, lv;
                  split(m, hv, lv);
                  f[e] = __float_as_uint(hv);
                  f[4 + e] = __float_as_uint(lv);
                }
              } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) f[e] = 0u;
              }
              if (kk == 0) {                          // C . S, scaled per row
                wgmma_wait<0>();
                fence_regs(yacc);
                const float e0 = ecla[r], e1 = ecla[r + 8];
#pragma unroll
                for (int i = 0; i < 16; ++i) yacc[i] *= (i & 2) ? e1 : e0;
              }
              fence_regs(yacc);
              fence_regs(f);
              wgmma_fence();
              wgmma_rs_n32(yacc, &f[0], dx + kstep(kk, HALF));
              wgmma_rs_n32(yacc, &f[0], dxl + kstep(kk, HALF));
              wgmma_rs_n32(yacc, &f[4], dx + kstep(kk, HALF));
              wgmma_commit();
            }
          }
          wgmma_wait<0>();
          fence_regs(yacc);
          fence_regs(fr[0]);
          fence_regs(fr[1]);
          // y into S^T's hi buffer (C . S is done with it) in the 128-byte
          // swizzle, for one TMA store below.
#pragma unroll
          for (int i = 0; i < 16; i += 2) {
            const int t = r + ((i & 2) ? 8 : 0);
            *reinterpret_cast<float2*>(gw + ST + swz(t, (i / 4) * 8 + q * 2, TILE)) =
                make_float2(yacc[i], yacc[i + 1]);
          }
          // S' = e^{cla_L} S + (B w)^T . xw, A = (B w)^T (n, t) from B's hi + lo,
          // built and issued one k-step at a time.
          {
            const float dl = *reinterpret_cast<const float*>(rec + SC_DECAY);
#pragma unroll
            for (int i = 0; i < 16; ++i) st[0][i] *= dl;
            const uint8_t* bh = gstage + 2 * TILE;
            const uint8_t* bl = gbase + LO_OFF + 2 * TILE;
            const uint64_t dx = desc_at(wbase + XWT), dxl = desc_at(wbase + XWT_LO);
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              uint32_t(&f)[8] = fr[kk & 1];
              if (kk >= 2) {
                wgmma_wait<1>();                      // step kk - 2 is done with f
                fence_regs(f);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int n = r + ((e & 1) ? 8 : 0);
                const int t = 8 * kk + q + ((e & 2) ? 4 : 0);
                const uint32_t off = swz(t, n, TILE);
                const float bv = *reinterpret_cast<const float*>(bh + off) +
                                 *reinterpret_cast<const float*>(bl + off);
                float hv, lv;
                split(bv * wv[t], hv, lv);
                f[e] = __float_as_uint(hv);
                f[4 + e] = __float_as_uint(lv);
              }
              fence_regs(st[0]);
              fence_regs(f);
              wgmma_fence();
              wgmma_rs_n32(st[0], &f[0], dx + kstep(kk, HALF));
              wgmma_rs_n32(st[0], &f[0], dxl + kstep(kk, HALF));
              wgmma_rs_n32(st[0], &f[4], dx + kstep(kk, HALF));
              wgmma_commit();
            }
          }
          // Beside it: one TMA store of y, which drops rows past S and columns
          // past P; it is waited for before the buffer is written again, at the
          // next head's start.
          fence_async_smem();
          bar_sync(2 + wg, 128);
          if (tid == 0 && store) {
            tma_store_4d(&tm_y, wbase + ST, 32 * wg, h, c * L, w.b);
            asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          }
        }
        wgmma_wait<0>();
        fence_regs(st[0]);
        fence_regs(fr[0]);
        fence_regs(fr[1]);
        // The next head's state to st[0]: the heads' loop is not unrolled
        // (one copy of its body fits the instruction cache), and after K
        // turns every state is back in place.
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float first = st[0][i];
#pragma unroll
          for (int jj = 0; jj + 1 < K; ++jj) st[jj][i] = st[jj + 1][i];
          st[K - 1][i] = first;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(grp_empty + 8 * s);
    }

    // The final state of each head, rows n < N and columns p < P.
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= w.n_valid) continue;
      const int h = w.h0 + j;
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int n = r + ((i & 2) ? 8 : 0);
        const int p = 32 * wg + (i / 4) * 8 + q * 2;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(state_out + ((size_t(w.b) * H + h) * N + n) * P + p) =
              make_float2(st[j][i], st[j][i + 1]);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A float32 (B, S, mid, inner) tensor with packed (mid, inner) and the given
// batch and sequence strides (elements), seen as (inner, mid, S, B); box
// (32, 1, 64, 1) with the 128-byte swizzle; out-of-bounds elements read as 0.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int mid, int inner,
              long long stride_b, long long stride_s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(inner), cuuint64_t(mid), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(inner) * 4, cuuint64_t(stride_s) * 4,
                                 cuuint64_t(stride_b) * 4};
  const cuuint32_t box[4] = {32, 1, L, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace

extern "C" {

// float32 x (B, S, H, P), B and C (B, S, G, N), each with packed last two
// dims, 16-byte aligned, and batch / sequence strides (elements) that are
// multiples of 4; dt (B, S, H) and A (H,) contiguous float32; y (B, S, H, P)
// and state (B, H, N, P) contiguous float32.  N, P in 4..64, multiples of 4.
// Returns 0, a cudaError_t of the launch, or 1000 when a tensor map cannot
// be made; the kernel runs on `stream` and is not waited for.
int ssd_fwd_sm90(const void* x, const void* dt, const void* A, const void* bm, const void* cm,
                 void* y, void* state, int B, int S, int H, int P, int G, int N,
                 long long x_sb, long long x_ss, long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, void* stream) {
  if (B < 1 || S < 1 || G < 1 || H % G != 0 || P < 4 || P > 64 || P % 4 || N < 4 || N > 64 ||
      N % 4)
    return cudaErrorInvalidValue;
  CUtensorMap mx, mb, mc, my;
  if (!make_map(&mx, x, B, S, H, P, x_sb, x_ss) || !make_map(&mb, bm, B, S, G, N, b_sb, b_ss) ||
      !make_map(&mc, cm, B, S, G, N, c_sb, c_ss) ||
      !make_map(&my, y, B, S, H, P, (long long)S * H * P, (long long)H * P))
    return ERR_TENSOR_MAP;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int n_units = B * G * ((H / G + MAX_HEADS - 1) / MAX_HEADS);
  // persistent: one block per SM at most
  ssd_fwd_sm90_kernel<<<n_units < sms ? n_units : sms, NTHREADS, SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      mx, mb, mc, my, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<float*>(state), B, S, H, P, G, N);
  return cudaGetLastError();
}

// Dynamic shared memory of one block, bytes.
int ssd_fwd_sm90_smem_bytes() { return SMEM; }

const char* ssd_fwd_sm90_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled is missing or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
