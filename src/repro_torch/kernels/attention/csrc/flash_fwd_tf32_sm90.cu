// Flash-attention forward for Hopper tensor cores (sm_90a): the float32 path,
// in split TF32.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/attention/flash.py (launched by `flash_attention_hmajor`,
// wrapped by src/repro/kernels/attention/ops.py::flash_attention) for float32
// inputs; bf16 inputs go to flash_fwd_sm90.cu.  It computes what the TPU
// kernel computes: q scaled by 1/sqrt(hd) in float32; online softmax with a
// float32 running max, sum and accumulator; masked scores set to -1e30,
// never -inf (a row that is fully masked inside a live tile gets p = 1 there
// and is wiped later by a correction factor of 0, as in the Pallas kernel);
// KV tiles above the causal diagonal or below the window band are skipped,
// not masked; the final divide clamps l at 1e-30; q head h reads KV head
// h / (H / K), with no repetition of K or V.
//
// Layout: the model's (B, S, heads, hd), contiguous, read through 4-D TMA
// tensor maps over (hd, heads, S, B) in 32-float (128-byte) swizzled chunks,
// zero-filled past S and past hd (hd 16 pads to 32, hd 80 to 96); O is
// written straight from the accumulators, rows past S dropped.  Head dims
// 16, 32, 64, 80, 128 and 192.
//
// Products on the tensor cores at float32 accuracy.  Every product is a
// split-TF32 wgmma (m64nNk8, float32 accumulators): a = hi + lo with hi = a
// with its low 13 mantissa bits cleared and lo = tf32(a - hi), and
// a.b = hi.hi + hi.lo + lo.hi; the lo.lo term, below 2^-22 |a b|, is the one
// dropped.  One TF32 product alone misses the 2e-4 tolerance (PERF.md;
// ref.py::attention_split_tf32_reference is this arithmetic on the CPU).
// wgmma takes 32-bit operands K-major only, so:
//   S (q, key) = Q (q, d) . K (key, d)     Q hi from registers, Q lo and
//                                          K hi / lo from shared memory
//   O (q, d)  += P (q, key) . V^T (d, key) P hi / lo from registers, V^T
//                                          hi / lo written by a transposing pass
// The tensor cores round each wgmma's float32 sum toward zero (as far as a
// CPU emulation that reproduces the card's errors can tell), so a sum
// accumulated over many wgmma calls comes out a little closer to zero than
// float64, by about half an ulp of the sum per call.  O would take 12 such
// calls a KV tile over the whole row: on the MoE serve activations, where
// a few early keys carry most of the weight, that left O 4e-6 (relative)
// closer to zero than float64 and 5e-5 from it.  So each tile's P.V^T goes
// into a fresh accumulator, which an FMA adds to the rescaled O (PERF.md
// has the errors and the bias that remain; a fresh accumulator per k-step
// with half an ulp put back cut the bias tenfold at four times the time).
// P needs no shuffle: the S accumulator holds columns (2t, 2t + 1) of each
// 8-column group where a tf32 A fragment wants (t, t + 4), so its registers
// are read as the A fragment as they stand, and the transposing pass writes
// V^T's keys in the order 0, 2, 4, 6, 1, 3, 5, 7 within each group of 8.
//
// Design.  A work tile is 128 q rows of one (b, h), owned by two consumer
// warpgroups of 64 rows each; a producer warpgroup feeds them.  Blocks are
// persistent, at most one per SM, and walk the work tiles heaviest first
// (the last q tiles, under causal masking).  In the producer warpgroup one
// thread issues every TMA load: Q once per tile, and K and V tiles of 32
// keys into rings of two stages, each arrival counted on an mbarrier; its
// three other warps split each K tile into hi (in place) and lo, and
// transpose and split each V tile into V^T hi and lo, beside the consumers'
// products.  A consumer warpgroup scales and splits its 64 rows of Q once per
// tile (hi into registers, lo back in place: two of Q.K^T's three products
// then read only K from shared memory), then for each KV tile that is
// live for its rows: S in three products per 8-column k-step, masking only
// where the tile crosses the diagonal, the window's edge or the sequence's
// end, the softmax update in registers (row max and sum over the four lanes
// that share a row), P split in registers, and the tile's P.V^T in three
// products per 8-key k-step, added to the rescaled O.  A KV tile live for
// the block but not for a warpgroup's
// rows (above its diagonal, below its window) is only released by it.  The
// Q buffer goes back to the producer after each warpgroup's last Q.K^T.
// The two warpgroups issue their products as they come: the bf16 kernel's
// ping-pong (taking turns) measured slower here (PERF.md).
//
// Shared memory at hd 128: Q 64 KB, K hi + lo 2 x 32 KB, V as loaded 2 x 16
// KB, V^T hi + lo 2 x 32 KB: 224 KB of the 227 a block may have.
//
// Head dim 192 (nemotron-4-340b's) fits neither: two stages would take 336
// KB, and Q hi (96 words) beside O (96) would leave a consumer thread too
// few registers.  So at hd 192 the K/V ring has one stage (Q 96 KB, K hi +
// lo 48 KB, V 24 KB, V^T hi + lo 48 KB: 216 KB), and Q stays in shared
// memory as loaded: for each group of two k-steps a consumer reads its A
// fragments of Q, scales and splits them into registers (two sets, so one
// group loads while the last one's products run), and all three products
// of Q.K^T take A from registers.  Groups of four k-steps spilled.
//
// Registers: setmaxnreg gives each consumer thread 224 (O 64, Q hi 64, S
// 16, or P hi and lo 32 and a 16-word quarter of a tile's P.V^T, at hd 128)
// and each producer thread 56: together the 384 x 168 registers the block
// is launched with, all that setmaxnreg can hand out.  Every mbarrier wait
// traps after about 10 s of spinning, so that a fault in the pipeline ends
// the launch with an error instead of hanging the card.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 495 TFLOP/s dense TF32): at the MoE
// serve shape (B=8, S=512, H=32, K=8, hd=128) the function moves q, k, v and
// o once, 168 MB, 50 us, and does 4*hd per unmasked (q, k) pair, 17.2 GFLOP;
// three TF32 products per product on the tensor cores are 104 us, so
// operations bound it.  Where its time goes is measured by
// tools/flash_tf32_ablate.py (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                        // q rows per work tile
constexpr int BK = 32;                         // keys per K/V tile
constexpr int NCONSUMERS = 256;                // two warpgroups of 64 rows
constexpr int NTHREADS = NCONSUMERS + 128;     // and one producer warpgroup
constexpr int NTRANSFORM = 96;                 // its three splitting warps
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base.  A chunk is 32 floats of
// the head dim (one 128-byte swizzle row) for every row of a tile.
template <int HD>
struct Tile {
  static constexpr int NST = HD > 128 ? 1 : 2;             // K/V ring depth
  static constexpr bool QREG = HD <= 128;                  // Q hi held in registers
  static constexpr int HDP = (HD + 31) / 32 * 32;          // the head dim padded
  static constexpr int NCH = HDP / 32;                     // 128-byte head-dim chunks
  static constexpr int NKS = HD / 8;                       // k-steps of Q.K^T
  static constexpr int Q_CHUNK = BQ * 128;
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;          // one K or V tile as loaded
  static constexpr int VT_BYTES = HD * 128;                // V^T: hd rows of 32 keys
  static constexpr int K_OFF = Q_BYTES;                    // per stage: K hi, K lo
  static constexpr int V_OFF = K_OFF + NST * 2 * KV_BYTES; // per stage: V as loaded
  static constexpr int VT_OFF = V_OFF + NST * KV_BYTES;    // per stage: V^T hi, V^T lo
  static constexpr int BAR_OFF = VT_OFF + NST * 2 * VT_BYTES;
  static constexpr int NBARS = 2 + 6 * NST;
  static constexpr int SMEM = BAR_OFF + 8 * NBARS + 1024;  // + slack to align the base
  static_assert(SMEM <= 232448, "shared memory of one block");
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

// The descriptor of an operand, made where it is used: the empty asm keeps
// the compiler from hoisting every k-step's 64-bit descriptor out of the
// loops into registers, as ssd_fwd_sm90.cu does (where that spilled).
__device__ __forceinline__ uint64_t desc_at(uint32_t addr) {
  uint64_t d = smem_desc(addr);
  asm volatile("" : "+l"(d));
  return d;
}

// Byte offset of k-step k (8 columns of 4 bytes) of a K-major operand whose
// 32-column chunks lie `chunk` bytes apart.
__device__ __forceinline__ constexpr uint32_t kstep(int k, int chunk) {
  return uint32_t((k / 4) * chunk + (k % 4) * 32);
}

// Byte offset of element (row, col) of such an operand in the 128-byte
// swizzle (16-byte unit u of a row stored at u ^ (row & 7)).
__device__ __forceinline__ uint32_t swz(int row, int col, int chunk) {
  return (col >> 5) * chunk + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) + (col & 3) * 4;
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

// ---- wgmma (tf32 in, float32 accumulate) ------------------------------------

// D(64 x 32) += A(64 x 8) . B(32 x 8)^T, tf32, both in shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D(64 x 16) (+)= A(64 x 8) . B(16 x 8)^T, tf32, A in registers (four words
// a thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 32) (+)= A(64 x 8) . B(32 x 8)^T, tf32, A in registers (four words
// a thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 64) (+)= A(64 x 8) . B(64 x 8)^T, tf32, A in registers (four words
// a thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t desc_b,
                                              int accumulate = 1) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 80) (+)= A(64 x 8) . B(80 x 8)^T, tf32, A in registers (four words
// a thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t* a, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D(64 x 128) (+)= A(64 x 8) . B(128 x 8)^T, tf32, A in registers (four words
// a thread), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t desc_b,
                                              int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t desc_b,
                                         int accumulate = 1) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 80 || N == 128,
                "P.V is as wide as a head dim the kernel takes, or 32 columns of it");
  if constexpr (N == 16) wgmma_rs_n16(d, a, desc_b, accumulate);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b, accumulate);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b, accumulate);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, desc_b, accumulate);
  else wgmma_rs_n128(d, a, desc_b, accumulate);
}

// ---- split TF32 ---------------------------------------------------------------

__device__ __forceinline__ float tf32_hi(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xffffe000u);
}
// a rounded to TF32, half away from zero, as cvt.rna.tf32.f32 rounds a
// finite value, in two integer operations.
__device__ __forceinline__ float tf32_rna(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}
__device__ __forceinline__ float4 hi4(float4 v) {
  return make_float4(tf32_hi(v.x), tf32_hi(v.y), tf32_hi(v.z), tf32_hi(v.w));
}
__device__ __forceinline__ float4 lo4(float4 v, float4 h) {
  return make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y), tf32_rna(v.z - h.z),
                     tf32_rna(v.w - h.w));
}

// 2^x by the SFU's approximation (relative error about 2^-22; results
// below 2^-126, as for masked scores, flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- the splitting warps ------------------------------------------------------

// A K tile as loaded: hi in place, lo beside, element by element on the
// swizzled bytes (both keep the layout wgmma reads).  Each thread has U
// loads in flight before it stores.
template <int HD>
__device__ __forceinline__ void split_k(uint8_t* hi, uint8_t* lo, int t) {
  constexpr int N = Tile<HD>::KV_BYTES / 16, U = 2;
  float4* const h4 = reinterpret_cast<float4*>(hi);
  float4* const l4 = reinterpret_cast<float4*>(lo);
#pragma unroll 1
  for (int i0 = t; i0 < N; i0 += U * NTRANSFORM) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * NTRANSFORM < N) v[u] = h4[i0 + u * NTRANSFORM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u * NTRANSFORM < N) {
        const float4 h = hi4(v[u]);
        h4[i0 + u * NTRANSFORM] = h;
        l4[i0 + u * NTRANSFORM] = lo4(v[u], h);
      }
    }
  }
}

// Component c of v (c a constant once the loop over c is unrolled).
__device__ __forceinline__ float part(float4 v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A V tile as loaded (32 keys, K-major chunks) to V^T hi and lo: hd rows of
// 32 keys, one 128-byte swizzle row each, keys in the order 0, 2, 4, 6, 1,
// 3, 5, 7 within each group of 8 (the order in which P's accumulator
// registers, read as an A fragment, hold them).  An item is 4 columns of d
// and the even (or odd) keys of one group of 8: four float4 reads, a 4 x 4
// transpose in registers, four float4 writes of each part.  The eight
// threads of a quarter warp take the eight (group, parity) pairs of one
// column block, so that their writes fall on eight distinct 16-byte units.
template <int HD>
__device__ __forceinline__ void transpose_v(const uint8_t* raw, uint8_t* hi, uint8_t* lo, int t) {
  constexpr int N = 2 * HD;                    // items: 8 per 4 columns of d
#pragma unroll 1
  for (int it = t; it < N; it += NTRANSFORM) {
    const int g = (it >> 1) & 3, par = it & 1, d0 = 4 * (it >> 3);
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(raw + swz(8 * g + 2 * i + par, d0,
                                                        Tile<HD>::KV_CHUNK));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = d0 + c;
      const float4 v = make_float4(part(x[0], c), part(x[1], c), part(x[2], c), part(x[3], c));
      const float4 h = hi4(v);
      const uint32_t off = d * 128 + (((2 * g + par) ^ (d & 7)) << 4);
      *reinterpret_cast<float4*>(hi + off) = h;
      *reinterpret_cast<float4*>(lo + off) = lo4(v, h);
    }
  }
}

// ---- work ---------------------------------------------------------------------
//
// Fragments (wgmma's accumulator layout): thread `lane` of warp w of a
// consumer warpgroup holds rows r = w*16 + lane/4 and r + 8; its element i
// of an N-column accumulator lies in row r + 8 when (i & 2), column
// (i / 4) * 8 + (lane % 4) * 2 + (i & 1).  A tf32 A fragment of k-step kk
// holds (r, 8kk + lane%4), (r + 8, same), (r, 8kk + lane%4 + 4), (r + 8, same).

// The KV tiles live for q rows r_first .. r_last (flash.py's `live`, for
// these rows): none above the causal diagonal, none wholly below the window.
__device__ __forceinline__ void live_range(int r_first, int r_last, int S, int causal, int window,
                                           int& lo, int& hi) {
  hi = (S + BK - 1) / BK - 1;
  if (causal) hi = min(hi, r_last / BK);
  lo = 0;
  if (window > 0 && r_first - window + 1 > 0) lo = (r_first - window + 1) / BK;
}

// One work tile: 128 q rows of one (b, h) and the KV tiles live for any of
// them.  Tiles are numbered so that the q tiles with the most KV tiles come
// first and the heads that share a KV head sit side by side.
struct Work {
  int b, h, kh, q0, j_lo, j_hi;
};

__device__ __forceinline__ Work work_of(int t, int B, int S, int H, int KH, int causal,
                                        int window) {
  const int n_qt = (S + BQ - 1) / BQ;
  Work w;
  w.h = t % H;
  w.b = (t / H) % B;
  w.q0 = (n_qt - 1 - t / (H * B)) * BQ;
  w.kh = w.h / (H / KH);
  live_range(w.q0, min(w.q0 + BQ, S) - 1, S, causal, window, w.j_lo, w.j_hi);
  return w;
}

// Scale one tile's scores to the log2 domain, mask them where the tile
// crosses the diagonal, the window's edge or the sequence's end (MASK),
// update the running max (over the four lanes that share a row) and the row
// sums, and leave p in `sc`; `corr` gets each row's correction factor for O.
// Unmasked, the scale folds into the exponent's argument: p = 2^(s log2(e) - m).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[16], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], int row0, int k0, int lane, int S,
                                             int causal, int window) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = row0 + ((i & 2) ? 8 : 0);
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      bool ok = col < S;
      if (causal) ok = ok && row >= col;
      if (window > 0) ok = ok && row < col + window;
      sc[i] = ok ? sc[i] * LOG2E : NEG_INF;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = sc[2 * r];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (((i >> 1) & 1) == r) mx = fmaxf(mx, sc[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], MASK ? mx : mx * LOG2E);
    corr[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = MASK ? ex2(sc[i] - m_run[r]) : ex2(fmaf(sc[i], LOG2E, -m_run[r]));
    sum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + sum[r];
}

// Lane 0 of each consumer warp arrives, once the warp is done with the buffer.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                           int B, int S, int H, int KH, int causal, int window, float scale) {
  using T = Tile<HD>;
  // Columns of O per P.V^T pass: at hd 128 a tile accumulator of 64 words
  // (or two passes of 32) beside O and Q hi spilled; four passes of 32
  // columns do not, and ran faster (PERF.md).
  constexpr int NPV = HD > 80 ? 32 : HD;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // the same bytes, generic
  // mbarriers, 8 bytes each: Q full and Q empty, then per stage K full (TMA),
  // K ready (split), K empty (consumed), and the same for V.
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;
  const uint32_t k_ready = k_full + 8 * T::NST;
  const uint32_t k_empty = k_ready + 8 * T::NST;
  const uint32_t v_full = k_empty + 8 * T::NST;
  const uint32_t v_ready = v_full + 8 * T::NST;
  const uint32_t v_empty = v_ready + 8 * T::NST;
  const int n_work = (S + BQ - 1) / BQ * B * H;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NCONSUMERS / 32);                    // lane 0 of each consumer warp
    for (int s = 0; s < T::NST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_ready + 8 * s, NTRANSFORM / 32);          // lane 0 of each splitting warp
      mbar_init(k_empty + 8 * s, NCONSUMERS / 32);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_ready + 8 * s, NTRANSFORM / 32);
      mbar_init(v_empty + 8 * s, NCONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each block walks the work tiles blockIdx.x, + gridDim.x, ...; `n_done`
  // counts the work tiles done, `kv` the K/V tiles through the ring (stage
  // kv % T::NST).  A barrier's phase u completes with the u-th use of its
  // buffer, so a wait names the parity of u.
  if (threadIdx.x >= NCONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (threadIdx.x == NCONSUMERS) {
      // ---- one thread issues every TMA load ----
      int kv = 0, n_done = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n_done) {
        const Work w = work_of(t, B, S, H, KH, causal, window);
        if (n_done > 0) mbar_wait(q_empty, (n_done - 1) & 1);
        mbar_expect_tx(q_full, T::Q_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load_4d(base + c * T::Q_CHUNK, &tm_q, q_full, c * 32, w.h, w.q0, w.b);
        for (int j = w.j_lo; j <= w.j_hi; ++j, ++kv) {
          const int s = kv % T::NST, use = kv / T::NST;
          if (use > 0) mbar_wait(k_empty + 8 * s, (use - 1) & 1);
          mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
          for (int c = 0; c < T::NCH; ++c)
            tma_load_4d(base + T::K_OFF + s * 2 * T::KV_BYTES + c * T::KV_CHUNK, &tm_k,
                        k_full + 8 * s, c * 32, w.kh, j * BK, w.b);
          if (use > 0) mbar_wait(v_ready + 8 * s, (use - 1) & 1);  // the last V is transposed
          mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
          for (int c = 0; c < T::NCH; ++c)
            tma_load_4d(base + T::V_OFF + s * T::KV_BYTES + c * T::KV_CHUNK, &tm_v,
                        v_full + 8 * s, c * 32, w.kh, j * BK, w.b);
        }
      }
    } else if (threadIdx.x >= NCONSUMERS + 32) {
      // ---- three warps split K and transpose and split V ----
      const int tt = threadIdx.x - NCONSUMERS - 32;
      const int lane = threadIdx.x % 32;
      int kv = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x) {
        const Work w = work_of(t, B, S, H, KH, causal, window);
        for (int j = w.j_lo; j <= w.j_hi; ++j, ++kv) {
          const int s = kv % T::NST, use = kv / T::NST;
          uint8_t* const kh = gbase + T::K_OFF + s * 2 * T::KV_BYTES;
          mbar_wait(k_full + 8 * s, use & 1);
          split_k<HD>(kh, kh + T::KV_BYTES, tt);
          fence_async_smem();
          release(k_ready + 8 * s, lane);
          mbar_wait(v_full + 8 * s, use & 1);
          if (use > 0) mbar_wait(v_empty + 8 * s, (use - 1) & 1);
          uint8_t* const vt = gbase + T::VT_OFF + s * 2 * T::VT_BYTES;
          transpose_v<HD>(gbase + T::V_OFF + s * T::KV_BYTES, vt, vt + T::VT_BYTES, tt);
          fence_async_smem();
          release(v_ready + 8 * s, lane);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 of a tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qd = lane % 4;
  const int r = warp * 16 + lane / 4;                     // fragment rows r and r + 8
  const uint32_t q_wg = base + wg * 64 * 128;              // this warpgroup's rows of Q
  int kv = 0, n_done = 0;
  for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n_done) {
    const Work w = work_of(t, B, S, H, KH, causal, window);
    const int r_first = w.q0 + 64 * wg;
    const bool has_rows = r_first < S;
    int my_lo = w.j_hi + 1, my_hi = w.j_hi;                // none live without rows
    if (has_rows) live_range(r_first, min(r_first + 63, S - 1), S, causal, window, my_lo, my_hi);

    // Q of this warpgroup's rows, scaled: hi into registers in the A-fragment
    // layout, lo in place (two of Q.K^T's three products take A from
    // registers, which halves what they read of shared memory).
    uint32_t qhi[T::QREG ? T::NKS * 4 : 1];
    mbar_wait(q_full, n_done & 1);
    if (T::QREG && has_rows) {
#pragma unroll
      for (int k = 0; k < T::NKS; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* p = reinterpret_cast<float*>(
              gbase + swz(64 * wg + r + 8 * (e & 1), 8 * k + qd + 4 * (e >> 1), T::Q_CHUNK));
          const float x = __fmul_rn(*p, scale);
          const float h = tf32_hi(x);
          *p = tf32_rna(x - h);
          qhi[4 * k + e] = __float_as_uint(h);
        }
      }
      fence_async_smem();
    }
    bar_sync(1 + wg, 128);
    if (!has_rows) release(q_empty, lane);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};                          // this thread's share of the row sums
    float corr[2];                                        // this tile's correction of O
    for (int j = w.j_lo; j <= w.j_hi; ++j, ++kv) {
      const int s = kv % T::NST, ph = (kv / T::NST) & 1;
      const bool live = j >= my_lo && j <= my_hi;           // uniform over the warpgroup
      const uint32_t khi = base + T::K_OFF + s * 2 * T::KV_BYTES, klo = khi + T::KV_BYTES;
      const uint32_t vhi = base + T::VT_OFF + s * 2 * T::VT_BYTES, vlo = vhi + T::VT_BYTES;
      float sc[16];
      uint32_t pa[16], pl[16];                              // P hi and lo, A-fragment order
      mbar_wait(k_ready + 8 * s, ph);
      if (live) {
        // S = Q.K^T: lo.hi + hi.lo + hi.hi per k-step.
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] = 0.f;
        if constexpr (T::QREG) {
          fence_regs(sc);
          fence_regs(qhi);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < T::NKS; ++k) {
            const uint64_t dkh = desc_at(khi + kstep(k, T::KV_CHUNK));
            wgmma_ss_n32(sc, desc_at(q_wg + kstep(k, T::Q_CHUNK)), dkh);
            wgmma_rs_n32(sc, &qhi[4 * k], desc_at(klo + kstep(k, T::KV_CHUNK)));
            wgmma_rs_n32(sc, &qhi[4 * k], dkh);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(qhi);
        } else {
          // Q's A fragments, scaled and split, two k-steps at a time into
          // one of two register sets (hi in words 0-3 of a k-step, lo in
          // 4-7); a set is refilled once the products that read it are done.
          constexpr int G = 2;
          static_assert(T::NKS % G == 0, "k-steps come in groups of two");
          uint32_t qa[2][8 * G];
          fence_regs(sc);
#pragma unroll
          for (int g = 0; g < T::NKS / G; ++g) {
            uint32_t(&a)[8 * G] = qa[g & 1];
            if (g >= 2) wgmma_wait<1>();
            fence_regs(a);
#pragma unroll
            for (int k = 0; k < G; ++k) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float x = __fmul_rn(*reinterpret_cast<const float*>(
                    gbase + swz(64 * wg + r + 8 * (e & 1), 8 * (g * G + k) + qd + 4 * (e >> 1),
                                T::Q_CHUNK)), scale);
                const float h = tf32_hi(x);
                a[8 * k + e] = __float_as_uint(h);
                a[8 * k + 4 + e] = __float_as_uint(tf32_rna(x - h));
              }
            }
            fence_regs(a);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < G; ++k) {
              const uint64_t dkh = desc_at(khi + kstep(g * G + k, T::KV_CHUNK));
              wgmma_rs_n32(sc, &a[8 * k + 4], dkh);
              wgmma_rs_n32(sc, &a[8 * k], desc_at(klo + kstep(g * G + k, T::KV_CHUNK)));
              wgmma_rs_n32(sc, &a[8 * k], dkh);
            }
            wgmma_commit();
          }
          wgmma_wait<0>();
          fence_regs(sc);
          fence_regs(qa[0]);
          fence_regs(qa[1]);
        }
      }
      release(k_empty + 8 * s, lane);
      if (has_rows && j == my_hi) release(q_empty, lane);  // this warpgroup's last Q.K^T
      if (live) {
        const int k0 = j * BK;
        const bool mask = (k0 + BK > S) || (causal && k0 + BK - 1 > r_first) ||
                          (window > 0 && k0 <= r_first + 63 - window);
        if (mask)
          softmax_tile<true>(sc, m_run, l_run, corr, r_first + r, k0, lane, S, causal, window);
        else
          softmax_tile<false>(sc, m_run, l_run, corr, r_first + r, k0, lane, S, causal, window);
        // P split, its accumulator registers read as A fragments: slot e of
        // k-step kk is element 4 kk + {0, 2, 1, 3}[e].
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float p = sc[(i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1)];
          const float h = tf32_hi(p);
          pa[i] = __float_as_uint(h);
          pl[i] = __float_as_uint(tf32_rna(p - h));
        }
      }
      mbar_wait(v_ready + 8 * s, ph);
      if (live) {
        // O = corr O + P.V^T: the tile's hi.hi + hi.lo + lo.hi per 8-key
        // k-step into a fresh accumulator (its first product overwrites
        // it: nothing to zero, so no pass's accumulator lives before its
        // products), NPV columns at a time, added to the rescaled O by an
        // FMA.
#pragma unroll
        for (int c0 = 0; c0 < HD; c0 += NPV) {
          float pv[NPV / 2];
          fence_regs(pa);
          fence_regs(pl);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const uint64_t dvh = desc_at(vhi + c0 * 128 + kk * 32);
            wgmma_rs<NPV>(pv, &pa[4 * kk], dvh, kk > 0);
            wgmma_rs<NPV>(pv, &pa[4 * kk], desc_at(vlo + c0 * 128 + kk * 32));
            wgmma_rs<NPV>(pv, &pl[4 * kk], dvh);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(pv);
          fence_regs(pa);
          fence_regs(pl);
#pragma unroll
          for (int i = 0; i < NPV / 2; ++i)
            acc[c0 / 2 + i] = fmaf(acc[c0 / 2 + i], corr[(i >> 1) & 1], pv[i]);
        }
      }
      release(v_empty + 8 * s, lane);
    }

    // Epilogue: O / max(l, 1e-30), rows past S dropped.
    if (has_rows) {
      float inv[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float l = l_run[rr];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[rr] = 1.f / fmaxf(l, 1e-30f);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = r_first + r + 8 * rr;
        if (row < S) {
          float* orow = o + ((size_t(w.b) * S + row) * H + w.h) * HD + 2 * qd;
#pragma unroll
          for (int n8 = 0; n8 < HD / 8; ++n8)
            *reinterpret_cast<float2*>(orow + n8 * 8) =
                make_float2(acc[n8 * 4 + 2 * rr] * inv[rr], acc[n8 * 4 + 2 * rr + 1] * inv[rr]);
        }
      }
    }
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

// A (B, S, heads, hd) float32 tensor seen as (hd, heads, S, B); box (32, 1,
// rows, 1) with the 128-byte swizzle; out-of-bounds elements read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(heads), cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(hd) * 4, cuuint64_t(heads) * hd * 4,
                                 cuuint64_t(S) * heads * hd * 4};
  const cuuint32_t box[4] = {32, 1, cuuint32_t(rows), 1};
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

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KH,
           int causal, int window, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tf32_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, HD, BQ) || !make_map(&mk, k, B, S, KH, HD, BK) ||
      !make_map(&mv, v, B, S, KH, HD, BK))
    return ERR_TENSOR_MAP;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int n_work = (S + BQ - 1) / BQ * B * H;   // persistent: one block per SM at most
  flash_fwd_tf32_sm90_kernel<HD><<<n_work < sms ? n_work : sms, NTHREADS, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<float*>(o), B, S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// float32 q (B, S, H, hd), k and v (B, S, KH, hd), o like q; all contiguous
// and 16-byte aligned.  hd in {16, 32, 64, 80, 128, 192}.  window <= 0 means no
// window.  Returns 0 on success, a cudaError_t of the launch, or 1000 when a
// tensor map cannot be made; the kernel runs on `stream` and is not waited
// for.
int flash_fwd_tf32_sm90(const void* q, const void* k, const void* v, void* o, int B, int S,
                        int H, int KH, int hd, int causal, int window, float scale,
                        void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, B, S, H, KH, causal, window, scale, s);
    case 32: return launch<32>(q, k, v, o, B, S, H, KH, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, B, S, H, KH, causal, window, scale, s);
    case 80: return launch<80>(q, k, v, o, B, S, H, KH, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, B, S, H, KH, causal, window, scale, s);
    case 192: return launch<192>(q, k, v, o, B, S, H, KH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at head dim hd (0 if hd is not taken).
int flash_fwd_tf32_sm90_smem_bytes(int hd) {
  switch (hd) {
    case 16: return Tile<16>::SMEM;
    case 32: return Tile<32>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 80: return Tile<80>::SMEM;
    case 128: return Tile<128>::SMEM;
    case 192: return Tile<192>::SMEM;
    default: return 0;
  }
}

const char* flash_fwd_tf32_sm90_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled is missing or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
