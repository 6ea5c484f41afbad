// Flash-attention forward for Hopper tensor cores (sm_90a): the bf16 path.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/attention/flash.py (launched by `flash_attention_hmajor`,
// wrapped by src/repro/kernels/attention/ops.py::flash_attention) for bf16
// inputs; float32 inputs go to flash_fwd_tf32_sm90.cu, whose split-TF32
// products hold the float32 tolerance that bf16 or one TF32 product cannot.
// It computes what
// the TPU kernel computes: online softmax with a float32 running max, sum and
// accumulator; scores scaled by 1/sqrt(hd) in float32 after the product;
// masked scores set to -1e30, never -inf (a row that is fully masked inside
// a tile gets p = 1 there and is wiped later by a correction factor of 0, as
// in the Pallas kernel); KV tiles above the causal diagonal or below the
// window band are skipped, not masked; the final divide clamps l at 1e-30;
// q head h reads KV head h / (H / K), with no repetition of K or V.  The one
// rounding the plain version does not have is P, rounded to bf16 before the
// P.V product.
//
// Layout: the model's (B, S, heads, hd), contiguous, read through 4-D TMA
// tensor maps over (hd, heads, S, B), so no transposes are needed around the
// launch; the S bound of the map zero-fills rows past the end of a sequence.
// Head dims 16, 32, 64, 80, 128 and 192: the head dim is cut into 64-column
// (128-byte) chunks, and a chunk past hd is zero-filled by TMA (hd 16 and 32
// pad to 64, hd 80 to 128).  Q.K^T runs hd / 16 k-steps and P.V hd
// columns (wgmma's N need not fill a swizzle atom), so the padding costs
// shared memory but no products.
//
// Design (FlashAttention-3's structure).  A work tile is 128 q rows of one
// (b, h), owned by two consumer warpgroups of 64 rows each; a producer
// warpgroup, of which two threads work, feeds them.  Blocks are persistent,
// at most one per SM, and walk the work tiles in an order that starts the q
// tiles with the most live KV tiles (the last ones, under causal masking)
// first.  The producer loads each tile's Q into one of two Q buffers, and K
// and V tiles (128 keys, or 64 at hd 192 so that everything fits in shared
// memory) into rings of NSTAGES stages, with TMA (cp.async.bulk.tensor),
// 128-byte swizzled, each arrival counted on an mbarrier; K and V stages
// are freed apart, K as soon as its product is done.  A consumer warpgroup
// computes S = Q.K^T with wgmma (both operands in shared memory, K-major),
// masks only the tiles that cross the diagonal, the window's edge or the
// sequence's end, updates the softmax state in registers (row max and sum
// over the four lanes that share a row), converts its float32 accumulator
// fragment to bf16 in place, and computes O += P.V with wgmma taking A = P
// from registers and B = V from shared memory with the transpose flag (V's
// keys are not contiguous).  Two overlaps keep the tensor cores busy: a
// warpgroup issues S of the next KV tile before P.V of this one and runs
// its softmax beside that P.V, and the two warpgroups take turns to issue
// their products (ping-pong, on a pair of mbarriers), so one's softmax runs
// beside the other's products.  The epilogue divides by max(l, 1e-30) and
// writes bf16 into the warpgroup's half of its Q buffer; a second thread of
// the producer warpgroup stores it with one TMA store per 64 columns, which
// drops rows past S and columns past hd, so that no consumer waits for it.
//
// The training path launches flash_fwd_sm90_stats_kernel, the same body
// compiled to also write each q row's log-sum-exp (float32, natural log) for
// the backward kernels of flash_bwd_sm90.cu; the score path's
// flash_fwd_sm90_kernel writes nothing more.  The PTX and host helpers both
// files use are in flash_sm90.cuh.
//
// Registers: the block is three warpgroups; setmaxnreg takes the producer's
// down to 40 and gives each consumer thread 232 (S, P and O fragments are
// 64 + 32 + 64 words at hd 128).  Every mbarrier wait traps after about
// 10 s of spinning, so that a fault in the pipeline ends the launch with an
// error instead of hanging the card.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16): for the
// granite-3-8b prefill (B=8, S=512, H=32, K=8, hd=128) the function moves
// q, k, v and o once, 84 MB, 25 us, and does 4*hd per unmasked (q, k) pair,
// 17.2 GFLOP, 17 us; so bytes bound it.  The design reads each q tile once
// and each K/V tile once per work tile (the heads that share a KV head run
// in neighbouring blocks, so the repeats hit L2), and never materialises S.

#include "flash_sm90.cuh"

namespace {

constexpr int BQ = 128;                       // q rows per work tile
constexpr int NCONSUMERS = 256;               // two warpgroups of 64 rows
constexpr int NTHREADS = NCONSUMERS + 128;    // and one producer warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int HD>
struct Tile {
  static constexpr int HDP = (HD + 63) / 64 * 64;           // the head dim padded
  static constexpr int NKS = HD / 16;                       // k-steps of Q.K^T
  static constexpr int NCH = HDP / 64;                      // 128-byte head-dim chunks
  static constexpr int BK = HDP > 128 ? 64 : 128;           // keys per K/V tile
  static constexpr int NSTAGES = 2;                         // K/V ring depth
  static constexpr int NQBUF = 2;                           // Q buffers
  static constexpr int Q_CHUNK = BQ * 128;                  // bytes of one Q chunk
  static constexpr int KV_CHUNK = BK * 128;                 // bytes of one K or V chunk
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;           // one of K or V, one stage
  static constexpr int BAR_OFFSET = NQBUF * Q_BYTES + 2 * NSTAGES * KV_BYTES;
  // The Q buffers and the K and V rings, then 2 + 3 * NQBUF + 4 * NSTAGES
  // mbarriers; 1024 bytes of slack for aligning the base to the 128-byte
  // swizzle's 1024-byte period.
  static constexpr int SMEM = BAR_OFFSET + 8 * (2 + 3 * NQBUF + 4 * NSTAGES) + 1024;
};

// ---- the kernel -------------------------------------------------------------
//
// Fragments (wgmma's accumulator layout): thread `lane` of warp `w` in a
// consumer warpgroup holds rows w*16 + lane/4 and w*16 + lane/4 + 8; its
// element i of an N-column accumulator lies in row +8 when (i & 2), column
// (i / 4) * 8 + (lane % 4) * 2 + (i & 1).  The same layout, read as pairs,
// is wgmma's A operand in registers: words 4kk..4kk+3 of P are the 16 keys
// of k-step kk.


// One work tile: 128 q rows of one (b, h), and its live KV tiles j_lo ..
// j_hi (flash.py's `live`, for these rows), walked upwards as flash.py's
// grid does: the masked diagonal tile comes last, where its softmax runs
// beside the previous tile's P.V.
// Tiles are numbered so that the q tiles with the most KV tiles come first
// and the heads that share a KV head sit side by side.
struct Work {
  int b, h, kh, q0, j_lo, j_hi, n_iter;
};

template <int BK>
__device__ __forceinline__ Work work_of(int t, int B, int S, int H, int KH, int causal,
                                        int window) {
  const int n_qt = (S + BQ - 1) / BQ;
  Work w;
  w.h = t % H;
  w.b = (t / H) % B;
  const int qt = n_qt - 1 - t / (H * B);
  w.kh = w.h / (H / KH);
  w.q0 = qt * BQ;
  w.j_hi = (S + BK - 1) / BK - 1;
  if (causal) w.j_hi = min(w.j_hi, (min(w.q0 + BQ, S) - 1) / BK);
  w.j_lo = 0;
  if (window > 0 && w.q0 - window + 1 > 0) w.j_lo = (w.q0 - window + 1) / BK;
  w.n_iter = w.j_hi - w.j_lo + 1;
  return w;
}

// S = Q.K^T over hd / 16 k-steps, four to a 64-column chunk (one commit
// group, not waited for).  The count is a compile-time constant: a
// wgmma skipped at run time would make ptxas serialise them all.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<HD>::BK / 2], uint32_t q_tile,
                                         uint32_t k_tile) {
  using T = Tile<HD>;
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < T::NKS; ++k)
    wgmma_ss<T::BK>(sc, smem_desc(q_tile + (k / 4) * T::Q_CHUNK + (k % 4) * 32, 16, 1024),
                    smem_desc(k_tile + (k / 4) * T::KV_CHUNK + (k % 4) * 32, 16, 1024), k > 0);
  wgmma_commit();
}

// O += P.V, V MN-major: its keys are not contiguous (one commit group).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         uint32_t (&pa)[Tile<HD>::BK / 4], uint32_t v_tile) {
  using T = Tile<HD>;
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
    wgmma_rs<HD>(acc, &pa[4 * kk], smem_desc(v_tile + kk * 16 * 128, T::KV_CHUNK, 1024));
  wgmma_commit();
}


// Scale one tile's scores to the log2 domain, mask them where the tile
// crosses the diagonal, the window's edge or the sequence's end (MASK),
// update the running max (over the four lanes that share a row) and the row
// sums, and leave p in `sc`; `corr` gets each row's correction factor for O.
// Unmasked, the scale folds into the exponent's argument: p = 2^(s c - m).
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2], float scale_log2,
                                             int row0, int k0, int lane, int S, int causal,
                                             int window) {
  if (MASK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int row = row0 + ((i & 2) ? 8 : 0);
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      bool ok = col < S;
      if (causal) ok = ok && row >= col;
      if (window > 0) ok = ok && row < col + window;
      sc[i] = ok ? sc[i] * scale_log2 : NEG_INF;
    }
  }
  // Each row's BK / 4 elements reduce in four independent chains.
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[(i >> 1) & 1][(i >> 2) * 2 + (i & 1)] = sc[i];
#pragma unroll
  for (int i = 8; i < BK / 2; ++i) {
    float& p = part[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)];
    p = fmaxf(p, sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], MASK ? mx : mx * scale_log2);
    corr[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = MASK ? ex2(sc[i] - m_run[r]) : ex2(fmaf(sc[i], scale_log2, -m_run[r]));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[(i >> 1) & 1][(i >> 2) * 2 + (i & 1)] = sc[i];
#pragma unroll
  for (int i = 8; i < BK / 2; ++i) part[(i >> 1) & 1][((i >> 2) & 1) * 2 + (i & 1)] += sc[i];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l_run[r] = l_run[r] * corr[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2], float scale_log2,
                                             int row0, int r_first, int k0, int lane, int S,
                                             int causal, int window) {
  const bool mask = (k0 + BK > S) || (causal && k0 + BK - 1 > r_first) ||
                    (window > 0 && k0 <= r_first + 63 - window);
  if (mask)
    softmax_tile<BK, true>(sc, m_run, l_run, corr, scale_log2, row0, k0, lane, S, causal, window);
  else
    softmax_tile<BK, false>(sc, m_run, l_run, corr, scale_log2, row0, k0, lane, S, causal, window);
}

// P in bf16, in place of wgmma's A fragment.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 4], const float (&sc)[BK / 2]) {
#pragma unroll
  for (int i = 0; i < BK / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// The kernel's body.  With STATS it also writes each q row's log-sum-exp of
// the scaled scores (natural log, float32) to lse[(b * H + h) * s_pad + row],
// s_pad being S rounded up to BQ: every row of a work tile, those past S
// too (finite there), so that the backward pass reads whole tiles.
template <int HD, bool STATS>
__device__ __forceinline__ void flash_fwd_body(const CUtensorMap& tm_q, const CUtensorMap& tm_k,
                                               const CUtensorMap& tm_v, const CUtensorMap& tm_o,
                                               int B, int S, int H, int KH, int causal,
                                               int window, float scale_log2, float* lse) {
  using T = Tile<HD>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                               // NQBUF x NCH chunks of BQ x 64
  const uint32_t sK = sQ + T::NQBUF * T::Q_BYTES;        // NSTAGES x NCH chunks of BK x 64
  const uint32_t sV = sK + T::NSTAGES * T::KV_BYTES;     // the same
  // mbarriers, 8 bytes each: Q full, Q empty and O full (O written over Q)
  // per Q buffer, then K full, V full, K empty and V empty per stage, then
  // each consumer warpgroup's turn to issue products.
  const uint32_t q_full = base + T::BAR_OFFSET;
  const uint32_t q_empty = q_full + 8 * T::NQBUF;
  const uint32_t o_full = q_empty + 8 * T::NQBUF;
  const uint32_t k_full = o_full + 8 * T::NQBUF;
  const uint32_t v_full = k_full + 8 * T::NSTAGES;
  const uint32_t k_empty = v_full + 8 * T::NSTAGES;
  const uint32_t v_empty = k_empty + 8 * T::NSTAGES;
  const uint32_t turn = v_empty + 8 * T::NSTAGES;        // + 8 * warpgroup
  const int n_work = (S + BQ - 1) / BQ * B * H;

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::NQBUF; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 1);                      // the O store has read it
      mbar_init(o_full + 8 * i, NCONSUMERS / 32);         // lane 0 of each consumer warp
    }
    for (int s = 0; s < T::NSTAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, NCONSUMERS / 32);
      mbar_init(v_empty + 8 * s, NCONSUMERS / 32);
    }
    for (int i = 0; i < 2; ++i) mbar_init(turn + 8 * i, NCONSUMERS / 64);  // the other warpgroup's warps
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Each block walks the work tiles blockIdx.x, + gridDim.x, ...; `n_done`
  // counts the work tiles done (Q buffer n_done % NQBUF), `kv` the K/V tiles
  // through the ring (stage kv % NSTAGES).  A barrier's phase k completes
  // with the k-th use of its buffer, so a wait names the parity of k.
  if (threadIdx.x >= NCONSUMERS) {
    // ---- producer warpgroup: one thread issues every TMA load, one in the
    // next warp every TMA store ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NCONSUMERS + 32) {
      // O of a tile lies over its Q buffer once the consumers have written
      // it; the buffer goes back to the loads once the store has read it.
      int n_done = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n_done) {
        const Work w = work_of<BK>(t, B, S, H, KH, causal, window);
        const int qb = n_done % T::NQBUF;
        mbar_wait(o_full + 8 * qb, (n_done / T::NQBUF) & 1);
        for (int c = 0; c < T::NCH; ++c)
          tma_store_4d(&tm_o, sQ + qb * T::Q_BYTES + c * T::Q_CHUNK, c * 64, w.h, w.q0, w.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(q_empty + 8 * qb);
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    if (threadIdx.x == NCONSUMERS) {
      int kv = 0, n_done = 0;
      for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n_done) {
        const Work w = work_of<BK>(t, B, S, H, KH, causal, window);
        const int qb = n_done % T::NQBUF;
        if (n_done >= T::NQBUF) mbar_wait(q_empty + 8 * qb, ((n_done / T::NQBUF) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, T::Q_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load_4d(sQ + qb * T::Q_BYTES + c * T::Q_CHUNK, &tm_q, q_full + 8 * qb, c * 64, w.h,
                      w.q0, w.b);
        for (int i = 0; i < w.n_iter; ++i, ++kv) {
          const int s = kv % T::NSTAGES;
          const int k0 = (w.j_lo + i) * BK;
          if (kv >= T::NSTAGES) mbar_wait(k_empty + 8 * s, ((kv / T::NSTAGES) - 1) & 1);
          mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
          for (int c = 0; c < T::NCH; ++c)
            tma_load_4d(sK + s * T::KV_BYTES + c * T::KV_CHUNK, &tm_k, k_full + 8 * s, c * 64,
                        w.kh, k0, w.b);
          if (kv >= T::NSTAGES) mbar_wait(v_empty + 8 * s, ((kv / T::NSTAGES) - 1) & 1);
          mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
          for (int c = 0; c < T::NCH; ++c)
            tma_load_4d(sV + s * T::KV_BYTES + c * T::KV_CHUNK, &tm_v, v_full + 8 * s, c * 64,
                        w.kh, k0, w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + wg*64 .. + 63 of a tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  // Ping-pong: a warpgroup issues its products only after the other one has
  // issued its own, so one's softmax runs while the other's products keep
  // the tensor cores busy.  Warpgroup 0 goes first; `turns` counts this
  // warpgroup's waits, and the other's k-th issue completes phase k of
  // this warpgroup's barrier (warpgroup 1's start-up arrival is phase 0 of
  // warpgroup 0's).
  const uint32_t my_turn = turn + 8 * wg, their_turn = turn + 8 * (1 - wg);
  int turns = 0;
  if (wg == 1) release(their_turn, lane);
  int kv = 0, n_done = 0;
  for (int t = blockIdx.x; t < n_work; t += gridDim.x, ++n_done) {
    const Work w = work_of<BK>(t, B, S, H, KH, causal, window);
    const int r_first = w.q0 + wg * 64;
    const int row0 = r_first + ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // and row0 + 8
    const int qb = n_done % T::NQBUF;
    const uint32_t q_wg = sQ + qb * T::Q_BYTES + wg * 64 * 128;
    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};                          // this thread's share of the row sums
    float sc[BK / 2], corr[2];
    uint32_t pa[BK / 4];

    // The first KV tile: S, softmax, P.
    mbar_wait(q_full + 8 * qb, (n_done / T::NQBUF) & 1);
    int s = kv % T::NSTAGES;
    mbar_wait(k_full + 8 * s, (kv / T::NSTAGES) & 1);
    mbar_wait(my_turn, turns++ & 1);
    issue_qk<HD>(sc, q_wg, sK + s * T::KV_BYTES);
    release(their_turn, lane);
    wgmma_wait<0>();
    fence_regs(sc);
    release(k_empty + 8 * s, lane);
    softmax_tile<BK>(sc, m_run, l_run, corr, scale_log2, row0, r_first, w.j_lo * BK, lane, S,
                     causal, window);
    pack_p<BK>(pa, sc);

    // Then S of tile i runs on the tensor cores beside P.V of tile i - 1,
    // and the softmax of tile i beside that P.V.
    for (int i = 1; i < w.n_iter; ++i) {
      const int sp = s;                                   // the previous tile's stage
      s = (kv + i) % T::NSTAGES;
      mbar_wait(k_full + 8 * s, ((kv + i) / T::NSTAGES) & 1);
      mbar_wait(v_full + 8 * sp, ((kv + i - 1) / T::NSTAGES) & 1);
      mbar_wait(my_turn, turns++ & 1);
      issue_qk<HD>(sc, q_wg, sK + s * T::KV_BYTES);
      issue_pv<HD>(acc, pa, sV + sp * T::KV_BYTES);
      release(their_turn, lane);
      wgmma_wait<1>();                                    // S done, P.V in flight
      fence_regs(sc);
      release(k_empty + 8 * s, lane);
      softmax_tile<BK>(sc, m_run, l_run, corr, scale_log2, row0, r_first, (w.j_lo + i) * BK,
                       lane, S, causal, window);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(v_empty + 8 * sp, lane);
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
      pack_p<BK>(pa, sc);
    }

    // The last tile's P.V.
    mbar_wait(v_full + 8 * s, ((kv + w.n_iter - 1) / T::NSTAGES) & 1);
    mbar_wait(my_turn, turns++ & 1);
    issue_pv<HD>(acc, pa, sV + s * T::KV_BYTES);
    release(their_turn, lane);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    release(v_empty + 8 * s, lane);
    kv += w.n_iter;

    // Epilogue: O / max(l, 1e-30) in bf16, into this warpgroup's half of the
    // Q buffer (Q is no longer needed) in the 128-byte swizzled layout, for
    // the producer warpgroup's TMA store, which drops rows past S and
    // columns past hd.  The
    // Q buffer goes back to the producer once the store has read it.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
      if constexpr (STATS) {
        if (lane % 4 == 0)
          lse[(size_t(w.b) * H + w.h) * ((S + BQ - 1) / BQ * BQ) + row0 + 8 * r] =
              (m_run[r] + log2f(fmaxf(l, 1e-30f))) * LN2;
      }
    }
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 - r_first + 8 * r;           // 0..63 within the warpgroup
        const uint32_t addr = q_wg + (n8 / 8) * T::Q_CHUNK + row * 128 +
                              (((n8 % 8) ^ (row & 7)) << 4) + (lane % 4) * 4;
        const uint32_t val =
            pack_bf16(acc[n8 * 4 + 2 * r] * inv[r], acc[n8 * 4 + 2 * r + 1] * inv[r]);
        asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(val) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA store
    release(o_full + 8 * qb, lane);
  }
}

// The score path's kernel: no statistics.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, int B, int S, int H, int KH,
                      int causal, int window, float scale_log2) {
  flash_fwd_body<HD, false>(tm_q, tm_k, tm_v, tm_o, B, S, H, KH, causal, window, scale_log2,
                            nullptr);
}

// The training path's forward: the same, and each row's log-sum-exp.
template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_sm90_stats_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o, int B, int S, int H,
                            int KH, int causal, int window, float scale_log2, float* lse) {
  flash_fwd_body<HD, true>(tm_q, tm_k, tm_v, tm_o, B, S, H, KH, causal, window, scale_log2, lse);
}

// STATS: the training path's kernel, which also writes the log-sum-exp.
template <int HD, bool STATS>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S, int H,
           int KH, int causal, int window, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err;
    if constexpr (STATS)
      err = cudaFuncSetAttribute(flash_fwd_sm90_stats_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    else
      err = cudaFuncSetAttribute(flash_fwd_sm90_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, S, H, HD, BQ) || !make_map(&mk, k, B, S, KH, HD, T::BK) ||
      !make_map(&mv, v, B, S, KH, HD, T::BK) || !make_map(&mo, o, B, S, H, HD, BQ))
    return ERR_TENSOR_MAP;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int n_work = (S + BQ - 1) / BQ * B * H;   // persistent: one block per SM at most
  const int grid = n_work < sms ? n_work : sms;
  if constexpr (STATS)
    flash_fwd_sm90_stats_kernel<HD><<<grid, NTHREADS, T::SMEM, stream>>>(
        mq, mk, mv, mo, B, S, H, KH, causal, window, scale * LOG2E, lse);
  else
    flash_fwd_sm90_kernel<HD><<<grid, NTHREADS, T::SMEM, stream>>>(
        mq, mk, mv, mo, B, S, H, KH, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q (B, S, H, hd), k and v (B, S, KH, hd), o like q; all contiguous and
// 16-byte aligned.  hd in {16, 32, 64, 80, 128, 192}.  window <= 0 means no
// window.  Returns 0 on success, a cudaError_t of the launch, or 1000 when a
// tensor map cannot be made; the kernel runs on `stream` and is not waited
// for.
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                   int KH, int hd, int causal, int window, float scale, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16, false>(q, k, v, o, nullptr, B, S, H, KH, causal, window, scale, s);
    case 32: return launch<32, false>(q, k, v, o, nullptr, B, S, H, KH, causal, window, scale, s);
    case 64: return launch<64, false>(q, k, v, o, nullptr, B, S, H, KH, causal, window, scale, s);
    case 80: return launch<80, false>(q, k, v, o, nullptr, B, S, H, KH, causal, window, scale, s);
    case 128: return launch<128, false>(q, k, v, o, nullptr, B, S, H, KH, causal, window, scale, s);
    case 192: return launch<192, false>(q, k, v, o, nullptr, B, S, H, KH, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The training path's forward: causal, no window, and each q row's
// log-sum-exp of the scaled scores (natural log) into lse, float32
// (B, H, s_pad) with s_pad = S rounded up to 128, every row written.  hd in
// {64, 80, 128}: the head dims the backward kernels take.
int flash_fwd_sm90_stats(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int S, int H, int KH, int hd, float scale, void* stream) {
  if (B < 1 || S < 1 || KH < 1 || H % KH != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (hd) {
    case 64: return launch<64, true>(q, k, v, o, l, B, S, H, KH, 1, -1, scale, s);
    case 80: return launch<80, true>(q, k, v, o, l, B, S, H, KH, 1, -1, scale, s);
    case 128: return launch<128, true>(q, k, v, o, l, B, S, H, KH, 1, -1, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block at head dim hd (0 if hd is not taken).
int flash_fwd_sm90_smem_bytes(int hd) {
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

const char* flash_fwd_sm90_error_string(int err) {
  if (err == ERR_TENSOR_MAP) return "cuTensorMapEncodeTiled is missing or refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
