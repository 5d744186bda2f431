// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++ with
// wgmma, TMA and mbarriers (csrc/hopper.cuh).
//
// Replaces the TPU kernels of tasksrunner/ml/flash.py launched by
// _flash_bwd_call: _bwd_kernel_delta (the default, Δ computed outside the
// kernel; flash.py:189, pallas_call at :234) and _bwd_kernel
// (TASKSRUNNER_FLASH_BWD_DELTA=fused, Δ computed in the kernel from O;
// flash.py:168, pallas_call at :247). Both compute, over q/k/v/dO [b, s, h, d]
// and the forward's LSE [b, h, s], with the TPU kernel's bf16 rounding points:
//
//   P  = exp(bf16(q) . bf16(k)^T * scale - LSE)      f32
//   dV = bf16(P)^T . bf16(dO)
//   dP = bf16(dO) . bf16(v)^T
//   Δ  = sum_d f32(dO) * f32(O)                        per row, f32, from the
//                                                      IO dtype's values
//   dS = P * (dP - Δ) * scale
//   dQ = bf16(dS) . bf16(k),  dK = bf16(dS)^T . bf16(q)
//
// with dQ, dK, dV stored in the IO dtype.
//
// What bounds it on an H100: the five products are 10*b*h*s*s*d operations,
// 85.9 GFLOP at the bench shape b32 h16 s512 d64: 86.9 us at 989 TFLOP/s bf16,
// against 269 MB moved (q, k, v, O, dO read and dq, dk, dv written once in
// bf16, LSE in f32: 80.4 us at 3.35 TB/s). The bound is set by operations.
// At the served shape (s 32, d 32) it is far below one launch.
//
// Design (FlashAttention-3's backward arrangement, written here from scratch).
// The C entry enqueues, on the caller's stream:
//   1. the pre-pass bwd_prep, unless the variant is fused with bf16 IO: Δ
//      [b, h, s] f32 from O and dO (the default variant, as XLA's fused pass
//      computes it outside the Pallas kernel); with f32 IO it also writes bf16
//      copies of q, k, v and dO, so that the main kernel reads bf16 only, and
//      takes Δ from the f32 values for both variants. It zeroes the f32
//      scratch dq_accum [b, s, h, d]; without a pre-pass a memset does;
//   2. the main kernel bwd_main, one block per (128-key tile, head, batch):
//      * two consumer warpgroups own 64 keys each; one producer warp (of a
//        third warpgroup, which gives its registers to the consumers with
//        setmaxnreg) loads the block's K and V once and streams 64-row tiles
//        of Q and dO (and O for the fused variant with bf16 IO) through a
//        ring of 4 stages (2 at d 128, for shared memory), all by TMA
//        completing on mbarriers, with the tile's LSE (and Δ) rows beside
//        them, loaded while the TMA copies are in flight. Rows past s are
//        zero-filled by TMA; keys and rows past s get P = 0 before anything
//        uses it, so they add nothing, and such rows are never written;
//      * per Q tile each consumer warpgroup runs five wgmma products:
//          S^T  = K . Q^T            (SS, both K-major)
//          dP^T = V . dO^T           (SS, both K-major)
//          dV  += bf16(P^T) . dO     (RS: P^T packed from the accumulator;
//                                     dO MN-major through the transpose bit)
//          dK  += bf16(dS^T) . Q     (RS, Q MN-major)
//          dQ_tile = bf16(dS) . K    (SS: dS^T stored swizzled in shared
//                                     memory and read MN-major, as is K; each
//                                     warpgroup takes half of d over the
//                                     block's 128 keys)
//        so there are five products per (key tile, Q tile) and no transposed
//        copy of any tile in shared memory;
//      * dQ_tile (f32) goes through shared memory (swizzled, so the stores
//        do not conflict) into dq_accum by TMA tile reduce-adds
//        (cp.reduce.async.bulk.tensor .add, f32), which leave out rows past
//        s; dK and dV stay in registers and are written once at the end in
//        the IO dtype;
//      * the fused variant with bf16 IO computes Δ per Q tile from the O and
//        dO tiles it streams, inside the kernel, as the TPU kernel does;
//   3. with bf16 IO, bwd_dq_cast: dQ = bf16(dq_accum). With f32 IO dq_accum
//      is dQ itself.
// The caller's buffers are read in place through their [b, s, h, d] strides
// (4-D tensor maps over (d, h, s, b)); d 16, 32 and 64 are one TMA box wide,
// swizzled at 2d bytes; d 128 is two 64-column boxes of 128 bytes.
//
// dQ is not the same bit for bit from run to run: its sum over the key tiles
// is taken by f32 reduce-adds in the order the blocks finish, as
// FlashAttention-2 and -3 take it. dK and dV are deterministic.
//
// The ring's variant (C entry tr_flash_ring_bwd, the RING instantiation of
// bwd_main) is ring attention's backward, in place of the VJP the JAX ring
// takes step by step (tasksrunner/ml/ring.py:70, _block_update_bwd): with the
// ring's final LSE and Δ = rowsum(dO * O) given, one ring step's share of the
// gradients is this kernel's main pass for one visiting key block
// (FlashAttention-2's backward; Liu et al. 2023's ring-attention backward).
// It runs the main kernel alone, on bf16 IO, adds into f32 dQ, dK and dV
// accumulators that it does not zero, and reads the visiting block in place
// of the ring's fold (flash_ring.cu). Its bound per call at the bench shape
// (b 128, s 128, h 16, d 64): q, k, v, dO in bf16, LSE and Δ, dQ, dK and dV
// read and written once in f32, about 0.54 GB or 0.16 ms at 3.35 TB/s,
// against 10*b*h*s*s*d operations for 22 us: set by bytes.
//
// Its times on the card, its registers and spills, and what they show are in
// PERF.md.

#include <cuda.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // rows of a streamed Q / dO / O tile
constexpr int BN = 128;       // keys of a block: two consumer warpgroups of 64
constexpr int CONSUMERS = 256;
constexpr int BLOCK_THREADS = CONSUMERS + 128;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;

// the depth of the Q / dO ring below d 128 (a compile-time knob: the build
// sets -DTR_BWD_STAGES=n from TRTORCH_BWD_STAGES; at d 128 shared memory
// allows 2)
#ifndef TR_BWD_STAGES
#define TR_BWD_STAGES 4
#endif
static_assert(TR_BWD_STAGES >= 1, "the ring needs a stage");

// the shared-memory layout of a block, offsets from a 1024-byte aligned base
template <int D, bool WITH_O>
struct Layout {
  static constexpr int NA = D < 64 ? D : 64;  // columns of a TMA box
  static constexpr int NB = D / NA;           // boxes across d
  static constexpr int SW = NA * 2;           // bytes of a box row, the swizzle span
  static constexpr int STAGES = D == 128 ? 2 : TR_BWD_STAGES;  // depth of the Q / dO ring
  static constexpr int KV = BN * D * 2;       // a K or V tile
  static constexpr int QT = BM * D * 2;       // a Q, dO or O tile
  static constexpr int STAGE = (WITH_O ? 3 : 2) * QT;
  static constexpr int DS = BN * BM * 2;      // dS^T [key][row], 128-byte rows
  // a warpgroup's half of dQ_tile, f32, as boxes of QC columns swizzled at
  // QC * 4 bytes for the TMA reduce-add
  static constexpr int QC = D / 2 < 32 ? D / 2 : 32;
  static constexpr int NQ = D / 2 / QC;
  static constexpr int SWQ = QC * 4;
  static constexpr int DQ = BM * D / 2 * 4;
  static constexpr int K_OFF = 0, V_OFF = KV, STAGE_OFF = 2 * KV;
  static constexpr int DS_OFF = STAGE_OFF + STAGES * STAGE;  // two buffers
  static constexpr int DQ_OFF = DS_OFF + 2 * DS;             // two warpgroups
  static constexpr int LSE_OFF = DQ_OFF + 2 * DQ;  // [STAGES][BM], LSE * log2 e
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * BM * 4;  // [STAGES][BM]
  static constexpr int DELTA_WG_OFF = DELTA_OFF + STAGES * BM * 4;  // [2][BM]
  static constexpr int BAR_OFF = DELTA_WG_OFF + 2 * BM * 4;
  // full[STAGES], empty[STAGES], kv; then room to align the base
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(BYTES <= 232448, "a block has at most 227 KB of shared memory");
};

template <typename T>
struct Params {
  const float* lse;    // [b, h, s]
  const float* delta;  // [b, h, s], unless Δ is computed in the kernel
  T *dk, *dv;          // the ring's variant: f32 accumulators it adds into
  Axis dk_st, dv_st;
  int s, h;
  int shift, sp;  // the ring's variant: the visiting block (flash_ring.cu)
  float scale;
};

// RING: the ring's variant (tr_flash_ring_bwd). Δ and LSE are given, dQ is
// reduce-added into an accumulator the call does not zero, and dK/dV are
// added into f32 accumulators of the visiting block: folded row bi * sp + r
// reads K/V of row bi * sp + (r - shift) mod sp and adds into that row's dK/dV
// (for one shift that map is a permutation, so no two blocks write one row)
template <typename T, int D, bool DELTA_IN, bool RING>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    bwd_main(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
             const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_dq,
             const Params<T> p) {
  using L = Layout<D, DELTA_IN>;
  constexpr int NA = L::NA, NB = L::NB, SW = L::SW, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * STAGES, kv_bar = empty + 8 * STAGES;

  const int n0 = blockIdx.x * BN, head = blockIdx.y, batch = blockIdx.z;
  const int s = p.s, n_tiles = (s + BM - 1) / BM;
  const int rank = batch % p.sp;
  const int kv_batch = RING ? batch - rank + (rank - p.shift + p.sp) % p.sp : batch;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(full + 8 * i, 2);  // the TMA's bytes, then the LSE rows
      hopper::mbar_init(empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_init(kv_bar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer: one warp; the others of its warpgroup only give up registers
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x / 32 != CONSUMERS / 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(kv_bar, 2 * L::KV);
      for (int bb = 0; bb < NB; ++bb) {
        hopper::tma_load_4d(base + L::K_OFF + bb * BN * SW, &tm_k, kv_bar, bb * NA, head, n0,
                            kv_batch);
        hopper::tma_load_4d(base + L::V_OFF + bb * BN * SW, &tm_v, kv_bar, bb * NA, head, n0,
                            kv_batch);
      }
    }
    const int64_t bh = (static_cast<int64_t>(batch) * p.h + head) * s;
    float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
    float* delta_s = reinterpret_cast<float*>(smem + L::DELTA_OFF);
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % STAGES, m0 = i * BM;
      const uint32_t bar = full + 8 * stage;
      hopper::mbar_wait(empty + 8 * stage, ((i / STAGES) & 1) ^ 1);
      if (lane == 0) {  // the tiles first: the LSE loads below overlap them
        const uint32_t tile = base + L::STAGE_OFF + stage * L::STAGE;
        hopper::mbar_arrive_expect_tx(bar, L::STAGE);
        for (int bb = 0; bb < NB; ++bb) {
          hopper::tma_load_4d(tile + bb * BM * SW, &tm_q, bar, bb * NA, head, m0, batch);
          hopper::tma_load_4d(tile + L::QT + bb * BM * SW, &tm_g, bar, bb * NA, head, m0, batch);
          if (DELTA_IN)
            hopper::tma_load_4d(tile + 2 * L::QT + bb * BM * SW, &tm_o, bar, bb * NA, head, m0,
                                batch);
        }
      }
#pragma unroll
      for (int r = lane; r < BM; r += 32) {
        const bool live = m0 + r < s;
        lse_s[stage * BM + r] = live ? p.lse[bh + m0 + r] * LOG2E : 0.f;
        if (!DELTA_IN) delta_s[stage * BM + r] = live ? p.delta[bh + m0 + r] : 0.f;
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    }
  } else {
    // -- consumers: warpgroup wg owns keys n0 + 64 wg .. n0 + 64 wg + 63
    hopper::regs_alloc<CONSUMER_REGS>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int key = n0 + 64 * wg + 16 * warp + g;  // and key + 8
    const float scale = p.scale, scale_log2 = p.scale * LOG2E;

    // K-major A (64 keys of K or V) and B (a Q or dO tile) for k16 step kk
    auto kmajor = [&](uint32_t tile, int rows, int row0, int kk) {
      const int col = kk * 16;
      return hopper::desc<SW>(tile + (col / NA) * rows * SW + row0 * SW + (col % NA) * 2, 16,
                              8 * SW);
    };
    // MN-major B: rows (the k index) 16kk.. of box bb of a tile of ``rows``
    auto mnmajor = [&](uint32_t tile, int rows, int bb, int kk) {
      return hopper::desc<SW>(tile + bb * rows * SW + kk * 16 * SW, 8 * SW, 8 * SW);
    };
    // this warpgroup's half of d in K, MN-major, for the dQ product
    auto k_half = [&](int kk) {
      const uint32_t at = D == 128 ? base + L::K_OFF + wg * BN * SW + kk * 16 * SW
                                   : base + L::K_OFF + kk * 16 * SW + wg * D;
      return hopper::desc<SW>(at, 8 * SW, 8 * SW);
    };

    float dv[NB][NA / 2], dk[NB][NA / 2];
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int i = 0; i < NA / 2; ++i) dv[bb][i] = dk[bb][i] = 0.f;

    unsigned char* dq_stage = smem + L::DQ_OFF + wg * L::DQ;
    float* delta_wg = reinterpret_cast<float*>(smem + L::DELTA_WG_OFF) + wg * BM;

    hopper::mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % STAGES, m0 = i * BM;
      const uint32_t q_tile = base + L::STAGE_OFF + stage * L::STAGE;
      const uint32_t g_tile = q_tile + L::QT;
      hopper::mbar_wait(full + 8 * stage, (i / STAGES) & 1);

      // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 64 rows each
      float sc[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<0, 0>(sc, kmajor(base + L::K_OFF, BN, 64 * wg, kk),
                               kmajor(q_tile, BM, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<0, 0>(dp, kmajor(base + L::V_OFF, BN, 64 * wg, kk),
                               kmajor(g_tile, BM, 0, kk), kk);
      hopper::wgmma_commit();

      const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE_OFF) + stage * BM;
      const float* delta_s;
      if (DELTA_IN) {
        // Δ of the tile's 64 rows from its dO and O tiles, two threads a row
        const unsigned char* gt = smem + L::STAGE_OFF + stage * L::STAGE + L::QT;
        const unsigned char* ot = gt + L::QT;
        const int r = tid / 2, half = tid % 2;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int col = half * (D / 2) + 8 * c;
          const uint32_t off =
              hopper::swz<SW>((col / NA) * BM * SW + r * SW + (col % NA) * 2);
          const uint4 gv = *reinterpret_cast<const uint4*>(gt + off);
          const uint4 ov = *reinterpret_cast<const uint4*>(ot + off);
          const bf16* ge = reinterpret_cast<const bf16*>(&gv);
          const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc += __bfloat162float(ge[e]) * __bfloat162float(oe[e]);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        if (half == 0) delta_wg[r] = acc;
        hopper::named_barrier(2 + wg, 128);
        delta_s = delta_wg;
      } else {
        delta_s = reinterpret_cast<const float*>(smem + L::DELTA_OFF) + stage * BM;
      }
      hopper::wgmma_wait<0>();
      hopper::hold(sc);
      hopper::hold(dp);

      // P^T = 2^(S^T * scale * log2 e - LSE * log2 e) and dS^T, packed to
      // bf16 as the A fragments of k-slice j / 2 (the accumulators are only
      // read, so no ordinary instruction writes a wgmma's registers); keys
      // and rows past s are 0
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 delta2 = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const bool live = key + 8 * h2 < s;
          const int e = 4 * j + 2 * h2;
          const float p0 =
              live && m0 + col < s ? fast_exp2(fmaf(sc[e], scale_log2, -lse2.x)) : 0.f;
          const float p1 =
              live && m0 + col + 1 < s ? fast_exp2(fmaf(sc[e + 1], scale_log2, -lse2.y)) : 0.f;
          pa[j / 2][2 * (j & 1) + h2] = pack_bf16(p0, p1);
          da[j / 2][2 * (j & 1) + h2] = pack_bf16(p0 * (dp[e] - delta2.x) * scale,
                                                  p1 * (dp[e + 1] - delta2.y) * scale);
        }
      }
      // bf16(dS^T) into buffer i % 2: row = the block's key, 128-byte rows of
      // 64 tile rows, swizzled at 128 bytes
      unsigned char* ds_tile = smem + L::DS_OFF + (i & 1) * L::DS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int krow = 64 * wg + 16 * warp + g + 8 * h2;
          const uint32_t off = hopper::swz<128>(krow * 128 + (8 * j + 2 * t) * 2);
          *reinterpret_cast<uint32_t*>(ds_tile + off) = da[j / 2][(j & 1) * 2 + h2];
        }
      }

      // dV += bf16(P^T) . dO and dK += bf16(dS^T) . Q
      hopper::wgmma_fence();
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<1>(dv[bb], pa[kk], mnmajor(g_tile, BM, bb, kk), 1);
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_rs<1>(dk[bb], da[kk], mnmajor(q_tile, BM, bb, kk), 1);
      hopper::wgmma_commit();

      // dQ_tile = bf16(dS) . K over the block's 128 keys, once both halves of
      // dS^T are stored: this warpgroup's half of d
      hopper::fence_proxy_async();
      hopper::named_barrier(1, CONSUMERS);
      float dq[D / 4];
      const uint32_t ds_addr = base + L::DS_OFF + (i & 1) * L::DS;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        hopper::wgmma_ss<1, 1>(dq, hopper::desc<128>(ds_addr + kk * 16 * 128, 1024, 1024),
                               k_half(kk), kk);
      hopper::wgmma_commit();

      hopper::wgmma_wait<1>();  // dV and dK done: the stage is free
      hopper::hold(pa);
      hopper::hold(da);
      if (tid == 0) hopper::mbar_arrive(empty + 8 * stage);
      hopper::wgmma_wait<0>();
      hopper::hold(dq);

      // dQ_tile through shared memory into dq_accum by TMA reduce-adds,
      // which leave out the rows past s
      if (tid == 0) hopper::bulk_wait_read<0>();  // the previous tile's are read
      hopper::named_barrier(2 + wg, 128);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = 16 * warp + g + 8 * h2, col = 8 * j + 2 * t;
          const uint32_t off = hopper::swz<L::SWQ>((col / L::QC) * BM * L::SWQ + row * L::SWQ +
                                                   (col % L::QC) * 4);
          *reinterpret_cast<float2*>(dq_stage + off) =
              make_float2(dq[4 * j + 2 * h2], dq[4 * j + 2 * h2 + 1]);
        }
      }
      hopper::fence_proxy_async();
      hopper::named_barrier(2 + wg, 128);
      if (tid == 0) {
        for (int bq = 0; bq < L::NQ; ++bq)
          hopper::tma_reduce_add_4d(&tm_dq, hopper::smem_addr(dq_stage + bq * BM * L::SWQ),
                                    wg * (D / 2) + bq * L::QC, head, m0, batch);
        hopper::bulk_commit();
      }
    }
    if (tid == 0) hopper::bulk_wait<0>();

    // dK and dV, once, in the IO dtype (the ring's variant: added into the
    // visiting block's f32 accumulators)
    T* dkp = p.dk + kv_batch * p.dk_st.b + head * p.dk_st.h;
    T* dvp = p.dv + kv_batch * p.dv_st.b + head * p.dv_st.h;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = key + 8 * h2;
      if (row >= s) continue;
      T* krow = dkp + row * p.dk_st.s + 2 * t;
      T* vrow = dvp + row * p.dv_st.s + 2 * t;
      // the ring's variant: the row's earlier sums, every load issued before
      // the first store (a store could alias a later load, so the compiler
      // would otherwise wait out one memory round trip per pair)
      float2 k0[NB][NA / 8], v0[NB][NA / 8];
      if constexpr (RING) {
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
#pragma unroll
          for (int j = 0; j < NA / 8; ++j) {
            k0[bb][j] = *reinterpret_cast<const float2*>(krow + bb * NA + 8 * j);
            v0[bb][j] = *reinterpret_cast<const float2*>(vrow + bb * NA + 8 * j);
          }
      }
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) {
#pragma unroll
        for (int j = 0; j < NA / 8; ++j) {
          const float* k2 = &dk[bb][4 * j + 2 * h2];
          const float* v2 = &dv[bb][4 * j + 2 * h2];
          if constexpr (RING) {
            store2(krow + bb * NA + 8 * j, k0[bb][j].x + k2[0], k0[bb][j].y + k2[1]);
            store2(vrow + bb * NA + 8 * j, v0[bb][j].x + v2[0], v0[bb][j].y + v2[1]);
          } else {
            store2(krow + bb * NA + 8 * j, k2[0], k2[1]);
            store2(vrow + bb * NA + 8 * j, v2[0], v2[1]);
          }
        }
      }
    }
  }
}

// -- pre-pass: Δ, and bf16 copies of f32 inputs -----------------------------

template <typename T>
struct PrepArgs {
  const T *q, *k, *v, *o, *g;
  Axis q_st, k_st, v_st, o_st, g_st;
  float* delta;     // [b, h, s]
  float* dq_accum;  // [b, s, h, d], zeroed here
  bf16* staged;     // [4][b, s, h, d] contiguous: q, k, v, dO; f32 IO only
  int b, s, h;
};

__device__ __forceinline__ void load8f(float (&x)[8], const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8f(float (&x)[8], const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// each thread takes 8 elements of one row (b, s, h); D / 8 threads a row, all
// in one warp
template <typename T, int D>
__global__ void __launch_bounds__(256) bwd_prep(const PrepArgs<T> a) {
  constexpr int C = D / 8;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t rows = static_cast<int64_t>(a.b) * a.s * a.h;
  const int64_t row = idx / C;
  const int c = static_cast<int>(idx % C);
  const bool live = row < rows;
  const int hi = live ? static_cast<int>(row % a.h) : 0;
  const int si = live ? static_cast<int>((row / a.h) % a.s) : 0;
  const int bi = live ? static_cast<int>(row / (static_cast<int64_t>(a.h) * a.s)) : 0;
  float acc = 0.f;
  if (live) {
    float4* zero = reinterpret_cast<float4*>(a.dq_accum + row * D + 8 * c);
    zero[0] = zero[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    auto at = [&](const T* x, const Axis& st) {
      return x + bi * st.b + si * st.s + hi * st.h + 8 * c;
    };
    float go[8], oo[8];
    load8f(go, at(a.g, a.g_st));
    load8f(oo, at(a.o, a.o_st));
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += go[e] * oo[e];
    if (a.staged != nullptr) {  // f32 IO: bf16 copies for the main kernel
      const T* src[4] = {at(a.q, a.q_st), at(a.k, a.k_st), at(a.v, a.v_st), at(a.g, a.g_st)};
      const int64_t n = rows * D;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float f[8];
        load8f(f, src[x]);
        const uint4 packed = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                        pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        *reinterpret_cast<uint4*>(a.staged + x * n + row * D + 8 * c) = packed;
      }
    }
  }
#pragma unroll
  for (int off = C / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (live && c == 0) a.delta[(static_cast<int64_t>(bi) * a.h + hi) * a.s + si] = acc;
}

// -- post-pass: dQ = bf16(dq_accum) -----------------------------------------

__global__ void __launch_bounds__(256) bwd_dq_cast(const float* acc, bf16* dq, int64_t n8) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  float f[8];
  load8f(f, acc + 8 * i);
  *reinterpret_cast<uint4*>(dq + 8 * i) = make_uint4(
      pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

// -- host ---------------------------------------------------------------------

struct Call {
  const void *q, *k, *v, *o, *g;
  Axis q_st, k_st, v_st, o_st, g_st, dk_st, dv_st;
  const float* lse;
  float* delta;
  float* dq_accum;
  void *dq, *dk, *dv, *staged;
  int b, s, h;
  float scale;
  cudaStream_t stream;
  int shift = 0, sp = 1;
};

constexpr int ERR_TENSOR_MAP = -2;

template <typename T, int D, bool DELTA_IN, bool RING = false>
int launch_main(const Call& c, const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                const bf16* o, const Axis (&st)[5]) {
  using L = Layout<D, DELTA_IN>;
  CUtensorMap maps[6];
  const bf16* src[5] = {q, k, v, g, o};
  const int rows[5] = {BM, BN, BN, BM, BM};
  for (int i = 0; i < (DELTA_IN ? 5 : 4); ++i) {
    if (hopper::encode_bshd(&maps[i], src[i], false, c.b, c.s, c.h, D, st[i].b, st[i].s,
                            st[i].h, L::NA, rows[i]))
      return ERR_TENSOR_MAP;
  }
  if (!DELTA_IN) maps[4] = maps[3];  // not read
  const int64_t hd = static_cast<int64_t>(c.h) * D;
  if (hopper::encode_bshd(&maps[5], c.dq_accum, true, c.b, c.s, c.h, D, c.s * hd, hd, D, L::QC,
                          BM))
    return ERR_TENSOR_MAP;
  const Params<T> p{c.lse, c.delta, static_cast<T*>(c.dk), static_cast<T*>(c.dv),
                    c.dk_st, c.dv_st, c.s, c.h, c.shift, c.sp, c.scale};
  const int err = allow_smem(bwd_main<T, D, DELTA_IN, RING>, L::BYTES);
  if (err) return err;
  const dim3 grid((c.s + BN - 1) / BN, c.h, c.b);
  bwd_main<T, D, DELTA_IN, RING><<<grid, BLOCK_THREADS, L::BYTES, c.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_prep(const Call& c) {
  const PrepArgs<T> a{static_cast<const T*>(c.q), static_cast<const T*>(c.k),
                      static_cast<const T*>(c.v), static_cast<const T*>(c.o),
                      static_cast<const T*>(c.g), c.q_st, c.k_st, c.v_st, c.o_st, c.g_st,
                      c.delta, c.dq_accum, static_cast<bf16*>(c.staged), c.b, c.s, c.h};
  const int64_t threads = static_cast<int64_t>(c.b) * c.s * c.h * (D / 8);
  bwd_prep<T, D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, c.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_bf16(const Call& c, bool fused) {
  const Axis st[5] = {c.q_st, c.k_st, c.v_st, c.g_st, c.o_st};
  const bf16 *q = static_cast<const bf16*>(c.q), *k = static_cast<const bf16*>(c.k),
             *v = static_cast<const bf16*>(c.v), *g = static_cast<const bf16*>(c.g),
             *o = static_cast<const bf16*>(c.o);
  int err;
  if (fused) {
    const size_t bytes = static_cast<size_t>(c.b) * c.s * c.h * D * sizeof(float);
    err = static_cast<int>(cudaMemsetAsync(c.dq_accum, 0, bytes, c.stream));
    if (!err) err = launch_main<bf16, D, true>(c, q, k, v, g, o, st);
  } else {
    err = launch_prep<bf16, D>(c);
    if (!err) err = launch_main<bf16, D, false>(c, q, k, v, g, o, st);
  }
  if (err) return err;
  const int64_t n8 = static_cast<int64_t>(c.b) * c.s * c.h * D / 8;
  bwd_dq_cast<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, c.stream>>>(
      c.dq_accum, static_cast<bf16*>(c.dq), n8);
  return static_cast<int>(cudaGetLastError());
}

// f32 IO: the pre-pass takes Δ from the f32 values for both variants and
// writes bf16 copies of q, k, v, dO; dq_accum is dQ
template <int D>
int run_f32(const Call& c) {
  int err = launch_prep<float, D>(c);
  if (err) return err;
  const int64_t n = static_cast<int64_t>(c.b) * c.s * c.h * D;
  const bf16* staged = static_cast<const bf16*>(c.staged);
  const Axis dense{static_cast<int64_t>(c.s) * c.h * D, static_cast<int64_t>(c.h) * D, D};
  const Axis st[5] = {dense, dense, dense, dense, dense};
  return launch_main<float, D, false>(c, staged, staged + n, staged + 2 * n, staged + 3 * n,
                                      nullptr, st);
}

template <int D>
int run(const Call& c, bool is_bf16, bool fused) {
  return is_bf16 ? run_bf16<D>(c, fused) : run_f32<D>(c);
}

// the ring's variant: the main kernel alone, bf16 IO, f32 accumulators
template <int D>
int run_ring(const Call& c) {
  const Axis st[5] = {c.q_st, c.k_st, c.v_st, c.g_st, c.g_st};
  const bf16* g = static_cast<const bf16*>(c.g);
  return launch_main<float, D, false, true>(c, static_cast<const bf16*>(c.q),
                                            static_cast<const bf16*>(c.k),
                                            static_cast<const bf16*>(c.v), g, g, st);
}

}  // namespace

// C entry, bound with ctypes by tasksrunner_torch/flash.py. strides holds the
// b, s, h element strides of q, k, v, o, dO, dK, dV in order (21 values);
// dq_accum [b, s, h, d] f32 is contiguous (for f32 IO it is dQ, and dq is
// null), dq is contiguous; delta [b, h, s] f32 is scratch, unused by the fused
// variant with bf16 IO; staged [4, b, s, h, d] bf16 is scratch for f32 IO
// only. Enqueues on ``stream`` the pre-pass, which also zeroes dq_accum
// (for the fused variant with bf16 IO a memset in its place), the main kernel
// and, for bf16 IO, the cast of dQ.
// Returns 0, a CUDA error (cudaGetLastError after the launches), -1 for a d
// the kernels were not built for, or -2 if a tensor map could not be encoded.
// It does not synchronise and allocates nothing.
extern "C" int tr_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* g, const void* lse, void* delta, void* dq_accum, void* dq,
                            void* dk, void* dv, void* staged, int b, int s, int h, int d,
                            int is_bf16, int fused, const int64_t* strides, float scale,
                            void* stream) {
  Axis ax[7];
  for (int i = 0; i < 7; ++i) ax[i] = Axis{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Call c{q,      k,      v,      o,      g,      ax[0],
               ax[1],  ax[2],  ax[3],  ax[4],  ax[5],  ax[6],
               static_cast<const float*>(lse), static_cast<float*>(delta),
               static_cast<float*>(dq_accum), dq, dk, dv, staged, b, s, h, scale,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return run<16>(c, is_bf16, fused);
    case 32: return run<32>(c, is_bf16, fused);
    case 64: return run<64>(c, is_bf16, fused);
    case 128: return run<128>(c, is_bf16, fused);
    default: return -1;
  }
}

// C entry of the ring's variant, bound with ctypes by tasksrunner_torch/flash.py
// (ring_block_grad): one ring step's share of the gradients, for q of the
// rank's rows and the visiting K/V block,
//
//   P = exp(S - LSE),  dV_blk += P^T dO,  dS = P * (dO . V_blk^T - Δ) * scale,
//   dQ += dS . K_blk,  dK_blk += dS^T . Q
//
// with the rounding points of tr_flash_bwd. q, k, v and dO are bf16 [b, s, h,
// d] (sq = sk = s), read through the b, s, h element strides in ``strides``
// (12 values, q, k, v, dO in order); lse and delta [b, h, s] f32 are given
// (the ring's final LSE and rowsum(dO * O)); dq_accum, dk_accum and dv_accum
// are contiguous f32 [b, s, h, d] that the kernel adds into and never zeroes
// (dQ by TMA reduce-adds, so its last bits can change from run to run; dK and
// dV by one read and one write of each element). 0 <= shift < sp, sp divides
// b: folded row bi * sp + r reads K/V and adds into dK/dV of row
// bi * sp + (r - shift) mod sp. Returns as tr_flash_bwd does; it does not
// synchronise and allocates nothing.
extern "C" int tr_flash_ring_bwd(const void* q, const void* k, const void* v, const void* g,
                                 const void* lse, const void* delta, void* dq_accum,
                                 void* dk_accum, void* dv_accum, int b, int s, int h, int d,
                                 const int64_t* strides, float scale, int shift, int sp,
                                 void* stream) {
  Axis ax[4];
  for (int i = 0; i < 4; ++i) ax[i] = Axis{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const int64_t hd = static_cast<int64_t>(h) * d;
  const Axis dense{s * hd, hd, d};
  const Call c{q,      k,      v,      nullptr, g,     ax[0],
               ax[1],  ax[2],  ax[3],  ax[3],   dense, dense,
               static_cast<const float*>(lse), const_cast<float*>(static_cast<const float*>(delta)),
               static_cast<float*>(dq_accum), nullptr, dk_accum, dv_accum, nullptr, b, s, h,
               scale, static_cast<cudaStream_t>(stream), shift, sp};
  switch (d) {
    case 16: return run_ring<16>(c);
    case 32: return run_ring<32>(c);
    case 64: return run_ring<64>(c);
    case 128: return run_ring<128>(c);
    default: return -1;
  }
}
