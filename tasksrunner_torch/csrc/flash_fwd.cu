// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++ with
// wgmma, TMA and mbarriers (csrc/hopper.cuh).
//
// Replaces the TPU kernel tasksrunner/ml/flash.py::_fwd_kernel (flash.py:130,
// pallas_call at :152, launched by _flash_fwd). It computes the same function:
// bidirectional attention with no mask over q/k/v [b, s, h, d],
//
//   S = bf16(q) . bf16(k)^T accumulated in f32, times scale
//   m = rowmax S,  p = exp(S - m) (unnormalised),  l = sum p
//   O = (bf16(p) . bf16(v)) / l   in the IO dtype
//   LSE = m + log l               in f32, [b, h, s]
//
// What bounds it on an H100: at the bench shape b32 h16 s512 d64 the two
// products are 4*b*h*s*s*d = 34.4 GFLOP (34.7 us at 989 TFLOP/s bf16) and
// q/k/v/o in bf16 are 134 MB (40.1 us at 3.35 TB/s), so the bound is 40.4 us,
// set by bytes. At d 64 the exp is as large as the products: b*h*s*s = 134 M
// ex2 on the special-function unit (16 a clock on each SM) take as many
// clocks as the tensor cores need for both products, so the exp has to run
// under the products, not after them. At the served shape (b <= 32, s 32,
// h 4, d 32) the work is a few microseconds of launch.
//
// Design (FlashAttention-3's forward arrangement, written here from scratch):
//   * a persistent grid, one block per SM (at most), each walking work tiles
//     (128-row Q tile, head, batch) with the row tile fastest, so the blocks
//     that read one head's K and V run together and share them through L2.
//     A block has two consumer warpgroups of 64 rows each and one producer
//     warp, of a third warpgroup that gives its registers to the consumers
//     with setmaxnreg (producer 24, consumers 240; 168 at entry). One block
//     fills an SM: its 2 x 64 accumulator registers of S alone rule out a
//     second;
//   * the producer loads each work tile's Q tile into one of two slots (the
//     next tile's Q arrives while this one is computed) and streams 128-key
//     K and V tiles through a ring of 4 stages (2 at d 128, for shared
//     memory), all by TMA completing on mbarriers; a stage or a Q slot is
//     free again once both consumer warpgroups have arrived on its empty
//     barrier. Rows and keys past s come back zero-filled from TMA's bounds;
//     keys past s are left out of the max and get p = 0, so they add
//     nothing, and rows past s are never written;
//   * per K/V tile each consumer warpgroup runs two wgmma products:
//       S = Q . K^T          (SS, both K-major, m64n128k16)
//       O += bf16(P) . V     (RS: P packed to bf16 straight from the S
//                             accumulator; V read MN-major from its TMA tile
//                             through wgmma's transpose bit)
//     so no transposed copy of V exists anywhere;
//   * online softmax in registers, in base-2 exponent units: the max is
//     taken over S as it comes (scale > 0; the wrapper folds a negative
//     scale into k), then p = 2^(S * scale * log2 e - m) in one fma and
//     ex2.approx; the running max m and sum l stay in registers (each thread
//     holds two rows, reduced over the four threads of a quad), and the
//     accumulator is rescaled by 2^(m_old - m) per tile. p is rounded to
//     bf16 against the running max, as in the kernel this replaces;
//   * overlap: S of tile j is issued together with P . V of tile j - 1, and
//     the softmax of tile j runs while that P . V does; P is packed and the
//     accumulator rescaled only while no product uses their registers (else
//     ptxas serialises every wgmma). The two warpgroups also take turns at
//     issuing their products (named barriers 1 and 2), so one's softmax
//     runs under the other's products instead of both exps at once;
//   * epilogue: O = acc / l in the IO dtype and LSE = m + log l, from
//     registers, through the caller's strides. No atomics and no
//     order-dependent sums: the result is the same bit for bit between runs.
// The caller's buffers are read in place through their [b, s, h, d] strides
// (4-D tensor maps over (d, h, s, b)); d 16, 32 and 64 are one TMA box wide,
// swizzled at 2d bytes; d 128 is two 64-column boxes of 128 bytes. f32 IO
// goes through a pre-pass in the same C call that writes bf16 copies of q,
// k and v into a scratch buffer the wrapper allocates; O is written in f32.
//
// Its times on the card, its registers and spills, what the variants that
// were tried showed, and what is left are in PERF.md.

#include <cuda.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // query rows of a work tile: two consumer warpgroups of 64
constexpr int BN = 128;  // keys of a streamed K/V tile
constexpr int CONSUMERS = 256;
constexpr int BLOCK_THREADS = CONSUMERS + 128;
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;
constexpr float LN2 = 0.6931471805599453f;

// the depth of the K/V ring below d 128 (a compile-time knob: the build sets
// -DTR_FWD_STAGES=n from TRTORCH_FWD_STAGES; at d 128 shared memory allows 2)
#ifndef TR_FWD_STAGES
#define TR_FWD_STAGES 4
#endif
static_assert(TR_FWD_STAGES >= 2, "the consumers hold one K/V stage while the next one loads");

// the shared-memory layout of a block, offsets from a 1024-byte aligned base
template <int D>
struct Layout {
  static constexpr int NA = D < 64 ? D : 64;       // columns of a TMA box
  static constexpr int NB = D / NA;                // boxes across d
  static constexpr int SW = NA * 2;                // bytes of a box row, the swizzle span
  static constexpr int STAGES = D == 128 ? 2 : TR_FWD_STAGES;  // depth of the K/V ring
  static constexpr int TILE = 128 * D * 2;         // a Q, K or V tile (BM = BN = 128)
  static constexpr int Q_OFF = 0;                  // two Q slots
  static constexpr int STAGE_OFF = 2 * TILE;       // stage i: K, then V
  static constexpr int BAR_OFF = STAGE_OFF + STAGES * 2 * TILE;
  // q_full[2], q_empty[2], full[STAGES], empty[STAGES]; then room to align
  // the base
  static constexpr int BYTES = BAR_OFF + 8 * (2 * STAGES + 4) + 1024;
  static_assert(BYTES <= 232448, "a block has at most 227 KB of shared memory");
};

template <typename T>
struct Params {
  T* o;
  Axis o_st;
  float* lse;  // [b, h, s]
  int s, h, n_work;
  float scale;
};

// The softmax step of one 128-key tile for this thread's two rows (g and
// g + 8 of its warp; register i holds row (i >> 1) & 1), in base-2 exponent
// units: the running max m moved by the tile's, keys past s left out (only
// in a RAGGED tile), and S replaced in place by p = 2^(S * scale * log2 e -
// m), summed into l. corr = 2^(m_old - m) rescales the older sums; it is 0 on
// the first tile, where m_old = -inf. Eight running maxima and sums keep the
// dependency chains short.
template <bool RAGGED>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2, int n0, int s,
                                             int t) {
  auto live = [&](int i) { return !RAGGED || n0 + 8 * (i / 4) + 2 * t + (i & 1) < s; };
  float mx[8], rs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i] = live(i) ? sc[i] : -INFINITY;
#pragma unroll
  for (int i = 8; i < 64; ++i) mx[i % 8] = fmaxf(mx[i % 8], live(i) ? sc[i] : -INFINITY);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float row = fmaxf(fmaxf(mx[2 * r], mx[2 * r + 1]), fmaxf(mx[2 * r + 4], mx[2 * r + 5]));
    const float m_new = fmaxf(m[r], quad_max(row) * scale_log2);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = live(i) ? fast_exp2(fmaf(sc[i], scale_log2, -m[r])) : 0.f;
    rs[i % 8] = i < 8 ? sc[i] : rs[i % 8] + sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * corr[r] + ((rs[2 * r] + rs[2 * r + 1]) + (rs[2 * r + 4] + rs[2 * r + 5]));
}

__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2], float (&l)[2],
                                        float (&corr)[2], float scale_log2, int n0, int s,
                                        int t) {
  if (n0 + BN > s)
    softmax_tile<true>(sc, m, l, corr, scale_log2, n0, s, t);
  else
    softmax_tile<false>(sc, m, l, corr, scale_log2, n0, s, t);
}

// p packed to bf16 as the A fragments of P . V: k-slice kk is accumulator
// registers 8kk..8kk+7, in pairs
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
    fwd_main(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v, const Params<T> p) {
  using L = Layout<D>;
  constexpr int NA = L::NA, NB = L::NB, SW = L::SW, STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_full = base + L::BAR_OFF, q_empty = q_full + 16, full = q_empty + 16,
                 empty = full + 8 * STAGES;

  const int s = p.s, n_tiles = (s + BN - 1) / BN, n_m = (s + BM - 1) / BM;
  // work tile w: Q rows m0.. of (head, batch)
  auto decode = [&](int w, int& m0, int& head, int& batch) {
    m0 = (w % n_m) * BM;
    head = (w / n_m) % p.h;
    batch = w / (n_m * p.h);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(q_full + 8 * i, 1);   // the producer's arrival with the TMA's bytes
      hopper::mbar_init(q_empty + 8 * i, 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(full + 8 * i, 1);
      hopper::mbar_init(empty + 8 * i, 2);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // -- producer: one thread; the rest of its warpgroup only gives up registers
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != CONSUMERS) return;
    int it = 0, wi = 0;  // K/V tiles and work tiles so far
    for (int w = blockIdx.x; w < p.n_work; w += gridDim.x, ++wi) {
      int m0, head, batch;
      decode(w, m0, head, batch);
      const int slot = wi & 1;
      const uint32_t q_bar = q_full + 8 * slot;
      hopper::mbar_wait(q_empty + 8 * slot, ((wi >> 1) & 1) ^ 1);
      hopper::mbar_arrive_expect_tx(q_bar, L::TILE);
      for (int bb = 0; bb < NB; ++bb)
        hopper::tma_load_4d(base + L::Q_OFF + slot * L::TILE + bb * BM * SW, &tm_q, q_bar,
                            bb * NA, head, m0, batch);
      for (int j = 0; j < n_tiles; ++j, ++it) {
        const int stage = it % STAGES;
        const uint32_t bar = full + 8 * stage;
        const uint32_t k_tile = base + L::STAGE_OFF + stage * 2 * L::TILE;
        hopper::mbar_wait(empty + 8 * stage, ((it / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(bar, 2 * L::TILE);
        for (int bb = 0; bb < NB; ++bb) {
          hopper::tma_load_4d(k_tile + bb * BN * SW, &tm_k, bar, bb * NA, head, j * BN, batch);
          hopper::tma_load_4d(k_tile + L::TILE + bb * BN * SW, &tm_v, bar, bb * NA, head,
                              j * BN, batch);
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wg owns rows m0 + 64 wg .. m0 + 64 wg + 63
  hopper::regs_alloc<CONSUMER_REGS>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t = lane % 4;
  const float scale_log2 = p.scale * LOG2E;

  // K-major operand: rows row0.. of a 128-row tile (Q or K), k16 step kk
  auto kmajor = [&](uint32_t tile, int row0, int kk) {
    const int col = kk * 16;
    return hopper::desc<SW>(tile + (col / NA) * 128 * SW + row0 * SW + (col % NA) * 2, 16,
                            8 * SW);
  };
  // MN-major B: keys 16kk.. of box bb of a V tile
  auto mnmajor = [&](uint32_t tile, int bb, int kk) {
    return hopper::desc<SW>(tile + bb * 128 * SW + kk * 16 * SW, 8 * SW, 8 * SW);
  };
  auto k_of = [&](int it) { return base + L::STAGE_OFF + (it % STAGES) * 2 * L::TILE; };

  float acc[NB][NA / 2];
  float m_run[2], l_run[2], corr[2];
  float sc[64];
  uint32_t pa[8][4];
  uint32_t q_tile;  // the work tile's Q slot

  auto issue_s = [&](int it) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<0, 0>(sc, kmajor(q_tile, 64 * wg, kk), kmajor(k_of(it), 0, kk), kk);
  };
  auto issue_pv = [&](int it) {
    const uint32_t v_tile = k_of(it) + L::TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
        hopper::wgmma_rs<1>(acc[bb], pa[kk], mnmajor(v_tile, bb, kk), 1);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int i = 0; i < NA / 2; ++i) acc[bb][i] *= corr[(i >> 1) & 1];
  };
  auto full_wait = [&](int it) {
    hopper::mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  auto release = [&](int it) {
    if (tid == 0) hopper::mbar_arrive(empty + 8 * (it % STAGES));
  };
  auto hold_pv = [&]() {
    hopper::hold(pa);
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) hopper::hold(acc[bb]);
  };
  // turns at the tensor cores: named barrier 1 + w lets warpgroup w issue
  auto turn_wait = [&]() { hopper::named_barrier(1 + wg, CONSUMERS); };
  auto turn_pass = [&]() { hopper::named_barrier_arrive(2 - wg, CONSUMERS); };

  if (wg == 1) turn_pass();  // warpgroup 0 goes first
  int it = 0, wi = 0;
  for (int w = blockIdx.x; w < p.n_work; w += gridDim.x, ++wi) {
    int m0, head, batch;
    decode(w, m0, head, batch);
    q_tile = base + L::Q_OFF + (wi & 1) * L::TILE;
#pragma unroll
    for (int bb = 0; bb < NB; ++bb)
#pragma unroll
      for (int i = 0; i < NA / 2; ++i) acc[bb][i] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;
    hopper::mbar_wait(q_full + 8 * (wi & 1), (wi >> 1) & 1);

    full_wait(it);
    turn_wait();
    hopper::wgmma_fence();
    issue_s(it);
    hopper::wgmma_commit();
    turn_pass();
    hopper::wgmma_wait<0>();
    hopper::hold(sc);
    softmax(sc, m_run, l_run, corr, scale_log2, 0, s, t);
    pack_p(sc, pa);
#pragma unroll 1
    for (int j = 1; j < n_tiles; ++j) {
      full_wait(it + j);
      turn_wait();
      hopper::wgmma_fence();
      issue_s(it + j);
      hopper::wgmma_commit();
      rescale();
      hopper::wgmma_fence();
      issue_pv(it + j - 1);
      hopper::wgmma_commit();
      turn_pass();
      hopper::wgmma_wait<1>();  // S of tile j
      hopper::hold(sc);
      softmax(sc, m_run, l_run, corr, scale_log2, j * BN, s, t);
      hopper::wgmma_wait<0>();  // P . V of tile j - 1
      hold_pv();
      release(it + j - 1);
      pack_p(sc, pa);
    }
    if (tid == 0) hopper::mbar_arrive(q_empty + 8 * (wi & 1));  // every S of the tile is done
    rescale();
    turn_wait();
    hopper::wgmma_fence();
    issue_pv(it + n_tiles - 1);
    hopper::wgmma_commit();
    turn_pass();
    hopper::wgmma_wait<0>();
    hold_pv();
    release(it + n_tiles - 1);
    it += n_tiles;

    // O = acc / l in the IO dtype, LSE = m + log l in f32; rows past s are
    // not written
    T* op = p.o + batch * p.o_st.b + head * p.o_st.h;
    float* lp = p.lse + (static_cast<int64_t>(batch) * p.h + head) * s;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]), inv = 1.f / l;
      const int row = m0 + 64 * wg + 16 * warp + lane / 4 + 8 * r;
      if (row >= s) continue;
#pragma unroll
      for (int bb = 0; bb < NB; ++bb)
#pragma unroll
        for (int j = 0; j < NA / 8; ++j)
          store2(op + row * p.o_st.s + bb * NA + 8 * j + 2 * t, acc[bb][4 * j + 2 * r] * inv,
                 acc[bb][4 * j + 2 * r + 1] * inv);
      if (t == 0) lp[row] = m_run[r] * LN2 + logf(l);
    }
  }
  if (wg == 0) turn_wait();  // warpgroup 1's last turn
}

// -- pre-pass for f32 IO: bf16 copies of q, k, v ------------------------------

struct StageArgs {
  const float *q, *k, *v;
  Axis q_st, k_st, v_st;
  bf16* staged;  // [3][b, s, h, d] contiguous
  int b, s, h;
};

// each thread rounds 8 elements of one row (b, s, h) of q, k and v
template <int D>
__global__ void __launch_bounds__(256) fwd_stage(const StageArgs a) {
  constexpr int C = D / 8;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t rows = static_cast<int64_t>(a.b) * a.s * a.h;
  if (idx >= rows * C) return;
  const int64_t row = idx / C;
  const int c = static_cast<int>(idx % C);
  const int64_t hi = row % a.h, si = (row / a.h) % a.s, bi = row / (static_cast<int64_t>(a.h) * a.s);
  const float* src[3] = {a.q + bi * a.q_st.b + si * a.q_st.s + hi * a.q_st.h,
                         a.k + bi * a.k_st.b + si * a.k_st.s + hi * a.k_st.h,
                         a.v + bi * a.v_st.b + si * a.v_st.s + hi * a.v_st.h};
#pragma unroll
  for (int x = 0; x < 3; ++x)
    *reinterpret_cast<uint4*>(a.staged + x * rows * D + row * D + 8 * c) = load8(src[x] + 8 * c);
}

// -- host ---------------------------------------------------------------------

struct Call {
  const void *q, *k, *v;
  void *o, *staged;
  float* lse;
  Axis q_st, k_st, v_st, o_st;
  int b, s, h;
  float scale;
  cudaStream_t stream;
};

constexpr int ERR_TENSOR_MAP = -2;

// the current device's SM count, looked up once per device
int sm_count(int* sms) {
  static int cached[64] = {};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= 64)
    return static_cast<int>(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  if (cached[dev] == 0) {
    err = static_cast<int>(
        cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev));
    if (err) return err;
  }
  *sms = cached[dev];
  return 0;
}

template <typename T, int D>
int launch_main(const Call& c, const bf16* q, const bf16* k, const bf16* v,
                const Axis (&st)[3]) {
  using L = Layout<D>;
  CUtensorMap maps[3];
  const bf16* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (hopper::encode_bshd(&maps[i], src[i], false, c.b, c.s, c.h, D, st[i].b, st[i].s,
                            st[i].h, L::NA, 128))
      return ERR_TENSOR_MAP;
  }
  const int64_t work = static_cast<int64_t>((c.s + BM - 1) / BM) * c.h * c.b;
  if (work > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Params<T> p{static_cast<T*>(c.o), c.o_st, c.lse, c.s, c.h, static_cast<int>(work),
                    c.scale};
  int sms = 0;
  int err = sm_count(&sms);
  if (!err) err = allow_smem(fwd_main<T, D>, L::BYTES);
  if (err) return err;
  const int blocks = work < sms ? static_cast<int>(work) : sms;
  fwd_main<T, D><<<blocks, BLOCK_THREADS, L::BYTES, c.stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run(const Call& c, bool is_bf16) {
  if (is_bf16) {
    const Axis st[3] = {c.q_st, c.k_st, c.v_st};
    return launch_main<bf16, D>(c, static_cast<const bf16*>(c.q), static_cast<const bf16*>(c.k),
                                static_cast<const bf16*>(c.v), st);
  }
  // f32 IO: bf16 copies first, then the same main kernel with O in f32
  const StageArgs a{static_cast<const float*>(c.q), static_cast<const float*>(c.k),
                    static_cast<const float*>(c.v), c.q_st, c.k_st, c.v_st,
                    static_cast<bf16*>(c.staged), c.b, c.s, c.h};
  const int64_t threads = static_cast<int64_t>(c.b) * c.s * c.h * (D / 8);
  fwd_stage<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, c.stream>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int64_t n = static_cast<int64_t>(c.b) * c.s * c.h * D;
  const bf16* staged = static_cast<const bf16*>(c.staged);
  const Axis dense{static_cast<int64_t>(c.s) * c.h * D, static_cast<int64_t>(c.h) * D, D};
  const Axis st[3] = {dense, dense, dense};
  return launch_main<float, D>(c, staged, staged + n, staged + 2 * n, st);
}

}  // namespace

// C entry, bound with ctypes by tasksrunner_torch/flash.py. strides holds the
// b, s, h element strides of q, k, v and o in order (12 values); lse [b, h, s]
// f32 is contiguous; staged [3, b, s, h, d] bf16 is scratch for f32 IO only
// (null for bf16 IO); scale > 0. Enqueues on ``stream``, for f32 IO, the
// pre-pass that writes bf16 copies of q, k, v into staged, then the main
// kernel. Returns 0, a CUDA error (cudaGetLastError after the launches), -1
// for a d the kernel was not built for, or -2 if a tensor map could not be
// encoded. It does not synchronise and allocates nothing.
extern "C" int tr_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            void* staged, int b, int s, int h, int d, int is_bf16,
                            const int64_t* strides, float scale, void* stream) {
  Axis ax[4];
  for (int i = 0; i < 4; ++i) ax[i] = Axis{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Call c{q,     k,     v,     o,     staged, static_cast<float*>(lse),
               ax[0], ax[1], ax[2], ax[3], b,      s,
               h,     scale, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return run<16>(c, is_bf16);
    case 32: return run<32>(c, is_bf16);
    case 64: return run<64>(c, is_bf16);
    case 128: return run<128>(c, is_bf16);
    default: return -1;
  }
}
