// Ring attention's block update for Hopper (sm_90a), hand-written CUDA C++
// with wgmma, TMA and mbarriers (csrc/hopper.cuh).
//
// Replaces the TPU kernel tasksrunner/ml/flash.py::_ring_block_kernel
// (flash.py:297, launched by ring_block_update). One step of ring attention
// folds the K/V block that is visiting this rank into the running softmax
// state of the rank's own queries:
//
//   S    = bf16(q) . bf16(k)^T accumulated in f32, times scale   [sq, sk]
//   m'   = max(m, rowmax S)
//   c    = exp(m - m')
//   P    = exp(S - m')                                  in f32
//   num' = num * c + bf16(P) . bf16(v)                  accumulated in f32
//   den' = den * c + sum P                              summed over the f32 P
//
// q is [b, sq, h, d], k and v [b, sk, h, d] (bf16 or f32, read through their
// strides; sq and sk may differ); m, den [b, h, sq] and num [b, h, sq, d] are
// contiguous f32. The outputs are written to new buffers, never in place.
// With sp > 1 the batch axis is the ring's fold, row bi * sp + r holding rank
// r's block, and the block visiting row bi * sp + r at ring step ``shift`` is
// K/V row bi * sp + (r - shift) mod sp: the kernel reads it there, in place of
// a rotated copy (a coordinate of the TMA box, not a copy).
//
// What bounds it on an H100: bytes. At the bench config split four ways
// (b 128 = 4 ranks x batch 32, sq = sk = 128, h 16, d 64, bf16) q, k and v
// are 50 MB, num read and written is 134 MB of the ~239 MB, m and den 4 MB:
// about 71 us at 3.35 TB/s, against 8.7 us for the 4*b*h*sq*sk*d operations
// at 989 TFLOP/s. The f32 state, not the attention, is most of the traffic,
// so the design is about keeping loads in flight, not the tensor cores busy.
//
// Design:
//   * one block of two warpgroups per (128-row Q tile, head, batch row), each
//     warpgroup owning 64 rows; two blocks an SM at d <= 64 (80 KB of shared
//     memory and at most 128 registers a thread at d 64), one at d 128;
//   * every load of the block is issued by TMA as it starts, each on its own
//     mbarrier: the Q tile, the first 128-key K and V chunks and the f32 num
//     rows (m and den by ordinary loads beside them). The state's latency
//     hides under the products, and num' goes back by TMA store from the
//     same shared-memory tile it arrived in;
//   * S = Q . K^T on wgmma (SS, m64n128k16, both K-major) and num' from
//     bf16(P) . V on wgmma (RS: P packed from the S accumulator; V read
//     MN-major from its TMA tile through wgmma's transpose bit, so V is never
//     transposed);
//   * one pass where the whole row fits, sk <= 128 (the bench shape sk 128
//     and the served shape sk 16): the [64 x 128] S block stays in registers,
//     rowmax over all of sk, then P against that final max, which is the
//     TPU kernel's order and the plain version's rounding point, with no
//     second Q . K^T. For sk > 128 a first pass takes the row max over every
//     chunk and a second recomputes S (the same products in the same order,
//     so the same S) and forms P: holding S for 256 keys would take 128
//     registers of S alone and halve the blocks an SM, and no path of the
//     port has sk > 128. An online rescale is not used: it rounds bf16(P)
//     against a running max, which is not what the reference does;
//   * the exp in base 2 with scale * log2 e folded into one fma (scale > 0:
//     the wrapper turns a negative scale into -k), on ex2.approx. On the
//     ring's first step m = -inf gives c = 2^-inf = 0, and m' is always
//     finite (every row has a key); keys past sk get P = 0 and are left out
//     of the max; rows past sq are neither read from the state nor written;
//   * S is written by ordinary instructions only after its product is waited
//     for, and P and the accumulator only while no product uses them: an
//     ordinary write to a register of a product in flight makes ptxas
//     serialise every wgmma of the kernel.
// f32 IO goes through a pre-pass in the same C call that writes bf16 copies
// of q, k and v into a scratch buffer the wrapper allocates. The result is
// the same bit for bit between runs. Its times on the card, its registers and
// spills are in PERF.md.

#include <cuda.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // query rows of a block: two warpgroups of 64
constexpr int BN = 128;  // keys of a K/V chunk
constexpr int THREADS = 256;

// the shared-memory layout of a block, offsets from a 1024-byte aligned base
template <int D>
struct Layout {
  static constexpr int NA = D < 64 ? D : 64;  // bf16 columns of a TMA box
  static constexpr int NB = D / NA;           // boxes across d
  static constexpr int SW = NA * 2;           // bytes of a box row, the swizzle span
  static constexpr int TILE = 128 * D * 2;    // the Q tile, a K or a V chunk (BM = BN = 128)
  static constexpr int NC = D < 32 ? D : 32;  // f32 columns of a num box
  static constexpr int NNB = D / NC;          // num boxes across d
  static constexpr int SWN = NC * 4;          // bytes of a num box row, its swizzle span
  static constexpr int NUM_BOX = 64 * SWN;    // one warpgroup's 64 rows of one num box
  static constexpr int NUM_WG = NNB * NUM_BOX;
  static constexpr int Q_OFF = 0, K_OFF = TILE, V_OFF = 2 * TILE, NUM_OFF = 3 * TILE;
  static constexpr int BAR_OFF = NUM_OFF + 2 * NUM_WG;  // q, k, v, num barriers
  static constexpr int BYTES = BAR_OFF + 8 * 4 + 1024;  // and room to align the base
  static constexpr int MIN_BLOCKS = D == 128 ? 1 : 2;   // blocks an SM
  static_assert(BYTES * MIN_BLOCKS <= 232448, "shared memory for the blocks of an SM");
};

struct Params {
  const float *m, *den;  // [b, h, sq]
  float *m_out, *den_out;
  int sq, sk, h, shift, sp;
  float scale;
};

// for a 128-key chunk at n0: element i of the S accumulator is row g + 8 * ((i >> 1) & 1)
// of the warp's 16, key n0 + 8 * (i / 4) + 2t + (i & 1); only a RAGGED chunk has keys
// past sk
template <bool RAGGED>
__device__ __forceinline__ bool live_key(int i, int n0, int sk, int t) {
  return !RAGGED || n0 + 8 * (i / 4) + 2 * t + (i & 1) < sk;
}

// the running row max of S (unscaled) over the chunk, eight partial maxima
template <bool RAGGED>
__device__ __forceinline__ void chunk_max(const float (&sc)[64], float (&mx)[2], int n0, int sk,
                                          int t) {
  float part[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[i] = live_key<RAGGED>(i, n0, sk, t) ? sc[i] : -INFINITY;
#pragma unroll
  for (int i = 8; i < 64; ++i)
    part[i % 8] = fmaxf(part[i % 8], live_key<RAGGED>(i, n0, sk, t) ? sc[i] : -INFINITY);
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mx[r] = fmaxf(mx[r], fmaxf(fmaxf(part[2 * r], part[2 * r + 1]),
                               fmaxf(part[2 * r + 4], part[2 * r + 5])));
}

// S replaced in place by P = 2^(S * scale * log2 e - m' * log2 e), keys past
// sk 0, and summed into l
template <bool RAGGED>
__device__ __forceinline__ void chunk_exp(float (&sc)[64], float (&l)[2],
                                          const float (&neg_m2)[2], float scale_log2, int n0,
                                          int sk, int t) {
  float rs[8];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = live_key<RAGGED>(i, n0, sk, t)
                ? fast_exp2(fmaf(sc[i], scale_log2, neg_m2[(i >> 1) & 1]))
                : 0.f;
    rs[i % 8] = i < 8 ? sc[i] : rs[i % 8] + sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] += (rs[2 * r] + rs[2 * r + 1]) + (rs[2 * r + 4] + rs[2 * r + 5]);
}

template <int D>
__global__ void __launch_bounds__(THREADS, Layout<D>::MIN_BLOCKS)
    ring_main(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_num,
              const __grid_constant__ CUtensorMap tm_num_out, const Params p) {
  using L = Layout<D>;
  constexpr int NA = L::NA, NB = L::NB, SW = L::SW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = hopper::smem_addr(smem);
  const uint32_t q_bar = base + L::BAR_OFF, k_bar = q_bar + 8, v_bar = q_bar + 16,
                 num_bar = q_bar + 24;

  const int m0 = blockIdx.x * BM, head = blockIdx.y, batch = blockIdx.z;
  const int sq = p.sq, sk = p.sk, n_chunks = (sk + BN - 1) / BN;
  // the visiting block: folded row bi * sp + r reads K/V of row bi * sp + (r - shift) mod sp
  const int rank = batch % p.sp;
  const int kv_batch = batch - rank + (rank - p.shift + p.sp) % p.sp;

  auto load_chunk = [&](uint32_t bar, uint32_t tile, const CUtensorMap* map, int n0) {
    hopper::mbar_arrive_expect_tx(bar, L::TILE);
    for (int bb = 0; bb < NB; ++bb)
      hopper::tma_load_4d(tile + bb * BN * SW, map, bar, bb * NA, head, n0, kv_batch);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) hopper::mbar_init(q_bar + 8 * i, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // every load of the block at once, each on its own barrier
    hopper::mbar_arrive_expect_tx(q_bar, L::TILE);
    for (int bb = 0; bb < NB; ++bb)
      hopper::tma_load_4d(base + L::Q_OFF + bb * BM * SW, &tm_q, q_bar, bb * NA, head, m0, batch);
    load_chunk(k_bar, base + L::K_OFF, &tm_k, 0);
    load_chunk(v_bar, base + L::V_OFF, &tm_v, 0);
    const int live_wgs = m0 + 64 < sq ? 2 : 1;  // a warpgroup wholly past sq loads no state
    hopper::mbar_arrive_expect_tx(num_bar, live_wgs * L::NUM_WG);
    for (int w = 0; w < live_wgs; ++w)
      for (int nb = 0; nb < L::NNB; ++nb)
        hopper::tma_load_4d(base + L::NUM_OFF + w * L::NUM_WG + nb * L::NUM_BOX, &tm_num,
                            num_bar, nb * L::NC, head, m0 + 64 * w, batch);
  }

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = p.scale * LOG2E;

  // this thread's two rows and their m and den, loaded now, under the products
  const int64_t state0 = (static_cast<int64_t>(batch) * p.h + head) * sq;
  int row[2];
  float m_old[2], den_old[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = m0 + 64 * wg + 16 * warp + g + 8 * r;
    const bool live = row[r] < sq;
    m_old[r] = live ? p.m[state0 + row[r]] : -INFINITY;
    den_old[r] = live ? p.den[state0 + row[r]] : 0.f;
  }

  // K-major operand: rows row0.. of a 128-row tile (Q or K), k16 step kk
  auto kmajor = [&](uint32_t tile, int row0, int kk) {
    const int col = kk * 16;
    return hopper::desc<SW>(tile + (col / NA) * 128 * SW + row0 * SW + (col % NA) * 2, 16,
                            8 * SW);
  };
  // MN-major B: keys 16kk.. of box bb of the V chunk
  auto mnmajor = [&](int bb, int kk) {
    return hopper::desc<SW>(base + L::V_OFF + bb * 128 * SW + kk * 16 * SW, 8 * SW, 8 * SW);
  };

  float sc[64];
  uint32_t pa[8][4];
  float acc[NB][NA / 2];
#pragma unroll
  for (int bb = 0; bb < NB; ++bb)
#pragma unroll
    for (int i = 0; i < NA / 2; ++i) acc[bb][i] = 0.f;

  // S = Q . K^T for this warpgroup's 64 rows and the K chunk in shared memory
  auto scores = [&]() {
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<0, 0>(sc, kmajor(base + L::Q_OFF, 64 * wg, kk),
                             kmajor(base + L::K_OFF, 0, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(sc);
  };
  auto row_max = [&](float (&mx)[2], int n0) {
    if (n0 + BN > sk)
      chunk_max<true>(sc, mx, n0, sk, t);
    else
      chunk_max<false>(sc, mx, n0, sk, t);
  };

  uint32_t k_phase = 0, v_phase = 0;
  hopper::mbar_wait(q_bar, 0);
  float mx[2] = {-INFINITY, -INFINITY};
  if (n_chunks > 1) {
    // first pass: the row max over every chunk; the second starts at chunk 0
    for (int c = 0; c < n_chunks; ++c) {
      hopper::mbar_wait(k_bar, k_phase);
      k_phase ^= 1;
      scores();
      row_max(mx, c * BN);
      __syncthreads();  // both warpgroups are done with this K chunk
      if (threadIdx.x == 0)
        load_chunk(k_bar, base + L::K_OFF, &tm_k, c + 1 < n_chunks ? (c + 1) * BN : 0);
    }
  }

  float m_new[2], corr[2], neg_m2[2], l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int n0 = c * BN;
    hopper::mbar_wait(k_bar, k_phase);
    k_phase ^= 1;
    scores();
    if (c == 0) {
      if (n_chunks == 1) row_max(mx, 0);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // max(rowmax S) * scale is rowmax(S * scale) exactly: scale > 0
        m_new[r] = fmaxf(m_old[r], quad_max(mx[r]) * p.scale);  // finite: every row has a key
        corr[r] = fast_exp2((m_old[r] - m_new[r]) * LOG2E);     // 0 on the ring's first step
        neg_m2[r] = -m_new[r] * LOG2E;
      }
    }
    if (n0 + BN > sk)
      chunk_exp<true>(sc, l, neg_m2, scale_log2, n0, sk, t);
    else
      chunk_exp<false>(sc, l, neg_m2, scale_log2, n0, sk, t);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);

    // P . V into the f32 accumulator
    hopper::mbar_wait(v_bar, v_phase);
    v_phase ^= 1;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int bb = 0; bb < NB; ++bb) hopper::wgmma_rs<1>(acc[bb], pa[kk], mnmajor(bb, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::hold(pa);
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) hopper::hold(acc[bb]);
    if (c + 1 < n_chunks) {
      __syncthreads();  // both warpgroups are done with this K/V chunk
      if (threadIdx.x == 0) {
        load_chunk(k_bar, base + L::K_OFF, &tm_k, n0 + BN);
        load_chunk(v_bar, base + L::V_OFF, &tm_v, n0 + BN);
      }
    }
  }

  // num' = num * c + P . V in the shared-memory tile num arrived in, then out by
  // TMA store, which leaves out the rows past sq; m' and den' from registers
  hopper::mbar_wait(num_bar, 0);
  unsigned char* num_s = smem + L::NUM_OFF + wg * L::NUM_WG;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = quad_sum(l[r]);
    const int rr = 16 * warp + g + 8 * r;  // the row within the warpgroup's 64
#pragma unroll
    for (int bb = 0; bb < NB; ++bb) {
#pragma unroll
      for (int j = 0; j < NA / 8; ++j) {
        const int col = bb * NA + 8 * j + 2 * t;
        const uint32_t off = (col / L::NC) * L::NUM_BOX +
                             hopper::swz<L::SWN>(rr * L::SWN + (col % L::NC) * 4);
        float2* x = reinterpret_cast<float2*>(num_s + off);
        const float2 old = *x;
        *x = make_float2(old.x * corr[r] + acc[bb][4 * j + 2 * r],
                         old.y * corr[r] + acc[bb][4 * j + 2 * r + 1]);
      }
    }
    if (t == 0 && row[r] < sq) {
      p.m_out[state0 + row[r]] = m_new[r];
      p.den_out[state0 + row[r]] = den_old[r] * corr[r] + lsum;
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + wg, 128);
  if (tid == 0 && m0 + 64 * wg < sq) {
    for (int nb = 0; nb < L::NNB; ++nb)
      hopper::tma_store_4d(&tm_num_out, hopper::smem_addr(num_s + nb * L::NUM_BOX), nb * L::NC,
                           head, m0 + 64 * wg, batch);
    hopper::bulk_commit();
    hopper::bulk_wait_read<0>();  // the tile stays until the store has read it
  }
}

// -- pre-pass for f32 IO: a dense bf16 copy of one [b, s, h, d] tensor --------

template <int D>
__global__ void __launch_bounds__(256)
    ring_stage(const float* src, Axis st, bf16* dst, int b, int s, int h) {
  constexpr int C = D / 8;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t rows = static_cast<int64_t>(b) * s * h;
  if (idx >= rows * C) return;
  const int64_t row = idx / C;
  const int c = static_cast<int>(idx % C);
  const int64_t hi = row % h, si = (row / h) % s, bi = row / (static_cast<int64_t>(h) * s);
  *reinterpret_cast<uint4*>(dst + row * D + 8 * c) =
      load8(src + bi * st.b + si * st.s + hi * st.h + 8 * c);
}

// -- host ---------------------------------------------------------------------

struct Call {
  const void *q, *k, *v;
  const float *m, *num, *den;
  float *m_out, *num_out, *den_out;
  bf16* staged;
  Axis q_st, k_st, v_st;
  int b, sq, sk, h, shift, sp;
  float scale;
  cudaStream_t stream;
};

constexpr int ERR_TENSOR_MAP = -2;

template <int D>
int launch_main(const Call& c, const bf16* q, const bf16* k, const bf16* v,
                const Axis (&st)[3]) {
  using L = Layout<D>;
  CUtensorMap maps[5];
  const bf16* src[3] = {q, k, v};
  const int rows[3] = {c.sq, c.sk, c.sk};
  for (int i = 0; i < 3; ++i) {
    if (hopper::encode_bshd(&maps[i], src[i], false, c.b, rows[i], c.h, D, st[i].b, st[i].s,
                            st[i].h, L::NA, 128))
      return ERR_TENSOR_MAP;
  }
  // num [b, h, sq, d], contiguous f32: a (d, h, s, b) map whose s stride is d
  const int64_t hd = static_cast<int64_t>(c.sq) * D;
  const float* nums[2] = {c.num, c.num_out};
  for (int i = 0; i < 2; ++i) {
    if (hopper::encode_bshd(&maps[3 + i], nums[i], true, c.b, c.sq, c.h, D, c.h * hd, D, hd,
                            L::NC, 64))
      return ERR_TENSOR_MAP;
  }
  const Params p{c.m, c.den, c.m_out, c.den_out, c.sq, c.sk, c.h, c.shift, c.sp, c.scale};
  const int err = allow_smem(ring_main<D>, L::BYTES);
  if (err) return err;
  const dim3 grid((c.sq + BM - 1) / BM, c.h, c.b);
  ring_main<D><<<grid, THREADS, L::BYTES, c.stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                      maps[4], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run(const Call& c, bool is_bf16) {
  if (is_bf16) {
    const Axis st[3] = {c.q_st, c.k_st, c.v_st};
    return launch_main<D>(c, static_cast<const bf16*>(c.q), static_cast<const bf16*>(c.k),
                          static_cast<const bf16*>(c.v), st);
  }
  // f32 IO: dense bf16 copies of q, k and v first, one after the other in staged
  const float* src[3] = {static_cast<const float*>(c.q), static_cast<const float*>(c.k),
                         static_cast<const float*>(c.v)};
  const Axis ax[3] = {c.q_st, c.k_st, c.v_st};
  const int rows[3] = {c.sq, c.sk, c.sk};
  const bf16* copies[3];
  Axis dense[3];
  bf16* dst = c.staged;
  for (int i = 0; i < 3; ++i) {
    const int64_t threads = static_cast<int64_t>(c.b) * rows[i] * c.h * (D / 8);
    ring_stage<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, c.stream>>>(
        src[i], ax[i], dst, c.b, rows[i], c.h);
    copies[i] = dst;
    dense[i] = Axis{static_cast<int64_t>(rows[i]) * c.h * D, static_cast<int64_t>(c.h) * D, D};
    dst += static_cast<int64_t>(c.b) * rows[i] * c.h * D;
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_main<D>(c, copies[0], copies[1], copies[2], dense);
}

}  // namespace

// C entry, bound with ctypes by tasksrunner_torch/flash.py. strides holds the
// nine element strides b, s, h of q, k, v in order; m, num, den and the
// outputs are contiguous f32; staged [b, sq + 2 sk, h, d] bf16 is scratch for
// f32 IO only (null for bf16 IO); scale > 0; 0 <= shift < sp, sp divides b
// (sp 1 and shift 0 read K/V at q's batch row). Enqueues on ``stream``, for
// f32 IO, the pre-pass that writes bf16 copies of q, k, v into staged, then the
// main kernel. Returns 0, a CUDA error (cudaGetLastError after the launches),
// -1 for a d the kernel was not built for, or -2 if a tensor map could not be
// encoded. It does not synchronise and allocates nothing.
extern "C" int tr_flash_ring(const void* q, const void* k, const void* v, const void* m,
                             const void* num, const void* den, void* m_out, void* num_out,
                             void* den_out, void* staged, int b, int sq, int sk, int h, int d,
                             int is_bf16, int shift, int sp, const int64_t* strides, float scale,
                             void* stream) {
  const Call c{q,
               k,
               v,
               static_cast<const float*>(m),
               static_cast<const float*>(num),
               static_cast<const float*>(den),
               static_cast<float*>(m_out),
               static_cast<float*>(num_out),
               static_cast<float*>(den_out),
               static_cast<bf16*>(staged),
               Axis{strides[0], strides[1], strides[2]},
               Axis{strides[3], strides[4], strides[5]},
               Axis{strides[6], strides[7], strides[8]},
               b,
               sq,
               sk,
               h,
               shift,
               sp,
               scale,
               static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 16: return run<16>(c, is_bf16);
    case 32: return run<32>(c, is_bf16);
    case 64: return run<64>(c, is_bf16);
    case 128: return run<128>(c, is_bf16);
    default: return -1;
  }
}
