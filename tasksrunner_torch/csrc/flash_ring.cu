// Ring attention's block update for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel tasksrunner/ml/flash.py::_ring_block_kernel
// (launched by ring_block_update). One step of ring attention folds the K/V
// block that is visiting this rank into the running softmax state of the
// rank's own queries:
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
// contiguous f32. The outputs are written to new buffers, never in place: the
// ring's backward recomputes the step from its inputs.
//
// What bounds it on an H100: bytes. At the bench config split four ways
// (b 128 = 4 ranks x batch 32, sq = sk = 128, h 16, d 64, bf16) q, k and v
// are 50 MB, num read and written is 134 MB of the ~239 MB, m and den 4 MB:
// about 71 us at 3.35 TB/s, against 8.7 us for the 4*b*h*sq*sk*d operations
// at 989 TFLOP/s. The f32 state, not the attention, is most of the traffic.
//
// Design. The TPU kernel holds a few heads' whole [Sq, Sk] score tiles in
// VMEM. Here, as in flash_fwd.cu:
//   * one block of 4 warps per (64-row q tile, head, batch row); each warp
//     owns 16 query rows, so the row statistics never leave a warp;
//   * two passes over 64-key tiles of K. Pass 1 computes S with mma.sync
//     m16n8k16 bf16 and keeps only its row max, which gives m'. Pass 2
//     streams K and V, computes S again (the same products in the same order,
//     so the same S), forms P = exp(S - m') against the final max, sums it in
//     f32 and feeds bf16(P) from registers into the P.V product. Rounding P
//     against the final max is what the TPU kernel and the plain version do;
//     a single online pass would round against a running max and agree only
//     to one bf16 rounding of P per term. The second QK^T costs operations,
//     which the kernel has to spare;
//   * num, m and den are read once, in the epilogue, in the mma fragment
//     layout (each quad of threads reads 32 contiguous bytes of a row), and
//     the new state is written once from there: the state makes exactly one
//     round trip through memory, which is the bound;
//   * on the ring's first step m is -inf and num, den are 0: c = exp(-inf) is
//     0, and m' is always finite (every row has at least one key), so
//     (-inf) - (-inf) is never formed;
//   * keys past sk are zero-filled on load, left out of the max and given
//     P = 0 explicitly; rows past sq are neither read from the state nor
//     written;
//   * V is stored transposed in shared memory, rows padded by 8 bf16, as in
//     flash_fwd.cu. Above 48 KB of shared memory (d 128) the launch asks for
//     it first.
// A load pipeline and wgmma are later work. Its times on the card are in
// PERF.md.

#include "flash_common.cuh"

namespace {

constexpr int BLOCK_M = TILE;  // query rows per block
constexpr int BLOCK_N = TILE;  // keys per streamed K/V tile

struct Strides {
  Axis q, k, v;
};

template <int D>
struct Tiles {
  static constexpr int ROW = Rows<D>::ROW;        // Q and K tiles: [row][d]
  static constexpr int VT_ROW = Rows<D>::T_ROW;   // V tile transposed: [d][key]
  static constexpr int BYTES =
      (BLOCK_M * ROW + BLOCK_N * ROW + D * VT_ROW) * (int)sizeof(__nv_bfloat16);
};

// S = q . k^T * scale for the warp's 16 rows against one 64-key tile: eight
// n-tiles of 8 keys; element e of n-tile j is row g + 8 (e >> 1), key
// n0 + 8 j + 2 t + (e & 1)
template <int D>
__device__ __forceinline__ void scores(float sc[BLOCK_N / 8][4], const uint32_t qf[D / 16][4],
                                       const __nv_bfloat16* k_tile, float scale, int g,
                                       int t) {
#pragma unroll
  for (int j = 0; j < BLOCK_N / 8; ++j) {
    sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    const __nv_bfloat16* krow = k_tile + (8 * j + g) * Tiles<D>::ROW + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_bf16(sc[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] *= scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_ring_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ m,
                  const float* __restrict__ num, const float* __restrict__ den,
                  float* __restrict__ m_out, float* __restrict__ num_out,
                  float* __restrict__ den_out, int sq, int sk, int h, Strides st,
                  float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_tile = q_tile + BLOCK_M * Tiles<D>::ROW;
  __nv_bfloat16* vt_tile = k_tile + BLOCK_N * Tiles<D>::ROW;

  const int m0 = blockIdx.x * BLOCK_M;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair

  const T* qp = q + batch * st.q.b + head * st.q.h;
  const T* kp = k + batch * st.k.b + head * st.k.h;
  const T* vp = v + batch * st.v.b + head * st.v.h;

  load_tile<T, D>(q_tile, qp, st.q.s, m0, sq);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide slice of d
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* row = q_tile + (warp * 16 + g) * Tiles<D>::ROW + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) a_frag<Tiles<D>::ROW>(qf[kk], row, kk);
  }

  // pass 1: the row max of S over every key of the block
  float mx[2] = {-INFINITY, -INFINITY};
  for (int n0 = 0; n0 < sk; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K tile
    load_tile<T, D>(k_tile, kp, st.k.s, n0, sk);
    __syncthreads();
    float sc[BLOCK_N / 8][4];
    scores<D>(sc, qf, k_tile, scale, g, t);
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + 8 * j + 2 * t + (e & 1) < sk) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
  }

  // m' = max(m, rowmax S) and c = exp(m - m') for rows g and g + 8 of the
  // warp's slice; rows past sq read no state (their m is taken as -inf)
  const int64_t state0 = ((int64_t)batch * h + head) * sq;  // row 0 in m and den
  int row[2];
  float m_new[2], corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = m0 + warp * 16 + g + 8 * r;
    const float m_old = row[r] < sq ? m[state0 + row[r]] : -INFINITY;
    m_new[r] = fmaxf(m_old, quad_max(mx[r]));  // finite: every row has a key
    corr[r] = expf(m_old - m_new[r]);           // 0 on the ring's first step
  }

  // pass 2: P = exp(S - m') in f32, its row sum, and P.V in f32 registers
  float psum[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n0 = 0; n0 < sk; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(k_tile, kp, st.k.s, n0, sk);
    load_tile_t<T, D>(vt_tile, vp, st.v.s, n0, sk);
    __syncthreads();
    float sc[BLOCK_N / 8][4];
    scores<D>(sc, qf, k_tile, scale, g, t);

    // k-slice kk of the P.V product takes n-tiles 2kk (registers 0, 1) and
    // 2kk + 1 (registers 2, 3)
    uint32_t pf[BLOCK_N / 16][4];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = n0 + 8 * j + 2 * t + (e & 1) < sk ? expf(sc[j][e] - m_new[e >> 1]) : 0.f;
      psum[0] += p[0] + p[1];
      psum[1] += p[2] + p[3];
      pf[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vrow =
            vt_tile + (8 * j + g) * Tiles<D>::VT_ROW + kk * 16 + 2 * t;
        mma_bf16(acc[j], pf[kk], ld32(vrow), ld32(vrow + 8));
      }
    }
  }

  // epilogue: the state read once and the new state written once, in the
  // fragment layout (columns 8j + 2t, 8j + 2t + 1 of rows g and g + 8)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(psum[r]);
    if (row[r] >= sq) continue;
    const int64_t at = state0 + row[r];
    const float* src = num + at * D + 2 * t;
    float* dst = num_out + at * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 old = *reinterpret_cast<const float2*>(src + 8 * j);
      store2(dst + 8 * j, old.x * corr[r] + acc[j][2 * r], old.y * corr[r] + acc[j][2 * r + 1]);
    }
    if (t == 0) {
      m_out[at] = m_new[r];
      den_out[at] = den[at] * corr[r] + l;
    }
  }
}

struct Args {
  const void *q, *k, *v, *m, *num, *den;
  void *m_out, *num_out, *den_out;
  int b, sq, sk, h;
  Strides st;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch(const Args& a) {
  constexpr int bytes = Tiles<D>::BYTES;
  const int err = allow_smem(flash_ring_kernel<T, D>, bytes);
  if (err) return err;
  const dim3 grid((a.sq + BLOCK_M - 1) / BLOCK_M, a.h, a.b);
  flash_ring_kernel<T, D><<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.m), static_cast<const float*>(a.num),
      static_cast<const float*>(a.den), static_cast<float*>(a.m_out),
      static_cast<float*>(a.num_out), static_cast<float*>(a.den_out), a.sq, a.sk, a.h,
      a.st, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const Args& a) {
  switch (d) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return -1;
  }
}

}  // namespace

// C entry, bound with ctypes by tasksrunner_torch/flash.py. strides holds the
// nine element strides of Strides in order (b, s, h of q, k, v). Returns
// cudaGetLastError() after the launch (0 on success), or -1 for a d the kernel
// was not built for. It does not synchronise and allocates nothing.
extern "C" int tr_flash_ring(const void* q, const void* k, const void* v, const void* m,
                             const void* num, const void* den, void* m_out, void* num_out,
                             void* den_out, int b, int sq, int sk, int h, int d, int is_bf16,
                             const int64_t* strides, float scale, void* stream) {
  const Args a{q, k, v, m, num, den, m_out, num_out, den_out, b, sq, sk, h,
               Strides{{strides[0], strides[1], strides[2]},
                       {strides[3], strides[4], strides[5]},
                       {strides[6], strides[7], strides[8]}},
               scale, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16>(d, a) : dispatch<float>(d, a);
}
