// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel tasksrunner/ml/flash.py::_fwd_kernel (launched by
// _flash_fwd). It computes the same function: bidirectional attention with no
// mask over q/k/v [b, s, h, d],
//
//   S = bf16(q) . bf16(k)^T accumulated in f32, times scale
//   m = rowmax S,  p = exp(S - m) (unnormalised),  l = sum p
//   O = (bf16(p) . bf16(v)) / l   in the IO dtype
//   LSE = m + log l               in f32, [b, h, s]
//
// What bounds it on an H100: at the bench shapes b32 h16 s512 d64 the two
// products are 4*b*h*s*s*d = 34.4 GFLOP (about 35 us at 989 TFLOP/s bf16)
// and q/k/v/o in bf16 are 134 MB (about 40 us at 3.35 TB/s), so the bound is
// about 40 us and the kernel is close to memory-bound. At the served shape
// (b <= 32, s 32, h 4, d 32) the work is a few microseconds of launch.
//
// Design. The TPU kernel holds a head's whole [S, S] f32 score tile in VMEM
// and folds several heads into one program; neither carries over to a block
// with at most 227 KB of shared memory. Here:
//   * one block of 4 warps per (64-row Q tile, head, batch); each warp owns
//     16 query rows, so softmax statistics never leave a warp;
//   * K/V stream through shared memory in 64-key tiles with an online softmax
//     (running max m, running sum l, f32 accumulator rescaled by exp(m - m'));
//   * both products are mma.sync m16n8k16 bf16 with f32 accumulation; the
//     S accumulator is reused in registers as the A operand of P.V, with p
//     rounded to bf16 before that product as the TPU kernel does;
//   * q/k/v/o are read and written in place through their [b, s, h, d]
//     strides (no transposes); f32 inputs are rounded to bf16 on load;
//   * rows and keys past s (the ragged last tile) are zero-filled on load,
//     keys are masked to -inf before the max, rows are not written;
//   * V is stored transposed in shared memory so the B operand of P.V is two
//     adjacent bf16 values; rows are padded by 8 bf16 so the fragment reads
//     hit 32 distinct banks.
// wgmma, TMA and a load pipeline are later work: this version is simple and
// right first. Its times on the card are in PERF.md.
//
// Numerics against the single-tile TPU kernel: p is rounded to bf16 relative
// to the running max of the tiles seen so far rather than the final max, so
// the two differ at the level of one bf16 rounding of p (relative 2^-8).

#include "flash_common.cuh"

namespace {

constexpr int BLOCK_M = TILE;  // query rows per block
constexpr int BLOCK_N = TILE;  // keys per streamed K/V tile

struct Strides {
  Axis q, k, v, o;
};

template <int D>
struct Tiles {
  static constexpr int ROW = Rows<D>::ROW;        // Q and K tiles: [row][d]
  static constexpr int VT_ROW = Rows<D>::T_ROW;   // V tile transposed: [d][key]
  static constexpr int BYTES =
      (BLOCK_M * ROW + BLOCK_N * ROW + D * VT_ROW) * (int)sizeof(__nv_bfloat16);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int h, Strides st, float scale) {
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

  load_tile<T, D>(q_tile, qp, st.q.s, m0, s);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide slice of d
  uint32_t qf[D / 16][4];
  {
    const __nv_bfloat16* row = q_tile + (warp * 16 + g) * Tiles<D>::ROW + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) a_frag<Tiles<D>::ROW>(qf[kk], row, kk);
  }

  // rows g and g + 8 of the warp's slice: running max, this thread's share of
  // the running sum, and the f32 output accumulator (columns 8j + 2t, +1)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int n0 = 0; n0 < s; n0 += BLOCK_N) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(k_tile, kp, st.k.s, n0, s);
    load_tile_t<T, D>(vt_tile, vp, st.v.s, n0, s);
    __syncthreads();

    // S = q . k^T for 16 rows x 64 keys: eight n-tiles of 8 keys
    float sc[BLOCK_N / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* krow = k_tile + (8 * j + g) * Tiles<D>::ROW + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(sc[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // scale, mask the keys past s, and fold the tile into the running max
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n0 + 8 * j + 2 * t + (e & 1);
        sc[j][e] = key < s ? sc[j][e] * scale : -INFINITY;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], sc[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = quad_max(m_new[r]);
      corr[r] = exp2f((m_run[r] - m_new[r]) * LOG2E);  // 0 on the first tile
      m_run[r] = m_new[r];
    }

    // p = exp(S - m), summed in f32 and packed to bf16 as the A operand of
    // P.V: k-slice kk takes n-tiles 2kk (registers 0, 1) and 2kk + 1 (2, 3)
    uint32_t pf[BLOCK_N / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      const float p0 = exp2f((sc[j][0] - m_run[0]) * LOG2E);
      const float p1 = exp2f((sc[j][1] - m_run[0]) * LOG2E);
      const float p2 = exp2f((sc[j][2] - m_run[1]) * LOG2E);
      const float p3 = exp2f((sc[j][3] - m_run[1]) * LOG2E);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += p . v
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

  // O = acc / l in the IO dtype, LSE = m + log l in f32
  T* op = o + batch * st.o.b + head * st.o.h;
  float* lp = lse + ((int64_t)batch * h + head) * s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(op + row * st.o.s + 8 * j + 2 * t, acc[j][2 * r] / l, acc[j][2 * r + 1] / l);
    if (t == 0) lp[row] = m_run[r] + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int s, int h, const Strides& st, float scale, cudaStream_t stream) {
  constexpr int bytes = Tiles<D>::BYTES;
  const int err = allow_smem(flash_fwd_kernel<T, D>, bytes);
  if (err) return err;
  const dim3 grid((s + BLOCK_M - 1) / BLOCK_M, h, b);
  flash_fwd_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, h, st, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o, void* lse,
             int b, int s, int h, const Strides& st, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, s, h, st, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, s, h, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, s, h, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, s, h, st, scale, stream);
    default: return -1;
  }
}

}  // namespace

// C entry, bound with ctypes by tasksrunner_torch/flash.py. strides holds the
// twelve element strides of Strides in order. Returns cudaGetLastError() after
// the launch (0 on success), or -1 for a d the kernel was not built for. It
// does not synchronise and allocates nothing.
extern "C" int tr_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            void* lse, int b, int s, int h, int d, int is_bf16,
                            const int64_t* strides, float scale, void* stream) {
  const Strides st{{strides[0], strides[1], strides[2]},
                   {strides[3], strides[4], strides[5]},
                   {strides[6], strides[7], strides[8]},
                   {strides[9], strides[10], strides[11]}};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, o, lse, b, s, h, st, scale, cs)
                 : dispatch<float>(d, q, k, v, o, lse, b, s, h, st, scale, cs);
}
