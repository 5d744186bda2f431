// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels of tasksrunner/ml/flash.py launched by
// _flash_bwd_call: _bwd_kernel_delta (the default, Δ precomputed outside the
// kernel) and _bwd_kernel (TASKSRUNNER_FLASH_BWD_DELTA=fused, Δ computed in the
// kernel from O). The variant is the template parameter FUSED. Both compute,
// over q/k/v/dO [b, s, h, d] and the forward's LSE [b, h, s], with the TPU
// kernel's bf16 rounding points:
//
//   P  = exp(bf16(q) . bf16(k)^T * scale - LSE)      f32
//   dV = bf16(P)^T . bf16(dO)
//   dP = bf16(dO) . bf16(v)^T
//   Δ  = sum_d f32(dO) * f32(O)                        per row, f32
//   dS = P * (dP - Δ) * scale
//   dQ = bf16(dS) . bf16(k),  dK = bf16(dS)^T . bf16(q)
//
// with dQ, dK, dV stored in the IO dtype.
//
// What bounds it on an H100: the five products are 10*b*h*s*s*d operations,
// 85.9 GFLOP at the bench shape b32 h16 s512 d64 (86.8 us at 989 TFLOP/s
// bf16), against about 237 MB moved (70.7 us at 3.35 TB/s; 270 MB with O for
// the fused variant), so the bound is set by operations. At the served shape
// (s 32, d 32) it is far below one launch.
//
// Design. The TPU kernel holds a head's whole [S, S] score tile in VMEM and
// computes every gradient in one program; a block here has at most 227 KB of
// shared memory and blocks run in no order, so the FA2 arrangement is used,
// as two kernels launched one after the other by one call of the C entry:
//   * dK/dV: one block of 4 warps per (64-key tile, head, batch). K and V stay
//     in shared memory; Q and dO stream through in 64-row tiles; each warp
//     recomputes P^T for its 16 keys from the saved LSE and accumulates dK and
//     dV in registers, written once at the end.
//   * dQ: one block per (64-row Q tile, head, batch), streaming K/V tiles and
//     recomputing S and dP (two products more than the TPU kernel does), with
//     dQ accumulated in registers. This keeps the sum over keys in one order:
//     the result is deterministic, where f32 atomics into a scratch buffer
//     would change their sum order from run to run.
//   * every product is mma.sync m16n8k16 bf16 with f32 accumulation; a
//     product's f32 result is packed to bf16 in registers as the A operand of
//     the next (P^T for dV, dS^T for dK, dS for dQ); the B operands that
//     contract over rows (dO and Q for dV and dK, K for dQ) are stored
//     transposed in shared memory;
//   * tensors are read and written through their [b, s, h, d] strides, f32
//     inputs rounded to bf16 on load; Δ is read in the IO dtype in f32;
//   * keys and rows past s (the ragged last tile) are zero-filled on load and
//     their P is set to 0 before anything uses it, so dS is 0 there and no
//     exp of a missing LSE is taken; such rows are never written;
//   * at d 64 and 128 the tiles exceed 48 KB and are dynamic shared memory
//     after cudaFuncSetAttribute.
// wgmma, TMA and a load pipeline are later work: this version is simple and
// right first. Its times on the card are in PERF.md.

#include "flash_common.cuh"

namespace {

struct Strides {
  Axis q, k, v, o, g, dq, dk, dv;  // g is dO
};

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *g;  // o is read by the fused variant only
  const float* lse;            // [b, h, s]
  const float* delta;          // [b, h, s], read by the precompute variant only
  T *dq, *dk, *dv;
  int s, h;
  float scale;
  Strides st;
};

template <int D>
struct DkdvTiles {  // K, V, Q, dO tiles; Q and dO transposed; LSE and Δ rows
  static constexpr int BYTES =
      (4 * TILE * Rows<D>::ROW + 2 * D * Rows<D>::T_ROW) * (int)sizeof(__nv_bfloat16) +
      2 * TILE * (int)sizeof(float);
};

template <int D>
struct DqTiles {  // Q, dO, K, V tiles; K transposed; LSE and Δ rows
  static constexpr int BYTES =
      (4 * TILE * Rows<D>::ROW + D * Rows<D>::T_ROW) * (int)sizeof(__nv_bfloat16) +
      2 * TILE * (int)sizeof(float);
};

// LSE and Δ of rows [row0, row0 + 64) into lse_s[64] and delta_s[64], 0 past
// s. The fused variant sums dO * O in f32 over the IO dtype's values, two
// threads per row; the precompute variant reads Δ.
template <typename T, int D, bool FUSED>
__device__ __forceinline__ void row_stats(float* lse_s, float* delta_s, const Args<T>& a,
                                          int batch, int head, int row0) {
  const int64_t bh = ((int64_t)batch * a.h + head) * a.s;
  if (threadIdx.x < TILE) {
    const int row = row0 + threadIdx.x;
    lse_s[threadIdx.x] = row < a.s ? a.lse[bh + row] : 0.f;
    if (!FUSED) delta_s[threadIdx.x] = row < a.s ? a.delta[bh + row] : 0.f;
  }
  if (FUSED) {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int row = row0 + r;
    float acc = 0.f;
    if (row < a.s) {
      const T* op = a.o + batch * a.st.o.b + head * a.st.o.h + row * a.st.o.s + half * (D / 2);
      const T* gp = a.g + batch * a.st.g.b + head * a.st.g.h + row * a.st.g.s + half * (D / 2);
#pragma unroll 8
      for (int i = 0; i < D / 2; ++i) acc += to_f32(gp[i]) * to_f32(op[i]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) delta_s[r] = acc;
  }
}

// acc[j] (16 rows x 64 columns, eight n-tiles of 8) = A . B^T, with A the
// warp's 16 rows of a [row][d] tile and B the 64 rows of another
template <int D>
__device__ __forceinline__ void rows_times_rows(float acc[TILE / 8][4],
                                                const __nv_bfloat16* a_rows,
                                                const __nv_bfloat16* b_tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    a_frag<Rows<D>::ROW>(af, a_rows, kk);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const __nv_bfloat16* b = b_tile + (8 * j + g) * Rows<D>::ROW + 2 * t + kk * 16;
      mma_bf16(acc[j], af, ld32(b), ld32(b + 8));
    }
  }
}

// out[jd] (16 x D) += P . B, with P the packed 16 x 64 A fragments and B a
// 64 x D operand stored transposed as a [d][row] tile
template <int D>
__device__ __forceinline__ void packed_times_t(float out[D / 8][4], const uint32_t pf[TILE / 16][4],
                                               const __nv_bfloat16* bt_tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const __nv_bfloat16* b = bt_tile + (8 * jd + g) * Rows<D>::T_ROW + kk * 16 + 2 * t;
      mma_bf16(out[jd], pf[kk], ld32(b), ld32(b + 8));
    }
  }
}

// 16 x 64 f32 accumulator tiles to bf16 A fragments: k-slice kk takes n-tiles
// 2kk (registers 0, 1) and 2kk + 1 (2, 3)
__device__ __forceinline__ void pack_a(uint32_t pf[TILE / 16][4], const float x[TILE / 8][4]) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    pf[j / 2][(j & 1) * 2] = pack_bf16(x[j][0], x[j][1]);
    pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(const Args<T> a) {
  using R = Rows<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* v_tile = k_tile + TILE * R::ROW;
  __nv_bfloat16* q_tile = v_tile + TILE * R::ROW;
  __nv_bfloat16* g_tile = q_tile + TILE * R::ROW;
  __nv_bfloat16* qt_tile = g_tile + TILE * R::ROW;   // [d][row]
  __nv_bfloat16* gt_tile = qt_tile + D * R::T_ROW;  // [d][row]
  float* lse_s = reinterpret_cast<float*>(gt_tile + D * R::T_ROW);
  float* delta_s = lse_s + TILE;

  const int n0 = blockIdx.x * TILE;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const Strides& st = a.st;
  const T* qp = a.q + batch * st.q.b + head * st.q.h;
  const T* kp = a.k + batch * st.k.b + head * st.k.h;
  const T* vp = a.v + batch * st.v.b + head * st.v.h;
  const T* gp = a.g + batch * st.g.b + head * st.g.h;

  load_tile<T, D>(k_tile, kp, st.k.s, n0, s);
  load_tile<T, D>(v_tile, vp, st.v.s, n0, s);

  // this warp's keys: local rows 16 * warp + g and + 8
  const __nv_bfloat16* k_rows = k_tile + (warp * 16 + g) * R::ROW + 2 * t;
  const __nv_bfloat16* v_rows = v_tile + (warp * 16 + g) * R::ROW + 2 * t;
  const int key0 = n0 + warp * 16 + g;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int m0 = 0; m0 < s; m0 += TILE) {
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<T, D>(q_tile, qp, st.q.s, m0, s);
    load_tile<T, D>(g_tile, gp, st.g.s, m0, s);
    load_tile_t<T, D>(qt_tile, qp, st.q.s, m0, s);
    load_tile_t<T, D>(gt_tile, gp, st.g.s, m0, s);
    row_stats<T, D, FUSED>(lse_s, delta_s, a, batch, head, m0);
    __syncthreads();

    // P^T = exp(K . Q^T * scale - LSE) for 16 keys x 64 rows; 0 past s
    float p[TILE / 8][4];
    rows_times_rows<D>(p, k_rows, q_tile, g, t);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const bool live = key0 + 8 * (e >> 1) < s && m0 + col < s;
        p[j][e] = live ? exp2f((p[j][e] * a.scale - lse_s[col]) * LOG2E) : 0.f;
      }
    }

    // dV += bf16(P^T) . dO
    uint32_t pf[TILE / 16][4];
    pack_a(pf, p);
    packed_times_t<D>(dv, pf, gt_tile, g, t);

    // dS^T = P^T * (V . dO^T - Δ) * scale
    float ds[TILE / 8][4];
    rows_times_rows<D>(ds, v_rows, g_tile, g, t);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - delta_s[8 * j + 2 * t + (e & 1)]) * a.scale;
    }

    // dK += bf16(dS^T) . Q
    pack_a(pf, ds);
    packed_times_t<D>(dk, pf, qt_tile, g, t);
  }

  T* dkp = a.dk + batch * st.dk.b + head * st.dk.h;
  T* dvp = a.dv + batch * st.dv.b + head * st.dv.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= s) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dkp + key * st.dk.s + 8 * j + 2 * t, dk[j][2 * r], dk[j][2 * r + 1]);
      store2(dvp + key * st.dv.s + 8 * j + 2 * t, dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <typename T, int D, bool FUSED>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Args<T> a) {
  using R = Rows<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_tile = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* g_tile = q_tile + TILE * R::ROW;
  __nv_bfloat16* k_tile = g_tile + TILE * R::ROW;
  __nv_bfloat16* v_tile = k_tile + TILE * R::ROW;
  __nv_bfloat16* kt_tile = v_tile + TILE * R::ROW;  // [d][key]
  float* lse_s = reinterpret_cast<float*>(kt_tile + D * R::T_ROW);
  float* delta_s = lse_s + TILE;

  const int m0 = blockIdx.x * TILE;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int s = a.s;
  const Strides& st = a.st;
  const T* kp = a.k + batch * st.k.b + head * st.k.h;
  const T* vp = a.v + batch * st.v.b + head * st.v.h;

  load_tile<T, D>(q_tile, a.q + batch * st.q.b + head * st.q.h, st.q.s, m0, s);
  load_tile<T, D>(g_tile, a.g + batch * st.g.b + head * st.g.h, st.g.s, m0, s);
  row_stats<T, D, FUSED>(lse_s, delta_s, a, batch, head, m0);
  __syncthreads();

  // this warp's rows: local rows 16 * warp + g and + 8
  const int lrow = warp * 16 + g;
  const __nv_bfloat16* q_rows = q_tile + lrow * R::ROW + 2 * t;
  const __nv_bfloat16* g_rows = g_tile + lrow * R::ROW + 2 * t;
  const bool live_row[2] = {m0 + lrow < s, m0 + lrow + 8 < s};
  const float lse_r[2] = {lse_s[lrow], lse_s[lrow + 8]};
  const float delta_r[2] = {delta_s[lrow], delta_s[lrow + 8]};

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int n0 = 0; n0 < s; n0 += TILE) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D>(k_tile, kp, st.k.s, n0, s);
    load_tile<T, D>(v_tile, vp, st.v.s, n0, s);
    load_tile_t<T, D>(kt_tile, kp, st.k.s, n0, s);
    __syncthreads();

    // P = exp(Q . K^T * scale - LSE) for 16 rows x 64 keys; 0 past s
    float p[TILE / 8][4];
    rows_times_rows<D>(p, q_rows, k_tile, g, t);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = live_row[e >> 1] && n0 + 8 * j + 2 * t + (e & 1) < s;
        p[j][e] = live ? exp2f((p[j][e] * a.scale - lse_r[e >> 1]) * LOG2E) : 0.f;
      }
    }

    // dS = P * (dO . V^T - Δ) * scale
    float ds[TILE / 8][4];
    rows_times_rows<D>(ds, g_rows, v_tile, g, t);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] - delta_r[e >> 1]) * a.scale;
    }

    // dQ += bf16(dS) . K
    uint32_t pf[TILE / 16][4];
    pack_a(pf, ds);
    packed_times_t<D>(dq, pf, kt_tile, g, t);
  }

  T* dqp = a.dq + batch * st.dq.b + head * st.dq.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live_row[r]) continue;
    const int row = m0 + lrow + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dqp + row * st.dq.s + 8 * j + 2 * t, dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

template <typename T, int D, bool FUSED>
int launch(const Args<T>& a, int b, cudaStream_t stream) {
  const dim3 grid((a.s + TILE - 1) / TILE, a.h, b);
  constexpr int dkdv_bytes = DkdvTiles<D>::BYTES, dq_bytes = DqTiles<D>::BYTES;
  int err = allow_smem(flash_bwd_dkdv_kernel<T, D, FUSED>, dkdv_bytes);
  if (err) return err;
  flash_bwd_dkdv_kernel<T, D, FUSED><<<grid, THREADS, dkdv_bytes, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = allow_smem(flash_bwd_dq_kernel<T, D, FUSED>, dq_bytes);
  if (err) return err;
  flash_bwd_dq_kernel<T, D, FUSED><<<grid, THREADS, dq_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool FUSED>
int dispatch(int d, const Args<T>& a, int b, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, FUSED>(a, b, stream);
    case 32: return launch<T, 32, FUSED>(a, b, stream);
    case 64: return launch<T, 64, FUSED>(a, b, stream);
    case 128: return launch<T, 128, FUSED>(a, b, stream);
    default: return -1;
  }
}

template <typename T>
int run(const void* q, const void* k, const void* v, const void* o, const void* g,
        const void* lse, const void* delta, void* dq, void* dk, void* dv, int b, int s,
        int h, int d, int fused, const Strides& st, float scale, cudaStream_t stream) {
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(o),
                  static_cast<const T*>(g), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq),
                  static_cast<T*>(dk), static_cast<T*>(dv), s, h, scale, st};
  return fused ? dispatch<T, true>(d, a, b, stream) : dispatch<T, false>(d, a, b, stream);
}

}  // namespace

// C entry, bound with ctypes by tasksrunner_torch/flash.py. strides holds the
// b, s, h element strides of q, k, v, o, dO, dQ, dK, dV in order (24 values).
// o is read only when fused is set and delta only when it is not (either may
// be null otherwise). Enqueues the dK/dV kernel and then the dQ kernel on
// ``stream``; returns cudaGetLastError() after them (0 on success), or -1 for
// a d the kernels were not built for. It does not synchronise and allocates
// nothing.
extern "C" int tr_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* g, const void* lse, const void* delta, void* dq,
                            void* dk, void* dv, int b, int s, int h, int d, int is_bf16,
                            int fused, const int64_t* strides, float scale, void* stream) {
  Axis ax[8];
  for (int i = 0; i < 8; ++i) ax[i] = Axis{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Strides st{ax[0], ax[1], ax[2], ax[3], ax[4], ax[5], ax[6], ax[7]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(q, k, v, o, g, lse, delta, dq, dk, dv, b, s, h, d,
                                      fused, st, scale, cs)
                 : run<float>(q, k, v, o, g, lse, delta, dq, dk, dv, b, s, h, d, fused, st,
                              scale, cs);
}
