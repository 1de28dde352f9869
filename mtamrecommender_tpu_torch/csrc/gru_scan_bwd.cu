// Whole-sequence (time-aware) GRU scan, backward.
//
// Replaces: mtamrecommender_tpu/ops/pallas/gru_kernel.py,
// _gru_scan_bwd_kernel (launched by gru_scan_bwd, the backward of
// gru_scan_vjp).  Walks time in reverse from the saved forward outputs
// (h_prev = out[t-1], or h0 at t = 0: valid because the alive steps of a
// row are a prefix):
//   gates = sigmoid(gx[t] + h_prev W_gh + b_g) = [r | u]
//   c     = tanh(cx[t] + (r*h_prev) W_ch + b_c)
//   d     = alive ? g[t] + dh : 0
//   head of the cell mode -> du, dc, de1, de2, dh' (and, for tgru, dvecs)
//   dac   = dc (1 - c^2)                      -> dcx[t], db_c
//   d_rh  = dac W_ch^T;  dr = d_rh h_prev;  dh' += d_rh r
//   dgates = [dr | du] gates (1 - gates)      -> dgx[t], db_g
//   dh'  += dgates W_gh^T;  dh = alive ? dh' : dh   (dead steps pass dh on)
//   dW_gh = sum_{b,t} h_prev^T dgates,  dW_ch = sum_{b,t} (r h_prev)^T dac
// Every product's operands are rounded to the input type (f32 or bf16) and
// summed in f32, as the Pallas kernel does; all ten outputs are f32.
//
// What bounds it: the reverse recurrence is a chain of L dependent steps.
// At B=64, L=512, U=128 the bytes need ~0.05 ms (bf16) at 3.35 TB/s and
// the FLOPs ~0.14 ms (f32) at 67 TFLOP/s, spread over 512 steps: 0.1-0.3
// us a step.  What sets the time is how long one step of the chain takes.
//
// Design ("two_product", the default).  The Pallas kernel recomputes the
// gates and the candidate inside each reverse step; on the TPU's 128-row
// MXU that was cheap, but here it doubled the serial chain (the earlier
// design below runs four dependent products a step on U threads a row,
// 12-13 us a step at B=64).  The recompute depends only on the saved
// outputs, never on dh, so it leaves the chain:
//  1. gru_recompute_kernel, parallel over all B*L rows on every SM: a
//     block takes 64 (b,t) rows, stages op(h_prev) transposed in shared
//     memory, streams W through two 32-row buffers by cp.async (the next
//     chunk in flight), and a warp computes 8 rows x the lane's units by
//     register-tiled f32 FMA (no TF32: the f32 path is held to JAX within
//     1e-4; bf16 operands are exact in f32, so the rounding points are the
//     Pallas kernel's).  It writes r, u, c ([B,L,3U]) and r*h_prev
//     ([B,L,U]) to the f32 workspace.
//  2. gru_chain_kernel, the reverse chain with two products a step:
//     d_rh = op(dac) W_ch^T and dh' += op(dgates) W_gh^T.  A block holds
//     TB batch rows and 4U threads: thread (j, s) sums the quarter s of k
//     (U/4 of the first product, 2U/4 of the second) for unit j of all TB
//     rows, two accumulators a row, and the four partials are added in
//     slice order through shared memory, so no thread runs a chain of more
//     than U/4 FMAs and the sums are the same every run.  Thread (j, s < TB)
//     owns row s's elementwise work and keeps its dh in a register.  Four
//     barriers a step.  W_ch and W_gh sit in shared memory in the input
//     type, rows padded by 16 bytes so that the 16-byte row reads of 8
//     neighbouring threads hit distinct banks (196 KB in f32 at U=128);
//     with one row a block (B up to 132) each thread also keeps its W_gh
//     slice in registers (64 f32, or 32 registers of bf16 pairs), which
//     halves the bytes a step reads from shared memory.  The step's inputs
//     (r, u, c, h_prev, g, e1, e2) do not depend on dh: cp.async copies
//     the next step's into shared memory behind the current one.  TB is the
//     smallest of 1, 2, 4 that keeps the grid within one wave of SMs
//     (B=256: 128 blocks, as in the four-product design).
//  3. the weight gradients, off the chain: wgrad_tiled computes
//     dW_gh = h_prev^T dgx and dW_ch = (r h_prev)^T dcx over 32 fixed
//     segments of the (b,t) rows (64 x 64 output tiles, 4 x 4 a thread,
//     operands rounded to the input type, the next 16 rows' loads in flight
//     while this chunk is summed), and grad_finish sums the segments and
//     the chain's per-row bias and dvecs partials in a fixed order, one
//     thread per output element.  No float atomics anywhere: the same
//     inputs give the same bits.
// Options measured on the H100 and not taken (PERF.md): 2 or 8
// k-slices (8: 1024 threads, 64 registers; neither faster overall); the
// four slices of a unit on neighbouring lanes, added by warp shuffles
// with two barriers a step (slower: every warp then runs the elementwise
// work on a quarter of its lanes); the step's inputs loaded to registers
// a step ahead (their latency still showed in the step).
//
// Design "four_product" (the earlier one), kept for comparison only: the
// forward's layout (csrc/gru_scan.cu), thread j owns unit j of TB rows,
// and each reverse step recomputes the gates and candidate and runs both
// transposed products, four dependent products of U or 2U FMAs a thread
// with a block barrier between each, W staged as padded f32 in shared
// memory (198 KB at U=128).  It writes r*h_prev itself; wgrad_partial
// (32 x 32 tiles, 16 segments) and grad_finish finish.

#include "common.cuh"

namespace {

enum { MODE_PLAIN = 0, MODE_TSEQREC = 1, MODE_TGRU = 2 };
enum { DESIGN_TWO_PRODUCT = 0, DESIGN_FOUR_PRODUCT = 1 };
constexpr int kSegments = 16;   // wgrad_partial: most (b,t) segments
constexpr int kTile = 32;       // wgrad_partial output tile (32 x 32)
constexpr int kWSegments = 32;  // wgrad_tiled: most (b,t) segments
constexpr int kWTile = 64;      // wgrad_tiled output tile (64 x 64)
constexpr int kWRows = 16;      // wgrad_tiled: (b,t) rows a chunk
constexpr int kSlices = 4;      // gru_chain_kernel: k-slices a product
constexpr int kRecRows = 64;    // gru_recompute_kernel: (b,t) rows a block
constexpr int kRecChunk = 32;   // gru_recompute_kernel: W rows a chunk
constexpr int kRecThreads = 256;
constexpr int kRecStride = kRecRows + 4;   // padded operand row (16 bytes)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


// --------------------------------------------------- pass 1: recompute

// Rows ci*kRecChunk .. of W ([U][n], type T) into buffer ci % 2 of s_w by
// cp.async, one commit group.
template <typename T>
__device__ __forceinline__ void stage_w(T* s_w, const T* w, int n, int U,
                                        int ci) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(
      w + (size_t)ci * kRecChunk * n);
  unsigned char* dst =
      reinterpret_cast<unsigned char*>(s_w + (ci % 2) * kRecChunk * 2 * U);
  const int pieces = kRecChunk * n * (int)sizeof(T) / 16;
  for (int c = threadIdx.x; c < pieces; c += kRecThreads)
    cp_async16(dst + 16 * c, src + 16 * c);
  cp_async_commit();
}

// Wait for W chunk ci (the next one may stay in flight), then a barrier.
__device__ __forceinline__ void wait_w(int ci, int nchunk) {
  if (ci + 1 < nchunk)
    cp_async_wait_group<1>();
  else
    cp_async_wait_group<0>();
  __syncthreads();
}

// For every (b,t) row m: gates from op(h_prev), then c from op(r*h_prev).
// Warp w owns rows m0 + 8w .. m0 + 8w + 7; lane l owns units l + 32q.  W
// streams through two shared-memory buffers of kRecChunk rows, the next
// chunk's copy in flight while this one is summed.
template <typename T>
__global__ void __launch_bounds__(kRecThreads) gru_recompute_kernel(
    const float* __restrict__ out, const T* __restrict__ gx,
    const T* __restrict__ cx, const T* __restrict__ h0,
    const T* __restrict__ wgh, const T* __restrict__ wch,
    const T* __restrict__ bg, const T* __restrict__ bc,
    float* __restrict__ ruc, float* __restrict__ rh_ws, int M, int L,
    int U) {
  extern __shared__ __align__(16) float rsm[];
  float* s_a = rsm;                     // [U][kRecStride] operand, k-major
  T* s_w = reinterpret_cast<T*>(rsm + U * kRecStride);  // [2][kRecChunk][2U]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.x * kRecRows;
  const int nu = U / 32;                // units a lane owns (at most 4)
  const int nchunk = U / kRecChunk;

  stage_w(s_w, wgh, 2 * U, U, 0);

  for (int i = threadIdx.x; i < kRecRows * U; i += kRecThreads) {
    const int mm = i / U, k = i % U, m = m0 + mm;
    float v = 0.f;
    if (m < M)
      v = m % L == 0 ? port::to_float(h0[(size_t)(m / L) * U + k])
                     : out[(size_t)(m - 1) * U + k];
    s_a[k * kRecStride + mm] = port::round_to<T>(v);
  }

  float acc_r[8][4], acc_u[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_r[r][q] = acc_u[r][q] = 0.f;
  for (int ci = 0; ci < nchunk; ++ci) {
    if (ci + 1 < nchunk) stage_w(s_w, wgh, 2 * U, U, ci + 1);
    wait_w(ci, nchunk);   // chunk ci (and, first, the operand) is in
    const int k0 = ci * kRecChunk;
#pragma unroll 2
    for (int kk = 0; kk < kRecChunk; ++kk) {
      const float* ap = s_a + (k0 + kk) * kRecStride + warp * 8;
      const float4 a0 = *reinterpret_cast<const float4*>(ap);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const T* wp = s_w + (ci % 2) * kRecChunk * 2 * U + kk * 2 * U + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < nu) {
          const float wr = port::to_float(wp[32 * q]);
          const float wu = port::to_float(wp[U + 32 * q]);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc_r[r][q] = fmaf(a[r], wr, acc_r[r][q]);
            acc_u[r][q] = fmaf(a[r], wu, acc_u[r][q]);
          }
        }
      }
    }
    __syncthreads();   // buffer ci % 2 is free for chunk ci + 2
  }
  // every warp is done with op(h_prev) and with W_gh
  stage_w(s_w, wch, U, U, 0);

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int mm = warp * 8 + r, m = m0 + mm;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nu) continue;
      const int n = lane + 32 * q;
      float rh = 0.f;
      if (m < M) {
        const size_t o = (size_t)m * 2 * U;
        const float rg = port::sigmoid(port::to_float(gx[o + n]) +
                                       acc_r[r][q] + port::to_float(bg[n]));
        const float ug =
            port::sigmoid(port::to_float(gx[o + U + n]) + acc_u[r][q] +
                          port::to_float(bg[U + n]));
        const float hp = m % L == 0
                             ? port::to_float(h0[(size_t)(m / L) * U + n])
                             : out[(size_t)(m - 1) * U + n];
        rh = rg * hp;
        ruc[(size_t)m * 3 * U + n] = rg;
        ruc[(size_t)m * 3 * U + U + n] = ug;
        rh_ws[(size_t)m * U + n] = rh;
      }
      s_a[n * kRecStride + mm] = port::round_to<T>(rh);
    }
  }

  float acc_c[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc_c[r][q] = 0.f;
  for (int ci = 0; ci < nchunk; ++ci) {
    if (ci + 1 < nchunk) stage_w(s_w, wch, U, U, ci + 1);
    wait_w(ci, nchunk);   // chunk ci (and, first, op(r*h_prev)) is in
    const int k0 = ci * kRecChunk;
#pragma unroll 2
    for (int kk = 0; kk < kRecChunk; ++kk) {
      const float* ap = s_a + (k0 + kk) * kRecStride + warp * 8;
      const float4 a0 = *reinterpret_cast<const float4*>(ap);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const T* wp = s_w + (ci % 2) * kRecChunk * 2 * U + kk * U + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < nu) {
          const float w = port::to_float(wp[32 * q]);
#pragma unroll
          for (int r = 0; r < 8; ++r) acc_c[r][q] = fmaf(a[r], w, acc_c[r][q]);
        }
      }
    }
    __syncthreads();   // buffer ci % 2 is free for chunk ci + 2
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = m0 + warp * 8 + r;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nu) continue;
      const int n = lane + 32 * q;
      ruc[(size_t)m * 3 * U + 2 * U + n] = tanhf(
          port::to_float(cx[(size_t)m * U + n]) + acc_c[r][q] +
          port::to_float(bc[n]));
    }
  }
}

// ------------------------------------------------- pass 2: the chain

// Eight consecutive shared-memory entries as f32 (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  // a bf16 is the high half of its f32: the low element of each word
  // shifts up, the high one is masked
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// Bytes of one row's step inputs in shared memory: r | u | c (3U f32),
// h_prev (U f32), g (U f32), e1, e2 (U each, input type).
__host__ __device__ __forceinline__ int step_bytes(int U, int elem) {
  return 20 * U + 2 * U * elem;
}

// Copy step t's inputs of the block's rows into s_in with cp.async, 16
// bytes a thread at a time (h_prev only for t > 0: at t = 0 it is h0, in
// the input type, read by its owner).  They do not depend on dh, so the
// copy runs behind the step before.
template <typename T, int MODE, int TB>
__device__ __forceinline__ void stage_step(
    unsigned char* s_in, int t, int row0, int B, int L, int U,
    const float* g, const float* out, const float* ruc, const T* e1,
    const T* e2) {
  const int n_ruc = 3 * U / 4, n_u = U / 4;
  const int n_e = MODE == MODE_PLAIN ? 0 : U * (int)sizeof(T) / 16;
  const int per_row = n_ruc + 2 * n_u + 2 * n_e;
  for (int c = threadIdx.x; c < TB * per_row; c += blockDim.x) {
    const int r = c / per_row, q = c % per_row, b = row0 + r;
    if (b >= B) continue;
    const size_t bt = (size_t)b * L + t;
    const unsigned char* src;
    if (q < n_ruc) {
      src = reinterpret_cast<const unsigned char*>(ruc + bt * 3 * U) + 16 * q;
    } else if (q < n_ruc + n_u) {
      if (t == 0) continue;
      src = reinterpret_cast<const unsigned char*>(out + (bt - 1) * U) +
            16 * (q - n_ruc);
    } else if (q < n_ruc + 2 * n_u) {
      src = reinterpret_cast<const unsigned char*>(g + bt * U) +
            16 * (q - n_ruc - n_u);
    } else if (q < n_ruc + 2 * n_u + n_e) {
      src = reinterpret_cast<const unsigned char*>(e1 + bt * U) +
            16 * (q - n_ruc - 2 * n_u);
    } else {
      src = reinterpret_cast<const unsigned char*>(e2 + bt * U) +
            16 * (q - n_ruc - 2 * n_u - n_e);
    }
    cp_async16(s_in + r * step_bytes(U, sizeof(T)) + 16 * q, src);
  }
  cp_async_commit();
}

// partial[r] = sum over the thread's k-slice of x[r][k] * w[k], for TB rows
// of x (f32, row stride ldx) against one padded row of W (type T); two
// accumulators a row, added at the end.
template <typename T, int TB>
__device__ __forceinline__ void slice_dot(const T* w, const float* x,
                                          int ldx, int n, float* part) {
  float acc0[TB], acc1[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc0[r] = acc1[r] = 0.f;
#pragma unroll 2
  for (int k = 0; k < n; k += 8) {
    float wv[8];
    load8(w + k, wv);
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      float xv[8];
      load8(x + r * ldx + k, xv);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        acc0[r] = fmaf(xv[i], wv[i], acc0[r]);
        acc1[r] = fmaf(xv[i + 1], wv[i + 1], acc1[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TB; ++r) part[r] = acc0[r] + acc1[r];
}

// A thread's slice of a W_gh row in registers (one-row blocks): up to
// kRegW entries, f32 as they are, bf16 two to a register.
constexpr int kRegW = 64;   // 2U / kSlices at U = 128

template <typename T>
struct WSlice;

template <>
struct WSlice<float> {
  float v[kRegW];
  __device__ __forceinline__ void load(const float* p, int n) {
#pragma unroll
    for (int i = 0; i < kRegW; ++i) v[i] = i < n ? p[i] : 0.f;
  }
  __device__ __forceinline__ float get(int i) const { return v[i]; }
};

template <>
struct WSlice<__nv_bfloat16> {
  unsigned v[kRegW / 2];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int n) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int i = 0; i < kRegW / 2; ++i) v[i] = 2 * i < n ? q[i] : 0u;
  }
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(i % 2 ? v[i / 2] & 0xffff0000u : v[i / 2] << 16);
  }
};

// slice_dot for one row with the W slice in registers.
template <typename T>
__device__ __forceinline__ float slice_dot_reg(const WSlice<T>& w,
                                               const float* x, int n) {
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
  for (int k = 0; k < kRegW; k += 8) {
    if (k < n) {
      float xv[8];
      load8(x + k, xv);
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        acc0 = fmaf(xv[i], w.get(k + i), acc0);
        acc1 = fmaf(xv[i + 1], w.get(k + i + 1), acc1);
      }
    }
  }
  return acc0 + acc1;
}

template <typename T, int MODE, int TB>
__global__ void __launch_bounds__(512, 1) gru_chain_kernel(
    const float* __restrict__ g, const float* __restrict__ out,
    const float* __restrict__ ruc, const T* __restrict__ e1,
    const T* __restrict__ e2, const int* __restrict__ lengths,
    const T* __restrict__ h0, const T* __restrict__ wgh,
    const T* __restrict__ wch, const T* __restrict__ vecs,
    float* __restrict__ dgx, float* __restrict__ dcx,
    float* __restrict__ de1, float* __restrict__ de2,
    float* __restrict__ dh0, float* __restrict__ part_bias, int B, int L,
    int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = 16 / sizeof(T);
  const int RC = U + PAD, RG = 2 * U + PAD;       // padded row lengths
  T* s_wch = reinterpret_cast<T*>(smem);          // [U][RC]: row j of W_ch
  T* s_wgh = s_wch + U * RC;                      // [U][RG]: row j of W_gh
  float* s_dac = reinterpret_cast<float*>(s_wgh + U * RG);   // [TB][U]
  float* s_dg = s_dac + TB * U;                   // [TB][2U]
  float* s_part = s_dg + TB * 2 * U;              // [kSlices][TB][U]
  unsigned char* s_in =            // [TB][step_bytes]: a step's inputs
      reinterpret_cast<unsigned char*>(s_part + kSlices * TB * U);

  const int j = threadIdx.x % U;   // unit
  const int s = threadIdx.x / U;   // k-slice; the row it owns if s < TB
  const int row0 = blockIdx.x * TB;
  const int b = row0 + s;
  const bool own = s < TB && b < B;

#pragma unroll 4
  for (int i = threadIdx.x; i < U * U; i += blockDim.x)
    s_wch[(i / U) * RC + i % U] = wch[i];
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * U * U; i += blockDim.x)
    s_wgh[(i / (2 * U)) * RG + i % (2 * U)] = wgh[i];

  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
  if (MODE == MODE_TGRU) {
    v0 = port::to_float(vecs[j]);
    v1 = port::to_float(vecs[U + j]);
    v2 = port::to_float(vecs[2 * U + j]);
    v3 = port::to_float(vecs[3 * U + j]);
  }
  const int len = own ? min(lengths[b], L) : 0;
  int t_end = 0;   // no row of the block is alive at or past t_end
#pragma unroll
  for (int r = 0; r < TB; ++r)
    if (row0 + r < B) t_end = max(t_end, min(lengths[row0 + r], L));
  // this thread's share of its row's bias and dvecs sums
  float sum_bgr = 0.f, sum_bgu = 0.f, sum_bc = 0.f;
  float sum_v0 = 0.f, sum_v1 = 0.f, sum_v2 = 0.f, sum_v3 = 0.f;
  float dh = 0.f;
  const int ks1 = U / kSlices, ks2 = 2 * U / kSlices;
  // this thread's row in s_in (its own row when it owns one)
  const unsigned char* my_in =
      s_in + (s < TB ? s : 0) * step_bytes(U, sizeof(T));
  const float* in_f = reinterpret_cast<const float*>(my_in);
  const T* in_e = reinterpret_cast<const T*>(my_in + 20 * U);
  if (t_end > 0)
    stage_step<T, MODE, TB>(s_in, t_end - 1, row0, B, L, U, g, out, ruc, e1,
                            e2);
  cp_async_wait_all();
  __syncthreads();   // W and the first step's inputs are staged
  // one-row blocks keep the thread's W_gh slice in registers: the second
  // product then reads only its operand from shared memory
  WSlice<T> wreg;
  if (TB == 1) wreg.load(s_wgh + j * RG + s * ks2, ks2);

  for (int t = t_end - 1; t >= 0; --t) {
    const bool alive = t < len;
    const size_t bt = (size_t)(own ? b : 0) * L + t;
    float dhn = 0.f, du = 0.f;
    // this step's inputs, staged by the step before (zeros for a padding
    // row, whose outputs are never written)
    float rg = 0.f, ug = 0.f, cand = 0.f, hp = 0.f, gv = 0.f, e1v = 0.f,
          e2v = 0.f;
    if (own) {
      rg = in_f[j];
      ug = in_f[U + j];
      cand = in_f[2 * U + j];
      if (t == 0)
        hp = port::to_float(h0[(size_t)b * U + j]);
      else
        hp = in_f[3 * U + j];
      gv = in_f[4 * U + j];
      if (MODE != MODE_PLAIN) {
        e1v = port::to_float(in_e[j]);
        e2v = port::to_float(in_e[U + j]);
      }
    }
    // --- cell-mode head
    if (s < TB) {
      const float dn = alive ? gv + dh : 0.f;
      const float u = ug;
      float dc, d_e1, d_e2;
      if (MODE == MODE_PLAIN) {
        du = dn * (hp - cand);
        dhn = dn * u;
        dc = dn * (1.f - u);
        d_e1 = 0.f;
        d_e2 = 0.f;
      } else if (MODE == MODE_TSEQREC) {
        du = dn * (hp * e1v - cand * e2v);
        dhn = dn * u * e1v;
        dc = dn * (1.f - u) * e2v;
        d_e1 = dn * u * hp;
        d_e2 = dn * (1.f - u) * cand;
      } else {
        const float pre = e1v + hp * v0;
        const float w = fmaxf(pre, 0.f);
        const float ts = port::sigmoid(v1 * w + v2 * e2v + v3);
        du = dn * (hp - cand * ts);
        dhn = dn * u;
        dc = dn * (1.f - u) * ts;
        const float dts = dn * (1.f - u) * cand;
        const float dz = dts * ts * (1.f - ts);
        const float dw = dz * v1;
        const float m = pre > 0.f ? 1.f : 0.f;
        d_e1 = dw * m;
        d_e2 = dz * v2;
        dhn += dw * m * v0;
        sum_v0 += dw * m * hp;
        sum_v1 += dz * w;
        sum_v2 += dz * e2v;
        sum_v3 += dz;
      }
      const float dac = dc * (1.f - cand * cand);
      sum_bc += dac;
      s_dac[s * U + j] = port::round_to<T>(dac);
      if (own) {
        dcx[bt * U + j] = dac;
        de1[bt * U + j] = d_e1;
        de2[bt * U + j] = d_e2;
      }
    }
    __syncthreads();
    // every owner has read s_in: stage the next step's inputs behind this one
    if (t > 0)
      stage_step<T, MODE, TB>(s_in, t - 1, row0, B, L, U, g, out, ruc, e1,
                              e2);

    // --- d_rh = op(dac) W_ch^T: slice s of k, every row
    float part[TB];
    slice_dot<T, TB>(s_wch + j * RC + s * ks1, s_dac + s * ks1, U, ks1,
                     part);
#pragma unroll
    for (int r = 0; r < TB; ++r) s_part[(s * TB + r) * U + j] = part[r];
    __syncthreads();

    // --- the gate path: the slices added in order
    if (s < TB) {
      float d_rh = 0.f;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) d_rh += s_part[(q * TB + s) * U + j];
      dhn += d_rh * rg;
      const float dg_r = d_rh * hp * rg * (1.f - rg);
      const float dg_u = du * ug * (1.f - ug);
      sum_bgr += dg_r;
      sum_bgu += dg_u;
      s_dg[s * 2 * U + j] = port::round_to<T>(dg_r);
      s_dg[s * 2 * U + U + j] = port::round_to<T>(dg_u);
      if (own) {
        dgx[bt * 2 * U + j] = dg_r;
        dgx[bt * 2 * U + U + j] = dg_u;
      }
    }
    __syncthreads();

    // --- dh' += op(dgates) W_gh^T: slice s of k, every row
    if (TB == 1)
      part[0] = slice_dot_reg<T>(wreg, s_dg + s * ks2, ks2);
    else
      slice_dot<T, TB>(s_wgh + j * RG + s * ks2, s_dg + s * ks2, 2 * U, ks2,
                       part);
#pragma unroll
    for (int r = 0; r < TB; ++r) s_part[(s * TB + r) * U + j] = part[r];
    cp_async_wait_all();
    __syncthreads();   // the partials, and the next step's inputs, are in

    if (s < TB) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) acc += s_part[(q * TB + s) * U + j];
      if (alive) dh = dhn + acc;
    }
    // the next head writes s_dac, whose readers passed the second barrier;
    // the next product writes s_part after the next head's barrier
  }

  if (!own) return;
  // steps past the block's longest length: every cotangent is 0
  for (int t = t_end; t < L; ++t) {
    const size_t bt = (size_t)b * L + t;
    dcx[bt * U + j] = de1[bt * U + j] = de2[bt * U + j] = 0.f;
    dgx[bt * 2 * U + j] = dgx[bt * 2 * U + U + j] = 0.f;
  }
  dh0[(size_t)b * U + j] = dh;
  float* part = part_bias + (size_t)b * 7 * U;
  part[j] = sum_bgr;
  part[U + j] = sum_bgu;
  part[2 * U + j] = sum_bc;
  part[3 * U + j] = sum_v0;
  part[4 * U + j] = sum_v1;
  part[5 * U + j] = sum_v2;
  part[6 * U + j] = sum_v3;
}

// ------------------------------------------- the four-product design

template <typename T, int MODE, int TB>
__global__ void __launch_bounds__(512) four_product_kernel(
    const float* __restrict__ g, const float* __restrict__ out,
    const T* __restrict__ gx, const T* __restrict__ cx,
    const T* __restrict__ e1, const T* __restrict__ e2,
    const int* __restrict__ lengths, const T* __restrict__ h0,
    const T* __restrict__ wgh, const T* __restrict__ wch,
    const T* __restrict__ bg, const T* __restrict__ bc,
    const T* __restrict__ vecs, float* __restrict__ dgx,
    float* __restrict__ dcx, float* __restrict__ de1,
    float* __restrict__ de2, float* __restrict__ dh0,
    float* __restrict__ rh_ws, float* __restrict__ part_bias, int B, int L,
    int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RG = 2 * U + 1, RC = U + 1;  // padded row lengths
  float* s_wgh = reinterpret_cast<float*>(smem);  // [U][2U+1]
  float* s_wch = s_wgh + U * RG;                  // [U][U+1]
  float* s_h = s_wch + U * RC;                    // [U][TB] h_prev operand
  float* s_rh = s_h + U * TB;                     // [U][TB] r*h_prev operand
  float* s_dac = s_rh + U * TB;                   // [U][TB] dac operand
  float* s_dg = s_dac + U * TB;                   // [2U][TB] dgates operand

  const int j = threadIdx.x;  // unit column; blockDim.x == U
  const int row0 = blockIdx.x * TB;

#pragma unroll 8
  for (int i = j; i < 2 * U * U; i += U)
    s_wgh[(i / (2 * U)) * RG + i % (2 * U)] = port::to_float(wgh[i]);
#pragma unroll 8
  for (int i = j; i < U * U; i += U)
    s_wch[(i / U) * RC + i % U] = port::to_float(wch[i]);

  const float bg_r = port::to_float(bg[j]);
  const float bg_u = port::to_float(bg[U + j]);
  const float bc_j = port::to_float(bc[j]);
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
  if (MODE == MODE_TGRU) {
    v0 = port::to_float(vecs[j]);
    v1 = port::to_float(vecs[U + j]);
    v2 = port::to_float(vecs[2 * U + j]);
    v3 = port::to_float(vecs[3 * U + j]);
  }

  float dh[TB];
  int len[TB];
  int t_end = 0;
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const int b = row0 + r;
    dh[r] = 0.f;
    len[r] = b < B ? min(lengths[b], L) : 0;
    t_end = max(t_end, len[r]);
  }
  // this thread's share of the block's bias and dvecs sums
  float sum_bgr = 0.f, sum_bgu = 0.f, sum_bc = 0.f;
  float sum_v0 = 0.f, sum_v1 = 0.f, sum_v2 = 0.f, sum_v3 = 0.f;
  __syncthreads();

  for (int t = t_end - 1; t >= 0; --t) {
    float hp[TB], gxr[TB], gxu[TB], cxv[TB], e1v[TB], e2v[TB], gv[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const int b = row0 + r;
      const size_t bt = (size_t)(b < B ? b : 0) * L + t;
      hp[r] = t == 0 ? port::to_float(h0[(size_t)(b < B ? b : 0) * U + j])
                     : out[(bt - 1) * U + j];
      gxr[r] = port::to_float(gx[bt * 2 * U + j]);
      gxu[r] = port::to_float(gx[bt * 2 * U + U + j]);
      cxv[r] = port::to_float(cx[bt * U + j]);
      e1v[r] = MODE == MODE_PLAIN ? 0.f : port::to_float(e1[bt * U + j]);
      e2v[r] = MODE == MODE_PLAIN ? 0.f : port::to_float(e2[bt * U + j]);
      gv[r] = g[bt * U + j];
      s_h[j * TB + r] = port::round_to<T>(hp[r]);
    }
    __syncthreads();

    // --- recompute the forward step
    float acc_r[TB], acc_u[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc_r[r] = acc_u[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < U; ++k) {
      const float w_r = s_wgh[k * RG + j];
      const float w_u = s_wgh[k * RG + U + j];
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float hk = s_h[k * TB + r];
        acc_r[r] = fmaf(hk, w_r, acc_r[r]);
        acc_u[r] = fmaf(hk, w_u, acc_u[r]);
      }
    }
    float rg[TB], ug[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      rg[r] = port::sigmoid(gxr[r] + acc_r[r] + bg_r);
      ug[r] = port::sigmoid(gxu[r] + acc_u[r] + bg_u);
      const float rh = rg[r] * hp[r];
      s_rh[j * TB + r] = port::round_to<T>(rh);
      const int b = row0 + r;
      if (b < B) rh_ws[((size_t)b * L + t) * U + j] = rh;
    }
    __syncthreads();

    float acc_c[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc_c[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < U; ++k) {
      const float w_c = s_wch[k * RC + j];
#pragma unroll
      for (int r = 0; r < TB; ++r)
        acc_c[r] = fmaf(s_rh[k * TB + r], w_c, acc_c[r]);
    }

    // --- cell-mode head and the candidate path
    float dhn[TB], du[TB];
    bool alive[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float cand = tanhf(cxv[r] + acc_c[r] + bc_j);
      const float u = ug[r];
      alive[r] = t < len[r];
      const float dn = alive[r] ? gv[r] + dh[r] : 0.f;
      float dc, d_e1, d_e2;
      if (MODE == MODE_PLAIN) {
        du[r] = dn * (hp[r] - cand);
        dhn[r] = dn * u;
        dc = dn * (1.f - u);
        d_e1 = 0.f;
        d_e2 = 0.f;
      } else if (MODE == MODE_TSEQREC) {
        du[r] = dn * (hp[r] * e1v[r] - cand * e2v[r]);
        dhn[r] = dn * u * e1v[r];
        dc = dn * (1.f - u) * e2v[r];
        d_e1 = dn * u * hp[r];
        d_e2 = dn * (1.f - u) * cand;
      } else {
        const float pre = e1v[r] + hp[r] * v0;
        const float w = fmaxf(pre, 0.f);
        const float ts = port::sigmoid(v1 * w + v2 * e2v[r] + v3);
        du[r] = dn * (hp[r] - cand * ts);
        dhn[r] = dn * u;
        dc = dn * (1.f - u) * ts;
        const float dts = dn * (1.f - u) * cand;
        const float dz = dts * ts * (1.f - ts);
        const float dw = dz * v1;
        const float m = pre > 0.f ? 1.f : 0.f;
        d_e1 = dw * m;
        d_e2 = dz * v2;
        dhn[r] += dw * m * v0;
        sum_v0 += dw * m * hp[r];
        sum_v1 += dz * w;
        sum_v2 += dz * e2v[r];
        sum_v3 += dz;
      }
      const float dac = dc * (1.f - cand * cand);
      sum_bc += dac;
      s_dac[j * TB + r] = port::round_to<T>(dac);
      const int b = row0 + r;
      if (b < B) {
        const size_t o = ((size_t)b * L + t) * U + j;
        dcx[o] = dac;
        de1[o] = d_e1;
        de2[o] = d_e2;
      }
    }
    __syncthreads();

    // --- d_rh = dac W_ch^T (row j of W_ch), then the gate path
    float acc_d[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc_d[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < U; ++k) {
      const float w = s_wch[j * RC + k];
#pragma unroll
      for (int r = 0; r < TB; ++r)
        acc_d[r] = fmaf(s_dac[k * TB + r], w, acc_d[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float dr = acc_d[r] * hp[r];
      dhn[r] += acc_d[r] * rg[r];
      const float dg_r = dr * rg[r] * (1.f - rg[r]);
      const float dg_u = du[r] * ug[r] * (1.f - ug[r]);
      sum_bgr += dg_r;
      sum_bgu += dg_u;
      s_dg[j * TB + r] = port::round_to<T>(dg_r);
      s_dg[(U + j) * TB + r] = port::round_to<T>(dg_u);
      const int b = row0 + r;
      if (b < B) {
        const size_t o = ((size_t)b * L + t) * 2 * U;
        dgx[o + j] = dg_r;
        dgx[o + U + j] = dg_u;
      }
    }
    __syncthreads();

    // --- dh' += dgates W_gh^T (row j of W_gh)
    float acc_h[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc_h[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < 2 * U; ++k) {
      const float w = s_wgh[j * RG + k];
#pragma unroll
      for (int r = 0; r < TB; ++r)
        acc_h[r] = fmaf(s_dg[k * TB + r], w, acc_h[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r)
      if (alive[r]) dh[r] = dhn[r] + acc_h[r];
    // the next step's first writes go to s_h, whose readers are done
  }

  // steps past the tile's longest length: every cotangent is 0
  for (int t = t_end; t < L; ++t) {
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const int b = row0 + r;
      if (b >= B) continue;
      const size_t bt = (size_t)b * L + t;
      dcx[bt * U + j] = de1[bt * U + j] = de2[bt * U + j] = 0.f;
      rh_ws[bt * U + j] = 0.f;
      dgx[bt * 2 * U + j] = dgx[bt * 2 * U + U + j] = 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const int b = row0 + r;
    if (b < B) dh0[(size_t)b * U + j] = dh[r];
  }
  float* part = part_bias + (size_t)blockIdx.x * 7 * U;
  part[j] = sum_bgr;
  part[U + j] = sum_bgu;
  part[2 * U + j] = sum_bc;
  part[3 * U + j] = sum_v0;
  part[4 * U + j] = sum_v1;
  part[5 * U + j] = sum_v2;
  part[6 * U + j] = sum_v3;
}

// The four-product design's weight sums:
// partial[s, k, n] = sum over rows m of segment s, in order, of
// round(A[m, k]) * round(Bm[m, n]).  With `shift`, A is h_prev: row m =
// (b, t) reads h0[b] at t = 0 and a[m - 1] (= out[b, t-1]) otherwise.
template <typename T>
__global__ void __launch_bounds__(256) wgrad_partial(
    const float* __restrict__ a, const T* __restrict__ h0, int shift,
    const float* __restrict__ bm, int M, int L, int U, int N, int seg_len,
    float* __restrict__ partial) {
  __shared__ float As[kTile][kTile + 1];
  __shared__ float Bs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  const int n0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const int s = blockIdx.z;
  const int m_begin = s * seg_len;
  const int m_end = min(M, m_begin + seg_len);
  float acc[kTile / 8];
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i) acc[i] = 0.f;
  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int mm = ty + 8 * i;
      const int m = m0 + mm;
      float av = 0.f, bv = 0.f;
      if (m < m_end) {
        if (shift && m % L == 0)
          av = port::to_float(h0[(size_t)(m / L) * U + k0 + tx]);
        else
          av = a[(size_t)(m - shift) * U + k0 + tx];
        bv = bm[(size_t)m * N + n0 + tx];
      }
      As[mm][tx] = port::round_to<T>(av);
      Bs[mm][tx] = port::round_to<T>(bv);
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kTile; ++mm) {
      const float bv = Bs[mm][tx];
#pragma unroll
      for (int i = 0; i < kTile / 8; ++i)
        acc[i] = fmaf(As[mm][ty + 8 * i], bv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTile / 8; ++i)
    partial[((size_t)s * U + k0 + ty + 8 * i) * N + n0 + tx] = acc[i];
}

// The two-product design's weight sums, the same partial[s, k, n] as
// wgrad_partial over segments of kWRows-row chunks, as register tiles: a
// block owns a 64 x 64 output tile, thread (ty, tx) of 16 x 16 its 4 x 4
// outputs k = k0 + 4ty + i, n = n0 + 4tx + i, and the next chunk's rows
// are loaded into registers while this one is summed.  Every output sums
// its segment's rows in order.
template <typename T>
__global__ void __launch_bounds__(256) wgrad_tiled(
    const float* __restrict__ a, const T* __restrict__ h0, int shift,
    const float* __restrict__ bm, int M, int L, int U, int N, int seg_len,
    float* __restrict__ partial) {
  __shared__ __align__(16) float As[kWRows][kWTile];   // [m][k]
  __shared__ __align__(16) float Bs[kWRows][kWTile];   // [m][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kWTile, k0 = blockIdx.y * kWTile;
  const int seg = blockIdx.z;
  const int m_begin = seg * seg_len;
  const int m_end = min(M, m_begin + seg_len);
  constexpr int kPer = kWRows * kWTile / 256;   // staged entries a thread
  float pa[kPer], pb[kPer];
  auto fetch = [&](int m0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + 256 * i, mm = e / kWTile, c = e % kWTile;
      const int m = m0 + mm;
      float av = 0.f, bv = 0.f;
      if (m < m_end) {
        if (k0 + c < U)
          av = shift && m % L == 0
                   ? port::to_float(h0[(size_t)(m / L) * U + k0 + c])
                   : a[(size_t)(m - shift) * U + k0 + c];
        if (n0 + c < N) bv = bm[(size_t)m * N + n0 + c];
      }
      pa[i] = av;   // rounded at the store, so that the loads stay in
      pb[i] = bv;   // flight while the current chunk is summed
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  fetch(m_begin);
  for (int m0 = m_begin; m0 < m_end; m0 += kWRows) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + 256 * i;
      As[e / kWTile][e % kWTile] = port::round_to<T>(pa[i]);
      Bs[e / kWTile][e % kWTile] = port::round_to<T>(pb[i]);
    }
    __syncthreads();
    if (m0 + kWRows < m_end) fetch(m0 + kWRows);
#pragma unroll
    for (int mm = 0; mm < kWRows; ++mm) {
      const float4 av = *reinterpret_cast<const float4*>(&As[mm][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[mm][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(ar[i], br[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + 4 * tx + jj;
      if (k < U && n < N)
        partial[((size_t)seg * U + k) * N + n] = acc[i][jj];
    }
  }
}

// One thread per output element: dW_gh and dW_ch sum their S segment
// partials, db_g, db_c and dvecs their `nbias` bias partial rows (one a
// block in the four-product design, one a batch row in the chain), in
// order.
__global__ void grad_finish(const float* __restrict__ part_gh,
                            const float* __restrict__ part_ch, int S,
                            const float* __restrict__ part_bias, int nbias,
                            int U, float* __restrict__ dwgh,
                            float* __restrict__ dwch, float* __restrict__ dbg,
                            float* __restrict__ dbc,
                            float* __restrict__ dvec) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_gh = 2 * U * U, n_ch = U * U;
  float sum = 0.f;
  if (idx < n_gh) {
    for (int s = 0; s < S; ++s) sum += part_gh[(size_t)s * n_gh + idx];
    dwgh[idx] = sum;
  } else if (idx < n_gh + n_ch) {
    const int i = idx - n_gh;
    for (int s = 0; s < S; ++s) sum += part_ch[(size_t)s * n_ch + i];
    dwch[i] = sum;
  } else if (idx < n_gh + n_ch + 7 * U) {
    const int i = idx - n_gh - n_ch;
    for (int p = 0; p < nbias; ++p) sum += part_bias[(size_t)p * 7 * U + i];
    if (i < 2 * U)
      dbg[i] = sum;
    else if (i < 3 * U)
      dbc[i - 2 * U] = sum;
    else
      dvec[i - 3 * U] = sum;
  }
}

size_t recompute_smem_bytes(int U, int elem) {
  return (size_t)U * kRecStride * sizeof(float) +
         (size_t)2 * kRecChunk * 2 * U * elem;
}

size_t chain_smem_bytes(int U, int tb, int elem) {
  const int pad = 16 / elem;
  return (size_t)U * (3 * U + 2 * pad) * elem +
         (size_t)(3 + kSlices) * tb * U * sizeof(float) +
         (size_t)tb * step_bytes(U, elem);
}

size_t four_product_smem_bytes(int U, int tb) {
  return ((size_t)U * (2 * U + 1) + (size_t)U * (U + 1) + 5 * (size_t)U * tb) *
         sizeof(float);
}

// Rows a block holds: the smallest power of two up to `most` whose grid
// fits in one wave of SMs (`most` beyond that).  The two-product chain
// takes up to 4 (its rows are owned by k-slices), the four-product design
// up to 8.
int rows_per_block(int B, int device, int most) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 132;
  int tb = 1;
  while (tb < most && (B + tb - 1) / tb > sms) tb *= 2;
  return tb;
}

int design_rows(int B, int device, int design) {
  return rows_per_block(B, device, design == DESIGN_TWO_PRODUCT ? kSlices : 8);
}

// The (b,t) rows of the weight sums split into S segments of seg_len rows
// (a multiple of the chunk): at most kWSegments of kWRows-row chunks for
// wgrad_tiled, kSegments of kTile rows for the four-product design's
// wgrad_partial; at least one chunk each.
void segments(int M, int design, int* S, int* seg_len) {
  const int chunk = design == DESIGN_TWO_PRODUCT ? kWRows : kTile;
  const int most = design == DESIGN_TWO_PRODUCT ? kWSegments : kSegments;
  const int chunks = (M + chunk - 1) / chunk;
  const int want = chunks < most ? chunks : most;
  const int per = (chunks + want - 1) / want;
  *seg_len = per * chunk;
  *S = (M + *seg_len - 1) / *seg_len;
}

// Bias and dvecs partial rows: one a batch row in the two-product design,
// one a block in the four-product design.
int bias_rows(int B, int tb, int design) {
  return design == DESIGN_TWO_PRODUCT ? B : (B + tb - 1) / tb;
}

struct Workspace {
  float* rh;         // [B, L, U]
  float* ruc;        // [B, L, 3U] (two-product design only)
  float* part_bias;  // [bias_rows, 7U]
  float* part_gh;    // [S, U, 2U]
  float* part_ch;    // [S, U, U]
};

size_t workspace_floats(int B, int L, int U, int tb, int design) {
  int S, seg_len;
  segments(B * L, design, &S, &seg_len);
  const size_t M = (size_t)B * L;
  return M * U + (design == DESIGN_TWO_PRODUCT ? M * 3 * U : 0) +
         (size_t)bias_rows(B, tb, design) * 7 * U + (size_t)S * 3 * U * U;
}

struct Args {
  const float *g, *out;
  const void *gx, *cx, *e1, *e2;
  const int* lengths;
  const void *h0, *wgh, *wch, *bg, *bc, *vecs;
  float *dgx, *dcx, *de1, *de2, *dh0, *dwgh, *dwch, *dbg, *dbc, *dvec;
  float* ws;
  int B, L, U, design;
  cudaStream_t stream;
};

Workspace carve(const Args& a, int tb) {
  const size_t M = (size_t)a.B * a.L;
  int S, seg_len;
  segments(a.B * a.L, a.design, &S, &seg_len);
  Workspace w;
  w.rh = a.ws;
  w.ruc = w.rh + M * a.U;
  w.part_bias =
      w.ruc + (a.design == DESIGN_TWO_PRODUCT ? M * 3 * a.U : (size_t)0);
  w.part_gh = w.part_bias + (size_t)bias_rows(a.B, tb, a.design) * 7 * a.U;
  w.part_ch = w.part_gh + (size_t)S * 2 * a.U * a.U;
  return w;
}

// dW_gh, dW_ch from the (b,t) rows, then every sum in a fixed order.
template <typename T>
cudaError_t launch_weight_grads(const Args& a, const Workspace& w,
                                int nbias) {
  const int U = a.U, M = a.B * a.L;
  int S, seg_len;
  segments(M, a.design, &S, &seg_len);
  const T* h0 = static_cast<const T*>(a.h0);
  if (a.design == DESIGN_TWO_PRODUCT) {
    const int ku = (U + kWTile - 1) / kWTile;
    wgrad_tiled<T><<<dim3((2 * U + kWTile - 1) / kWTile, ku, S), 256, 0,
                     a.stream>>>(a.out, h0, 1, a.dgx, M, a.L, U, 2 * U,
                                 seg_len, w.part_gh);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_tiled<T><<<dim3(ku, ku, S), 256, 0, a.stream>>>(
        w.rh, h0, 0, a.dcx, M, a.L, U, U, seg_len, w.part_ch);
  } else {
    const dim3 block(kTile, 8);
    wgrad_partial<T><<<dim3(2 * U / kTile, U / kTile, S), block, 0,
                       a.stream>>>(a.out, h0, 1, a.dgx, M, a.L, U, 2 * U,
                                   seg_len, w.part_gh);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_partial<T><<<dim3(U / kTile, U / kTile, S), block, 0, a.stream>>>(
        w.rh, h0, 0, a.dcx, M, a.L, U, U, seg_len, w.part_ch);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = 3 * U * U + 7 * U;
  grad_finish<<<(total + 255) / 256, 256, 0, a.stream>>>(
      w.part_gh, w.part_ch, S, w.part_bias, nbias, U, a.dwgh, a.dwch, a.dbg,
      a.dbc, a.dvec);
  return cudaGetLastError();
}

template <typename T, int MODE, int TB>
cudaError_t launch_two_product(const Args& a) {
  const int U = a.U, M = a.B * a.L;
  const int nblk = (a.B + TB - 1) / TB;
  const Workspace w = carve(a, TB);

  auto rec = gru_recompute_kernel<T>;
  const size_t rsmem = recompute_smem_bytes(U, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      rec, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsmem);
  if (err != cudaSuccess) return err;
  rec<<<(M + kRecRows - 1) / kRecRows, kRecThreads, rsmem, a.stream>>>(
      a.out, static_cast<const T*>(a.gx), static_cast<const T*>(a.cx),
      static_cast<const T*>(a.h0), static_cast<const T*>(a.wgh),
      static_cast<const T*>(a.wch), static_cast<const T*>(a.bg),
      static_cast<const T*>(a.bc), w.ruc, w.rh, M, a.L, U);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto chain = gru_chain_kernel<T, MODE, TB>;
  const size_t csmem = chain_smem_bytes(U, TB, sizeof(T));
  err = cudaFuncSetAttribute(
      chain, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)csmem);
  if (err != cudaSuccess) return err;
  chain<<<nblk, kSlices * U, csmem, a.stream>>>(
      a.g, a.out, w.ruc, static_cast<const T*>(a.e1),
      static_cast<const T*>(a.e2), a.lengths, static_cast<const T*>(a.h0),
      static_cast<const T*>(a.wgh), static_cast<const T*>(a.wch),
      static_cast<const T*>(a.vecs), a.dgx, a.dcx, a.de1, a.de2, a.dh0,
      w.part_bias, a.B, a.L, U);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_weight_grads<T>(a, w, a.B);
}

template <typename T, int MODE, int TB>
cudaError_t launch_four_product(const Args& a) {
  const int U = a.U;
  const int nblk = (a.B + TB - 1) / TB;
  const Workspace w = carve(a, TB);
  auto kernel = four_product_kernel<T, MODE, TB>;
  const size_t smem = four_product_smem_bytes(U, TB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblk, U, smem, a.stream>>>(
      a.g, a.out, static_cast<const T*>(a.gx), static_cast<const T*>(a.cx),
      static_cast<const T*>(a.e1), static_cast<const T*>(a.e2), a.lengths,
      static_cast<const T*>(a.h0), static_cast<const T*>(a.wgh),
      static_cast<const T*>(a.wch), static_cast<const T*>(a.bg),
      static_cast<const T*>(a.bc), static_cast<const T*>(a.vecs), a.dgx,
      a.dcx, a.de1, a.de2, a.dh0, w.rh, w.part_bias, a.B, a.L, U);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_weight_grads<T>(a, w, nblk);
}

template <typename T, int MODE>
cudaError_t launch_tb(int tb, const Args& a) {
  if (a.design == DESIGN_TWO_PRODUCT) {
    switch (tb) {
      case 1: return launch_two_product<T, MODE, 1>(a);
      case 2: return launch_two_product<T, MODE, 2>(a);
      default: return launch_two_product<T, MODE, 4>(a);
    }
  }
  switch (tb) {
    case 1: return launch_four_product<T, MODE, 1>(a);
    case 2: return launch_four_product<T, MODE, 2>(a);
    case 4: return launch_four_product<T, MODE, 4>(a);
    default: return launch_four_product<T, MODE, 8>(a);
  }
}

template <typename T>
cudaError_t launch_mode(int mode, int tb, const Args& a) {
  switch (mode) {
    case MODE_PLAIN: return launch_tb<T, MODE_PLAIN>(tb, a);
    case MODE_TSEQREC: return launch_tb<T, MODE_TSEQREC>(tb, a);
    case MODE_TGRU: return launch_tb<T, MODE_TGRU>(tb, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest dynamic shared memory a launch of `design` (0: two-product, 1:
// the four-product) may ask for at width U; the wrapper refuses widths
// whose weights do not fit.
extern "C" long long gru_scan_bwd_smem_bytes(int U, int is_bf16, int design) {
  if (design == DESIGN_FOUR_PRODUCT)
    return (long long)four_product_smem_bytes(U, 8);
  const size_t chain = chain_smem_bytes(U, kSlices, is_bf16 ? 2 : 4);
  const size_t rec = recompute_smem_bytes(U, is_bf16 ? 2 : 4);
  return (long long)(chain > rec ? chain : rec);
}

// Floats of f32 workspace a launch of `design` at (B, L, U) on `device`
// needs.
extern "C" long long gru_scan_bwd_workspace_floats(int B, int L, int U,
                                                   int device, int design) {
  return (long long)workspace_floats(B, L, U, design_rows(B, device, design),
                                     design);
}

// All pointers are device pointers to contiguous arrays:
// g, out [B,L,U] f32; gx [B,L,2U], cx/e1/e2 [B,L,U], h0 [B,U], wgh [U,2U],
// wch [U,U], bg [2U], bc [U], vecs [4,U], all f32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1); lengths [B] int32.  Outputs, all f32: dgx [B,L,2U],
// dcx/de1/de2 [B,L,U], dh0 [B,U], dwgh [U,2U], dwch [U,U], dbg [2U],
// dbc [U], dvec [4,U].  ws holds gru_scan_bwd_workspace_floats floats.
// design: 0 the two-product design, 1 the four-product design (U a
// multiple of 32 up to 128 for both).  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int gru_scan_bwd_launch(
    int mode, int is_bf16, int design, const void* g, const void* out,
    const void* gx, const void* cx, const void* e1, const void* e2,
    const void* lengths, const void* h0, const void* wgh, const void* wch,
    const void* bg, const void* bc, const void* vecs, void* dgx, void* dcx,
    void* de1, void* de2, void* dh0, void* dwgh, void* dwch, void* dbg,
    void* dbc, void* dvec, void* ws, int B, int L, int U, int device,
    void* stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  if (U % 32 || U < 32 || U > 128 ||
      (design != DESIGN_TWO_PRODUCT && design != DESIGN_FOUR_PRODUCT))
    return cudaErrorInvalidValue;
  // the two-product design copies g, out, e1, e2, W_gh and W_ch in 16-byte
  // pieces
  if ((reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(out) |
       reinterpret_cast<size_t>(e1) | reinterpret_cast<size_t>(e2) |
       reinterpret_cast<size_t>(wgh) | reinterpret_cast<size_t>(wch)) % 16)
    return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.g = static_cast<const float*>(g);
  a.out = static_cast<const float*>(out);
  a.gx = gx; a.cx = cx; a.e1 = e1; a.e2 = e2;
  a.lengths = static_cast<const int*>(lengths);
  a.h0 = h0; a.wgh = wgh; a.wch = wch; a.bg = bg; a.bc = bc; a.vecs = vecs;
  a.dgx = static_cast<float*>(dgx);
  a.dcx = static_cast<float*>(dcx);
  a.de1 = static_cast<float*>(de1);
  a.de2 = static_cast<float*>(de2);
  a.dh0 = static_cast<float*>(dh0);
  a.dwgh = static_cast<float*>(dwgh);
  a.dwch = static_cast<float*>(dwch);
  a.dbg = static_cast<float*>(dbg);
  a.dbc = static_cast<float*>(dbc);
  a.dvec = static_cast<float*>(dvec);
  a.ws = static_cast<float*>(ws);
  a.B = B; a.L = L; a.U = U; a.design = design;
  a.stream = static_cast<cudaStream_t>(stream);
  const int tb = design_rows(B, device, design);
  if (is_bf16) return launch_mode<__nv_bfloat16>(mode, tb, a);
  return launch_mode<float>(mode, tb, a);
}
