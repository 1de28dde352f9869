// Whole-sequence (time-aware) GRU scan, backward.
//
// Replaces: mtamrecommender_tpu/ops/pallas/gru_kernel.py,
// _gru_scan_bwd_kernel (launched by gru_scan_bwd, the backward of
// gru_scan_vjp).  Walks time in reverse and recomputes each step's gates
// and candidate from the saved forward outputs (h_prev = out[t-1], or h0
// at t = 0: valid because the alive steps of a row are a prefix):
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
// What bounds it: like the forward, the reverse recurrence is a chain of L
// dependent steps, here four small products a step ([TB,U]x[U,2U],
// [TB,U]x[U,U] and their transposes) with a block barrier between each.
// At B=256, L=50, U=128 the bytes (~80 MB in f32) need ~24 us at
// 3.35 TB/s and the FLOPs (about 3x the forward's) ~57 us at 67 TFLOP/s;
// the latency of 50 serial steps is the real limit.
//
// Design: the forward's layout (csrc/gru_scan.cu).  A block owns TB batch
// rows, thread j owns unit j, and the reverse time loop runs inside the
// block from the tile's longest length down to 0 (the TPU kernel's
// time-chunk grid does not carry over: Hopper blocks run in no order).
// The backward reads W by row as well as by column, so W_gh and W_ch are
// staged once as f32 in shared memory with each row padded by one word:
// a column read (forward recompute) and a row read (the transposed
// products) are then both free of bank conflicts; 198 KB at U=128.
// The weight gradients are sums over every block.  Float atomics would
// make the step differ from run to run, so the main kernel writes its
// per-block bias and dvecs partials and the r*h_prev operand to a
// workspace, and two more kernels in this file reduce in a fixed order:
// wgrad_partial computes dW_gh = h_prev^T dgx and dW_ch = (r h_prev)^T dcx
// over fixed segments of the (b,t) rows (32x32 shared-memory tiles,
// operands rounded to the input type), and grad_finish sums the segments
// and the block partials, one thread per output element.

#include "common.cuh"

namespace {

enum { MODE_PLAIN = 0, MODE_TSEQREC = 1, MODE_TGRU = 2 };
constexpr int kSegments = 16;   // most (b,t) segments of the weight sums
constexpr int kTile = 32;       // wgrad_partial output tile (32 x 32)

template <typename T, int MODE, int TB>
__global__ void __launch_bounds__(512) gru_bwd_kernel(
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

// One thread per output element: dW_gh and dW_ch sum their S segment
// partials, db_g, db_c and dvecs their per-block partials, in order.
__global__ void grad_finish(const float* __restrict__ part_gh,
                            const float* __restrict__ part_ch, int S,
                            const float* __restrict__ part_bias, int nblk,
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
    for (int blk = 0; blk < nblk; ++blk) sum += part_bias[(size_t)blk * 7 * U + i];
    if (i < 2 * U)
      dbg[i] = sum;
    else if (i < 3 * U)
      dbc[i - 2 * U] = sum;
    else
      dvec[i - 3 * U] = sum;
  }
}

size_t smem_bytes(int U, int tb) {
  return ((size_t)U * (2 * U + 1) + (size_t)U * (U + 1) + 5 * (size_t)U * tb) *
         sizeof(float);
}

int rows_per_block(int B, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 132;
  int tb = 1;
  while (tb < 8 && (B + tb - 1) / tb > sms) tb *= 2;
  return tb;
}

// The (b,t) rows of the weight sums split into S segments of seg_len rows
// (a multiple of the tile): at most kSegments, at least one tile each.
void segments(int M, int* S, int* seg_len) {
  const int tiles = (M + kTile - 1) / kTile;
  const int want = tiles < kSegments ? tiles : kSegments;
  const int per = (tiles + want - 1) / want;
  *seg_len = per * kTile;
  *S = (M + *seg_len - 1) / *seg_len;
}

struct Workspace {
  float* rh;         // [B, L, U]
  float* part_bias;  // [nblk, 7U]
  float* part_gh;    // [S, U, 2U]
  float* part_ch;    // [S, U, U]
};

size_t workspace_floats(int B, int L, int U, int tb) {
  int S, seg_len;
  segments(B * L, &S, &seg_len);
  const size_t nblk = (B + tb - 1) / tb;
  return (size_t)B * L * U + nblk * 7 * U + (size_t)S * 3 * U * U;
}

struct Args {
  const float *g, *out;
  const void *gx, *cx, *e1, *e2;
  const int* lengths;
  const void *h0, *wgh, *wch, *bg, *bc, *vecs;
  float *dgx, *dcx, *de1, *de2, *dh0, *dwgh, *dwch, *dbg, *dbc, *dvec;
  float* ws;
  int B, L, U;
  cudaStream_t stream;
};

template <typename T, int MODE, int TB>
cudaError_t launch(const Args& a) {
  const int U = a.U, M = a.B * a.L;
  const int nblk = (a.B + TB - 1) / TB;
  int S, seg_len;
  segments(M, &S, &seg_len);
  Workspace w;
  w.rh = a.ws;
  w.part_bias = w.rh + (size_t)M * U;
  w.part_gh = w.part_bias + (size_t)nblk * 7 * U;
  w.part_ch = w.part_gh + (size_t)S * 2 * U * U;

  auto kernel = gru_bwd_kernel<T, MODE, TB>;
  const size_t smem = smem_bytes(U, TB);
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

  const dim3 block(kTile, 8);
  wgrad_partial<T><<<dim3(2 * U / kTile, U / kTile, S), block, 0, a.stream>>>(
      a.out, static_cast<const T*>(a.h0), 1, a.dgx, M, a.L, U, 2 * U, seg_len,
      w.part_gh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wgrad_partial<T><<<dim3(U / kTile, U / kTile, S), block, 0, a.stream>>>(
      w.rh, static_cast<const T*>(a.h0), 0, a.dcx, M, a.L, U, U, seg_len,
      w.part_ch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int total = 3 * U * U + 7 * U;
  grad_finish<<<(total + 255) / 256, 256, 0, a.stream>>>(
      w.part_gh, w.part_ch, S, w.part_bias, nblk, U, a.dwgh, a.dwch, a.dbg,
      a.dbc, a.dvec);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_tb(int tb, const Args& a) {
  switch (tb) {
    case 1: return launch<T, MODE, 1>(a);
    case 2: return launch<T, MODE, 2>(a);
    case 4: return launch<T, MODE, 4>(a);
    default: return launch<T, MODE, 8>(a);
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

// Largest dynamic shared memory the main kernel may ask for (TB = 8); the
// wrapper refuses widths whose padded f32 weights do not fit.
extern "C" long long gru_scan_bwd_smem_bytes(int U) {
  return (long long)smem_bytes(U, 8);
}

// Floats of f32 workspace a launch at (B, L, U) on `device` needs.
extern "C" long long gru_scan_bwd_workspace_floats(int B, int L, int U,
                                                   int device) {
  return (long long)workspace_floats(B, L, U, rows_per_block(B, device));
}

// All pointers are device pointers to contiguous arrays:
// g, out [B,L,U] f32; gx [B,L,2U], cx/e1/e2 [B,L,U], h0 [B,U], wgh [U,2U],
// wch [U,U], bg [2U], bc [U], vecs [4,U], all f32 (is_bf16 = 0) or all
// bf16 (is_bf16 = 1); lengths [B] int32.  Outputs, all f32: dgx [B,L,2U],
// dcx/de1/de2 [B,L,U], dh0 [B,U], dwgh [U,2U], dwch [U,U], dbg [2U],
// dbc [U], dvec [4,U].  ws holds gru_scan_bwd_workspace_floats floats.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int gru_scan_bwd_launch(
    int mode, int is_bf16, const void* g, const void* out, const void* gx,
    const void* cx, const void* e1, const void* e2, const void* lengths,
    const void* h0, const void* wgh, const void* wch, const void* bg,
    const void* bc, const void* vecs, void* dgx, void* dcx, void* de1,
    void* de2, void* dh0, void* dwgh, void* dwch, void* dbg, void* dbc,
    void* dvec, void* ws, int B, int L, int U, int device, void* stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
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
  a.B = B; a.L = L; a.U = U;
  a.stream = static_cast<cudaStream_t>(stream);
  const int tb = rows_per_block(B, device);
  if (is_bf16) return launch_mode<__nv_bfloat16>(mode, tb, a);
  return launch_mode<float>(mode, tb, a);
}
