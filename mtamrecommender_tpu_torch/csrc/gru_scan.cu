// Whole-sequence (time-aware) GRU scan, forward (the backward is
// gru_scan_bwd.cu).
//
// Replaces: mtamrecommender_tpu/ops/pallas/gru_kernel.py, _gru_scan_kernel
// (launched by gru_scan, the forward of gru_scan_vjp).  Same cell math:
//   gates = sigmoid(gx[t] + h W_gh + b_g) = [r | u]
//   c     = tanh(cx[t] + (r*h) W_ch + b_c)
//   plain    h' = u*h + (1-u)*c
//   tseqrec  h' = u*h*e1[t] + (1-u)*c*e2[t]
//   tgru     w = relu(e1[t] + h*v0); ts = sigmoid(v1*w + v2*e2[t] + v3)
//            h' = u*h + (1-u)*c*ts
// Length semantics of dynamic_rnn: for t >= lengths[b] the output is 0 and
// the state stays frozen.  Inputs are f32 or bf16; h is carried in f32 and
// rounded to the input type only as the operand of the two products, as
// the Pallas kernel does; outputs are f32.
//
// What bounds it: the recurrence is a chain of L dependent steps, each two
// small products [TB,U]x[U,2U] and [TB,U]x[U,U] with a block barrier
// between them.  At B=256, L=50, U=128 the bytes (about 40 MB in f32)
// need ~12 us at 3.35 TB/s and the products (1.26 GFLOP) ~19 us at the
// 67 TFLOP/s f32 rate, but no step can start before the one before it ends,
// so the real limit is the latency of 50 serial steps on few SMs.
//
// Design: the TPU kernel carried h from one grid step to the next in VMEM
// scratch over a sequential time-chunk grid axis.  Hopper blocks run in no
// order, so here the whole time loop runs inside one block that owns TB
// batch rows: thread j owns unit column j of all TB rows, keeps their h in
// registers, and the block stages W_gh and W_ch in dynamic shared memory
// once (196 KB in f32 at U=128) so each step reads them from shared memory
// instead of L2.  TB is the smallest of 1, 2, 4, 8 that keeps the grid
// within one wave of SMs, so B=256 runs 128 blocks.  The products run on
// the f32 FMA units: TF32 tensor cores would lose the f32 parity the port
// is held to, and tensor-core tiles are a later optimisation.

#include "common.cuh"

namespace {

enum { MODE_PLAIN = 0, MODE_TSEQREC = 1, MODE_TGRU = 2 };

template <typename T, int MODE, int TB>
__global__ void __launch_bounds__(512) gru_scan_kernel(
    const T* __restrict__ gx, const T* __restrict__ cx,
    const T* __restrict__ e1, const T* __restrict__ e2,
    const int* __restrict__ lengths, const T* __restrict__ h0,
    const T* __restrict__ wgh, const T* __restrict__ wch,
    const T* __restrict__ bg, const T* __restrict__ bc,
    const T* __restrict__ vecs, float* __restrict__ out, int B, int L,
    int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_wgh = reinterpret_cast<T*>(smem);                 // [U][2U]
  T* s_wch = s_wgh + 2 * U * U;                          // [U][U]
  float* s_h = reinterpret_cast<float*>(s_wch + U * U);  // [U][TB] h operand
  float* s_rh = s_h + U * TB;                            // [U][TB] r*h operand

  const int j = threadIdx.x;  // unit column; blockDim.x == U
  const int row0 = blockIdx.x * TB;

  // unrolled so that many loads are in flight at once
#pragma unroll 16
  for (int i = j; i < 2 * U * U; i += U) s_wgh[i] = wgh[i];
#pragma unroll 16
  for (int i = j; i < U * U; i += U) s_wch[i] = wch[i];

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

  float h[TB];
  int len[TB];
  int t_end = 0;  // no row of the tile is alive at or past t_end
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const int b = row0 + r;
    h[r] = b < B ? port::to_float(h0[(size_t)b * U + j]) : 0.f;
    len[r] = b < B ? min(lengths[b], L) : 0;
    t_end = max(t_end, len[r]);
    s_h[j * TB + r] = port::round_to<T>(h[r]);
  }
  __syncthreads();

  for (int t = 0; t < t_end; ++t) {
    // this step's inputs do not depend on h: issue their loads first
    float gxr[TB], gxu[TB], cxv[TB], e1v[TB], e2v[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const int b = row0 + r;
      const size_t bt = (size_t)(b < B ? b : 0) * L + t;
      gxr[r] = port::to_float(gx[bt * 2 * U + j]);
      gxu[r] = port::to_float(gx[bt * 2 * U + U + j]);
      cxv[r] = port::to_float(cx[bt * U + j]);
      e1v[r] = MODE == MODE_PLAIN ? 0.f : port::to_float(e1[bt * U + j]);
      e2v[r] = MODE == MODE_PLAIN ? 0.f : port::to_float(e2[bt * U + j]);
    }

    float acc_r[TB], acc_u[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc_r[r] = acc_u[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < U; ++k) {
      const float w_r = port::to_float(s_wgh[k * 2 * U + j]);
      const float w_u = port::to_float(s_wgh[k * 2 * U + U + j]);
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float hk = s_h[k * TB + r];
        acc_r[r] = fmaf(hk, w_r, acc_r[r]);
        acc_u[r] = fmaf(hk, w_u, acc_u[r]);
      }
    }
    float u_gate[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float r_gate = port::sigmoid(gxr[r] + acc_r[r] + bg_r);
      u_gate[r] = port::sigmoid(gxu[r] + acc_u[r] + bg_u);
      s_rh[j * TB + r] = port::round_to<T>(r_gate * h[r]);
    }
    __syncthreads();

    float acc_c[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc_c[r] = 0.f;
#pragma unroll 4
    for (int k = 0; k < U; ++k) {
      const float w_c = port::to_float(s_wch[k * U + j]);
#pragma unroll
      for (int r = 0; r < TB; ++r) acc_c[r] = fmaf(s_rh[k * TB + r], w_c, acc_c[r]);
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const float cand = tanhf(cxv[r] + acc_c[r] + bc_j);
      const float u = u_gate[r];
      float new_h;
      if (MODE == MODE_PLAIN) {
        new_h = u * h[r] + (1.f - u) * cand;
      } else if (MODE == MODE_TSEQREC) {
        new_h = u * h[r] * e1v[r] + (1.f - u) * cand * e2v[r];
      } else {
        const float weight = fmaxf(e1v[r] + h[r] * v0, 0.f);
        const float ts = port::sigmoid(v1 * weight + v2 * e2v[r] + v3);
        new_h = u * h[r] + (1.f - u) * cand * ts;
      }
      const bool alive = t < len[r];
      const int b = row0 + r;
      if (b < B) out[((size_t)b * L + t) * U + j] = alive ? new_h : 0.f;
      if (alive) h[r] = new_h;
      s_h[j * TB + r] = port::round_to<T>(h[r]);
    }
    __syncthreads();
  }

  for (int t = t_end; t < L; ++t) {
#pragma unroll
    for (int r = 0; r < TB; ++r) {
      const int b = row0 + r;
      if (b < B) out[((size_t)b * L + t) * U + j] = 0.f;
    }
  }
}

size_t smem_bytes(int U, int tb, size_t elem) {
  return 3 * (size_t)U * U * elem + 2 * (size_t)U * tb * sizeof(float);
}

// Rows per block for a batch of B on `device`: the smallest of 1, 2, 4, 8
// whose grid fits in one wave of SMs (8 beyond that).
int rows_per_block(int B, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 132;
  int tb = 1;
  while (tb < 8 && (B + tb - 1) / tb > sms) tb *= 2;
  return tb;
}

template <typename T, int MODE, int TB>
cudaError_t launch(const void* gx, const void* cx, const void* e1,
                   const void* e2, const int* lengths, const void* h0,
                   const void* wgh, const void* wch, const void* bg,
                   const void* bc, const void* vecs, float* out, int B, int L,
                   int U, cudaStream_t stream) {
  auto kernel = gru_scan_kernel<T, MODE, TB>;
  const size_t smem = smem_bytes(U, TB, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + TB - 1) / TB;
  kernel<<<grid, U, smem, stream>>>(
      static_cast<const T*>(gx), static_cast<const T*>(cx),
      static_cast<const T*>(e1), static_cast<const T*>(e2), lengths,
      static_cast<const T*>(h0), static_cast<const T*>(wgh),
      static_cast<const T*>(wch), static_cast<const T*>(bg),
      static_cast<const T*>(bc), static_cast<const T*>(vecs), out, B, L, U);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_tb(int tb, const void* gx, const void* cx, const void* e1,
                      const void* e2, const int* lengths, const void* h0,
                      const void* wgh, const void* wch, const void* bg,
                      const void* bc, const void* vecs, float* out, int B,
                      int L, int U, cudaStream_t stream) {
#define PORT_GRU_LAUNCH(TBV)                                                 \
  launch<T, MODE, TBV>(gx, cx, e1, e2, lengths, h0, wgh, wch, bg, bc, vecs, \
                       out, B, L, U, stream)
  switch (tb) {
    case 1: return PORT_GRU_LAUNCH(1);
    case 2: return PORT_GRU_LAUNCH(2);
    case 4: return PORT_GRU_LAUNCH(4);
    default: return PORT_GRU_LAUNCH(8);
  }
#undef PORT_GRU_LAUNCH
}

template <typename T>
cudaError_t launch_mode(int mode, int tb, const void* gx, const void* cx,
                        const void* e1, const void* e2, const int* lengths,
                        const void* h0, const void* wgh, const void* wch,
                        const void* bg, const void* bc, const void* vecs,
                        float* out, int B, int L, int U, cudaStream_t stream) {
  switch (mode) {
    case MODE_PLAIN:
      return launch_tb<T, MODE_PLAIN>(tb, gx, cx, e1, e2, lengths, h0, wgh,
                                      wch, bg, bc, vecs, out, B, L, U, stream);
    case MODE_TSEQREC:
      return launch_tb<T, MODE_TSEQREC>(tb, gx, cx, e1, e2, lengths, h0, wgh,
                                        wch, bg, bc, vecs, out, B, L, U,
                                        stream);
    case MODE_TGRU:
      return launch_tb<T, MODE_TGRU>(tb, gx, cx, e1, e2, lengths, h0, wgh,
                                     wch, bg, bc, vecs, out, B, L, U, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest dynamic shared memory a launch may ask for (TB = 8); the
// wrapper refuses widths whose weights do not fit.
extern "C" long long gru_scan_smem_bytes(int U, int is_bf16) {
  return (long long)smem_bytes(U, 8, is_bf16 ? 2 : 4);
}

// All pointers are device pointers to contiguous arrays:
// gx [B,L,2U], cx/e1/e2 [B,L,U], lengths [B] int32, h0 [B,U],
// wgh [U,2U], wch [U,U], bg [2U], bc [U], vecs [4,U], out [B,L,U] f32.
// The floating inputs are all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int gru_scan_launch(int mode, int is_bf16, const void* gx,
                               const void* cx, const void* e1, const void* e2,
                               const void* lengths, const void* h0,
                               const void* wgh, const void* wch,
                               const void* bg, const void* bc,
                               const void* vecs, void* out, int B, int L,
                               int U, int device, void* stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int tb = rows_per_block(B, device);
  const int* len = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_mode<__nv_bfloat16>(mode, tb, gx, cx, e1, e2, len, h0, wgh,
                                      wch, bg, bc, vecs, o, B, L, U, s);
  return launch_mode<float>(mode, tb, gx, cx, e1, e2, len, h0, wgh, wch, bg,
                            bc, vecs, o, B, L, U, s);
}
