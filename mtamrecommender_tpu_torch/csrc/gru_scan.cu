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
// between them.  At B=64, L=2048, U=128 the bytes need ~0.07 ms (bf16) at
// 3.35 TB/s and the FLOPs ~0.19 ms (f32) at 67 TFLOP/s, spread over 2048
// steps: 0.03-0.09 us a step.  What sets the time is how long one step of
// the chain takes.
//
// The TPU kernel carried h from one grid step to the next in VMEM scratch
// over a sequential time-chunk grid axis.  Hopper blocks run in no order,
// so here the whole time loop runs inside one block that owns TB batch
// rows.  The products run on the f32 FMA units: TF32 tensor cores would
// lose the f32 parity the port is held to, and an mma tile's 16 rows would
// leave most SMs idle at B=64.
//
// Design "sliced" (the default for U a multiple of 32 up to 128, which
// covers every preset): a block holds TB rows and 4U threads.  Thread
// (j, s) sums the quarter s of k (U/4 values) for unit j, both gate
// columns (j and U+j) of the first product and column j of the second,
// for all TB rows; the four partials go through shared memory and the
// owner adds them in slice order, so no thread runs a chain of more than
// U/4 FMAs and the same inputs give the same bits.  Thread (j, s < TB)
// owns row s's elementwise work and keeps its h in a register.  Four
// barriers a step: (1) partials of op(h) W_gh; (2) the owner's gates,
// op(r*h) to shared memory; (3) partials of op(r*h) W_ch; (4) the owner's
// candidate, head, output and op(h').  Each thread converts its slices of
// W_gh and W_ch to f32 once, into registers (3U/4 floats: 96 at U=128),
// so the k-loops read only their operand from shared memory, a 16-byte
// broadcast a warp, and bf16 runs the same chain as f32.  The biases and
// the tgru vectors sit in shared memory.  A step's inputs (gx, cx, e1, e2)
// do not depend on h: cp.async copies them into a ring of kRing steps in
// shared memory, kRing - 1 steps ahead of the chain.  TB is the smallest
// of 1, 2, 4 that keeps the grid within one wave of SMs (B=64: 64 blocks
// of one row; B=256: 128 blocks of two).  Options measured on the H100
// and not taken (PERF.md): W_ch in shared memory as f32 instead of
// registers (a fifth slower a step); U at run time, with the register
// arrays sized for 128 (4-44 spill bytes at 128 registers); tgru's time
// gate computed in the step's first phase, with the next step's inputs
// waited for at the end of the step (6 % slower).
//
// Design "unit_column" (the earlier one): U threads a block, thread
// j owns unit column j of TB rows (the smallest of 1, 2, 4, 8 within one
// wave) and runs both products over all U values of k alone, W_gh and W_ch
// staged in shared memory in the input type (196 KB in f32 at U=128) and
// converted at every FMA.  It takes the widths above 128 that the sliced
// design does not (bf16 up to 160), and is forced for comparison only.

#include "common.cuh"

namespace {

enum { MODE_PLAIN = 0, MODE_TSEQREC = 1, MODE_TGRU = 2 };
enum { DESIGN_SLICED = 0, DESIGN_UNIT_COLUMN = 1 };
constexpr int kSlices = 4;   // sliced: k-slices a product
constexpr int kRing = 8;     // sliced: steps of inputs in the cp.async ring

struct Args {
  const void *gx, *cx, *e1, *e2, *h0, *wgh, *wch, *bg, *bc, *vecs;
  const int* lengths;
  float* out;
  int B, L, U;
  cudaStream_t stream;
};

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

// --------------------------------------------------- design "sliced"

// Copy step t's inputs of the block's rows into `slot` ([TB][5U]: gx, cx,
// e1, e2) by cp.async, 16 bytes a thread at a time (e1 and e2 only where
// the mode reads them).  The caller commits the group.
template <typename T, int MODE, int TB, int U>
__device__ __forceinline__ void stage_step(T* slot, int t, int row0, int B,
                                           int L, const T* gx, const T* cx,
                                           const T* e1, const T* e2) {
  constexpr int E = 16 / sizeof(T);   // elements a 16-byte piece
  constexpr int n_u = U / E, n_gx = 2 * n_u;
  constexpr int per_row = n_gx + n_u + (MODE == MODE_PLAIN ? 0 : 2 * n_u);
  for (int c = threadIdx.x; c < TB * per_row; c += kSlices * U) {
    const int r = c / per_row, q = c % per_row, b = row0 + r;
    if (b >= B) continue;
    const size_t bt = (size_t)b * L + t;
    const T* src;
    if (q < n_gx)
      src = gx + bt * 2 * U + q * E;
    else if (q < n_gx + n_u)
      src = cx + bt * U + (q - n_gx) * E;
    else if (q < n_gx + 2 * n_u)
      src = e1 + bt * U + (q - n_gx - n_u) * E;
    else
      src = e2 + bt * U + (q - n_gx - 2 * n_u) * E;
    cp_async16(slot + r * 5 * U + q * E, src);
  }
}

// The slice's partial sum of x[k] * w[k] (x in shared memory, read as
// 16-byte broadcasts; w in registers), two accumulators.
template <int KS>
__device__ __forceinline__ float slice_dot(const float* x,
                                           const float (&w)[KS]) {
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + k);
    a0 = fmaf(xv.x, w[k], a0);
    a1 = fmaf(xv.y, w[k + 1], a1);
    a0 = fmaf(xv.z, w[k + 2], a0);
    a1 = fmaf(xv.w, w[k + 3], a1);
  }
  return a0 + a1;
}

// slice_dot for the two gate columns at once: one operand read, four chains.
template <int KS>
__device__ __forceinline__ void slice_dot2(const float* x,
                                           const float (&wa)[KS],
                                           const float (&wb)[KS], float& pa,
                                           float& pb) {
  float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
#pragma unroll
  for (int k = 0; k < KS; k += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + k);
    a0 = fmaf(xv.x, wa[k], a0);
    a1 = fmaf(xv.y, wa[k + 1], a1);
    b0 = fmaf(xv.x, wb[k], b0);
    b1 = fmaf(xv.y, wb[k + 1], b1);
    a0 = fmaf(xv.z, wa[k + 2], a0);
    a1 = fmaf(xv.w, wa[k + 3], a1);
    b0 = fmaf(xv.z, wb[k + 2], b0);
    b1 = fmaf(xv.w, wb[k + 3], b1);
  }
  pa = a0 + a1;
  pb = b0 + b1;
}

// U is a template argument (32, 64, 96 or 128): the slices' register
// arrays take their exact size and every shared-memory offset folds into
// its instruction.
template <typename T, int MODE, int TB, int U>
__global__ void __launch_bounds__(kSlices * U, 1) gru_scan_kernel(
    const T* __restrict__ gx, const T* __restrict__ cx,
    const T* __restrict__ e1, const T* __restrict__ e2,
    const int* __restrict__ lengths, const T* __restrict__ h0,
    const T* __restrict__ wgh, const T* __restrict__ wch,
    const T* __restrict__ bg, const T* __restrict__ bc,
    const T* __restrict__ vecs, float* __restrict__ out, int B, int L) {
  constexpr int KS = U / kSlices;   // k values a slice
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_part = reinterpret_cast<float*>(smem);   // [kSlices][TB][2U]
  float* s_h = s_part + kSlices * TB * 2 * U;       // [TB][U] op(h)
  float* s_rh = s_h + TB * U;                       // [TB][U] op(r*h)
  float* s_vec = s_rh + TB * U;                     // b_g | b_c | vecs: 7U
  T* ring = reinterpret_cast<T*>(s_vec + 7 * U);    // [kRing][TB][5U]

  const int j = threadIdx.x % U;   // unit
  const int s = threadIdx.x / U;   // k-slice; the row it owns if s < TB
  const int row0 = blockIdx.x * TB;
  const int b = row0 + s;
  const bool own = s < TB && b < B;
  int t_end = 0;   // no row of the block is alive at or past t_end
#pragma unroll
  for (int r = 0; r < TB; ++r)
    if (row0 + r < B) t_end = max(t_end, min(lengths[row0 + r], L));

  // the first kRing - 1 steps' inputs in flight before anything else
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < t_end)
      stage_step<T, MODE, TB, U>(ring + q * TB * 5 * U, q, row0, B, L, gx,
                                 cx, e1, e2);
    cp_async_commit();
  }

  // this thread's slices of W_gh's columns j and U+j and W_ch's column j,
  // converted to f32 once
  float wr[KS], wu[KS], wc[KS];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int k = s * KS + i;
    wr[i] = port::to_float(wgh[k * 2 * U + j]);
    wu[i] = port::to_float(wgh[k * 2 * U + U + j]);
    wc[i] = port::to_float(wch[k * U + j]);
  }
  for (int i = threadIdx.x; i < 7 * U; i += kSlices * U)
    s_vec[i] = port::to_float(i < 2 * U   ? bg[i]
                              : i < 3 * U ? bc[i - 2 * U]
                                          : vecs[i - 3 * U]);

  float h = 0.f;   // the owner's state (0 for a padding row)
  const int len = own ? min(lengths[b], L) : 0;
  if (s < TB) {
    if (own) h = port::to_float(h0[(size_t)b * U + j]);
    s_h[s * U + j] = port::round_to<T>(h);
    s_rh[s * U + j] = 0.f;
  }
  __syncthreads();

  const int me = s < TB ? s : 0;   // the row whose inputs this thread reads
  for (int t = 0; t < t_end; ++t) {
    // the slot step t - 1 read takes step t + kRing - 1
    {
      const int tn = t + kRing - 1;
      if (tn < t_end)
        stage_step<T, MODE, TB, U>(ring + (tn % kRing) * TB * 5 * U, tn,
                                   row0, B, L, gx, cx, e1, e2);
      cp_async_commit();
    }

    // (1) partials of op(h) W_gh over slice s, every row
#pragma unroll 1
    for (int r = 0; r < TB; ++r) {
      float pr, pu;
      slice_dot2<KS>(s_h + r * U + s * KS, wr, wu, pr, pu);
      s_part[(s * TB + r) * 2 * U + j] = pr;
      s_part[(s * TB + r) * 2 * U + U + j] = pu;
    }
    cp_async_wait_group<kRing - 1>();   // step t's inputs (this thread's)
    __syncthreads();

    const T* in = ring + ((t % kRing) * TB + me) * 5 * U;
    // (2) the gates, the slices added in order
    float ug = 0.f;
    if (s < TB) {
      float pr = 0.f, pu = 0.f;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) {
        pr += s_part[(q * TB + s) * 2 * U + j];
        pu += s_part[(q * TB + s) * 2 * U + U + j];
      }
      const float gxr = own ? port::to_float(in[j]) : 0.f;
      const float gxu = own ? port::to_float(in[U + j]) : 0.f;
      const float rg = port::sigmoid(gxr + pr + s_vec[j]);
      ug = port::sigmoid(gxu + pu + s_vec[U + j]);
      s_rh[s * U + j] = port::round_to<T>(rg * h);
    }
    __syncthreads();

    // (3) partials of op(r*h) W_ch over slice s, every row
#pragma unroll 1
    for (int r = 0; r < TB; ++r)
      s_part[(s * TB + r) * 2 * U + j] =
          slice_dot<KS>(s_rh + r * U + s * KS, wc);
    __syncthreads();

    // (4) the candidate, the mode's head, the output and the state
    if (s < TB) {
      float pc = 0.f;
#pragma unroll
      for (int q = 0; q < kSlices; ++q) pc += s_part[(q * TB + s) * 2 * U + j];
      const float cxv = own ? port::to_float(in[2 * U + j]) : 0.f;
      const float cand = tanhf(cxv + pc + s_vec[2 * U + j]);
      float new_h;
      if (MODE == MODE_PLAIN) {
        new_h = ug * h + (1.f - ug) * cand;
      } else {
        const float e1v = own ? port::to_float(in[3 * U + j]) : 0.f;
        const float e2v = own ? port::to_float(in[4 * U + j]) : 0.f;
        if (MODE == MODE_TSEQREC) {
          new_h = ug * h * e1v + (1.f - ug) * cand * e2v;
        } else {
          const float* v = s_vec + 3 * U;
          const float weight = fmaxf(e1v + h * v[j], 0.f);
          const float ts =
              port::sigmoid(v[U + j] * weight + v[2 * U + j] * e2v +
                            v[3 * U + j]);
          new_h = ug * h + (1.f - ug) * cand * ts;
        }
      }
      const bool alive = t < len;
      if (own) out[((size_t)b * L + t) * U + j] = alive ? new_h : 0.f;
      if (alive) h = new_h;
      s_h[s * U + j] = port::round_to<T>(h);
    }
    __syncthreads();
  }
  cp_async_wait_all();

  if (own)
    for (int t = t_end; t < L; ++t) out[((size_t)b * L + t) * U + j] = 0.f;
}

size_t sliced_smem_bytes(int U, int tb, size_t elem) {
  return (size_t)(kSlices * tb * 2 * U + 2 * tb * U + 7 * U) * sizeof(float) +
         (size_t)kRing * tb * 5 * U * elem;
}

// ---------------------------------------------- design "unit_column"

template <typename T, int MODE, int TB>
__global__ void __launch_bounds__(512) unit_column_kernel(
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

size_t unit_column_smem_bytes(int U, int tb, size_t elem) {
  return 3 * (size_t)U * U * elem + 2 * (size_t)U * tb * sizeof(float);
}

// ------------------------------------------------------------ launch

// Rows per block for a batch of B on `device`: the smallest power of two
// up to `most` whose grid fits in one wave of SMs (`most` beyond that).
int rows_per_block(int B, int device, int most) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    sms = 132;
  int tb = 1;
  while (tb < most && (B + tb - 1) / tb > sms) tb *= 2;
  return tb;
}

template <typename T, int MODE, int TB, int U>
cudaError_t launch_sliced(const Args& a) {
  auto kernel = gru_scan_kernel<T, MODE, TB, U>;
  const size_t smem = sliced_smem_bytes(U, TB, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + TB - 1) / TB, kSlices * U, smem, a.stream>>>(
      static_cast<const T*>(a.gx), static_cast<const T*>(a.cx),
      static_cast<const T*>(a.e1), static_cast<const T*>(a.e2), a.lengths,
      static_cast<const T*>(a.h0), static_cast<const T*>(a.wgh),
      static_cast<const T*>(a.wch), static_cast<const T*>(a.bg),
      static_cast<const T*>(a.bc), static_cast<const T*>(a.vecs), a.out, a.B,
      a.L);
  return cudaGetLastError();
}

template <typename T, int MODE, int TB>
cudaError_t launch_sliced_u(const Args& a) {
  switch (a.U) {
    case 32: return launch_sliced<T, MODE, TB, 32>(a);
    case 64: return launch_sliced<T, MODE, TB, 64>(a);
    case 96: return launch_sliced<T, MODE, TB, 96>(a);
    case 128: return launch_sliced<T, MODE, TB, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int MODE, int TB>
cudaError_t launch_unit_column(const Args& a) {
  auto kernel = unit_column_kernel<T, MODE, TB>;
  const size_t smem = unit_column_smem_bytes(a.U, TB, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(a.B + TB - 1) / TB, a.U, smem, a.stream>>>(
      static_cast<const T*>(a.gx), static_cast<const T*>(a.cx),
      static_cast<const T*>(a.e1), static_cast<const T*>(a.e2), a.lengths,
      static_cast<const T*>(a.h0), static_cast<const T*>(a.wgh),
      static_cast<const T*>(a.wch), static_cast<const T*>(a.bg),
      static_cast<const T*>(a.bc), static_cast<const T*>(a.vecs), a.out, a.B,
      a.L, a.U);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_tb(int design, int tb, const Args& a) {
  if (design == DESIGN_SLICED) {
    switch (tb) {
      case 1: return launch_sliced_u<T, MODE, 1>(a);
      case 2: return launch_sliced_u<T, MODE, 2>(a);
      default: return launch_sliced_u<T, MODE, 4>(a);
    }
  }
  switch (tb) {
    case 1: return launch_unit_column<T, MODE, 1>(a);
    case 2: return launch_unit_column<T, MODE, 2>(a);
    case 4: return launch_unit_column<T, MODE, 4>(a);
    default: return launch_unit_column<T, MODE, 8>(a);
  }
}

template <typename T>
cudaError_t launch_mode(int mode, int design, int tb, const Args& a) {
  switch (mode) {
    case MODE_PLAIN: return launch_tb<T, MODE_PLAIN>(design, tb, a);
    case MODE_TSEQREC: return launch_tb<T, MODE_TSEQREC>(design, tb, a);
    case MODE_TGRU: return launch_tb<T, MODE_TGRU>(design, tb, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Largest dynamic shared memory a launch of `design` (0: sliced, 1:
// unit_column) may ask for at width U; the wrapper refuses widths whose
// weights do not fit.
extern "C" long long gru_scan_smem_bytes(int U, int is_bf16, int design) {
  const size_t elem = is_bf16 ? 2 : 4;
  return (long long)(design == DESIGN_SLICED ? sliced_smem_bytes(U, 4, elem)
                                             : unit_column_smem_bytes(U, 8,
                                                                      elem));
}

// All pointers are device pointers to contiguous arrays:
// gx [B,L,2U], cx/e1/e2 [B,L,U], lengths [B] int32, h0 [B,U],
// wgh [U,2U], wch [U,U], bg [2U], bc [U], vecs [4,U], out [B,L,U] f32.
// The floating inputs are all f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1).
// design: 0 sliced (U a multiple of 32 up to 128; gx, cx, e1 and e2 on
// 16-byte boundaries), 1 unit_column.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int gru_scan_launch(int mode, int is_bf16, int design,
                               const void* gx, const void* cx, const void* e1,
                               const void* e2, const void* lengths,
                               const void* h0, const void* wgh,
                               const void* wch, const void* bg,
                               const void* bc, const void* vecs, void* out,
                               int B, int L, int U, int device, void* stream) {
  if (B <= 0 || L <= 0) return cudaSuccess;
  if (design != DESIGN_SLICED && design != DESIGN_UNIT_COLUMN)
    return cudaErrorInvalidValue;
  if (design == DESIGN_SLICED) {
    if (U % 32 || U < 32 || U > 128) return cudaErrorInvalidValue;
    if ((reinterpret_cast<size_t>(gx) | reinterpret_cast<size_t>(cx) |
         reinterpret_cast<size_t>(e1) | reinterpret_cast<size_t>(e2)) % 16)
      return cudaErrorMisalignedAddress;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.gx = gx; a.cx = cx; a.e1 = e1; a.e2 = e2; a.h0 = h0;
  a.wgh = wgh; a.wch = wch; a.bg = bg; a.bc = bc; a.vecs = vecs;
  a.lengths = static_cast<const int*>(lengths);
  a.out = static_cast<float*>(out);
  a.B = B; a.L = L; a.U = U;
  a.stream = static_cast<cudaStream_t>(stream);
  const int tb = rows_per_block(B, device, design == DESIGN_SLICED ? 4 : 8);
  if (is_bf16) return launch_mode<__nv_bfloat16>(mode, design, tb, a);
  return launch_mode<float>(mode, design, tb, a);
}
