// MTAM's fused multi-hop readout, forward: every hop of the Tq=1
// time-aware attention over a row's behaviour memory, projections
// included (the hop's algebra is in readout_hop.cuh).
//
// Replaces: mtamrecommender_tpu/ops/pallas/readout_kernel.py,
// _readout_kernel (body _hop_forward), launched by _readout_fwd.
// Returns the last hop's output, f32 [B, D].
//
// What bounds it: operations.  Per row and hop the K and V projections
// are 4 L D^2 FLOPs against L D input values: at B=64, L=512, D=128, 3 hops
// that is 6.4 GFLOP for 8.4 MB (bf16) of memory, well above the card's
// FLOP-per-byte line in f32 and bf16 alike.
//
// Two designs, chosen by the caller; neither uses float atomics, so the
// same inputs give the same bits.
//
// "gemm" (the default).  K_i = relu(mem Wk_i + bk_i) and V_i do not
// depend on the hop's query: only the O(L D) vector work of each hop has
// to wait for the previous hop's softmax.  So the projections leave the
// row and become one matrix product over all B*L keys on every SM, and
// the chain from hop to hop runs a row a block on vector work alone.
// Two launches:
//  1. proj (readout_gemm.cuh, shared with the backward): KV = relu(mem
//     [B*L, D] @ [Wk_0 .. Wk_n-1, Wv_0 .. Wv_n-1] + bias), M = B*L, N =
//     2nD, K = D, rounded to T into the workspace [2, n, B, L, D]
//     (tile_gemm.cuh: mma.sync on the tensor cores in bf16, 8 x 8
//     register tiles of FMA in f32).  It computes every key; the chain
//     reads K only at the live keys and V only at the reached ones.
//  2. chain: one block of 256 threads a row, D a template argument.  Per
//     hop: q and u (query_side), q . K_l and u . mem_l over the live keys
//     (row_dots), the time gate and the scores, the softmax over L, o =
//     sum_l w_l V_l over the reached keys (weighted_sums), then residual
//     and LN into the next hop's query.  It is the backward's forward
//     replay (fused_readout_bwd.cu) without its per-key cache.
// The workspace is 2 n B L D elements of T: 50.3 MB in bf16 at B=64,
// L=512, D=128, 3 hops.
//
// "rows" (the first design, kept for comparison): one block of 256
// threads per batch row runs every hop, projections included.  A row's K
// and V at L=1024 do not fit in shared memory, so keys stream through it
// 64 at a time, twice per hop: the first pass projects K and keeps only
// the [L] f32 scores, the second projects V and accumulates the weighted
// sum.  The current weight matrix (f32, 64 KB at D=128) stays in shared
// memory during its pass; each warp computes 8 chunk rows x 128 columns
// with FMA on CUDA cores.  At B=64 that is 64 busy SMs of 132, and 1 at
// B=1.

#include "readout_gemm.cuh"

namespace {

using readout::HopSmem;
using readout::kThreads;
using readout::kWarps;
using readout::Params;

// the designs, in the order of the C interface's `design`
enum { DESIGN_GEMM = 0, DESIGN_ROWS, kDesigns };

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// ------------------------------------------------------------ design "rows"

size_t rows_smem_floats(int L, int D) {
  return (size_t)D * D + 2 * (size_t)readout::kChunk * D + L + 4 * (size_t)D;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_readout_kernel(Params p, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  const int D = p.D, b = blockIdx.x;
  HopSmem sm;
  sm.w = smem;
  sm.m = sm.w + (size_t)D * D;
  sm.p = sm.m + readout::kChunk * D;
  sm.s = sm.p + readout::kChunk * D;
  sm.dec = sm.s + p.L;
  sm.decr = sm.dec + D;
  sm.q = sm.decr + D;
  sm.u = sm.q + D;
  readout::load_f32(sm.dec, readout::ptr<T>(p.dec) + (size_t)b * D, D);
  __syncthreads();
  for (int i = 0; i < p.n; ++i)
    readout::hop_forward<T>(p, i, b, sm, red, (T*)nullptr, (T*)nullptr);
  for (int e = threadIdx.x; e < D; e += kThreads)
    out[(size_t)b * D + e] = sm.dec[e];
}

template <typename T>
cudaError_t run_rows(const Params& p, float* out, cudaStream_t stream) {
  const size_t smem = rows_smem_floats(p.L, p.D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_readout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_readout_kernel<T><<<p.B, kThreads, smem, stream>>>(p, out);
  return cudaGetLastError();
}

// ------------------------------------------------------------ design "gemm"

size_t chain_smem_floats(int L, int D) {
  return 4 * (size_t)D + 2 * (size_t)L;
}

// The hops of row b from the projected planes kv [2, n, B, L, D]: K of
// hop i is plane i, V plane n + i.  Writes the last hop's output.  The
// launch bounds ask for one block an SM: without that minimum ptxas kept
// 64 registers at D=32 and spilled.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) readout_fwd_chain_kernel(
    Params p, const T* __restrict__ kv, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  __shared__ float scratch[2 * kThreads];
  const int L = p.L, b = blockIdx.x, tid = threadIdx.x;
  HopSmem sm;                      // the query side's slots only
  sm.dec = smem;                   // [D] the hop's input, then its output
  sm.decr = sm.dec + D;
  sm.q = sm.decr + D;
  sm.u = sm.q + D;
  float* s_w = sm.u + D;           // [L] scores, then softmax weights
  float* s_t = s_w + L;            // [L] u . mem_l
  const int live = readout::live_keys(p, b);
  const int span = readout::span_keys(live, L);
  const T* mem = readout::ptr<T>(p.mem) + (size_t)b * L * D;
  const size_t M = (size_t)p.B * L;
  const float qz = p.qmask[b];

  readout::load_f32(sm.dec, readout::ptr<T>(p.dec) + (size_t)b * D, D);
  __syncthreads();
  for (int i = 0; i < p.n; ++i) {
    const T* K = kv + ((size_t)i * M + (size_t)b * L) * D;
    const T* V = kv + ((size_t)(p.n + i) * M + (size_t)b * L) * D;
    readout::query_side<T>(p, i, sm);
    readout::row_dots<D, 2>(sm.q, K, sm.u, mem, live,
                            [&](int c, float a, float t) {
                              s_w[c] = a;
                              s_t[c] = t;
                            });
    __syncthreads();
    for (int c = tid; c < L; c += kThreads)
      s_w[c] = c < live
                   ? s_w[c] * readout::gate_terms(p, i, b, c, s_t[c]).sig *
                         p.scale
                   : readout::kNegFill;
    __syncthreads();
    readout::softmax_inplace(s_w, L, red);
    float o[1];
    readout::weighted_sums<D, 1>(s_w, V, s_w, V, span, scratch, o);

    // residual + normalize over the dl live lanes (the query mask touches
    // o only; a padded lane's x is 0 and its dx is set to 0)
    const float x = tid < D ? o[0] * qz + sm.dec[tid] : 0.f;
    const float mean = port::block_sum<kThreads>(x, red) / p.dl;
    const float dx = tid < p.dl ? x - mean : 0.f;
    const float var = port::block_sum<kThreads>(dx * dx, red) / p.dl;
    const float inv = 1.f / sqrtf(var + readout::kLnEps);
    if (tid < D)
      sm.dec[tid] =
          dx * inv * port::to_float(readout::ptr<T>(p.lng)[i * D + tid]) +
          port::to_float(readout::ptr<T>(p.lnb)[i * D + tid]);
    __syncthreads();
  }
  if (tid < D) out[(size_t)b * D + tid] = sm.dec[tid];
}

template <typename T, int D>
cudaError_t launch_chain(const Params& p, const T* kv, float* out,
                         cudaStream_t stream) {
  const size_t smem = chain_smem_floats(p.L, D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      readout_fwd_chain_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  readout_fwd_chain_kernel<T, D><<<p.B, kThreads, smem, stream>>>(p, kv,
                                                                  out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_gemm(const Params& p, float* out, void* ws,
                     cudaStream_t stream) {
  const int D = p.D, n = p.n, M = p.B * p.L;
  T* kv = static_cast<T*>(ws);
  cudaError_t err = readout::launch_product<T>(
      readout::readout_proj_kernel<T>,
      dim3(cdiv(M, tile::kBM), cdiv(2 * n * D, tile::kBN)),
      readout::ProjGemm<T>{static_cast<const T*>(p.mem),
                           static_cast<const T*>(p.wk),
                           static_cast<const T*>(p.wv),
                           static_cast<const T*>(p.bk),
                           static_cast<const T*>(p.bv), kv, M, D, n},
      stream);
  if (err != cudaSuccess) return err;
  switch (D) {
    case 32: return launch_chain<T, 32>(p, kv, out, stream);
    case 64: return launch_chain<T, 64>(p, kv, out, stream);
    case 128: return launch_chain<T, 128>(p, kv, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The most dynamic shared memory one of the design's kernels takes, in
// bytes (design: 0 "gemm", 1 "rows"; -1 for another value).
extern "C" long long fused_readout_smem_bytes(int L, int D, int n,
                                              int design) {
  (void)n;
  if (design == DESIGN_ROWS)
    return (long long)(rows_smem_floats(L, D) * sizeof(float));
  if (design != DESIGN_GEMM) return -1;
  const size_t chain = chain_smem_floats(L, D) * sizeof(float);
  const size_t most = tile::fma_smem_bytes() > tile::mma_smem_bytes()
                          ? tile::fma_smem_bytes() : tile::mma_smem_bytes();
  return (long long)(chain > most ? chain : most);
}

// Workspace bytes the launch needs (the gemm design's K and V planes; 0
// for the rows design).
extern "C" long long fused_readout_workspace_bytes(int B, int L, int D,
                                                   int n, int is_bf16,
                                                   int design) {
  if (design != DESIGN_GEMM || B <= 0) return 0;
  return 2LL * n * B * L * D * (is_bf16 ? 2 : 4);
}

// All pointers are device pointers to contiguous arrays: mem [B,L,D], dec
// [B,D], wq/wk/wv/wt [n,D,D], bq/bk/bv/lng/lnb [n,D], all f32 (is_bf16 =
// 0) or all bf16 (is_bf16 = 1); logdt [B,L], qmask [B] and
// w1/b1/wo1/wo2/bo [n,L] f32; key_len [B] int32; out [B,D] f32; ws the
// workspace of fused_readout_workspace_bytes, mem, wk and wv 16-byte
// aligned in the gemm design.  D is 32, 64 or 128; dl the live width (1
// <= dl <= D, the operands zero-padded past it; dl == D in the rows
// design); design 0 "gemm", 1 "rows".  Returns the first cudaError_t of
// the launches (0 on success).
extern "C" int fused_readout_launch(
    int is_bf16, int design, const void* mem, const void* dec,
    const void* logdt, const void* key_len, const void* qmask, const void* wq,
    const void* bq, const void* wk, const void* bk, const void* wv,
    const void* bv, const void* wt, const void* w1, const void* b1,
    const void* wo1, const void* wo2, const void* bo, const void* lng,
    const void* lnb, void* out, void* ws, int B, int L, int D, int n, int dl,
    float scale, int device, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (L <= 0 || n <= 0 || D <= 0 || D > readout::kMaxD || D % 32 ||
      design < 0 || design >= kDesigns ||
      (design == DESIGN_GEMM && D != 32 && D != 64 && D != 128) ||
      dl < 1 || dl > D || (design == DESIGN_ROWS && dl != D))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Params p;
  p.mem = mem; p.dec = dec;
  p.logdt = static_cast<const float*>(logdt);
  p.key_len = static_cast<const int*>(key_len);
  p.qmask = static_cast<const float*>(qmask);
  p.wq = wq; p.bq = bq; p.wk = wk; p.bk = bk; p.wv = wv; p.bv = bv; p.wt = wt;
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.wo1 = static_cast<const float*>(wo1);
  p.wo2 = static_cast<const float*>(wo2);
  p.bo = static_cast<const float*>(bo);
  p.lng = lng; p.lnb = lnb;
  p.B = B; p.L = L; p.D = D; p.n = n; p.dl = dl;
  p.scale = scale;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == DESIGN_ROWS)
    return is_bf16 ? run_rows<__nv_bfloat16>(p, o, s)
                   : run_rows<float>(p, o, s);
  return is_bf16 ? run_gemm<__nv_bfloat16>(p, o, ws, s)
                 : run_gemm<float>(p, o, ws, s);
}
