// flash_attention.cu - blocked attention with an online softmax, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:75
// (flash_attention_kernel; body _flash_kernel at :26).  For each of BH
// heads, out = softmax(q k^T * scale [causal]) v, with q (Sq, hd), k
// (Skv, hd), v (Skv, hdv) in float32 or bfloat16 and the output in q's
// type.  The arithmetic is the TPU kernel's: q is cast to float32 and
// multiplied by the scale before the product; products, the running
// (max, sum, accumulator) and the softmax are float32 with IEEE expf; the
// causal mask is q_pos >= k_pos with no offset (masked scores are -1e30);
// the output is acc / max(l, 1e-30).  KV tiles wholly above the diagonal
// are skipped: every row has its k_pos = 0 entry in the first tile, so a
// skipped tile would only have multiplied the state by exp(0) and added
// zeros.
//
// What bounds it on an H100.  At the main path's shape (B*H = 4*16 heads,
// S = 2048, hd = 128, causal, bf16) the two products are 4*BH*S^2*hd/2 =
// 68.7 GFLOP: 0.069 ms at the 989 TFLOP/s of the bf16 tensor cores, while
// q, k, v and the output are 67 MB, 0.020 ms at 3.35 TB/s; operations
// bound it.  This kernel runs the products on the CUDA cores in float32,
// as the TPU kernel computes them, so its own floor is 68.7 GFLOP at 67
// TFLOP/s, about 1 ms.
//
// What the design does about it.  The TPU's sequential KV grid axis
// becomes a loop inside the block.  One block per (head, 64 query rows),
// heavy causal blocks first; four lanes a query row, each holding a
// quarter of the row's q (scaled, in registers) and of its accumulator,
// interleaved in 16-byte pieces so the four lanes read 64 contiguous bytes
// of shared memory.  K and V tiles of 64 rows are staged in shared memory
// as float32; a score is four partial dot products (fmaf: fused, as a
// matrix unit's products are) joined by two shuffles, so every lane of the
// row holds the same bits.  The tile's scores go to shared memory, the
// running max and sum are updated once a tile as in the TPU kernel, and
// the PV product reads p from shared memory.  Tensor cores (wgmma over
// bf16) would round q*scale and p to bf16, which the TPU kernel does not;
// they are for the PR that redesigns the kernel for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRows = 64;                 // query rows a block
constexpr int kLanes = 4;                 // lanes a query row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kTile = 64;                 // kv rows a shared-memory tile
constexpr int kScoreStride = kTile + 1;   // padded: rows hit distinct banks
constexpr float kNegInf = -1e30f;

// How a head dim of D floats is split over the four lanes of a row: lane c
// holds vectors i = 0..N-1 of VW floats at element VW * (c + 4 i).
template <int D>
struct Split {
  static constexpr int VW = (D % 16 == 0) ? 4 : 2;
  static constexpr int N = D / (kLanes * VW);
  static_assert(D % (kLanes * VW) == 0, "head dim must be a multiple of 8");
  __device__ static int at(int c, int i) { return VW * (c + kLanes * i); }
};

// One 16- or 8-byte shared-memory read of a lane's piece of a row.
__device__ __forceinline__ void lds(const float* p, float (&r)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x;
  r[1] = t.y;
  r[2] = t.z;
  r[3] = t.w;
}

__device__ __forceinline__ void lds(const float* p, float (&r)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  r[0] = t.x;
  r[1] = t.y;
}

__device__ __forceinline__ float load(const void* p, long long i,
                                      bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

template <int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int skv, float scale,
                           int causal, int bf16) {
  using SQ = Split<HD>;
  using SV = Split<HDV>;
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                    // (kTile, HD)
  float* sv = sk + kTile * HD;         // (kTile, HDV)
  float* ss = sv + kTile * HDV;        // (kRows, kScoreStride) scores, p

  // Heavy causal blocks (the last query rows) are issued first.
  const int n_q = (sq + kRows - 1) / kRows;
  const int head = blockIdx.x % bh;
  const int qb = n_q - 1 - static_cast<int>(blockIdx.x / bh);
  const int q0 = qb * kRows;
  const int row = threadIdx.x / kLanes;
  const int c = threadIdx.x % kLanes;
  const int qpos = q0 + row;
  const bool live = qpos < sq;
  const bool is_bf16 = bf16 != 0;

  // This lane's quarter of q, cast to float32 and scaled.
  float qr[SQ::N][SQ::VW];
  const long long qbase = (static_cast<long long>(head) * sq + qpos) * HD;
#pragma unroll
  for (int i = 0; i < SQ::N; ++i)
#pragma unroll
    for (int u = 0; u < SQ::VW; ++u)
      qr[i][u] = live ? load(q, qbase + SQ::at(c, i) + u, is_bf16) * scale
                      : 0.f;

  float acc[SV::N][SV::VW];
#pragma unroll
  for (int i = 0; i < SV::N; ++i)
#pragma unroll
    for (int u = 0; u < SV::VW; ++u) acc[i][u] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  float* srow = ss + row * kScoreStride;

  const int q_last = min(q0 + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const long long kvbase = static_cast<long long>(head) * skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    const int n = min(kTile, skv - kv0);
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < n * HD; e += kThreads)
      sk[e] = load(k, (kvbase + kv0) * HD + e, is_bf16);
    for (int e = threadIdx.x; e < n * HDV; e += kThreads)
      sv[e] = load(v, (kvbase + kv0) * HDV + e, is_bf16);
    __syncthreads();

    // Scores of this row against the tile; all four lanes get the same.
    float tmax = kNegInf;
    for (int j = 0; j < n; ++j) {
      const float* kr = sk + j * HD;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < SQ::N; ++i) {
        float kp[SQ::VW];
        lds(kr + SQ::at(c, i), kp);
#pragma unroll
        for (int u = 0; u < SQ::VW; ++u) part = fmaf(qr[i][u], kp[u], part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const float s = (causal && kv0 + j > qpos) ? kNegInf : part;
      if (c == 0) srow[j] = s;
      tmax = fmaxf(tmax, s);
    }
    __syncwarp();

    // The online softmax update, once a tile.
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    for (int j = c; j < n; j += kLanes) {
      const float p = expf(srow[j] - m_new);
      srow[j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < SV::N; ++i)
#pragma unroll
      for (int u = 0; u < SV::VW; ++u) acc[i][u] *= corr;
    for (int j = 0; j < n; ++j) {
      const float p = srow[j];
      const float* vr = sv + j * HDV;
#pragma unroll
      for (int i = 0; i < SV::N; ++i) {
        float vp[SV::VW];
        lds(vr + SV::at(c, i), vp);
#pragma unroll
        for (int u = 0; u < SV::VW; ++u) acc[i][u] = fmaf(p, vp[u], acc[i][u]);
      }
    }
    __syncwarp();  // srow is rewritten by the next tile
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
  const long long obase = (static_cast<long long>(head) * sq + qpos) * HDV;
#pragma unroll
  for (int i = 0; i < SV::N; ++i)
#pragma unroll
    for (int u = 0; u < SV::VW; ++u) {
      const float o = acc[i][u] / denom;
      const long long at = obase + SV::at(c, i) + u;
      if (is_bf16)
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(o);
      else
        static_cast<float*>(out)[at] = o;
    }
}

template <int HD, int HDV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, float scale, int causal,
                   int bf16, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(bh) * ((sq + kRows - 1) / kRows);
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (kTile * (HD + HDV) + kRows * kScoreStride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD, HDV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  flash_attention_kernel<HD, HDV>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          q, k, v, out, bh, sq, skv, scale, causal, bf16);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hdv(int hdv, const void* q, const void* k, const void* v,
                       void* out, int bh, int sq, int skv, float scale,
                       int causal, int bf16, cudaStream_t s) {
  switch (hdv) {
    case 8: return launch<HD, 8>(q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 16: return launch<HD, 16>(q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 32: return launch<HD, 32>(q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 64: return launch<HD, 64>(q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 128: return launch<HD, 128>(q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (bh, sq, hd), k (bh, skv, hd), v (bh, skv, hdv), out (bh, sq, hdv), all
// contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1); hd and hdv each
// one of 8, 16, 32, 64, 128.  Returns a cudaError_t (0 on success); the
// launch is asynchronous on `stream`.
extern "C" int flash_attention_launch(int device, const void* q,
                                      const void* k, const void* v,
                                      void* out, int bh, int sq, int skv,
                                      int hd, int hdv, float scale,
                                      int causal, int bf16, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch_hdv<8>(hdv, q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 16: return launch_hdv<16>(hdv, q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 32: return launch_hdv<32>(hdv, q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 64: return launch_hdv<64>(hdv, q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    case 128: return launch_hdv<128>(hdv, q, k, v, out, bh, sq, skv, scale, causal, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}
