// delta_codec.cu - the aura-exchange delta codec and the migration position
// codec of the ABM engine, for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).
//
// Replaces the four TPU kernels of src/repro/kernels/delta_codec.py:
//   delta_encode_kernel          (:44, body _encode_kernel :18)
//   delta_decode_kernel          (:78, body _decode_kernel :30)
//   migration_pos_encode_kernel  (:126, body _mig_encode_kernel :112)
//   migration_pos_decode_kernel  (:165, body _mig_decode_kernel :121)
// together with the jnp prologues their wrappers run (the adaptive scale's
// max |x - ref|, the min-image wrap and the dead-row zeroing), and the
// closed-loop reference update of core/delta.encode_delta.
//
// Every array is a stack of B rows, one per device of the virtual mesh
// (B = 1 for a single slab): the delta codec takes (B, N) float32 slabs
// with one scale per row; the position codec (B, R, D) positions with one
// centre per row and one scale per axis.
//
//   delta encode: q = clip(rint((x - ref) / s), lo, hi) in int8 or int16,
//     new_ref = ref + float(q) * s, overflow[b] = #{rint(...) outside
//     [lo, hi]}; s = max(max_n |x - ref|, 1e-30) / hi per row (adaptive)
//     or one fixed s.  [lo, hi] is [iinfo.min, iinfo.max] on the engine's
//     path (core/delta.encode_delta) or [-iinfo.max, iinfo.max] (the TPU
//     kernel's +-127).
//   delta decode: x = ref + float(q) * s[b].
//   position encode: d = pos - centre[b]; d -= L * rint(d / L) on
//     toroidal axes; d = 0 on dead rows if asked (the TPU wrapper does);
//     q = clip(rint(d / scale), lo, hi) in int16, overflow counts live
//     rows' coordinates outside [lo, hi].
//   position decode: pos = centre[b] + float(q) * scale, then jnp.mod(pos,
//     L) on toroidal axes.
//
// What bounds it on an H100.  Bytes, and at the engine's sizes launches.
// Each kernel reads its inputs once and writes its outputs once: an
// encode moves 8 B in and 4 + sizeof(q) B out per element (the adaptive
// scale's max pass reads the 8 B once more), a decode sizeof(q) + 4 B in
// and 4 B out.  A halo slab of the 2x2 main path is 1026 x 48 slots a
// device, so one float attribute of the four devices is 0.2-0.4 M elements,
// 1-4 MB: at 3.35 TB/s that is 0.3-1.2 us, below a kernel launch.
//
// What the design does about it.  Many blocks of elementwise threads over
// a (blocks, B) grid with a grid-stride loop, 16-byte loads and stores of
// four elements where the row length and the pointers allow it.  The
// adaptive scale is a first pass: a per-block max reduced with warp
// shuffles, then one atomicMax per block on the float's bits (|x - ref| is
// never negative, so the bits order as the floats do); a max is exact in
// any order.  Overflow counts are summed per block and added with one
// int32 atomicAdd per block: exact and order-free.  The TPU's sequential
// grid carried nothing between blocks, so nothing is lost in parallel.
// Built without fast math and with -fmad=false: IEEE division, rintf for
// jnp.round's half-to-even, and ref + q * s as a multiply then an add, so
// the sender's new reference, the receiver's reconstruction and the plain
// PyTorch version are the same bits.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocksX = 4096;

template <typename QT>
struct Vec4;
template <>
struct Vec4<int8_t> {
  using type = char4;
};
template <>
struct Vec4<int16_t> {
  using type = short4;
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max of a non-negative value; the result is valid in thread 0.
__device__ float block_max(float v) {
  __shared__ float part[kThreads / 32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0.f;
    v = warp_max(v);
  }
  return v;
}

// Block-wide sum; the result is valid in thread 0.
__device__ int block_sum(int v) {
  __shared__ int part[kThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : 0;
    v = warp_sum(v);
  }
  return v;
}

// ---------------------------------------------------------------------------
// Delta codec
// ---------------------------------------------------------------------------

// Pass 1 of the adaptive scale: amax[b] = max_n |x[b, n] - ref[b, n]| as the
// float's bits.  amax must be zero on entry.
__global__ void delta_absmax_kernel(const float* __restrict__ x,
                                    const float* __restrict__ ref,
                                    long long n, int vec,
                                    unsigned int* __restrict__ amax) {
  const long long row = static_cast<long long>(blockIdx.y) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float m = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const float4* r4 = reinterpret_cast<const float4*>(ref + row);
    for (long long i = start; i < n / 4; i += stride) {
      const float4 a = x4[i], r = r4[i];
      m = fmaxf(m, fabsf(a.x - r.x));
      m = fmaxf(m, fabsf(a.y - r.y));
      m = fmaxf(m, fabsf(a.z - r.z));
      m = fmaxf(m, fabsf(a.w - r.w));
    }
  } else {
    for (long long i = start; i < n; i += stride)
      m = fmaxf(m, fabsf(x[row + i] - ref[row + i]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, __float_as_uint(m));
}

struct Quant {
  float s, lo, hi;
  int overflow;

  __device__ __forceinline__ float operator()(float xv, float rv) {
    const float qf = rintf((xv - rv) / s);
    overflow += (qf > hi) | (qf < lo);
    return fminf(fmaxf(qf, lo), hi);
  }
};

// Pass 2: quantize, count, and (new_ref != null) the closed-loop reference.
// With amax != null the row's scale is max(amax[b], 1e-30) / hi, else
// fixed_scale; either way it is written to scale_out[b].  oflow must be
// zero on entry.
template <typename QT>
__global__ void delta_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ ref, long long n,
    int vec, const unsigned int* __restrict__ amax, float fixed_scale,
    float lo, float hi, QT* __restrict__ q, float* __restrict__ new_ref,
    float* __restrict__ scale_out, int* __restrict__ oflow) {
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float s =
      amax != nullptr ? fmaxf(__uint_as_float(amax[b]), 1e-30f) / hi
                      : fixed_scale;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[b] = s;
  Quant quant{s, lo, hi, 0};
  if (vec) {
    using V = typename Vec4<QT>::type;
    const float4* x4 = reinterpret_cast<const float4*>(x + row);
    const float4* r4 = reinterpret_cast<const float4*>(ref + row);
    V* q4 = reinterpret_cast<V*>(q + row);
    float4* n4 = new_ref != nullptr
                     ? reinterpret_cast<float4*>(new_ref + row) : nullptr;
    for (long long i = start; i < n / 4; i += stride) {
      const float4 a = x4[i], r = r4[i];
      const float c0 = quant(a.x, r.x), c1 = quant(a.y, r.y);
      const float c2 = quant(a.z, r.z), c3 = quant(a.w, r.w);
      V qv;
      qv.x = static_cast<QT>(c0);
      qv.y = static_cast<QT>(c1);
      qv.z = static_cast<QT>(c2);
      qv.w = static_cast<QT>(c3);
      q4[i] = qv;
      if (n4 != nullptr)
        n4[i] = make_float4(r.x + c0 * s, r.y + c1 * s, r.z + c2 * s,
                            r.w + c3 * s);
    }
  } else {
    for (long long i = start; i < n; i += stride) {
      const float rv = ref[row + i];
      const float c = quant(x[row + i], rv);
      q[row + i] = static_cast<QT>(c);
      if (new_ref != nullptr) new_ref[row + i] = rv + c * s;
    }
  }
  const int total = block_sum(quant.overflow);
  if (threadIdx.x == 0 && total != 0) atomicAdd(oflow + b, total);
}

template <typename QT>
__global__ void delta_decode_kernel(const QT* __restrict__ q,
                                    const float* __restrict__ ref,
                                    const float* __restrict__ scale,
                                    long long n, int vec,
                                    float* __restrict__ out) {
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long start =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float s = scale[b];
  if (vec) {
    using V = typename Vec4<QT>::type;
    const V* q4 = reinterpret_cast<const V*>(q + row);
    const float4* r4 = reinterpret_cast<const float4*>(ref + row);
    float4* o4 = reinterpret_cast<float4*>(out + row);
    for (long long i = start; i < n / 4; i += stride) {
      const V qv = q4[i];
      const float4 r = r4[i];
      o4[i] = make_float4(r.x + static_cast<float>(qv.x) * s,
                          r.y + static_cast<float>(qv.y) * s,
                          r.z + static_cast<float>(qv.z) * s,
                          r.w + static_cast<float>(qv.w) * s);
    }
  } else {
    for (long long i = start; i < n; i += stride)
      out[row + i] = ref[row + i] + static_cast<float>(q[row + i]) * s;
  }
}

// ---------------------------------------------------------------------------
// Migration position codec
// ---------------------------------------------------------------------------

struct Frame {
  float scale[3];  // per-axis quantum
  float len[3];    // per-axis domain length (toroidal period)
  int wrap[3];     // 1 on toroidal axes
};

// jnp.mod for floats: C fmod, moved into the divisor's sign.
__device__ __forceinline__ float jnp_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.f && ((r < 0.f) != (y < 0.f))) r += y;
  return r;
}

// One thread per (row, device); D coordinates a row.  valid may be null
// (every row live).  oflow must be zero on entry.
__global__ void migration_pos_encode_kernel(
    const float* __restrict__ pos, const float* __restrict__ center,
    const unsigned char* __restrict__ valid, long long rows, int d,
    Frame f, int dead_zero, float lo, float hi, int16_t* __restrict__ q,
    int* __restrict__ oflow) {
  const int b = blockIdx.y;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int count = 0;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < rows; r += stride) {
    const long long row = static_cast<long long>(b) * rows + r;
    const bool live = valid == nullptr || valid[row] != 0;
    for (int a = 0; a < d; ++a) {
      float off = pos[row * d + a] - center[b * d + a];
      if (f.wrap[a]) off = off - f.len[a] * rintf(off / f.len[a]);
      if (dead_zero && !live) off = 0.f;
      const float qf = rintf(off / f.scale[a]);
      count += live & ((qf > hi) | (qf < lo));
      q[row * d + a] = static_cast<int16_t>(fminf(fmaxf(qf, lo), hi));
    }
  }
  const int total = block_sum(count);
  if (threadIdx.x == 0 && total != 0) atomicAdd(oflow + b, total);
}

__global__ void migration_pos_decode_kernel(const int16_t* __restrict__ q,
                                            const float* __restrict__ center,
                                            long long rows, int d, Frame f,
                                            float* __restrict__ pos) {
  const int b = blockIdx.y;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < rows; r += stride) {
    const long long row = static_cast<long long>(b) * rows + r;
    for (int a = 0; a < d; ++a) {
      float p = center[b * d + a] +
                static_cast<float>(q[row * d + a]) * f.scale[a];
      if (f.wrap[a]) p = jnp_mod(p, f.len[a]);
      pos[row * d + a] = p;
    }
  }
}

// Blocks along x for `work` items a row: enough to cover them, at least one
// (so a scale is written for an empty row), capped for the grid-stride loop.
dim3 grid_for(long long work, long long b) {
  long long bx = (work + kThreads - 1) / kThreads;
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(b));
}

bool bad_rows(long long b) { return b < 1 || b > 65535; }

template <typename QT>
cudaError_t encode(const float* x, const float* ref, long long b,
                   long long n, int vec, int adaptive, float fixed_scale,
                   float lo, float hi, unsigned int* amax, QT* q,
                   float* new_ref, float* scale_out, int* oflow,
                   cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(oflow, 0, sizeof(int) * b, s);
  if (e != cudaSuccess) return e;
  const dim3 grid = grid_for(vec ? n / 4 : n, b);
  if (adaptive) {
    e = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * b, s);
    if (e != cudaSuccess) return e;
    delta_absmax_kernel<<<grid, kThreads, 0, s>>>(x, ref, n, vec, amax);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  delta_encode_kernel<QT><<<grid, kThreads, 0, s>>>(
      x, ref, n, vec, adaptive ? amax : nullptr, fixed_scale, lo, hi, q,
      new_ref, scale_out, oflow);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t decode(const QT* q, const float* ref, const float* scale,
                   long long b, long long n, int vec, float* out,
                   cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  delta_decode_kernel<QT><<<grid_for(vec ? n / 4 : n, b), kThreads, 0, s>>>(
      q, ref, scale, n, vec, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* delta_codec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qbits: 8 or 16.  vec: 1 when n % 4 == 0 and every pointer is 16-byte
// aligned (q: 4- or 8-byte).  adaptive: 1 for the per-row max scale (amax
// is a (b,) uint32 scratch), 0 for fixed_scale.  new_ref may be null.
// Returns a cudaError_t (0 on success); the launches are asynchronous on
// `stream`.
extern "C" int delta_encode_launch(int qbits, int device, const void* x,
                                   const void* ref, long long b, long long n,
                                   int vec, int adaptive, float fixed_scale,
                                   float lo, float hi, void* amax, void* q,
                                   void* new_ref, void* scale_out,
                                   void* oflow, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_rows(b) || n < 0) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* rf = static_cast<const float*>(ref);
  unsigned int* am = static_cast<unsigned int*>(amax);
  float* nr = static_cast<float*>(new_ref);
  float* so = static_cast<float*>(scale_out);
  int* of = static_cast<int*>(oflow);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qbits) {
    case 8:
      return encode<int8_t>(xf, rf, b, n, vec, adaptive, fixed_scale, lo, hi,
                            am, static_cast<int8_t*>(q), nr, so, of, s);
    case 16:
      return encode<int16_t>(xf, rf, b, n, vec, adaptive, fixed_scale, lo,
                             hi, am, static_cast<int16_t*>(q), nr, so, of, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int delta_decode_launch(int qbits, int device, const void* q,
                                   const void* ref, const void* scale,
                                   long long b, long long n, int vec,
                                   void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_rows(b) || n < 0) return cudaErrorInvalidValue;
  const float* rf = static_cast<const float*>(ref);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qbits) {
    case 8:
      return decode<int8_t>(static_cast<const int8_t*>(q), rf, sc, b, n, vec,
                            o, s);
    case 16:
      return decode<int16_t>(static_cast<const int16_t*>(q), rf, sc, b, n,
                             vec, o, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// valid may be null.  dead_zero: 1 zeroes dead rows' offsets before
// quantizing (the TPU wrapper's mode), 0 quantizes them as they are (the
// engine's, core/delta.encode_migration).
extern "C" int migration_pos_encode_launch(
    int device, const void* pos, const void* center, const void* valid,
    long long b, long long rows, int d, float s0, float s1, float s2,
    float l0, float l1, float l2, int w0, int w1, int w2, int dead_zero,
    float lo, float hi, void* q, void* oflow, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_rows(b) || rows < 0 || d < 1 || d > 3) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = cudaMemsetAsync(oflow, 0, sizeof(int) * b, s);
  if (e != cudaSuccess) return e;
  if (rows == 0) return cudaSuccess;
  const Frame f{{s0, s1, s2}, {l0, l1, l2}, {w0, w1, w2}};
  migration_pos_encode_kernel<<<grid_for(rows, b), kThreads, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const float*>(center),
      static_cast<const unsigned char*>(valid), rows, d, f, dead_zero, lo,
      hi, static_cast<int16_t*>(q), static_cast<int*>(oflow));
  return cudaGetLastError();
}

extern "C" int migration_pos_decode_launch(
    int device, const void* q, const void* center, long long b,
    long long rows, int d, float s0, float s1, float s2, float l0, float l1,
    float l2, int w0, int w1, int w2, void* pos, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (bad_rows(b) || rows < 0 || d < 1 || d > 3) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  const Frame f{{s0, s1, s2}, {l0, l1, l2}, {w0, w1, w2}};
  migration_pos_decode_kernel<<<grid_for(rows, b), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(q), static_cast<const float*>(center),
      rows, d, f, static_cast<float*>(pos));
  return cudaGetLastError();
}
