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
// What bounds it on an H100.  Bytes, and at the engine's sizes the fixed
// cost of a call.  Each kernel reads its inputs once and writes its outputs
// once: an encode moves 8 B in and 4 + sizeof(q) B out per element, a
// decode sizeof(q) + 4 B in and 4 B out.  A delta call of the 2x2 main path
// is 0.2-0.4 M elements (3 MB): about 1 us at 3.35 TB/s, which is what a
// launch and a memset cost.
//
// What the design does about it.  Each encoder is ONE cooperative launch
// (cudaLaunchCooperativeKernel) with no memset and no atomic of its own
// (cooperative groups' grid sync has its own): the grid is at most the
// blocks the card holds at once (the occupancy API, asked once by the
// wrapper), so a block may wait at cg::this_grid().sync() for the others,
// and cross-block sums go through per-block partial slots, each written
// before any block reads it, reduced in a fixed order.  A grid sync costs
// about as much as a launch (tools/codec_ab.py times the floor), so the
// delta encode's two set its floor; a zero delta skips the division,
// whose slow path a zero dividend takes.
//   delta encode: a (blocks, rows) grid; each thread loads its share of x
//   and ref as float4 (scalar where a row or a pointer is not 16-byte
//   aligned) into a register tile of kTileElems elements, takes its max
//   |x - ref|; each block writes its max to a partial slot; grid.sync();
//   every block reduces its row's maxima and forms s; each thread quantizes
//   from its registers and writes q and new_ref as 4/8- and 16-byte
//   vectors; each block writes its overflow count to a slot; grid.sync();
//   block 0 of each row sums them into overflow[b] and writes s.  Elements
//   beyond the tile are read again in the second phase (the first has just
//   pulled them into L2).  A fixed scale skips the first sync.
//   position encode: each row's R x D floats as a flat run, four rows (D
//   float4, four valid bytes) a chunk, kChunks chunks a thread loaded
//   before they are computed, the axis of each coordinate fixed by its
//   place in the chunk; q stored as 8, 16 or 16 + 8 bytes.  Rows before the
//   first 16-byte aligned chunk of a row (B > 1 and R % 4 != 0), the tail
//   (R % 4) and every row of a misaligned stack go through a scalar loop in
//   the same kernel.  Overflow as in the delta encode, with one sync.
// The decoders are a (blocks, rows) grid of elementwise threads with a
// grid-stride loop, 16-byte vectors where the row length and pointers
// allow.  The TPU's sequential grid carried nothing between blocks, so
// nothing is lost in parallel.  Built without fast math and with
// -fmad=false: IEEE division, rintf for jnp.round's half-to-even, and
// ref + q * s as a multiply then an add, so the sender's new reference,
// the receiver's reconstruction and the plain PyTorch version are the same
// bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocksX = 4096;
// Elements of x - ref (and of ref) a delta-encode thread keeps in registers
// from the max to the quantize (kernels/delta_codec.py TILE_ELEMS).
constexpr int kTileElems = 16;
// Chunks of four rows a position-encode thread loads before it computes
// (kernels/delta_codec.py MIG_CHUNKS).
constexpr int kChunks = 2;

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

struct MaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct SumOp {
  __device__ int operator()(int a, int b) const { return a + b; }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_reduce(T v, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction with the result in every thread; the warps are
// combined in a fixed order, and the shared slots are free on return.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op) {
  __shared__ T part[kWarps];
  v = warp_reduce(v, op);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = part[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, part[w]);
  __syncthreads();
  return r;
}

// One row's n partial slots, written by other blocks before the last
// grid.sync(): read through L2 (__ldcg), never the non-coherent path.
template <typename T, typename Op>
__device__ T reduce_partials(const T* part, int n, T init, Op op) {
  T v = init;
  for (int i = threadIdx.x; i < n; i += kThreads) v = op(v, __ldcg(part + i));
  return block_reduce(v, op);
}

// ---------------------------------------------------------------------------
// Delta codec
// ---------------------------------------------------------------------------

struct Quant {
  float s, lo, hi;
  int overflow;

  // d == 0 takes d itself: for s > 0, 0 / s is a zero of d's sign, and the
  // division's slow path (a zero dividend fails its fast-path check) is
  // skipped.  Most of a delta slab is unchanged slots: 93.6 % of the
  // elements of a delta step of the 2x2 mesh path, 99.96 % of the 2x2x2's
  // (tools/codec_ab.py prints the shares and times the branch's worth).
  __device__ __forceinline__ float operator()(float d) {
    const float qf = d == 0.f && s > 0.f ? d : rintf(d / s);
    overflow += (qf > hi) | (qf < lo);
    return fminf(fmaxf(qf, lo), hi);
  }
};

// Item i of a row (W = 4: a float4, W = 1: a float): d = x - ref and ref.
template <int W>
__device__ __forceinline__ void load_item(const float* __restrict__ x,
                                          const float* __restrict__ ref,
                                          long long i, float (&d)[W],
                                          float (&r)[W]) {
  if constexpr (W == 4) {
    const float4 a = reinterpret_cast<const float4*>(x)[i];
    const float4 b = reinterpret_cast<const float4*>(ref)[i];
    d[0] = a.x - b.x;
    d[1] = a.y - b.y;
    d[2] = a.z - b.z;
    d[3] = a.w - b.w;
    r[0] = b.x;
    r[1] = b.y;
    r[2] = b.z;
    r[3] = b.w;
  } else {
    r[0] = ref[i];
    d[0] = x[i] - r[0];
  }
}

// Quantizes item i and stores q (and new_ref unless it is null).
template <typename QT, int W>
__device__ __forceinline__ void put_item(Quant& quant, const float (&d)[W],
                                         const float (&r)[W], long long i,
                                         QT* __restrict__ q,
                                         float* __restrict__ new_ref) {
  float c[W];
#pragma unroll
  for (int w = 0; w < W; ++w) c[w] = quant(d[w]);
  const float s = quant.s;
  if constexpr (W == 4) {
    using V = typename Vec4<QT>::type;
    V qv;
    qv.x = static_cast<QT>(c[0]);
    qv.y = static_cast<QT>(c[1]);
    qv.z = static_cast<QT>(c[2]);
    qv.w = static_cast<QT>(c[3]);
    reinterpret_cast<V*>(q)[i] = qv;
    if (new_ref != nullptr)
      reinterpret_cast<float4*>(new_ref)[i] =
          make_float4(r[0] + c[0] * s, r[1] + c[1] * s, r[2] + c[2] * s,
                      r[3] + c[3] * s);
  } else {
    q[i] = static_cast<QT>(c[0]);
    if (new_ref != nullptr) new_ref[i] = r[0] + c[0] * s;
  }
}

// The whole encode of `rows` rows of n elements in one cooperative launch:
// a (bpr, rows per round) grid, `rounds` rounds when the rows outnumber
// the grid's y.  part_max and part_count hold bpr slots a row.
template <typename QT, bool VEC, bool ADAPTIVE>
__global__ void __launch_bounds__(kThreads) delta_encode_kernel(
    const float* __restrict__ x, const float* __restrict__ ref,
    long long rows, long long n, int rounds, float fixed_scale, float lo,
    float hi, QT* __restrict__ q, float* __restrict__ new_ref,
    float* __restrict__ scale_out, int* __restrict__ oflow, float* part_max,
    int* part_count) {
  constexpr int W = VEC ? 4 : 1;       // elements an item
  constexpr int K = kTileElems / W;    // items a thread holds
  const cg::grid_group grid = cg::this_grid();
  const int bpr = gridDim.x;
  const long long items = n / W;
  const long long stride = static_cast<long long>(bpr) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int round = 0; round < rounds; ++round) {
    // `active` is the same for every thread of a block; every block, active
    // or not, meets every grid.sync().
    const long long b = blockIdx.y + static_cast<long long>(round) * gridDim.y;
    const bool active = b < rows;
    const long long row = active ? b * n : 0;
    const float* xr = x + row;
    const float* rr = ref + row;
    QT* qr = q + row;
    float* nr = new_ref != nullptr ? new_ref + row : nullptr;
    float d[K][W], r[K][W];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long i = first + k * stride;
      if (active && i < items) {
        load_item<W>(xr, rr, i, d[k], r[k]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) d[k][w] = r[k][w] = 0.f;
      }
    }
    float s = fixed_scale;
    if constexpr (ADAPTIVE) {
      if (active) {
        float m = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int w = 0; w < W; ++w) m = fmaxf(m, fabsf(d[k][w]));
        for (long long i = first + K * stride; i < items; i += stride) {
          float dd[W], rv[W];
          load_item<W>(xr, rr, i, dd, rv);
#pragma unroll
          for (int w = 0; w < W; ++w) m = fmaxf(m, fabsf(dd[w]));
        }
        m = block_reduce(m, MaxOp());
        if (threadIdx.x == 0) part_max[b * bpr + blockIdx.x] = m;
      }
      grid.sync();
      if (active)
        s = fmaxf(reduce_partials(part_max + b * bpr, bpr, 0.f, MaxOp()),
                  1e-30f) / hi;
    }
    if (active) {
      Quant quant{s, lo, hi, 0};
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long i = first + k * stride;
        if (i < items) put_item<QT, W>(quant, d[k], r[k], i, qr, nr);
      }
      for (long long i = first + K * stride; i < items; i += stride) {
        float dd[W], rv[W];
        load_item<W>(xr, rr, i, dd, rv);
        put_item<QT, W>(quant, dd, rv, i, qr, nr);
      }
      const int count = block_reduce(quant.overflow, SumOp());
      if (threadIdx.x == 0) part_count[b * bpr + blockIdx.x] = count;
    }
    grid.sync();
    if (active && blockIdx.x == 0) {
      const int total = reduce_partials(part_count + b * bpr, bpr, 0,
                                        SumOp());
      if (threadIdx.x == 0) {
        oflow[b] = total;
        scale_out[b] = s;
      }
    }
  }
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

// One coordinate of one row's encode, with the row's centre.
struct MigQuant {
  Frame f;
  float c[3];
  int dead_zero;
  float lo, hi;
  int overflow;

  __device__ __forceinline__ int16_t operator()(float p, int a, bool live) {
    float off = p - c[a];
    if (f.wrap[a]) off = off - f.len[a] * rintf(off / f.len[a]);
    if (dead_zero && !live) off = 0.f;
    const float qf = rintf(off / f.scale[a]);
    overflow += live & ((qf > hi) | (qf < lo));
    return static_cast<int16_t>(fminf(fmaxf(qf, lo), hi));
  }
};

__device__ __forceinline__ unsigned int pack2(int16_t a, int16_t b) {
  return static_cast<unsigned int>(static_cast<uint16_t>(a)) |
         (static_cast<unsigned int>(static_cast<uint16_t>(b)) << 16);
}

// The whole position encode of `nb` rows of R = `rows` positions in one
// cooperative launch: a (bpr, rows per round) grid, `rounds` rounds.  valid
// may be null (every row live).  With VEC every pointer is aligned (pos 16
// bytes, q 8, valid 4), and chunk g of the whole stack - its rows 4g..4g+3 -
// is D float4 of pos, one 32-bit word of valid and 8 D bytes of q.
template <int D, bool VEC>
__global__ void __launch_bounds__(kThreads) migration_pos_encode_kernel(
    const float* __restrict__ pos, const float* __restrict__ center,
    const unsigned char* __restrict__ valid, long long nb, long long rows,
    int rounds, Frame f, int dead_zero, float lo, float hi,
    int16_t* __restrict__ q, int* __restrict__ oflow, int* part_count) {
  const cg::grid_group grid = cg::this_grid();
  const int bpr = gridDim.x;
  const long long stride = static_cast<long long>(bpr) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int round = 0; round < rounds; ++round) {
    const long long b = blockIdx.y + static_cast<long long>(round) * gridDim.y;
    const bool active = b < nb;
    if (active) {
      MigQuant mq{f, {0.f, 0.f, 0.f}, dead_zero, lo, hi, 0};
#pragma unroll
      for (int a = 0; a < D; ++a) mq.c[a] = center[b * D + a];
      const long long base = b * rows;     // the row's first, in the stack
      // Scalar rows: up to the first chunk boundary of the stack (every row
      // without VEC), and the tail after the last whole chunk.
      long long head = VEC ? (4 - base % 4) % 4 : rows;
      if (head > rows) head = rows;
      const long long chunks = (rows - head) / 4;
      const long long tail = head + 4 * chunks;
      auto scalar_row = [&](long long g) {
        const bool live = valid == nullptr || valid[g] != 0;
#pragma unroll
        for (int a = 0; a < D; ++a) q[g * D + a] = mq(pos[g * D + a], a, live);
      };
      for (long long r = first; r < head; r += stride) scalar_row(base + r);
      for (long long r = tail + first; r < rows; r += stride)
        scalar_row(base + r);
      if constexpr (VEC) {
        const long long g0 = (base + head) / 4;
        const float4* p4 = reinterpret_cast<const float4*>(pos);
        const unsigned int* v4 = reinterpret_cast<const unsigned int*>(valid);
        for (long long c0 = first; c0 < chunks; c0 += kChunks * stride) {
          float4 p[kChunks][D];
          unsigned int v[kChunks];
#pragma unroll
          for (int u = 0; u < kChunks; ++u) {
            const long long c = c0 + u * stride;
            if (c < chunks) {
#pragma unroll
              for (int e = 0; e < D; ++e) p[u][e] = p4[(g0 + c) * D + e];
              v[u] = valid != nullptr ? v4[g0 + c] : 0x01010101u;
            }
          }
#pragma unroll
          for (int u = 0; u < kChunks; ++u) {
            const long long g = g0 + c0 + u * stride;
            if (c0 + u * stride >= chunks) continue;
            float pf[4 * D];
#pragma unroll
            for (int e = 0; e < D; ++e) {
              pf[4 * e] = p[u][e].x;
              pf[4 * e + 1] = p[u][e].y;
              pf[4 * e + 2] = p[u][e].z;
              pf[4 * e + 3] = p[u][e].w;
            }
            int16_t o[4 * D];
#pragma unroll
            for (int j = 0; j < 4 * D; ++j)
              o[j] = mq(pf[j], j % D, ((v[u] >> (8 * (j / D))) & 0xffu) != 0);
            unsigned int w[2 * D];
#pragma unroll
            for (int i = 0; i < 2 * D; ++i)
              w[i] = pack2(o[2 * i], o[2 * i + 1]);
            char* qb = reinterpret_cast<char*>(q) + 8 * D * g;
            if constexpr (D == 1) {
              *reinterpret_cast<uint2*>(qb) = make_uint2(w[0], w[1]);
            } else if constexpr (D == 2) {
              *reinterpret_cast<uint4*>(qb) =
                  make_uint4(w[0], w[1], w[2], w[3]);
            } else if (g % 2 == 0) {       // 24 bytes from a 16-byte boundary
              *reinterpret_cast<uint4*>(qb) =
                  make_uint4(w[0], w[1], w[2], w[3]);
              *reinterpret_cast<uint2*>(qb + 16) = make_uint2(w[4], w[5]);
            } else {                       // ... or from 8 bytes past one
              *reinterpret_cast<uint2*>(qb) = make_uint2(w[0], w[1]);
              *reinterpret_cast<uint4*>(qb + 8) =
                  make_uint4(w[2], w[3], w[4], w[5]);
            }
          }
        }
      }
      const int count = block_reduce(mq.overflow, SumOp());
      if (threadIdx.x == 0) part_count[b * bpr + blockIdx.x] = count;
    }
    grid.sync();
    if (active && blockIdx.x == 0) {
      const int total = reduce_partials(part_count + b * bpr, bpr, 0,
                                        SumOp());
      if (threadIdx.x == 0) oflow[b] = total;
    }
  }
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


// Blocks along x for `work` items a row: enough to cover them, at least one,
// capped for the grid-stride loop.
dim3 grid_for(long long work, long long b) {
  long long bx = (work + kThreads - 1) / kThreads;
  if (bx < 1) bx = 1;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(b));
}

bool bad_rows(long long b) { return b < 1 || b > 65535; }

// A cooperative grid: `rounds` rounds of grid_y rows must cover the b rows.
bool bad_grid(long long b, int grid_x, int grid_y, int rounds) {
  return grid_x < 1 || grid_y < 1 || grid_y > 65535 || rounds < 1 ||
         static_cast<long long>(grid_y) * rounds < b;
}

template <typename QT>
const void* encode_kernel(int vec, int adaptive) {
  if (vec)
    return adaptive
               ? reinterpret_cast<const void*>(
                     delta_encode_kernel<QT, true, true>)
               : reinterpret_cast<const void*>(
                     delta_encode_kernel<QT, true, false>);
  return adaptive ? reinterpret_cast<const void*>(
                        delta_encode_kernel<QT, false, true>)
                  : reinterpret_cast<const void*>(
                        delta_encode_kernel<QT, false, false>);
}

const void* encode_kernel(int qbits, int vec, int adaptive) {
  switch (qbits) {
    case 8:
      return encode_kernel<int8_t>(vec, adaptive);
    case 16:
      return encode_kernel<int16_t>(vec, adaptive);
    default:
      return nullptr;
  }
}

template <int D>
const void* mig_kernel(int vec) {
  return vec ? reinterpret_cast<const void*>(
                   migration_pos_encode_kernel<D, true>)
             : reinterpret_cast<const void*>(
                   migration_pos_encode_kernel<D, false>);
}

const void* mig_kernel(int d, int vec) {
  switch (d) {
    case 1:
      return mig_kernel<1>(vec);
    case 2:
      return mig_kernel<2>(vec);
    case 3:
      return mig_kernel<3>(vec);
    default:
      return nullptr;
  }
}

// SMs and the blocks of kThreads threads of `kernel` one SM holds: a
// cooperative grid may have at most their product.
cudaError_t coresident(const void* kernel, int device, int* sms,
                       int* per_sm) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, 0);
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

// The SMs and the blocks an SM holds of the encode kernel these arguments
// select (as delta_encode_launch / migration_pos_encode_launch take them),
// into *sms and *per_sm.  Returns a cudaError_t.
extern "C" int delta_encode_coresident(int qbits, int vec, int adaptive,
                                       int device, int* sms, int* per_sm) {
  return coresident(encode_kernel(qbits, vec, adaptive), device, sms,
                    per_sm);
}

extern "C" int migration_pos_encode_coresident(int d, int vec, int device,
                                               int* sms, int* per_sm) {
  return coresident(mig_kernel(d, vec), device, sms, per_sm);
}

// qbits: 8 or 16.  vec: 1 when n % 4 == 0 and every pointer is 16-byte
// aligned (q: 4- or 8-byte).  adaptive: 1 for the per-row max scale, 0 for
// fixed_scale.  new_ref may be null.  The grid (grid_x blocks a row,
// grid_y rows a round, `rounds` rounds) is at most the co-resident blocks
// of delta_encode_coresident; part holds 2 * b * grid_x int32 slots of
// scratch, each written before it is read.  One cooperative launch on
// `stream`, asynchronous; returns a cudaError_t (0 on success).
extern "C" int delta_encode_launch(int qbits, int device, const void* x,
                                   const void* ref, long long b, long long n,
                                   int vec, int adaptive, float fixed_scale,
                                   float lo, float hi, int grid_x, int grid_y,
                                   int rounds, void* part, void* q,
                                   void* new_ref, void* scale_out,
                                   void* oflow, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* kernel = encode_kernel(qbits, vec, adaptive);
  if (kernel == nullptr || bad_rows(b) || n < 0 ||
      bad_grid(b, grid_x, grid_y, rounds))
    return cudaErrorInvalidValue;
  float* part_max = static_cast<float*>(part);
  int* part_count = static_cast<int*>(part) + b * grid_x;
  void* args[] = {&x,  &ref, &b,       &n,         &rounds,
                  &fixed_scale, &lo, &hi, &q, &new_ref,
                  &scale_out,   &oflow, &part_max, &part_count};
  return cudaLaunchCooperativeKernel(kernel, dim3(grid_x, grid_y),
                                     dim3(kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
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

// valid may be null.  vec: 1 when pos is 16-byte, q 8-byte and valid 4-byte
// aligned (any R: the rows before a row's first aligned chunk and the tail
// go scalar).  dead_zero: 1 zeroes dead rows' offsets before quantizing
// (the TPU wrapper's mode), 0 quantizes them as they are (the engine's,
// core/delta.encode_migration).  The grid as delta_encode_launch's; part
// holds b * grid_x int32 slots.  One cooperative launch.
extern "C" int migration_pos_encode_launch(
    int device, const void* pos, const void* center, const void* valid,
    long long b, long long rows, int d, float s0, float s1, float s2,
    float l0, float l1, float l2, int w0, int w1, int w2, int dead_zero,
    float lo, float hi, int vec, int grid_x, int grid_y, int rounds,
    void* part, void* q, void* oflow, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* kernel = mig_kernel(d, vec);
  if (kernel == nullptr || bad_rows(b) || rows < 0 ||
      bad_grid(b, grid_x, grid_y, rounds))
    return cudaErrorInvalidValue;
  Frame f{{s0, s1, s2}, {l0, l1, l2}, {w0, w1, w2}};
  void* args[] = {&pos, &center, &valid,     &b,  &rows, &rounds, &f,
                  &dead_zero,    &lo,        &hi, &q,    &oflow,  &part};
  return cudaLaunchCooperativeKernel(kernel, dim3(grid_x, grid_y),
                                     dim3(kThreads), args, 0,
                                     static_cast<cudaStream_t>(stream));
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
