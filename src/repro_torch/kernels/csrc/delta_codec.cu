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
//     L) on toroidal axes; with a seam, a wrapped pos equal to L is set to
//     at_l[a] (core/engine's seam repair, ROADMAP C 2-3).
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
// The decoders are one plain launch each (no memset, no grid sync), on a
// grid sized to the card (`plan` over the blocks an SM holds, asked of the
// occupancy API once) with a grid-stride loop, a row of the stack a block
// row, `rounds` rounds when the rows outnumber the grid's y.  The TPU's
// sequential grid carried nothing between blocks, so nothing is lost in
// parallel.
//   Both walk each row's elements (a position row's R x D coordinates as a
//   flat run) in units of four from the first multiple of four in the
//   stack: a unit is one float4 of output and one 4-, 8- (int8, int16 q)
//   or 8-byte (int16 positions) vector of q, plus a float4 of ref for the
//   delta decode; consecutive threads take consecutive units, so every
//   warp load and store is one contiguous run, and each thread loads
//   kUnits units before it computes any.  The elements before a row's first
//   unit and after its last, and every element of a misaligned stack, go
//   scalar in the same kernel.  Each thread reads its row's values (the
//   scale; the centre) once, after its first units' loads (row_value).  The
//   position decode holds the row's centre, scale, period, wrap flag and
//   at_l per axis in registers and picks them by selects (the axis of a
//   coordinate is its place in the row modulo D); with `seam`, a
//   wrapped coordinate equal to L (a step a hair below 0 rounds to L under
//   jnp.mod) is written as at_l[a]: the engine's seam repair, folded into
//   the one launch.  (A layout with a thread on 16 contiguous elements,
//   or on four rows of positions, touched each 32-byte sector only in part
//   per warp instruction and ran slower: PERF.md §6.)
// Built without fast math and with -fmad=false: IEEE division, rintf for
// jnp.round's half-to-even, and ref + q * s as a multiply then an add, so
// the sender's new reference, the receiver's reconstruction and the plain
// PyTorch version are the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Elements of x - ref (and of ref) a delta-encode thread keeps in registers
// from the max to the quantize (kernels/delta_codec.py TILE_ELEMS).
constexpr int kTileElems = 16;
// Chunks of four rows a position-encode thread loads before it computes
// (kernels/delta_codec.py MIG_CHUNKS).
constexpr int kChunks = 2;
// Units of four elements a decoder thread loads before it computes
// (kernels/delta_codec.py DECODE_UNITS).
constexpr int kUnits = 2;

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

// A row of n elements from stack element `base` (>= 0): its units of four
// are the stack's units [g_lo, g_hi) (elements 4 g .. 4 g + 3), those wholly
// inside it, none without VEC; its elements [0, head) and [tail, n) go
// scalar.  Shifts, not signed division: the first load waits on the few
// integer operations from blockIdx to g_lo.
struct RowSplit {
  long long g_lo, g_hi, head, tail;
  __device__ __forceinline__ RowSplit(long long base, long long n, bool vec) {
    g_lo = (base + 3) >> 2;
    g_hi = (base + n) >> 2;
    if (!vec || g_hi <= g_lo) {
      g_hi = g_lo;
      head = tail = n;
    } else {
      head = 4 * g_lo - base;
      tail = 4 * g_hi - base;
    }
  }
};

// A value of a decoder's row (its scale, a centre coordinate), read by an
// asm load: it stays in an ordinary register, and its latency overlaps the
// units' loads.  As a plain load, ptxas moved the row-uniform value into a
// uniform register (R2UR) as soon as it was loaded, and the units' loads,
// issued after the R2UR, waited for it: two round trips to memory instead
// of one.  (A C++ volatile read is a strong system-scope load, slower
// still: PERF.md §6.)
__device__ __forceinline__ float row_value(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// A decoder's pass over a row's units: kUnits a thread loaded (load(g))
// before any is computed and stored (store(g, loaded, values)); the row's
// values (row_values()) read once, after the first group's loads.
// Consecutive threads take consecutive units, so every warp access is
// contiguous.
template <typename Load, typename RowValues, typename Store>
__device__ __forceinline__ void unit_pass(const RowSplit& row,
                                          long long first, long long stride,
                                          Load load, RowValues row_values,
                                          Store store) {
  long long g0 = row.g_lo + first;
  if (g0 >= row.g_hi) return;
  decltype(load(0LL)) v[kUnits];
  auto load_group = [&] {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const long long g = g0 + u * stride;
      if (g < row.g_hi) v[u] = load(g);
    }
  };
  load_group();
  const auto values = row_values();
  for (;;) {
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const long long g = g0 + u * stride;
      if (g < row.g_hi) store(g, v[u], values);
    }
    g0 += kUnits * stride;
    if (g0 >= row.g_hi) return;
    load_group();
  }
}

template <typename QT>
struct DeltaUnit {
  typename Vec4<QT>::type q;
  float4 r;
};

// The decode of `nb` rows of n elements: a (blocks, rows per round) grid,
// `rounds` rounds.  With VEC, q is 4 sizeof(q)-byte and ref and out 16-byte
// aligned, so a unit of four elements starting at a multiple of four in
// the stack is one Vec4 of q and one float4 of ref and of out.
template <typename QT, bool VEC>
__global__ void __launch_bounds__(kThreads) delta_decode_kernel(
    const QT* __restrict__ q, const float* __restrict__ ref,
    const float* __restrict__ scale, long long nb, long long n, int rounds,
    float* __restrict__ out) {
  using V = typename Vec4<QT>::type;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (int round = 0; round < rounds; ++round) {
    const long long b = blockIdx.y + static_cast<long long>(round) * gridDim.y;
    if (b >= nb) return;
    const long long base = b * n;     // the row's first element, in the stack
    const RowSplit row(base, n, VEC);
    if constexpr (VEC) {
      const V* q4 = reinterpret_cast<const V*>(q);
      const float4* r4 = reinterpret_cast<const float4*>(ref);
      float4* o4 = reinterpret_cast<float4*>(out);
      unit_pass(
          row, first, stride,
          [&](long long g) { return DeltaUnit<QT>{q4[g], __ldg(r4 + g)}; },
          [&] { return row_value(scale + b); },
          [&](long long g, const DeltaUnit<QT>& v, float s) {
            o4[g] = make_float4(v.r.x + static_cast<float>(v.q.x) * s,
                                v.r.y + static_cast<float>(v.q.y) * s,
                                v.r.z + static_cast<float>(v.q.z) * s,
                                v.r.w + static_cast<float>(v.q.w) * s);
          });
    }
    if (first >= row.head && row.tail + first >= n) continue;
    const float s = row_value(scale + b);
    auto scalar = [&](long long i) {
      out[base + i] = ref[base + i] + static_cast<float>(q[base + i]) * s;
    };
    for (long long i = first; i < row.head; i += stride) scalar(i);
    for (long long i = row.tail + first; i < n; i += stride) scalar(i);
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

// The position decode's seam: with `on`, a wrapped coordinate equal to L on
// axis a is written as at_l[a].
struct Seam {
  float at_l[3];
  int on;
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

// One coordinate of one row's decode: the row's centre and the frame, an
// axis a slot.  The axis of a coordinate is its place in the row modulo D,
// so a thread's four coordinates may start on any axis: each field is
// picked by selects over the D slots, never by indexing them at a runtime
// axis (which would put them in local memory).
template <int D>
struct MigDecode {
  float c[D], s[D], len[D], at[D];
  bool wrap[D], seam[D];

  __device__ __forceinline__ MigDecode(const float* __restrict__ center,
                                       long long b, const Frame& f,
                                       const Seam& sm) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      c[a] = row_value(center + b * D + a);
      s[a] = f.scale[a];
      len[a] = f.len[a];
      wrap[a] = f.wrap[a] != 0;
      seam[a] = wrap[a] && sm.on != 0;
      at[a] = sm.at_l[a];
    }
  }

  template <typename T>
  __device__ __forceinline__ static T pick(const T (&v)[D], int a) {
    if constexpr (D == 1) return v[0];
    else if constexpr (D == 2) return a == 0 ? v[0] : v[1];
    else return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
  }

  __device__ __forceinline__ float operator()(int16_t qv, int a) const {
    float p = pick(c, a) + static_cast<float>(qv) * pick(s, a);
    if (pick(wrap, a)) {
      const float l = pick(len, a);
      p = jnp_mod(p, l);
      if (pick(seam, a) && p == l) p = pick(at, a);
    }
    return p;
  }
};

// The position decode of `nb` rows of R = `rows` positions, each row's
// R x D coordinates a flat run of n = R D: a (blocks, rows per round) grid,
// `rounds` rounds.  With VEC, q is 8-byte and pos 16-byte aligned, so a
// unit of four coordinates starting at a multiple of four in the stack is
// one uint2 (four int16) of q and one float4 of pos.
template <int D, bool VEC>
__global__ void __launch_bounds__(kThreads) migration_pos_decode_kernel(
    const int16_t* __restrict__ q, const float* __restrict__ center,
    long long nb, long long rows, int rounds, Frame f, Seam sm,
    float* __restrict__ pos) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = rows * D;
  for (int round = 0; round < rounds; ++round) {
    const long long b = blockIdx.y + static_cast<long long>(round) * gridDim.y;
    if (b >= nb) return;
    const long long base = b * n;     // the row's first coordinate
    const RowSplit row(base, n, VEC);
    if constexpr (VEC) {
      const uint2* q4 = reinterpret_cast<const uint2*>(q);
      float4* p4 = reinterpret_cast<float4*>(pos);
      unit_pass(
          row, first, stride, [&](long long g) { return __ldg(q4 + g); },
          [&] { return MigDecode<D>(center, b, f, sm); },
          [&](long long g, const uint2& w, const MigDecode<D>& md) {
            // the unit's first coordinate is row-local 4 g - base
            const int a = static_cast<int>((4 * g - base) % D);
            p4[g] = make_float4(
                md(static_cast<int16_t>(w.x), a),
                md(static_cast<int16_t>(w.x >> 16), (a + 1) % D),
                md(static_cast<int16_t>(w.y), (a + 2) % D),
                md(static_cast<int16_t>(w.y >> 16), (a + 3) % D));
          });
    }
    if (first >= row.head && row.tail + first >= n) continue;
    const MigDecode<D> md(center, b, f, sm);
    for (long long k = first; k < row.head; k += stride)
      pos[base + k] = md(q[base + k], static_cast<int>(k % D));
    for (long long k = row.tail + first; k < n; k += stride)
      pos[base + k] = md(q[base + k], static_cast<int>(k % D));
  }
}

bool bad_rows(long long b) { return b < 1 || b > 65535; }

// `rounds` rounds of grid_y rows must cover the b rows.
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

template <int D>
const void* mig_decode_kernel(int vec) {
  return vec ? reinterpret_cast<const void*>(
                   migration_pos_decode_kernel<D, true>)
             : reinterpret_cast<const void*>(
                   migration_pos_decode_kernel<D, false>);
}

const void* mig_kernel(int d, int vec, bool decode) {
  switch (d) {
    case 1:
      return decode ? mig_decode_kernel<1>(vec) : mig_kernel<1>(vec);
    case 2:
      return decode ? mig_decode_kernel<2>(vec) : mig_kernel<2>(vec);
    case 3:
      return decode ? mig_decode_kernel<3>(vec) : mig_kernel<3>(vec);
    default:
      return nullptr;
  }
}

const void* decode_kernel(int qbits, int vec) {
  switch (qbits) {
    case 8:
      return vec ? reinterpret_cast<const void*>(
                       delta_decode_kernel<int8_t, true>)
                 : reinterpret_cast<const void*>(
                       delta_decode_kernel<int8_t, false>);
    case 16:
      return vec ? reinterpret_cast<const void*>(
                       delta_decode_kernel<int16_t, true>)
                 : reinterpret_cast<const void*>(
                       delta_decode_kernel<int16_t, false>);
    default:
      return nullptr;
  }
}

// SMs and the blocks of kThreads threads of `kernel` one SM holds: a
// cooperative grid may have at most their product, and a decoder's grid
// is sized to it.
cudaError_t occupancy(const void* kernel, int device, bool cooperative,
                      int* sms, int* per_sm) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (cooperative) {
    int coop = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (e != cudaSuccess) return e;
    if (!coop) return cudaErrorNotSupported;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kThreads, 0);
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
  return occupancy(encode_kernel(qbits, vec, adaptive), device, true, sms,
                   per_sm);
}

extern "C" int migration_pos_encode_coresident(int d, int vec, int device,
                                               int* sms, int* per_sm) {
  return occupancy(mig_kernel(d, vec, false), device, true, sms, per_sm);
}

// The same for the decoders (plain launches), as delta_decode_launch /
// migration_pos_decode_launch take their arguments.
extern "C" int delta_decode_occupancy(int qbits, int vec, int device,
                                      int* sms, int* per_sm) {
  return occupancy(decode_kernel(qbits, vec), device, false, sms, per_sm);
}

extern "C" int migration_pos_decode_occupancy(int d, int vec, int device,
                                              int* sms, int* per_sm) {
  return occupancy(mig_kernel(d, vec, true), device, false, sms, per_sm);
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

// qbits: 8 or 16.  vec: 1 when q, ref and out are 16-byte aligned (any n:
// the elements before a row's first 16-byte q vector and after its last go
// scalar).  The grid: grid_x blocks a row, grid_y rows a round, `rounds`
// rounds (delta_codec.plan).  One plain launch on `stream` (none when n is
// 0), asynchronous; returns a cudaError_t (0 on success).
extern "C" int delta_decode_launch(int qbits, int device, const void* q,
                                   const void* ref, const void* scale,
                                   long long b, long long n, int vec,
                                   int grid_x, int grid_y, int rounds,
                                   void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* kernel = decode_kernel(qbits, vec);
  if (kernel == nullptr || bad_rows(b) || n < 0 ||
      bad_grid(b, grid_x, grid_y, rounds))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  void* args[] = {&q, &ref, &scale, &b, &n, &rounds, &out};
  return cudaLaunchKernel(kernel, dim3(grid_x, grid_y), dim3(kThreads), args,
                          0, static_cast<cudaStream_t>(stream));
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
  const void* kernel = mig_kernel(d, vec, false);
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

// vec: 1 when pos is 16-byte aligned and q 8-byte (d = 1) or 16-byte
// (d = 2, 3) aligned (any R, as the encode).  seam: 1 writes a wrapped
// coordinate equal to L as a0, a1, a2 by axis.  The grid as
// delta_decode_launch's.  One plain launch (none when rows is 0).
extern "C" int migration_pos_decode_launch(
    int device, const void* q, const void* center, long long b,
    long long rows, int d, float s0, float s1, float s2, float l0, float l1,
    float l2, int w0, int w1, int w2, int seam, float a0, float a1, float a2,
    int vec, int grid_x, int grid_y, int rounds, void* pos, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const void* kernel = mig_kernel(d, vec, true);
  if (kernel == nullptr || bad_rows(b) || rows < 0 ||
      bad_grid(b, grid_x, grid_y, rounds))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  Frame f{{s0, s1, s2}, {l0, l1, l2}, {w0, w1, w2}};
  Seam sm{{a0, a1, a2}, seam};
  void* args[] = {&q, &center, &b, &rows, &rounds, &f, &sm, &pos};
  return cudaLaunchKernel(kernel, dim3(grid_x, grid_y), dim3(kThreads), args,
                          0, static_cast<cudaStream_t>(stream));
}
