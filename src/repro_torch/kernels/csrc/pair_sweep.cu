// pair_sweep.cu - the neighbour pair sweep of the ABM engine, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/neighbor_interaction.py:92
// (pair_sweep_kernel; body _pair_eval at :47).  For every interior cell of
// the neighbour-search grid, each of its K slots i is paired with the
// 3^D * K slots j of the cell's 3^D neighbourhood.  A pair counts when both
// slots are valid, their <gid_rank, gid_count> differ and
// dist2 <= radius^2 (displacement taken as the minimum image on toroidal
// axes); the pair law's contributions are summed over j, offset-major (the
// offsets row-major over (-1, 0, 1)^D, last axis fastest), then slot.
// Every law is instantiated at D = 2 and D = 3.  The laws are device
// functions (below): the soft-sphere force (law 0), the same-type counts
// of the clustering metric (1), the infected-neighbour count of
// epidemiology (2), oncology's force plus neighbour count (3), the crowd
// count of tumor_spheroid (4, no columns), the infected count behind a
// per-lane radius gate of sir_mechanics' ensembles (5), and three compose()
// stacks, each part gated to its own radius, in one sweep over one
// neighbourhood: the force and the infected count (16, sir_mechanics), the
// force and the crowd count (17, tumor_spheroid), the force and the gated
// count (18, sir_mechanics' ensemble family).  Their outputs may differ in
// width (oncology: force (D), crowd (1)); counts are exact.
//
// Lanes.  The reference batches the kernel over an ensemble's replicas
// with jax.vmap (src/repro/core/ensemble.py:251, :269 inside shard_map),
// each replica with its own parameters.  Here pair_sweep_lanes_kernel
// takes B lanes on blockIdx.y: lane b reads its columns b * lane_stride
// slots from the first lane's (so one device's block of every lane is read
// in place from a stacked (R, *mesh, *local, K, ...) state), writes (B,
// *interior, K, w) outputs, and takes its params and gates from row b of a
// float32 device table, loaded once a block; its registers are held to
// the blocks an SM holds of a strip.  Both it and the solo
// pair_sweep_kernel (one SoA, the host's params) run one strip a block
// through the same sweep_strip, so a lane's float32 operations are its
// solo launch's at its params, in the same order: a lane equals its solo
// launch bit for bit.
//
// Gathered slabs.  The same laws also run on slabs a caller has gathered
// (the reference's public op, ops.neighborhood_pair_sweep):
// neighborhood_pair_sweep_kernel, after the legacy force kernel below,
// dispatched through the same law numbers (with_law).
//
// What bounds it on an H100.  Bytes: each slot's valid flag (1 B), the
// law's columns of the occupied slots only (pos 8 B, gids 8 B, up to 8 B
// of law columns), and the dense accumulators of every interior slot
// (8 B a slot for either law), each moved once.  On the main path (2048 x
// 2048 interior cells, cap 48, 16.8M agents) that is 0.20 + 0.40 + 1.61 GB
// = 2.2 GB, 0.66 ms at 3.35 TB/s.  Arithmetic: ~7 float operations on each
// pair of occupied slots (the distance test), ~20 more on each pair within
// the radius: ~8.4e9 operations, 0.13 ms at 67 TFLOP/s (fp32, outside the
// tensor cores).  So a kernel that skips empty slots is bound by memory,
// mostly the dense output.  (chip_smoke.py computes these bounds from each
// run's data.)
//
// What the design does about it.  One block of 256 threads takes a strip
// of up to 32 consecutive interior cells along the last axis (shorter at
// a row's end), so a slot's columns are read by the strips of its own row
// and of the rows above and below, about 3 x 34 / 32 times, against 9
// times when every cell stages its own neighbourhood:
//  1. the valid flags of the 3 x 34 staged cells (three contiguous runs of
//     the SoA) go to shared memory as 16-byte vectors where K is a
//     multiple of 16, and the strip's dense outputs are zeroed with
//     16-byte stores (the occupied slots' sums overwrite theirs in 5);
//  2. a thread a staged cell counts its occupied slots (0/1 bytes, a
//     popcount a word), and one warp scans the counts: each staged cell's
//     occupied slots get consecutive numbers, rows first, in slot order;
//  3. a thread a staged cell lists where its occupied slots go;
//  4. a thread an occupied slot stages its columns (pos and gids as one
//     16-byte entry, the law's float and first int column as an 8-byte
//     one, a second int column, where the law reads one, as 4 bytes);
//  5. a thread an occupied slot i of the strip (a warp per cell would
//     idle 28 of 32 lanes at the main path's 4 agents a cell) walks its
//     three neighbour rows, each a run of three cells' slots in order:
//     offset-major, then slot, the reference's order, summed in registers
//     with no atomics; the same float32 operations as the plain version
//     (built with -fmad=false), in the same order as the one-cell-a-block
//     kernel this design replaced, so the result is deterministic.
// Shared memory holds 1024 staged occupied slots (9 K if that is more);
// a strip whose 3 x 34 staged cells hold more is swept in parts of
// consecutive cells that fit (one cell's 9 K always do).  That keeps a
// block at ~38 KB at K = 48, whatever the occupancy, and five blocks on
// an SM.  On the main path (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py)
// it takes ~4 ms against its 0.66 ms bound: the pair loop of step 5 is
// bound by instruction issue (an IEEE sqrt and two IEEE divisions a pair
// within the radius, many instructions each, and lanes of one warp
// walking the lists of different cells), not by bytes.
//
// At D = 3 the same design runs on 3 x 3 = 9 staged rows of w + 2 cells
// (the strip's line of cells along the last axis and the eight lines
// around it in the first two axes), in the offsets' order: the rows by
// (first, second) axis offset row-major, each a run of three consecutive
// cells along the last axis.  A 3-D position and two gids do not fit one
// 16-byte entry, so an entry is (x, y, z, the float column) in 16 bytes,
// the two gids in 8 (read first: the self test needs both, and on one
// device every gid_rank is equal) and each int column in 4: 36 bytes an
// entry with one int column, against 32 at D = 2.  A block holds 1024
// staged slots (27 K if that is more), and the 48 KB budget still admits
// a strip of 32 cells at K = 32 (36,864 B of entries, 9,792 B of flags):
// four blocks on an SM.  At 8 agents a cell a strip's 9 x 34 staged cells
// hold ~2,450 slots, so it is swept in about three parts of ~11 cells,
// each re-staging its two edge columns; that costs threads (~90 own slots
// a part for 256 threads; a budget of 80-116 KB, which spares such a
// strip its parts, was no faster there and slower on a sparse SoA, with
// fewer blocks on an SM), not order: the sums are the D = 2 design's,
// one thread a slot over the 27 cells in order.  At D = 3 the bound is
// the operations (~27 x 8 distance tests an agent): on a uniform 128^3
// cells at 8 agents a cell (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// phase 13) the force law takes ~26 ms against 0.71 ms, the pair loop
// waiting on its shared-memory loads with ~90 threads of a block busy.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

struct Box {
  float len[3];  // per-axis domain length (minimum image period)
  int wrap[3];   // 1 on toroidal axes
};

constexpr int kMaxParams = 8;   // float parameters of a law (or stack)
constexpr int kMaxParts = 4;    // output tensors of a law (or stack)

// A law's float parameters, and for a stack the r^2 gate of each part
// (+inf where a part runs at the sweep's full radius).
struct LawParams {
  float v[kMaxParams];
  float gate[kMaxParts];
};

// The output tensors, in the law's order; part q holds width(q) floats a
// slot.
struct Outputs {
  float* p[kMaxParts];
};

// Floats of a lane's row in the per-lane table of a lane launch: the
// law's params, then the parts' gates.
constexpr int kTableWidth = kMaxParams + kMaxParts;

// Resident SoA columns, each contiguous with layout (*local_grid, K, *t);
// lane b of a lane launch starts b * lane_stride slots further on.
struct Columns {
  const float* pos;            // (..., K, D)
  const int* gid_rank;         // (..., K)
  const int* gid_count;        // (..., K)
  const unsigned char* valid;  // (..., K) bool
  const float* fcol;           // (..., K) the law's float column, or null
  const int* icol[2];          // (..., K) its int columns, or null
};

// One slot's law columns as the pair loop reads them.
struct Cols {
  float f;
  int i[2];
};

// The laws.  Each has kParts output tensors of width(q) floats a slot
// (kAcc floats in all, in that order), reads kParams floats of `p` and
// int columns 0 .. kInts - 1, and adds one pair's contributions to acc
// with the float32 operations of its plain version, in the same order.

// Law 0: repro_torch.core.behaviors.soft_repulsion_adhesion.
// Columns: f = diameter, i[0] = ctype.  Params: repulsion, adhesion,
// same_type_only.  Output: force (D floats a slot).
template <int D>
struct SoftRepulsionAdhesion {
  static constexpr int kParts = 1;
  static constexpr int kAcc = D;
  static constexpr int kParams = 3;
  static constexpr int kInts = 1;
  __host__ __device__ static constexpr int width(int) { return D; }

  __device__ __forceinline__ static void add(
      float* acc, const float* disp, float dist2, const Cols& ci,
      const Cols& cj, const float* p, const float*) {
    const float dist = sqrtf(dist2 + 1e-6f);
    const float r_sum = 0.5f * (ci.f + cj.f);
    const float overlap = r_sum - dist;
    const float rep = overlap > 0.f ? p[0] * overlap : 0.f;
    const float same = ci.i[0] == cj.i[0] ? 1.f : 0.f;
    const float gate = p[2] > 0.f ? same : 1.f;
    const float adh = overlap <= 0.f ? p[1] * gate : 0.f;
    const float f = rep - adh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float unit = disp[d] / dist;
      acc[d] += -(f * unit);
    }
  }
};

// Law 1: repro_torch.sims.cell_clustering._same_type_pair.
// Columns: i[0] = ctype.  Outputs: same, cnt (one float a slot each).
template <int D>
struct SameType {
  static constexpr int kParts = 2;
  static constexpr int kAcc = 2;
  static constexpr int kParams = 0;
  static constexpr int kInts = 1;
  __host__ __device__ static constexpr int width(int) { return 1; }

  __device__ __forceinline__ static void add(
      float* acc, const float*, float, const Cols& ci, const Cols& cj,
      const float*, const float*) {
    acc[0] += ci.i[0] == cj.i[0] ? 1.f : 0.f;
    acc[1] += 1.f;
  }
};

// Law 2: repro_torch.sims.epidemiology._pair, reading int column S.
// Columns: i[S] = state.  Output: n_inf, the neighbours with state 1
// (infected), a count.
template <int D, int S>
struct Epidemiology {
  static constexpr int kParts = 1;
  static constexpr int kAcc = 1;
  static constexpr int kParams = 0;
  static constexpr int kInts = S + 1;
  __host__ __device__ static constexpr int width(int) { return 1; }

  __device__ __forceinline__ static void add(
      float* acc, const float*, float, const Cols&, const Cols& cj,
      const float*, const float*) {
    acc[0] += cj.i[S] == 1 ? 1.f : 0.f;
  }
};

// Law 5: repro_torch.sims.sir_mechanics._gated_sir_pair, reading int
// column S: law 2's count behind the lane's own radius gate, dist2 <=
// r * r with r = p[0] (sir_radius), the square taken in float32 here as
// the plain version takes it.  Output: n_inf (a count).
template <int D, int S>
struct GatedEpidemiology {
  static constexpr int kParts = 1;
  static constexpr int kAcc = 1;
  static constexpr int kParams = 1;
  static constexpr int kInts = S + 1;
  __host__ __device__ static constexpr int width(int) { return 1; }

  __device__ __forceinline__ static void add(
      float* acc, const float*, float dist2, const Cols&, const Cols& cj,
      const float* p, const float*) {
    if (dist2 <= __fmul_rn(p[0], p[0])) acc[0] += cj.i[S] == 1 ? 1.f : 0.f;
  }
};

// Law 3: repro_torch.sims.oncology._pair: law 0's force, then crowd, the
// neighbours in range (a count).  Outputs: force (D floats), crowd (1).
template <int D>
struct Oncology {
  static constexpr int kParts = 2;
  static constexpr int kAcc = D + 1;
  static constexpr int kParams = 3;
  static constexpr int kInts = 1;
  __host__ __device__ static constexpr int width(int q) {
    return q == 0 ? D : 1;
  }

  __device__ __forceinline__ static void add(
      float* acc, const float* disp, float dist2, const Cols& ci,
      const Cols& cj, const float* p, const float* gate) {
    SoftRepulsionAdhesion<D>::add(acc, disp, dist2, ci, cj, p, gate);
    acc[D] += 1.f;
  }
};

// Law 4: repro_torch.sims.tumor_spheroid._crowd_pair: crowd, the
// neighbours in range (a count).  Reads no column.
template <int D>
struct Crowd {
  static constexpr int kParts = 1;
  static constexpr int kAcc = 1;
  static constexpr int kParams = 0;
  static constexpr int kInts = 0;
  __host__ __device__ static constexpr int width(int) { return 1; }

  __device__ __forceinline__ static void add(
      float* acc, const float*, float, const Cols&, const Cols&,
      const float*, const float*) {
    acc[0] += 1.f;
  }
};

// A compose() stack of two laws over one neighbourhood: A's outputs, then
// B's (the b0. and b1. accumulators), A's params, then B's.  Part q runs
// on the pairs with dist2 <= gate[q] (its own radius^2; +inf at the
// sweep's radius): the plain version zeroes its contributions elsewhere.
template <class A, class B>
struct Stack {
  static constexpr int kParts = A::kParts + B::kParts;
  static constexpr int kAcc = A::kAcc + B::kAcc;
  static constexpr int kParams = A::kParams + B::kParams;
  static constexpr int kInts = A::kInts > B::kInts ? A::kInts : B::kInts;
  __host__ __device__ static constexpr int width(int q) {
    return q < A::kParts ? A::width(q) : B::width(q - A::kParts);
  }

  __device__ __forceinline__ static void add(
      float* acc, const float* disp, float dist2, const Cols& ci,
      const Cols& cj, const float* p, const float* gate) {
    if (dist2 <= gate[0]) A::add(acc, disp, dist2, ci, cj, p, gate);
    if (dist2 <= gate[1])
      B::add(acc + A::kAcc, disp, dist2, ci, cj, p + A::kParams, gate);
  }
};

// Writes a slot's sums to the law's outputs, part after part (part Q's
// floats start at acc[A]; every index is a compile-time constant, so acc
// stays in registers).
template <class Law, int Q = 0, int A = 0>
__device__ __forceinline__ void store(const float* acc, const Outputs& out,
                                      long long slot) {
  if constexpr (Q < Law::kParts) {
    constexpr int kW = Law::width(Q);
#pragma unroll
    for (int x = 0; x < kW; ++x) out.p[Q][slot * kW + x] = acc[A + x];
    store<Law, Q + 1, A + kW>(acc, out, slot);
  }
}

constexpr int kSweepThreads = 256;
constexpr int kMaxStrip = 32;         // cells a strip
constexpr int kMinEntries = 1024;     // compacted slots a block holds
constexpr size_t kStripBudget = 48 * 1024;   // shared memory a block

// Staged rows of a strip: its own line of cells along the last axis and
// the lines next to it in the other axes, 3^(D - 1).
__host__ __device__ constexpr int staged_rows(int d) {
  return d == 2 ? 3 : 9;
}

// Shared memory of a block (byte offsets) at dimension d for strip width
// w, capacity k, room for `entries` compacted slots and `ints` int columns
// of the law.  D = 2: a = (x, y, gid_rank, gid_count), b = (float column,
// int column 0), c = int column 1.  D = 3: a = (x, y, z, float column),
// b = (gid_rank, gid_count), d = int column 0, c = int column 1.
struct StripLayout {
  size_t a, b, c, d, src, own, start, flag, bytes;
};

__host__ __device__ inline StripLayout strip_layout(int dim, int w, int k,
                                                    int entries, int ints) {
  const size_t e = static_cast<size_t>(entries);
  const size_t cells = static_cast<size_t>(staged_rows(dim)) * (w + 2);
  StripLayout s;
  size_t at = 0;
  s.a = at;     at += 16 * e;
  s.b = at;     at += 8 * e;
  s.c = at;     if (ints > 1) at += 4 * e;
  s.d = at;     if (dim == 3 && ints > 0) at += 4 * e;
  s.src = at;   at += 4 * e;                              // staged slot
  s.own = at;   at += 4 * e;                              // output slot
  s.start = at; at += 4 * (cells + 1);
  at = (at + 15) & ~static_cast<size_t>(15);
  s.flag = at;  at += cells * k;
  s.bytes = (at + 15) & ~static_cast<size_t>(15);
  return s;
}

// Zeros n floats of global memory: scalars up to a 16-byte boundary, then
// 16-byte stores, then the tail.
__device__ __forceinline__ void zero_strip(float* dst, int n) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(n, ((16 - mis) & 15) / 4);
  const int body = (n - head) / 4;
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[e] = 0.f;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int e = threadIdx.x; e < body; e += blockDim.x)
    d4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = head + 4 * body + threadIdx.x; e < n; e += blockDim.x)
    dst[e] = 0.f;
}

// Occupied slots of a cell: its k valid flags are 0/1 bytes, so a word's
// popcount counts four (`words`: k is a multiple of 4, the flags 4-byte
// aligned).
__device__ __forceinline__ int count_flags(const unsigned char* f, int k,
                                           bool words) {
  int c = 0;
  int x = 0;
  if (words) {
    const unsigned* w = reinterpret_cast<const unsigned*>(f);
    for (; x + 4 <= k; x += 4) c += __popc(w[x / 4]);
  }
  for (; x < k; ++x) c += f[x];
  return c;
}

// One block's strip of the sweep (below), of the columns `col` into the
// outputs `out`.  n: the interior cells along each axis (n.z unused at
// D = 2).
template <int D, class Law>
__device__ __forceinline__ void sweep_strip(const Columns& col, int3 n, int k,
                                            int w, int entries, float r2,
                                            const Box& box, const LawParams& p,
                                            const Outputs& out) {
  static_assert(D == 2 || D == 3, "the strip layout is written for D = 2, 3");
  constexpr int kRows = staged_rows(D);
  constexpr int kMid = kRows / 2;       // the strip's own row
  extern __shared__ __align__(16) unsigned char smem[];
  const StripLayout lay = strip_layout(D, w, k, entries, Law::kInts);
  float4* s_a = reinterpret_cast<float4*>(smem + lay.a);
  float2* s_b = reinterpret_cast<float2*>(smem + lay.b);   // D = 2
  int2* s_g = reinterpret_cast<int2*>(smem + lay.b);       // D = 3
  int* s_c = reinterpret_cast<int*>(smem + lay.c);
  int* s_d = reinterpret_cast<int*>(smem + lay.d);         // D = 3
  int* s_src = reinterpret_cast<int*>(smem + lay.src);
  int* s_own = reinterpret_cast<int*>(smem + lay.own);
  int* s_start = reinterpret_cast<int*>(smem + lay.start);
  unsigned char* s_flag = smem + lay.flag;

  // This block's strip: interior line `line` (a row at D = 2; at D = 3 the
  // line (line / n1, line % n1) of the first two axes), interior cells c0
  // .. c0 + wc - 1 along the last axis.  Staged cell (r, dc) is local-grid
  // cell dc + c0 of the line at offset r in the other axes (r - 1 at D = 2;
  // (r / 3 - 1, r % 3 - 1) at D = 3; the local grid is the interior plus
  // one ring); staged cells are numbered row-major, r * nc + dc.
  const int nl = D == 2 ? n.y : n.z;    // interior cells of a line
  const int strips = (nl + w - 1) / w;
  const int line = blockIdx.x / strips;
  const int c0 = (blockIdx.x % strips) * w;
  const int wc = min(w, nl - c0);
  const int nc = wc + 2;
  const int n_cells = kRows * nc;
  const long long ll = nl + 2;
  auto first_slot = [&](int r) {   // global slot of staged cell (r, 0)
    long long cell;
    if constexpr (D == 2) {
      cell = (line + r) * ll + c0;
    } else {
      const int i0 = line / n.y;
      const int i1 = line - i0 * n.y;
      cell = (static_cast<long long>(i0 + r / 3) * (n.y + 2) + i1 + r % 3) *
                 ll + c0;
    }
    return cell * k;
  };
  const long long slot0 = (static_cast<long long>(line) * nl + c0) * k;

  // 1. The valid flags of the staged rows; the strip's outputs zeroed (the
  // occupied slots' sums overwrite theirs in step 5).
  const bool vec = k % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(col.valid) & 15) == 0;
  for (int r = 0; r < kRows; ++r) {
    const unsigned char* src = col.valid + first_slot(r);
    unsigned char* dst = s_flag + r * nc * k;
    if (vec) {
      for (int e = threadIdx.x; e < nc * k / 16; e += blockDim.x)
        reinterpret_cast<uint4*>(dst)[e] =
            reinterpret_cast<const uint4*>(src)[e];
    } else {
      for (int e = threadIdx.x; e < nc * k; e += blockDim.x) dst[e] = src[e];
    }
  }
#pragma unroll
  for (int q = 0; q < Law::kParts; ++q)
    zero_strip(out.p[q] + slot0 * Law::width(q), wc * k * Law::width(q));
  __syncthreads();

  // 2. Occupied slots of each staged cell, then their exclusive scan (one
  // warp, a run of cells a lane): cell c's compacted slots are numbered
  // s_start[c] .. s_start[c + 1] - 1, in slot order.
  const bool words = k % 4 == 0;
  for (int c = threadIdx.x; c < n_cells; c += blockDim.x)
    s_start[c] = count_flags(s_flag + c * k, k, words);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (n_cells + 31) / 32;
    const int lo = min(lane * per, n_cells);
    const int hi = min(lo + per, n_cells);
    int sum = 0;
    for (int c = lo; c < hi; ++c) sum += s_start[c];
    int incl = sum;
    for (int off = 1; off < 32; off *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    int run = incl - sum;
    for (int c = lo; c < hi; ++c) {
      const int m = s_start[c];
      s_start[c] = run;
      run += m;
    }
    if (lane == 31) s_start[n_cells] = incl;
  }
  __syncthreads();

  // The strip in parts of consecutive cells a .. b (staged columns a + 1
  // .. b + 1) whose staged slots, columns a .. b + 2 of the staged rows,
  // fit `entries` (one cell's 3^D K always do).  A part's slots are its
  // rows' runs of the compacted numbering, one after the other: slot s of
  // row r sits at s + shift[r].
  for (int a = 0; a < wc;) {
    auto staged = [&](int b) {
      int m = 0;
      for (int r = 0; r < kRows; ++r)
        m += s_start[r * nc + b + 3] - s_start[r * nc + a];
      return m;
    };
    int b = wc - 1;   // the whole rest of the strip, as a rule
    if (staged(b) > entries) {
      b = a;
      while (staged(b + 1) <= entries) ++b;
    }
    int shift[kRows];
    int total = 0;
    for (int r = 0; r < kRows; ++r) {
      shift[r] = total - s_start[r * nc + a];
      total += s_start[r * nc + b + 3] - s_start[r * nc + a];
    }
    const int cols = b - a + 3;

    // 3. Where each occupied slot of the part goes (shared memory only):
    // a thread a staged cell lists its occupied slots in slot order.
    for (int u = threadIdx.x; u < kRows * cols; u += blockDim.x) {
      const int r = u / cols;
      const int c = r * nc + a + (u - r * cols);
      const unsigned char* f = s_flag + c * k;
      int* dst = s_src + s_start[c] + shift[r];
      int x = 0;
      if (words) {   // flags are 0/1 bytes: a set byte is bit 8 i of its word
        const unsigned* fw = reinterpret_cast<const unsigned*>(f);
        for (; x + 4 <= k; x += 4)
          for (unsigned v = fw[x / 4]; v != 0; v &= v - 1)
            *dst++ = c * k + x + (__ffs(v) - 1) / 8;
      }
      for (; x < k; ++x)
        if (f[x]) *dst++ = c * k + x;
    }
    __syncthreads();

    // 4. Their columns, a thread a slot; the strip's own slots (the middle
    // row, staged columns a + 1 .. b + 1) also keep their output slot.
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int s = s_src[e];
      const int c = s / k;
      const int j = s - c * k;
      const int r = c / nc;
      const int dc = c - r * nc;
      const long long g = first_slot(r) + static_cast<long long>(dc) * k + j;
      const float fv = col.fcol != nullptr ? col.fcol[g] : 0.f;
      const int iv = col.icol[0] != nullptr ? col.icol[0][g] : 0;
      if constexpr (D == 2) {
        const float2 xy = reinterpret_cast<const float2*>(col.pos)[g];
        s_a[e] = make_float4(xy.x, xy.y, __int_as_float(col.gid_rank[g]),
                             __int_as_float(col.gid_count[g]));
        s_b[e] = make_float2(fv, __int_as_float(iv));
      } else {
        const float* q = col.pos + 3 * g;
        s_a[e] = make_float4(q[0], q[1], q[2], fv);
        s_g[e] = make_int2(col.gid_rank[g], col.gid_count[g]);
        if (Law::kInts > 0) s_d[e] = iv;
      }
      if (Law::kInts > 1) s_c[e] = col.icol[1][g];
      s_own[e] = (dc - 1) * k + j;
    }
    __syncthreads();

    // 5. A thread an occupied slot i of the part's cells: its pairs over
    // the staged rows, each row's three cells in order and their slots in
    // order (offset-major, then slot), summed in registers.
    const int i0 = s_start[kMid * nc + a + 1] + shift[kMid];
    const int i1 = s_start[kMid * nc + b + 2] + shift[kMid];
    for (int e = i0 + threadIdx.x; e < i1; e += blockDim.x) {
      const int at = s_own[e];
      const int dc = at / k + 1;
      const float4 ai = s_a[e];
      int ri, ci;
      Cols cols_i;
      if constexpr (D == 2) {
        const float2 bi = s_b[e];
        ri = __float_as_int(ai.z);
        ci = __float_as_int(ai.w);
        cols_i = Cols{bi.x, {__float_as_int(bi.y),
                             Law::kInts > 1 ? s_c[e] : 0}};
      } else {
        const int2 gi = s_g[e];
        ri = gi.x;
        ci = gi.y;
        cols_i = Cols{ai.w, {Law::kInts > 0 ? s_d[e] : 0,
                             Law::kInts > 1 ? s_c[e] : 0}};
      }
      float acc[Law::kAcc];
#pragma unroll
      for (int x = 0; x < Law::kAcc; ++x) acc[x] = 0.f;
      for (int r = 0; r < kRows; ++r) {
        const int lo = s_start[r * nc + dc - 1] + shift[r];
        const int hi = s_start[r * nc + dc + 2] + shift[r];
        for (int x = lo; x < hi; ++x) {
          float disp[D];
          float fj = 0.f;
          if constexpr (D == 2) {
            const float4 aj = s_a[x];
            if (__float_as_int(aj.z) == ri && __float_as_int(aj.w) == ci)
              continue;
            disp[0] = aj.x - ai.x;
            disp[1] = aj.y - ai.y;
          } else {
            const int2 gj = s_g[x];
            if (gj.x == ri && gj.y == ci) continue;
            const float4 aj = s_a[x];
            disp[0] = aj.x - ai.x;
            disp[1] = aj.y - ai.y;
            disp[2] = aj.z - ai.z;
            fj = aj.w;
          }
          float dist2 = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            float dd = disp[d];
            if (box.wrap[d]) dd = dd - box.len[d] * rintf(dd / box.len[d]);
            disp[d] = dd;
            dist2 += dd * dd;
          }
          if (!(dist2 <= r2)) continue;
          Cols cols_j;
          if constexpr (D == 2) {
            const float2 bj = s_b[x];
            cols_j = Cols{bj.x, {__float_as_int(bj.y),
                                 Law::kInts > 1 ? s_c[x] : 0}};
          } else {
            cols_j = Cols{fj, {Law::kInts > 0 ? s_d[x] : 0,
                               Law::kInts > 1 ? s_c[x] : 0}};
          }
          Law::add(acc, disp, dist2, cols_i, cols_j, p.v, p.gate);
        }
      }
      store<Law>(acc, out, slot0 + at);
    }
    __syncthreads();   // the next part reuses the buffers
    a = b + 1;
  }
}

// Blocks an SM holds of a strip (the 48 KB budget: 5 at D = 2, 4 at D = 3).
constexpr int lane_blocks(int d) { return d == 2 ? 5 : 4; }

// The solo sweep: one SoA, the law's params from the host.  They sit in
// the kernel's parameter bank, which the pair loop reads for free (the
// lane kernel at one lane, its params in registers, is up to 7.8 % slower
// on the solo paths' laws).  Its registers are left to ptxas, as the lane
// kernel's are not: a bound on every law (a min-blocks bound, or
// __maxnreg__) slowed law 2 on epidemiology's SoA by 3-7 %.
template <int D, class Law>
__global__ void __launch_bounds__(kSweepThreads)
    pair_sweep_kernel(Columns col, int3 n, int k, int w, int entries,
                      float r2, Box box, LawParams p, Outputs out) {
  sweep_strip<D, Law>(col, n, k, w, entries, r2, box, p, out);
}

// SameType's alone are bounded to the blocks an SM holds: unbounded, the
// D = 2 one takes 58 registers and 14 % more time than at 44.
template <>
__global__ void __launch_bounds__(kSweepThreads, lane_blocks(2))
    pair_sweep_kernel<2, SameType<2>>(Columns col, int3 n, int k, int w,
                                      int entries, float r2, Box box,
                                      LawParams p, Outputs out) {
  sweep_strip<2, SameType<2>>(col, n, k, w, entries, r2, box, p, out);
}

template <>
__global__ void __launch_bounds__(kSweepThreads, lane_blocks(3))
    pair_sweep_kernel<3, SameType<3>>(Columns col, int3 n, int k, int w,
                                      int entries, float r2, Box box,
                                      LawParams p, Outputs out) {
  sweep_strip<3, SameType<3>>(col, n, k, w, entries, r2, box, p, out);
}

// The lanes' sweep: lane b = blockIdx.y reads its columns b * lane_stride
// slots from `lanes`, writes its outputs b * out_stride slots from
// `lane_out`, and takes its params and gates from row b of `table`.
template <int D, class Law>
__global__ void __launch_bounds__(kSweepThreads, lane_blocks(D))
    pair_sweep_lanes_kernel(Columns lanes, long long lane_stride, int3 n,
                            int k, int w, int entries, float r2, Box box,
                            const float* __restrict__ table, Outputs lane_out,
                            long long out_stride) {
  const long long lane = blockIdx.y;
  const long long at = lane * lane_stride;
  Columns col = lanes;
  col.pos += at * D;
  col.gid_rank += at;
  col.gid_count += at;
  col.valid += at;
  if (col.fcol != nullptr) col.fcol += at;
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (col.icol[c] != nullptr) col.icol[c] += at;
  Outputs out = lane_out;
#pragma unroll
  for (int q = 0; q < Law::kParts; ++q)
    out.p[q] += lane * out_stride * Law::width(q);
  LawParams p;
  const float* row = table + lane * kTableWidth;
#pragma unroll
  for (int i = 0; i < kMaxParams; ++i) p.v[i] = row[i];
#pragma unroll
  for (int i = 0; i < kMaxParts; ++i) p.gate[i] = row[kMaxParams + i];
  sweep_strip<D, Law>(col, n, k, w, entries, r2, box, p, out);
}

// The lanes of one launch: their count, the slots between two lanes'
// columns and between two lanes' outputs, and the per-lane table (a device
// array of lanes x kTableWidth floats; null for the solo sweep's one
// lane, which takes the host's params).
struct Lanes {
  int count;
  long long stride;
  long long out_stride;
  const float* table;
};

// The strip width and shared memory of law Law's sweep at dimension D and
// capacity k; false if they do not fit.
template <int D, class Law>
bool strip_shape(int k, int& w, int& entries, size_t& smem) {
  const int nbr = staged_rows(D) * 3 * k;   // one cell's 3^D K
  entries = nbr > kMinEntries ? nbr : kMinEntries;
  w = kMaxStrip;
  while (w > 1 &&
         strip_layout(D, w, k, entries, Law::kInts).bytes > kStripBudget)
    --w;
  smem = strip_layout(D, w, k, entries, Law::kInts).bytes;
  return smem <= 227 * 1024;
}

template <int D, class Law>
cudaError_t launch(const Columns& col, int3 n, int k, float r2,
                   const Box& box, const LawParams& p, const Lanes& ln,
                   const Outputs& out, int n_outs, cudaStream_t stream) {
  const long long lines = D == 2 ? n.x : static_cast<long long>(n.x) * n.y;
  const int nl = D == 2 ? n.y : n.z;
  if (lines * nl == 0 || ln.count == 0) return cudaSuccess;
  if (k < 1 || k > (1 << 20)) return cudaErrorInvalidValue;
  if (ln.count < 0 || ln.count > 65535) return cudaErrorInvalidValue;
  if (n_outs != Law::kParts) return cudaErrorInvalidValue;
  for (int q = 0; q < Law::kParts; ++q)
    if (out.p[q] == nullptr) return cudaErrorInvalidValue;
  if constexpr (Law::kInts > 0) {
    if (col.icol[Law::kInts - 1] == nullptr) return cudaErrorInvalidValue;
  }
  if (ln.table == nullptr && ln.count != 1) return cudaErrorInvalidValue;
  int w, entries;
  size_t smem;
  if (!strip_shape<D, Law>(k, w, entries, smem)) return cudaErrorInvalidValue;
  const long long blocks = lines * ((nl + w - 1) / w);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e;
  if (ln.table == nullptr) {
    e = cudaFuncSetAttribute(pair_sweep_kernel<D, Law>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    pair_sweep_kernel<D, Law>
        <<<static_cast<unsigned>(blocks), kSweepThreads, smem, stream>>>(
            col, n, k, w, entries, r2, box, p, out);
  } else {
    e = cudaFuncSetAttribute(pair_sweep_lanes_kernel<D, Law>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const dim3 grid(static_cast<unsigned>(blocks),
                    static_cast<unsigned>(ln.count));
    pair_sweep_lanes_kernel<D, Law><<<grid, kSweepThreads, smem, stream>>>(
        col, ln.stride, n, k, w, entries, r2, box, ln.table, out,
        ln.out_stride);
  }
  return cudaGetLastError();
}

// Calls fn.template run<Law>() with law number `law`'s functor at
// dimension D (the numbers of pair_sweep_launch, below).
template <int D, class Fn>
cudaError_t with_law(int law, const Fn& fn) {
  switch (law) {
    case 0:
      return fn.template run<SoftRepulsionAdhesion<D>>();
    case 1:
      return fn.template run<SameType<D>>();
    case 2:
      return fn.template run<Epidemiology<D, 0>>();
    case 3:
      return fn.template run<Oncology<D>>();
    case 4:
      return fn.template run<Crowd<D>>();
    case 5:
      return fn.template run<GatedEpidemiology<D, 0>>();
    case 16:
      return fn.template run<
          Stack<SoftRepulsionAdhesion<D>, Epidemiology<D, 1>>>();
    case 17:
      return fn.template run<Stack<SoftRepulsionAdhesion<D>, Crowd<D>>>();
    case 18:
      return fn.template run<
          Stack<SoftRepulsionAdhesion<D>, GatedEpidemiology<D, 1>>>();
    default:
      return cudaErrorInvalidValue;
  }
}

// The resident sweep's launch of one law at dimension D.
template <int D>
struct SweepLaunch {
  const Columns& col;
  int3 n;
  int k;
  float r2;
  const Box& box;
  const LawParams& p;
  const Lanes& ln;
  const Outputs& out;
  int n_outs;
  cudaStream_t s;
  template <class Law>
  cudaError_t run() const {
    return launch<D, Law>(col, n, k, r2, box, p, ln, out, n_outs, s);
  }
};

// The legacy soft-sphere force on gathered slabs.
//
// Replaces the TPU kernel src/repro/kernels/neighbor_interaction.py:201
// (neighbor_force_kernel, law _soft_sphere_pair at :187), which runs the
// pair sweep on slabs the caller has already gathered: self slots (C, K)
// against neighbourhood slots (C, NK) of every cell, columns pos (2
// floats), diameter, type, valid and one gid (the reference maps it onto
// the <rank 0, gid> pair).  A pair counts when both slots are valid, the
// gids differ and dist2 <= radius^2; there is no minimum image.  The law
// is SoftRepulsionAdhesion<2> above, summed over j in slab order.  Any
// valid mask is taken, not only slots packed at the front of a cell.
//
// What bounds it on an H100: bytes, and only those the valid rows need.
// Both valid columns are read whole, the other columns only in the 32-byte
// sectors that hold valid rows, and the (C, K, 2) force is written whole.
// At the 1024 x 1024-cell, cap-48 shape of chip_smoke.py (NK = 432, ~4
// agents a cell, ~36 valid neighbour rows of 432) that is 2.38 GB, 0.71 ms
// at 3.35 TB/s, against 10.97 GB (3.28 ms) if every slab row were read,
// and ~2e9 float operations on the valid pairs (0.03 ms at 67 TFLOP/s);
// chip_smoke.py computes both byte counts from each run's data.
//
// What the design does about it.  A block of 256 threads takes up to 48
// consecutive cells, whose valid flags are two contiguous runs of bytes:
//  1. the threads read both runs as 16-byte vectors (bytes where a run is
//     not 16-byte aligned), all loads in flight at once, keep each vector's
//     16 flags as a bit mask in shared memory, count each cell's valid
//     neighbour rows (shared-memory atomics, one a vector), and zero the
//     block's (cells, K, 2) output run with 16-byte stores;
//  2. a block-wide prefix count numbers the valid neighbour rows and the
//     valid self slots in slab order, and each thread places the row
//     indices of its vectors' set bits at their numbers in shared memory;
//  3. the threads gather only those rows' pos, diameter, type and gid
//     into 16-byte entries (x, y, diameter, type) and a gid, all at once;
//  4. a thread a valid self slot (~190 of 256 at 4 agents a cell) sums
//     over its own cell's staged rows, in slab order: the pairs and their
//     order are those of the one-cell-a-block kernel this design replaced,
//     the same float32 operations under -fmad=false, so the result is
//     unchanged; it writes its 8 bytes over the zeros.
// A block whose valid rows exceed its room (2048 neighbour rows, 256 self
// slots) is swept in windows of consecutive numbers, self windows outside
// and, inside, the windows of the neighbour rows of their cells, the sums
// carried in shared memory: a crowded cell costs re-staging and nothing
// else.  No atomics touch device memory.  Measured at that shape (NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py): ~1.8 ms, 2.6x its valid-first
// bound, against ~13.9 ms for the one-cell-a-block kernel.
constexpr int kForceThreads = 256;
constexpr int kForceCells = 48;        // most cells a block takes
constexpr int kForceRoomJ = 2048;      // neighbour rows staged at once
constexpr int kForceRoomI = 256;       // self slots staged at once
constexpr int kForceUnitsJ = 2048;     // 16-flag vectors of the j run
constexpr int kForceUnitsI = 512;      // and of the self run
constexpr unsigned kFull = 0xffffffffu;

struct ForceSmem {
  float4 j_ent[kForceRoomJ];           // x, y, diameter, type bits
  float4 i_ent[kForceRoomI];
  float2 i_acc[kForceRoomI];           // a staged self slot's sum
  int j_gid[kForceRoomJ];
  int j_row[kForceRoomJ];              // row in the block's j run
  int i_gid[kForceRoomI];
  int i_row[kForceRoomI];              // slot in the block's self run
  int j_count[kForceCells];            // valid neighbour rows of a cell
  int j_first[kForceCells];            // and the number of its first
  int warp_sums[2 * (kForceThreads / 32)];
  unsigned short mask_j[kForceUnitsJ];
  unsigned short mask_i[kForceUnitsI];
};

// Bits 0..3: which of the four bytes of x are nonzero.
__device__ __forceinline__ unsigned nibble(unsigned x) {
  const unsigned y = __vcmpne4(x, 0u);
  return (y & 1u) | ((y >> 7) & 2u) | ((y >> 14) & 4u) | ((y >> 21) & 8u);
}

// Bit u: flag first + u of a run of n flags is set (u < 16, first + u <
// n); one 16-byte read where the run is 16-byte aligned.
__device__ __forceinline__ unsigned unit_flags(const unsigned char* run,
                                               int n, int first) {
  if (first + 16 <= n && (reinterpret_cast<uintptr_t>(run) & 15) == 0) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(run + first));
    return nibble(w.x) | (nibble(w.y) << 4) | (nibble(w.z) << 8) |
           (nibble(w.w) << 12);
  }
  unsigned b = 0u;
  for (int u = 0; u < 16 && first + u < n; ++u)
    b |= (run[first + u] != 0 ? 1u : 0u) << u;
  return b;
}

// Exclusive prefix sums over the block's threads of a and b; tot_a and
// tot_b get the totals.
__device__ __forceinline__ void block_scan2(int& a, int& b, int& tot_a,
                                            int& tot_b, int* warp_sums) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kWarps = kForceThreads / 32;
  int ia = a, ib = b;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ya = __shfl_up_sync(kFull, ia, d);
    const int yb = __shfl_up_sync(kFull, ib, d);
    if (lane >= d) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    warp_sums[warp] = ia;
    warp_sums[kWarps + warp] = ib;
  }
  __syncthreads();
  int ba = 0, bb = 0;
  tot_a = 0;
  tot_b = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      ba += warp_sums[w];
      bb += warp_sums[kWarps + w];
    }
    tot_a += warp_sums[w];
    tot_b += warp_sums[kWarps + w];
  }
  a = ba + ia - a;
  b = bb + ib - b;
}

// Rows of this thread's vectors [u0, u1) of `mask`, numbered from `num`
// in run order: those whose numbers fall in [lo, lo + room) go to
// row[number - lo].
__device__ __forceinline__ void place(const unsigned short* mask, int u0,
                                      int u1, int num, int lo, int room,
                                      int* row) {
  for (int u = u0; u < u1 && num < lo + room; ++u) {
    unsigned bits = mask[u];
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      if (num >= lo && num < lo + room) row[num - lo] = 16 * u + b;
      ++num;
    }
  }
}

__global__ void __launch_bounds__(kForceThreads)
    neighbor_force_kernel(const float* __restrict__ pos_i,
                          const float* __restrict__ diam_i,
                          const int* __restrict__ type_i,
                          const unsigned char* __restrict__ valid_i,
                          const int* __restrict__ gid_i,
                          const float* __restrict__ pos_j,
                          const float* __restrict__ diam_j,
                          const int* __restrict__ type_j,
                          const unsigned char* __restrict__ valid_j,
                          const int* __restrict__ gid_j, long long c, int k,
                          int nk, int cells, float r2, LawParams p,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  ForceSmem& sm = *reinterpret_cast<ForceSmem*>(smem);
  const int tid = threadIdx.x;
  const long long cb = static_cast<long long>(blockIdx.x) * cells;
  const int nc = static_cast<int>(min(static_cast<long long>(cells), c - cb));
  const int n_j = nc * nk;             // the block's runs of flags
  const int n_i = nc * k;
  const int units_j = (n_j + 15) / 16;
  const int units_i = (n_i + 15) / 16;
  const unsigned char* run_j = valid_j + cb * nk;
  const unsigned char* run_i = valid_i + cb * k;

  // 1. Flags as bit masks, each cell's valid neighbour rows counted, the
  // output run zeroed.
  for (int x = tid; x < nc; x += kForceThreads) sm.j_count[x] = 0;
  __syncthreads();
  for (int u = tid; u < units_j; u += kForceThreads) {
    const unsigned bits = unit_flags(run_j, n_j, 16 * u);
    sm.mask_j[u] = static_cast<unsigned short>(bits);
    const int x0 = 16 * u / nk;
    const int x1 = min(16 * u + 15, n_j - 1) / nk;
    if (x0 == x1) {
      if (bits) atomicAdd(&sm.j_count[x0], __popc(bits));
    } else {
      for (unsigned b = bits; b; b &= b - 1)
        atomicAdd(&sm.j_count[(16 * u + __ffs(b) - 1) / nk], 1);
    }
  }
  for (int u = tid; u < units_i; u += kForceThreads)
    sm.mask_i[u] = static_cast<unsigned short>(unit_flags(run_i, n_i, 16 * u));
  zero_strip(out + 2 * cb * k, 2 * n_i);
  __syncthreads();

  // 2. This thread's vectors and the numbers of their first valid rows.
  const int per_j = (units_j + kForceThreads - 1) / kForceThreads;
  const int per_i = (units_i + kForceThreads - 1) / kForceThreads;
  const int uj0 = min(tid * per_j, units_j), uj1 = min(uj0 + per_j, units_j);
  const int ui0 = min(tid * per_i, units_i), ui1 = min(ui0 + per_i, units_i);
  int num_j = 0, num_i = 0;
  for (int u = uj0; u < uj1; ++u) num_j += __popc(sm.mask_j[u]);
  for (int u = ui0; u < ui1; ++u) num_i += __popc(sm.mask_i[u]);
  if (tid < 32) {       // each cell's first number (one warp's scan)
    int first = 0;
    for (int x0 = 0; x0 < nc; x0 += 32) {
      const int v = x0 + tid < nc ? sm.j_count[x0 + tid] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (tid >= d) incl += y;
      }
      if (x0 + tid < nc) sm.j_first[x0 + tid] = first + incl - v;
      first += __shfl_sync(kFull, incl, 31);
    }
  }
  int tot_j, tot_i;
  block_scan2(num_j, num_i, tot_j, tot_i, sm.warp_sums);

  for (int s0 = 0; s0 < tot_i; s0 += kForceRoomI) {
    // 2-3. The self slots numbered s0 .. s0 + kForceRoomI - 1.
    __syncthreads();
    place(sm.mask_i, ui0, ui1, num_i, s0, kForceRoomI, sm.i_row);
    __syncthreads();
    const int n_self = min(kForceRoomI, tot_i - s0);
    for (int e = tid; e < n_self; e += kForceThreads) {
      const long long s = cb * k + sm.i_row[e];
      const float2 xy = __ldg(reinterpret_cast<const float2*>(pos_i) + s);
      sm.i_ent[e] = make_float4(xy.x, xy.y, __ldg(diam_i + s),
                                __int_as_float(__ldg(type_i + s)));
      sm.i_gid[e] = __ldg(gid_i + s);
      sm.i_acc[e] = make_float2(0.f, 0.f);
    }
    // the neighbour rows of the cells these self slots belong to
    const int x_lo = sm.i_row[0] / k;
    const int x_hi = sm.i_row[n_self - 1] / k;
    const int lo = sm.j_first[x_lo];
    const int hi = sm.j_first[x_hi] + sm.j_count[x_hi];
    for (int p0 = lo; p0 < hi; p0 += kForceRoomJ) {
      // 2-3. The neighbour rows numbered p0 .. p0 + kForceRoomJ - 1.
      __syncthreads();
      place(sm.mask_j, uj0, uj1, num_j, p0, kForceRoomJ, sm.j_row);
      __syncthreads();
      const int n = min(kForceRoomJ, hi - p0);
#pragma unroll 4
      for (int e = tid; e < n; e += kForceThreads) {
        const long long r = cb * nk + sm.j_row[e];
        const float2 xy = __ldg(reinterpret_cast<const float2*>(pos_j) + r);
        const float d = __ldg(diam_j + r);
        const int ty = __ldg(type_j + r);
        const int gd = __ldg(gid_j + r);
        sm.j_ent[e] = make_float4(xy.x, xy.y, d, __int_as_float(ty));
        sm.j_gid[e] = gd;
      }
      __syncthreads();
      // 4. A thread a self slot, over its cell's staged rows in order.
      for (int e = tid; e < n_self; e += kForceThreads) {
        const int x = sm.i_row[e] / k;
        const int a0 = max(sm.j_first[x] - p0, 0);
        const int a1 = min(sm.j_first[x] + sm.j_count[x] - p0, n);
        if (a0 >= a1) continue;
        const float4 me = sm.i_ent[e];
        const int gi = sm.i_gid[e];
        const int ti = __float_as_int(me.w);
        float a[2] = {sm.i_acc[e].x, sm.i_acc[e].y};
        for (int jj = a0; jj < a1; ++jj) {
          if (sm.j_gid[jj] == gi) continue;
          const float4 o = sm.j_ent[jj];
          float disp[2] = {o.x - me.x, o.y - me.y};
          const float dist2 = disp[0] * disp[0] + disp[1] * disp[1];
          if (!(dist2 <= r2)) continue;
          SoftRepulsionAdhesion<2>::add(
              a, disp, dist2, Cols{me.z, {ti, 0}},
              Cols{o.z, {__float_as_int(o.w), 0}}, p.v, p.gate);
        }
        sm.i_acc[e] = make_float2(a[0], a[1]);
      }
    }
    // 4. The sums over the zeros (the block barriers above order the two).
    __syncthreads();
    for (int e = tid; e < n_self; e += kForceThreads)
      reinterpret_cast<float2*>(out)[cb * k + sm.i_row[e]] = sm.i_acc[e];
  }
}


// The pair sweep of every law on gathered slabs.
//
// Replaces the TPU kernel src/repro/kernels/neighbor_interaction.py:92
// (pair_sweep_kernel) as its public op calls it,
// src/repro/kernels/ops.py:65-88 (neighborhood_pair_sweep): on slabs the
// caller has already gathered, self slots (C, K) against neighbourhood
// slots (C, NK) of every cell (core/neighbors.gather_neighborhood gives NK
// = 3^D K), columns pos (D floats), gid_rank, gid_count, valid and the
// law's own, any law or stack above, minimum image on the wrapping axes.
// A pair counts when both slots are valid, their <gid_rank, gid_count>
// differ and dist2 <= radius^2; the law's contributions are summed over j
// in slab order, with the float32 operations of the resident sweep's
// pair loop (built with -fmad=false).  The resident sweep above reads the
// SoA in place and cannot take slabs; this is the port's entry point for
// a caller that gathers its own (only ops.neighborhood_pair_sweep calls
// it: no driven path does).
//
// What bounds it on an H100: bytes.  Every column of both slabs is read
// once (at D = 2, 9 + 4 law bytes a j row and as many a self slot) and
// the (C, K, w) sums are written once; ~20 float operations a pair within
// the radius are far below the 67 TFLOP/s line.  chip_smoke.py computes
// the bytes of each run's slabs.
//
// What the design does about it: a thread a self slot, in slab order, so
// the K threads of a cell read each j row at one address (one transaction
// for the warp, L1 serving the rest); it reads a j row's valid flag
// first and the rest of the row only where it is set, walks the row's
// NK entries in order and writes its sums once.  A simple first kernel:
// every thread re-reads its cell's valid flags, and a warp that straddles
// two cells reads two rows at once.
constexpr int kSlabThreads = 256;

struct SlabColumns {
  const float* pos;            // (C, n, D)
  const int* gid_rank;         // (C, n)
  const int* gid_count;        // (C, n)
  const unsigned char* valid;  // (C, n) bool
  const float* fcol;           // (C, n) the law's float column, or null
  const int* icol[2];          // (C, n) its int columns, or null
};

__device__ __forceinline__ Cols slab_cols(const SlabColumns& c, long long g,
                                          int ints) {
  return Cols{c.fcol != nullptr ? c.fcol[g] : 0.f,
              {ints > 0 ? c.icol[0][g] : 0, ints > 1 ? c.icol[1][g] : 0}};
}

template <int D, class Law>
__global__ void __launch_bounds__(kSlabThreads)
    neighborhood_pair_sweep_kernel(SlabColumns ci, SlabColumns cj,
                                   long long c, int k, int nk, float r2,
                                   Box box, LawParams p, Outputs out) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * kSlabThreads + threadIdx.x;
  if (slot >= c * k) return;
  const long long cell = slot / k;
  float acc[Law::kAcc];
#pragma unroll
  for (int x = 0; x < Law::kAcc; ++x) acc[x] = 0.f;
  if (ci.valid[slot]) {
    float pi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) pi[d] = ci.pos[slot * D + d];
    const int ri = ci.gid_rank[slot];
    const int gi = ci.gid_count[slot];
    const Cols cols_i = slab_cols(ci, slot, Law::kInts);
    const long long j0 = cell * nk;
    for (long long j = j0; j < j0 + nk; ++j) {
      if (!cj.valid[j]) continue;
      if (cj.gid_rank[j] == ri && cj.gid_count[j] == gi) continue;
      float disp[D];
      float dist2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float dd = cj.pos[j * D + d] - pi[d];
        if (box.wrap[d]) dd = dd - box.len[d] * rintf(dd / box.len[d]);
        disp[d] = dd;
        dist2 += dd * dd;
      }
      if (!(dist2 <= r2)) continue;
      Law::add(acc, disp, dist2, cols_i, slab_cols(cj, j, Law::kInts), p.v,
               p.gate);
    }
  }
  store<Law>(acc, out, slot);
}

// The gathered-slab sweep's launch of one law at dimension D.
template <int D>
struct SlabLaunch {
  const SlabColumns& ci;
  const SlabColumns& cj;
  long long c;
  int k;
  int nk;
  float r2;
  const Box& box;
  const LawParams& p;
  const Outputs& out;
  int n_outs;
  cudaStream_t s;
  template <class Law>
  cudaError_t run() const {
    if (n_outs != Law::kParts) return cudaErrorInvalidValue;
    for (int q = 0; q < Law::kParts; ++q)
      if (out.p[q] == nullptr) return cudaErrorInvalidValue;
    if constexpr (Law::kInts > 0) {
      if (ci.icol[Law::kInts - 1] == nullptr ||
          cj.icol[Law::kInts - 1] == nullptr)
        return cudaErrorInvalidValue;
    }
    const long long blocks = (c * k + kSlabThreads - 1) / kSlabThreads;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    neighborhood_pair_sweep_kernel<D, Law>
        <<<static_cast<unsigned>(blocks), kSlabThreads, 0, s>>>(
            ci, cj, c, k, nk, r2, box, p, out);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" const char* pair_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// law: 0 = soft_repulsion_adhesion, 1 = same_type, 2 = epidemiology,
// 3 = oncology, 4 = crowd, 5 = gated_epidemiology, 16 = the stack
// (soft_repulsion_adhesion, epidemiology), 17 = the stack
// (soft_repulsion_adhesion, crowd), 18 = the stack
// (soft_repulsion_adhesion, gated_epidemiology); ndim 2 or 3, n0, n1, n2
// the interior cells along each axis (n2 unused at ndim 2).  params:
// n_params floats, gates: n_gates floats (a stack's parts), outs: n_outs
// device pointers, all host arrays read before the launch; fcol, icol0,
// icol1: the law's columns (null where it reads none).  lanes: the lanes
// of the launch (blockIdx.y), lane b's columns lane_stride slots after
// lane b - 1's and its outputs out_stride slots after; table: a device
// array of lanes x (8 params, 4 gates) floats that takes the place of
// params and gates (pair_sweep_lanes_kernel), or null for one lane at
// params and gates (pair_sweep_kernel).  Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int pair_sweep_launch(
    int law, int ndim, int device, const void* pos, const void* gid_rank,
    const void* gid_count, const void* valid, const void* fcol,
    const void* icol0, const void* icol1, int n0, int n1, int n2, int k,
    float r2, float box0, float box1, float box2, int wrap0, int wrap1,
    int wrap2, const float* params, int n_params, const float* gates,
    int n_gates, void* const* outs, int n_outs, int lanes,
    long long lane_stride, long long out_stride, const float* table,
    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n_params < 0 || n_params > kMaxParams || n_gates < 0 ||
      n_gates > kMaxParts || n_outs < 1 || n_outs > kMaxParts)
    return cudaErrorInvalidValue;
  const Columns col{static_cast<const float*>(pos),
                    static_cast<const int*>(gid_rank),
                    static_cast<const int*>(gid_count),
                    static_cast<const unsigned char*>(valid),
                    static_cast<const float*>(fcol),
                    {static_cast<const int*>(icol0),
                     static_cast<const int*>(icol1)}};
  const int3 n = make_int3(n0, n1, n2);
  const Box box{{box0, box1, box2}, {wrap0, wrap1, wrap2}};
  LawParams p{};
  for (int i = 0; i < n_params; ++i) p.v[i] = params[i];
  for (int i = 0; i < kMaxParts; ++i)
    p.gate[i] = i < n_gates ? gates[i] : HUGE_VALF;
  Outputs out{};
  for (int i = 0; i < n_outs; ++i) out.p[i] = static_cast<float*>(outs[i]);
  const Lanes ln{lanes, lane_stride, out_stride, table};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 2)
    return with_law<2>(law, SweepLaunch<2>{col, n, k, r2, box, p, ln, out,
                                           n_outs, s});
  if (ndim == 3)
    return with_law<3>(law, SweepLaunch<3>{col, n, k, r2, box, p, ln, out,
                                           n_outs, s});
  return cudaErrorInvalidValue;
}

// Self slabs (c, k), neighbourhood slabs (c, nk), each contiguous: pos
// float (.., 2), diam float, type int32, valid bool, gid int32; out (c, k,
// 2) float.  same_type_only: 1.0 or 0.0.  Returns a cudaError_t (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int neighbor_force_launch(
    int device, const void* pos_i, const void* diam_i, const void* type_i,
    const void* valid_i, const void* gid_i, const void* pos_j,
    const void* diam_j, const void* type_j, const void* valid_j,
    const void* gid_j, int c, int k, int nk, float r2, float repulsion,
    float adhesion, float same_type_only, void* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (c == 0 || k == 0) return cudaSuccess;
  if (c < 0 || k < 0 || nk < 0) return cudaErrorInvalidValue;
  // up to kForceCells cells a block, fewer where their flags would not
  // fit the masks
  if (nk > 16 * kForceUnitsJ || k > 16 * kForceUnitsI)
    return cudaErrorInvalidValue;
  int cells = kForceCells;
  if (nk > 0 && cells > 16 * kForceUnitsJ / nk) cells = 16 * kForceUnitsJ / nk;
  if (cells > 16 * kForceUnitsI / k) cells = 16 * kForceUnitsI / k;
  const long long blocks = (c + cells - 1) / cells;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = sizeof(ForceSmem);
  e = cudaFuncSetAttribute(neighbor_force_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const LawParams p{{repulsion, adhesion, same_type_only}, {}};
  neighbor_force_kernel<<<static_cast<unsigned>(blocks), kForceThreads,
                          smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos_i), static_cast<const float*>(diam_i),
      static_cast<const int*>(type_i),
      static_cast<const unsigned char*>(valid_i),
      static_cast<const int*>(gid_i), static_cast<const float*>(pos_j),
      static_cast<const float*>(diam_j), static_cast<const int*>(type_j),
      static_cast<const unsigned char*>(valid_j),
      static_cast<const int*>(gid_j), c, k, nk, cells, r2, p,
      static_cast<float*>(out));
  return cudaGetLastError();
}

// The gathered-slab sweep (ops.neighborhood_pair_sweep): law and ndim as
// pair_sweep_launch takes them; cols_i and cols_j each 7 device pointers,
// pos, gid_rank, gid_count, valid, the float column and the two int
// columns (null where the law reads none) of the self slabs (c, k) and
// the neighbourhood slabs (c, nk), each contiguous; params, gates and
// outs as pair_sweep_launch takes them, the outputs (c, k, width).
// Returns a cudaError_t (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int neighborhood_pair_sweep_launch(
    int law, int ndim, int device, const void* const* cols_i,
    const void* const* cols_j, long long c, int k, int nk, float r2,
    float box0, float box1, float box2, int wrap0, int wrap1, int wrap2,
    const float* params, int n_params, const float* gates, int n_gates,
    void* const* outs, int n_outs, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (c < 0 || k < 0 || nk < 0 || n_params < 0 || n_params > kMaxParams ||
      n_gates < 0 || n_gates > kMaxParts || n_outs < 1 ||
      n_outs > kMaxParts)
    return cudaErrorInvalidValue;
  if (c == 0 || k == 0) return cudaSuccess;
  auto columns = [](const void* const* v) {
    return SlabColumns{static_cast<const float*>(v[0]),
                       static_cast<const int*>(v[1]),
                       static_cast<const int*>(v[2]),
                       static_cast<const unsigned char*>(v[3]),
                       static_cast<const float*>(v[4]),
                       {static_cast<const int*>(v[5]),
                        static_cast<const int*>(v[6])}};
  };
  const SlabColumns ci = columns(cols_i);
  const SlabColumns cj = columns(cols_j);
  const Box box{{box0, box1, box2}, {wrap0, wrap1, wrap2}};
  LawParams p{};
  for (int i = 0; i < n_params; ++i) p.v[i] = params[i];
  for (int i = 0; i < kMaxParts; ++i)
    p.gate[i] = i < n_gates ? gates[i] : HUGE_VALF;
  Outputs out{};
  for (int i = 0; i < n_outs; ++i) out.p[i] = static_cast<float*>(outs[i]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 2)
    return with_law<2>(law, SlabLaunch<2>{ci, cj, c, k, nk, r2, box, p, out,
                                          n_outs, s});
  if (ndim == 3)
    return with_law<3>(law, SlabLaunch<3>{ci, cj, c, k, nk, r2, box, p, out,
                                          n_outs, s});
  return cudaErrorInvalidValue;
}
