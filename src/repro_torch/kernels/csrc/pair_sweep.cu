// pair_sweep.cu - the neighbour pair sweep of the ABM engine, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/neighbor_interaction.py:92
// (pair_sweep_kernel; body _pair_eval at :47).  For every interior cell of
// the neighbour-search grid, each of its K slots i is paired with the
// 3^D * K slots j of the cell's 3^D neighbourhood.  A pair counts when both
// slots are valid, their <gid_rank, gid_count> differ and
// dist2 <= radius^2 (displacement taken as the minimum image on toroidal
// axes); the pair law's contributions are summed over j.  Only D = 2 is
// instantiated in this slice.
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
// mostly the dense output; one that evaluates every slot pair, as the TPU
// kernel does with masked vector arithmetic, would need ~6e11 operations,
// about 9 ms.  (chip_smoke.py computes these bounds from each run's data.)
//
// What the design does about it.  One block per interior cell and one
// thread per slot i (the block is K rounded up to a warp, so any capacity
// works).  The block's first warp reads the valid flags of its 3^D
// neighbour cells straight from the resident SoA tensors and stages only
// the occupied slots' columns in shared memory, compacted with a ballot
// and a popcount in the reference's order (the TPU path first builds a
// 3^D-times gathered copy in device memory; here a slot's 3^D re-reads by
// the blocks around it are served by L2, not by a copy).  Each thread then
// loops over the occupied slots only, so empty slots cost neither bytes
// beyond their flag nor arithmetic, and sums its pairs in registers in
// the reference's order (offset-major, then slot): no atomics, the result
// is deterministic.  Invalid i slots get zeros.  Making it fast (several
// cells a block, wider loads, a persistent grid) is later work; this
// version is simple and right.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

struct Box {
  float len[3];  // per-axis domain length (minimum image period)
  int wrap[3];   // 1 on toroidal axes
};

struct LawParams {
  float v[3];
};

// Resident SoA columns, each contiguous with layout (*local_grid, K, *t).
struct Columns {
  const float* pos;            // (..., K, D)
  const int* gid_rank;         // (..., K)
  const int* gid_count;        // (..., K)
  const unsigned char* valid;  // (..., K) bool
  const float* fcol;           // (..., K) the law's float column, or null
  const int* icol;             // (..., K) the law's int column, or null
};

// Law 0: repro_torch.core.behaviors.soft_repulsion_adhesion.
// Columns: fcol = diameter, icol = ctype.  Params: repulsion, adhesion,
// same_type_only.  Output: force (D floats a slot).
template <int D>
struct SoftRepulsionAdhesion {
  static constexpr int kAcc = D;

  __device__ static void add(float* acc, const float* disp, float dist2,
                             float fi, float fj, int ti, int tj,
                             const LawParams& p) {
    const float dist = sqrtf(dist2 + 1e-6f);
    const float r_sum = 0.5f * (fi + fj);
    const float overlap = r_sum - dist;
    const float rep = overlap > 0.f ? p.v[0] * overlap : 0.f;
    const float same = ti == tj ? 1.f : 0.f;
    const float gate = p.v[2] > 0.f ? same : 1.f;
    const float adh = overlap <= 0.f ? p.v[1] * gate : 0.f;
    const float f = rep - adh;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float unit = disp[d] / dist;
      acc[d] += -(f * unit);
    }
  }

  __device__ static void store(const float* acc, float* out0, float*,
                               long long slot) {
#pragma unroll
    for (int d = 0; d < D; ++d) out0[slot * D + d] = acc[d];
  }
};

// Law 1: repro_torch.sims.cell_clustering._same_type_pair.
// Columns: icol = ctype.  Outputs: same, cnt (one float a slot each).
template <int D>
struct SameType {
  static constexpr int kAcc = 2;

  __device__ static void add(float* acc, const float*, float, float, float,
                             int ti, int tj, const LawParams&) {
    acc[0] += ti == tj ? 1.f : 0.f;
    acc[1] += 1.f;
  }

  __device__ static void store(const float* acc, float* out0, float* out1,
                               long long slot) {
    out0[slot] = acc[0];
    out1[slot] = acc[1];
  }
};

template <int D>
__host__ __device__ constexpr int n_offsets() {
  return D == 2 ? 9 : 27;
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes_per_slot() {
  // pos, gid_rank, gid_count, float column, int column
  return sizeof(float) * D + 4 * sizeof(int);
}

template <int D, class Law>
__global__ void pair_sweep_kernel(Columns col, int3 interior, int k,
                                  float r2, Box box, LawParams p,
                                  float* out0, float* out1) {
  constexpr int kOff = n_offsets<D>();
  const int nk = kOff * k;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pos = reinterpret_cast<float*>(smem);
  int* s_rank = reinterpret_cast<int*>(s_pos + static_cast<size_t>(nk) * D);
  int* s_count = s_rank + nk;
  float* s_f = reinterpret_cast<float*>(s_count + nk);
  int* s_t = reinterpret_cast<int*>(s_f + nk);
  __shared__ int s_n;  // occupied slots staged

  // This block's interior cell, row-major over the interior grid, and the
  // local grid (interior + one halo ring on each side).
  const int n_int[3] = {interior.x, interior.y, interior.z};
  const long long cell = blockIdx.x;
  int c[D];
  {
    long long rem = cell;
#pragma unroll
    for (int a = D - 1; a >= 0; --a) {
      c[a] = static_cast<int>(rem % n_int[a]);
      rem /= n_int[a];
    }
  }
  // Local-grid index of the neighbour cell at stencil offset o: offsets
  // row-major over (-1, 0, 1)^D, last axis fastest (the reference's order).
  auto neighbour_cell = [&](int o) {
    int digit[D];
#pragma unroll
    for (int a = D - 1; a >= 0; --a) {
      digit[a] = o % 3 - 1;
      o /= 3;
    }
    long long lc = 0;
#pragma unroll
    for (int a = 0; a < D; ++a)
      lc = lc * (n_int[a] + 2) + (c[a] + 1 + digit[a]);
    return lc;
  };

  // The first warp stages the occupied slots of the 3^D neighbour cells,
  // compacted in the reference's order (offset-major, then slot): a ballot
  // over each 32 slots and a popcount give every occupied slot its place.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int e0 = 0; e0 < nk; e0 += 32) {
      const int e = e0 + lane;
      long long s = 0;
      bool occupied = false;
      if (e < nk) {
        const int o = e / k;
        s = neighbour_cell(o) * k + (e - o * k);
        occupied = col.valid[s] != 0;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, occupied);
      if (occupied) {
        const int at = n + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
        for (int d = 0; d < D; ++d) s_pos[at * D + d] = col.pos[s * D + d];
        s_rank[at] = col.gid_rank[s];
        s_count[at] = col.gid_count[s];
        s_f[at] = col.fcol != nullptr ? col.fcol[s] : 0.f;
        s_t[at] = col.icol != nullptr ? col.icol[s] : 0;
      }
      n += __popc(mask);
    }
    if (lane == 0) s_n = n;
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= k) return;
  float acc[Law::kAcc];
#pragma unroll
  for (int n = 0; n < Law::kAcc; ++n) acc[n] = 0.f;

  const long long self = neighbour_cell(kOff / 2) * k + i;  // offset 0
  if (col.valid[self]) {
    float pi[D];
#pragma unroll
    for (int d = 0; d < D; ++d) pi[d] = col.pos[self * D + d];
    const int ri = col.gid_rank[self];
    const int ci = col.gid_count[self];
    const float fi = col.fcol != nullptr ? col.fcol[self] : 0.f;
    const int ti = col.icol != nullptr ? col.icol[self] : 0;
    const int n = s_n;
    for (int e = 0; e < n; ++e) {
      if (s_rank[e] == ri && s_count[e] == ci) continue;
      float disp[D];
      float dist2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float dd = s_pos[e * D + d] - pi[d];
        if (box.wrap[d]) dd = dd - box.len[d] * rintf(dd / box.len[d]);
        disp[d] = dd;
        dist2 += dd * dd;
      }
      if (!(dist2 <= r2)) continue;
      Law::add(acc, disp, dist2, fi, s_f[e], ti, s_t[e], p);
    }
  }
  Law::store(acc, out0, out1, cell * k + i);
}

template <int D, class Law>
cudaError_t launch(const Columns& col, int3 interior, int k, float r2,
                   const Box& box, const LawParams& p, float* out0,
                   float* out1, cudaStream_t stream) {
  long long cells = static_cast<long long>(interior.x) * interior.y;
  if (D == 3) cells *= interior.z;
  if (cells == 0) return cudaSuccess;
  if (cells > INT_MAX || k < 1) return cudaErrorInvalidValue;
  const int threads = ((k + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(n_offsets<D>()) * k * smem_bytes_per_slot<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pair_sweep_kernel<D, Law>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  pair_sweep_kernel<D, Law><<<static_cast<unsigned>(cells), threads, smem,
                              stream>>>(col, interior, k, r2, box, p, out0,
                                        out1);
  return cudaGetLastError();
}

// The legacy soft-sphere force on gathered slabs.
//
// Replaces the TPU kernel src/repro/kernels/neighbor_interaction.py:201
// (neighbor_force_kernel, law _soft_sphere_pair at :187), which runs the
// pair sweep on slabs the caller has already gathered: self slots (C, K)
// against neighbourhood slots (C, NK) of every cell, columns pos (2
// floats), diameter, type, valid and one gid (the reference maps it onto
// the <rank 0, gid> pair).  A pair counts when both slots are valid, the
// gids differ and dist2 <= radius^2; there is no minimum image.  The law
// is SoftRepulsionAdhesion<2> above, summed over j in slab order.
//
// What bounds it on an H100: bytes.  The slabs are read once and the (C,
// K, 2) force written once, 21 bytes a slot: at the 1024 x 1024-cell,
// cap-48 shape of chip_smoke.py (NK = 432) that is about 10.5 GB, some 3 ms
// at 3.35 TB/s, against ~2e10 float operations on the pairs (0.3 ms at 67
// TFLOP/s).  One block per cell; its threads stage the cell's NK
// neighbour rows in shared memory with coalesced reads, then one thread a
// self slot sums its pairs in registers, in order, with no atomics.
__global__ void neighbor_force_kernel(
    const float* pos_i, const float* diam_i, const int* type_i,
    const unsigned char* valid_i, const int* gid_i, const float* pos_j,
    const float* diam_j, const int* type_j, const unsigned char* valid_j,
    const int* gid_j, int k, int nk, float r2, LawParams p, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pos = reinterpret_cast<float*>(smem);      // (nk, 2)
  float* s_diam = s_pos + 2 * nk;
  int* s_type = reinterpret_cast<int*>(s_diam + nk);
  int* s_gid = s_type + nk;
  unsigned char* s_valid = reinterpret_cast<unsigned char*>(s_gid + nk);

  const long long cell = blockIdx.x;
  const long long j0 = cell * nk;
  for (int e = threadIdx.x; e < 2 * nk; e += blockDim.x)
    s_pos[e] = pos_j[2 * j0 + e];
  for (int e = threadIdx.x; e < nk; e += blockDim.x) {
    s_diam[e] = diam_j[j0 + e];
    s_type[e] = type_j[j0 + e];
    s_gid[e] = gid_j[j0 + e];
    s_valid[e] = valid_j[j0 + e];
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= k) return;
  const long long self = cell * k + i;
  float acc[2] = {0.f, 0.f};
  if (valid_i[self]) {
    const float px = pos_i[2 * self];
    const float py = pos_i[2 * self + 1];
    const float fi = diam_i[self];
    const int ti = type_i[self];
    const int gi = gid_i[self];
    for (int j = 0; j < nk; ++j) {
      if (!s_valid[j] || s_gid[j] == gi) continue;
      float disp[2] = {s_pos[2 * j] - px, s_pos[2 * j + 1] - py};
      const float dist2 = disp[0] * disp[0] + disp[1] * disp[1];
      if (!(dist2 <= r2)) continue;
      SoftRepulsionAdhesion<2>::add(acc, disp, dist2, fi, s_diam[j], ti,
                                    s_type[j], p);
    }
  }
  out[2 * self] = acc[0];
  out[2 * self + 1] = acc[1];
}

}  // namespace

extern "C" const char* pair_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// law: 0 = soft_repulsion_adhesion, 1 = same_type.  Returns a cudaError_t
// (0 on success); the launch is asynchronous on `stream`.
extern "C" int pair_sweep_launch(
    int law, int ndim, int device, const void* pos, const void* gid_rank,
    const void* gid_count, const void* valid, const void* fcol,
    const void* icol, int n0, int n1, int n2, int k, float r2, float box0,
    float box1, float box2, int wrap0, int wrap1, int wrap2, float p0,
    float p1, float p2, void* out0, void* out1, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Columns col{static_cast<const float*>(pos),
                    static_cast<const int*>(gid_rank),
                    static_cast<const int*>(gid_count),
                    static_cast<const unsigned char*>(valid),
                    static_cast<const float*>(fcol),
                    static_cast<const int*>(icol)};
  const int3 interior = make_int3(n0, n1, n2);
  const Box box{{box0, box1, box2}, {wrap0, wrap1, wrap2}};
  const LawParams p{{p0, p1, p2}};
  float* o0 = static_cast<float*>(out0);
  float* o1 = static_cast<float*>(out1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim != 2) return cudaErrorInvalidValue;  // only D = 2 instantiated
  switch (law) {
    case 0:
      return launch<2, SoftRepulsionAdhesion<2>>(col, interior, k, r2, box,
                                                  p, o0, o1, s);
    case 1:
      return launch<2, SameType<2>>(col, interior, k, r2, box, p, o0, o1, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  const int threads = ((k + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  // pos (2 floats), diam, type, gid, valid
  const size_t smem = static_cast<size_t>(nk) * (5 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(neighbor_force_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const LawParams p{{repulsion, adhesion, same_type_only}};
  neighbor_force_kernel<<<static_cast<unsigned>(c), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos_i), static_cast<const float*>(diam_i),
      static_cast<const int*>(type_i),
      static_cast<const unsigned char*>(valid_i),
      static_cast<const int*>(gid_i), static_cast<const float*>(pos_j),
      static_cast<const float*>(diam_j), static_cast<const int*>(type_j),
      static_cast<const unsigned char*>(valid_j),
      static_cast<const int*>(gid_j), k, nk, r2, p,
      static_cast<float*>(out));
  return cudaGetLastError();
}
