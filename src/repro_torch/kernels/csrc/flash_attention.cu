// flash_attention.cu - blocked attention with an online softmax, for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).  Linked
// with -lcuda (the TMA descriptors come from the driver API).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:75
// (flash_attention_kernel; body _flash_kernel at :26).  For each of BH
// heads, out = softmax(q k^T * scale [causal]) v, with q (Sq, hd), k
// (Skv, hd), v (Skv, hdv) in float32 or bfloat16 and the output in q's
// type.  The function is the TPU kernel's: products, the running (max,
// sum, accumulator) and the softmax in float32 (accurate expf or exp2f,
// not the fast-math ones; see each kernel); the causal mask is q_pos >=
// k_pos with no offset (masked scores are -1e30); the output is acc /
// max(l, 1e-30).
// KV tiles wholly above the diagonal are skipped: every row has its
// k_pos = 0 entry in the first tile, so a skipped tile would only have
// multiplied the state by exp(0) and added zeros.
//
// Two kernels, picked by the wrapper (kernels/flash_attention.py) from the
// dtype and head dims, each with its own launch count:
//
// * flash_wgmma_kernel - bf16 q, k, v with hd = hdv in {64, 128}: the
//   language models' path.  What bounds it on an H100: at the main shape
//   (B*H = 4*16 heads, S = 2048, hd = 128, causal) the two products are
//   68.7 GFLOP of kept pairs, 0.069 ms at the 989 TFLOP/s of the bf16
//   tensor cores, while q, k, v and the output are 67 MB, 0.020 ms at 3.35
//   TB/s: operations.  Only wgmma reaches that rate, so the design is
//   Hopper's: one block per (head, 128 query rows), heavy causal blocks
//   first.  A producer warpgroup hands its registers to the consumers
//   (setmaxnreg) and one of its threads issues the TMA loads (128-byte
//   swizzle): the Q tile once, then 128-row K and V tiles into 2-stage
//   rings of their own, with mbarriers for full and empty stages.  Two
//   consumer warpgroups of 64 rows each run S = Q K^T as wgmma
//   m64n128k16 with Q and K both K-major from shared memory (hd is
//   contiguous in both), apply the scale to the float32 S, mask on the
//   diagonal tile only, update the online softmax once a tile on the S
//   registers (a row's 128 scores lie on the 4 threads of a quad: two
//   shuffles) with exp2f (not the fast-math exp2) of scores pre-scaled by
//   log2 e, which costs fewer instructions than expf and differs from it
//   by float32 rounding, and run O += P V as wgmma with P from registers
//   and V from shared memory with the transpose bit (no transposed copy
//   of V).  A consumer issues S_t with PV_(t-1) and runs its softmax while
//   PV_(t-1) runs (FlashAttention-3's order), which the consumers' 240
//   registers hold: O, S and P at once.
//   Rounding: q and k are bf16 already, so their products are exact and
//   the float32 accumulator sums them; scaling S afterwards is what the
//   plain version does (the TPU kernel scales q first; the two differ by
//   float32 rounding).  p is split into p_hi = bf16(p) and p_lo = bf16(p -
//   p_hi), and both go through a wgmma against v (exact in bf16): about 16
//   bits of p for 1.5x the products of a single bf16 PV.  A single bf16 p
//   would round each weight by up to 2^-9 (PERF.md has both errors).
//   Measured at the main shape (NVIDIA H100 80GB HBM3, 700 W;
//   chip_smoke.py): ~0.25 ms, ~275 TFLOP/s, 3.6x its bound, ~1.6x
//   scaled_dot_product_attention.  The 1.5x of the split PV and the two
//   warpgroups' softmax, which still run at the same time, hold it there;
//   making the warpgroups take turns (FlashAttention-3's ping-pong) was
//   tried and gave little at this shape.
// * flash_attention_kernel - float32 inputs, the other head dims, and hd
//   != hdv: the same products on the tensor cores in 3xTF32, so that they
//   keep float32's accuracy.  A single TF32 product (10-bit mantissas)
//   misses the float32 gate of 2e-5 (tests/test_torch_flash_tf32.py shows
//   it), but every float32 operand x is split in registers as it is loaded
//   into big = rna(x) and small = rna(x - big) (cvt.rna.tf32.f32's
//   rounding, see split(); x - big is exact), and S = Qs Kb + Qb Ks + Qb
//   Kb and O += Ps Vb + Pb Vs + Pb Vb, small terms first, drop only small
//   x small (about 2^-22 relative).  bf16 operands are exact in TF32: their
//   S takes one product and PV two (p's split alone).  What bounds it on
//   an H100: at the main shape the three TF32 products are 3 x 68.75
//   GFLOP, 0.417 ms at 495 TFLOP/s (float32 FMA on the CUDA cores would
//   take at least 1.026 ms).  The design is FlashAttention-2's on mma.sync
//   m16n8k8 (wgmma's TF32 form needs both operands K-major, so V would need
//   a transposed, split copy in shared memory): one block per (head, 128
//   query rows), heavy causal blocks first, 8 warps of 16 rows each; the Q
//   tile, and 64-row K and V tiles double-buffered, in shared memory by
//   16-byte cp.async (207 KB at hd 128: a block an SM), row strides padded
//   so that a warp's fragment reads hit distinct banks; S and O as mma
//   fragments, each summed from zero in short runs of mma (S four k-steps
//   at a time, P V a tile at a time) and added in float32, since mma.sync
//   truncates its sums (see kSSteps); the online softmax once a tile on
//   the fragments, with exp2f (not the fast-math form) of scores
//   pre-scaled by log2 e, a row's max
//   over the four threads of a quad in two shuffles and its sum a
//   per-thread share until the end; the k index of both products is
//   permuted (see the kernel) so that S's C fragment is P's A fragment as
//   it stands and V's B fragment is read straight from row-major V.  A
//   warp whose rows all lie above a tile's keys skips it.  Measured at the
//   main shape (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py): ~1.35 ms,
//   3.2x its bound, ~0.8x scaled_dot_product_attention's float32 kernel
//   (PyTorch's CUTLASS memory-efficient one), ~3.8x faster than the
//   CUDA-core kernel it replaced (one shared-memory read for every 4 FMAs,
//   ~5 ms).  Every warp splits every K and V element it reads (a quarter
//   of its instructions), and 255 registers (no spills) and 207 KB of
//   shared memory leave 8 warps an SM to hide mma.sync's latency: that
//   holds it there.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// float32-accurate attention on the tensor cores: 3xTF32 on mma.sync.
// ---------------------------------------------------------------------------

constexpr int kRows = 128;                // query rows a block
constexpr int kThreads = 256;             // 8 warps of 16 rows each
constexpr int kTile = 64;                 // kv rows a shared-memory tile
constexpr int kStages = 2;                // K and V tiles double-buffered
constexpr float kNegInf = -1e30f;
// mma.sync adds its products to the accumulator and truncates the sum
// toward zero, so a long chain of mma into one accumulator loses up to an
// ulp of the running sum at each step, all one way.  S is summed kSSteps
// k-steps at a time, and each tile's P V whole, into accumulators that
// start from zero; those are added to S and to O in float32, rounded to
// nearest.  With S and O chained whole the kernel was 4x further from a
// float64 attention than the plain version; so it is slightly closer
// (PERF.md; tools/flash_f32_sums.py measures other kSSteps).
constexpr int kSSteps = 4;

// Padded shared-memory row strides (elements) of the Q tile and of a K
// and a V tile: rows stay 16-byte aligned for cp.async, and the fragment
// reads of a warp hit distinct banks (Q and K: an 8-byte read of row g (+
// 8n), column 8s + 2t, so the stride is 8 mod 32 floats; V: 4-byte reads
// of rows 2t and 2t + 1, column 8n + g, so the stride is 4 mod 8 floats).
// The Q tile (kRows rows) comes first, then kStages K tiles, then kStages
// V tiles.
template <int HD, int HDV, class T>
struct TileLayout {
  static constexpr int kSK = HD + 8;
  static constexpr int kSV = HDV + 16 / static_cast<int>(sizeof(T));
  static constexpr size_t kBytes =
      sizeof(T) * (kRows * static_cast<size_t>(kSK) +
                   kStages * kTile * static_cast<size_t>(kSK + kSV));
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + R - 1 of an (n, D) head into a tile of row stride S;
// rows past n are zeros (Q rows past sq are never stored, K rows past skv
// are masked, and a zero V row keeps 0 * p finite).
template <int R, int D, int S, class T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int n) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // a chunk
  constexpr int kChunks = D / kPer;                         // a row
  for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
    const int row = e / kChunks;
    const int c = e % kChunks;
    const bool in = r0 + row < n;
    const T* p = src + static_cast<long long>(in ? r0 + row : 0) * D +
                 c * kPer;
    cp_async16(smem_addr(dst + row * S + c * kPer), p, in ? 16 : 0);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float ld1(const float* p) { return *p; }

__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x = big + small to about 22 bits: big = rna(x), small = rna(x - big),
// where rna rounds to TF32 (10 mantissa bits) to nearest, ties away from
// zero: cvt.rna.tf32.f32's rounding.  sm_90 has no instruction for that
// cvt (ptxas emits a compare, an integer add and selects around it), so
// it is written as the integer add of half a TF32 ulp to the magnitude
// bits: big's low 13 bits are then cleared, so that x - big is exact, and
// small's are left, since mma.sync reads a TF32 operand's top 19 bits
// only.  For finite x (an infinity stays one).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a b: a (16 x 8) in the m16n8k8 A layout, b (8 x 8) in the B layout.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The m16n8k8 fragments, with g = lane / 4 and t = lane % 4: A holds (row
// g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, column
// g), (t + 4, g); C holds (row g, columns 2t, 2t + 1), (g + 8, 2t, 2t +
// 1).  A sum over k may visit its terms in any order, so logical k t and t
// + 4 stand for columns 2t and 2t + 1 of each group of 8: in S = Q K^T, a
// thread then reads Q and K as 8-byte pairs, and in O += P V, the C
// fragment of S is already P's A fragment (no shuffle), with V's rows 2t
// and 2t + 1.
template <int HD, int HDV, class T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int bh, int sq, int skv, float scale2,
                           int causal) {
  using L = TileLayout<HD, HDV, T>;
  // bf16 operands are exact in TF32; float32 ones are split in two.
  constexpr bool kSplit = sizeof(T) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq_ = reinterpret_cast<T*>(smem);         // (kRows, kSK)
  T* sk = sq_ + kRows * L::kSK;                // (kStages, kTile, kSK)
  T* sv = sk + kStages * kTile * L::kSK;       // (kStages, kTile, kSV)

  // Heavy causal blocks (the last query rows) are issued first.
  const int n_q = (sq + kRows - 1) / kRows;
  const int head = blockIdx.x % bh;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x / bh)) * kRows;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int w0 = q0 + 16 * warp;             // the warp's first row
  const int r0 = w0 + g;                     // this thread's two rows
  const int r1 = r0 + 8;
  const int w_last = min(w0 + 15, sq - 1);   // its last row before sq

  float o[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of each row's sum

  const int q_last = min(q0 + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  const T* kh = k + static_cast<long long>(head) * skv * HD;
  const T* vh = v + static_cast<long long>(head) * skv * HDV;

  // The Q tile, then each K and V tile one tile ahead, a commit group
  // each.
  load_tile<kRows, HD, L::kSK>(
      sq_, q + static_cast<long long>(head) * sq * HD, q0, sq);
  cp_async_commit();
  load_tile<kTile, HD, L::kSK>(sk, kh, 0, skv);
  load_tile<kTile, HDV, L::kSV>(sv, vh, 0, skv);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % kStages;
    const int next = (it + 1) % kStages;
    if (it + 1 < n_tiles) {
      load_tile<kTile, HD, L::kSK>(sk + next * kTile * L::kSK, kh,
                                   (it + 1) * kTile, skv);
      load_tile<kTile, HDV, L::kSV>(sv + next * kTile * L::kSV, vh,
                                    (it + 1) * kTile, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();      // Q, and K and V of this tile, have landed
    __syncthreads();

    const int kv0 = it * kTile;
    // a warp whose rows all lie above this tile's keys (or past sq) skips
    // it: its scores would all be masked, p = 0 and corr = 1
    const bool live = w0 < sq && (!causal || kv0 <= w_last);
    float s[kTile / 8][4];
    if (live) {
      // S = Q K^T: Qs Kb + Qb Ks + Qb Kb (small terms first), or one
      // product of bf16 operands.  Q's A fragment of k-step ks: columns
      // 8ks + 2t, 8ks + 2t + 1 of rows r0 and r1.  kSSteps k-steps at a
      // time are summed from zero and then added to S in float32 (see
      // kSSteps).
      const T* kt = sk + stage * kTile * L::kSK + g * L::kSK + 2 * t;
      const T* qt = sq_ + (16 * warp + g) * L::kSK + 2 * t;
#pragma unroll
      for (int k0 = 0; k0 < HD / 8; k0 += kSSteps) {
        float c[kTile / 8][4];
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
        for (int ks = k0; ks < k0 + kSSteps && ks < HD / 8; ++ks) {
          const float2 x0 = ld2(qt + 8 * ks);
          const float2 x1 = ld2(qt + 8 * L::kSK + 8 * ks);
          const float qa[4] = {x0.x, x1.x, x0.y, x1.y};
          uint32_t ab[4], as[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kSplit)
              split(qa[i], ab[i], as[i]);
            else
              ab[i] = __float_as_uint(qa[i]);
          }
#pragma unroll
          for (int n = 0; n < kTile / 8; ++n) {
            const float2 kx = ld2(kt + 8 * n * L::kSK + 8 * ks);
            if constexpr (kSplit) {
              uint32_t bb0, bs0, bb1, bs1;
              split(kx.x, bb0, bs0);
              split(kx.y, bb1, bs1);
              mma(c[n], as, bb0, bb1);
              mma(c[n], ab, bs0, bs1);
              mma(c[n], ab, bb0, bb1);
            } else {
              mma(c[n], ab, __float_as_uint(kx.x), __float_as_uint(kx.y));
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[n][e] = k0 == 0 ? c[n][e] : s[n][e] + c[n][e];
      }

      // Scale (in log2 units, for exp2f) and mask: keys past skv, and
      // with causal keys after the row.
      const bool masked =
          kv0 + kTile > skv || (causal && kv0 + kTile - 1 > w0);
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale2;
          if (masked) {
            const int key = kv0 + 8 * n + 2 * t + (e & 1);
            const int row = e < 2 ? r0 : r1;
            if (key >= skv || (causal && key > row)) x = kNegInf;
          }
          s[n][e] = x;
        }

      // The online softmax, once a tile: a row's scores lie on the four
      // threads of a quad, so its max takes two shuffles; its sum stays
      // a per-thread share until the end.
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[h];
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[h] = exp2f(m[h] - mx);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(s[n][2 * h + e] - mx);
            s[n][2 * h + e] = p;
            sum += p;
          }
        l[h] = l[h] * corr[h] + sum;
        m[h] = mx;
      }

      // O = O corr + P V, with P V = Ps Vb + Pb Vs + Pb Vb (bf16 V: Ps V +
      // Pb V).  Key step j is S's column tile j; V's B fragment is rows 8j
      // + 2t, 8j + 2t + 1 of row-major V, column 8n + g.  The tile's P V
      // is summed from zero and then added to O in float32 (see kSSteps).
      const T* vt = sv + stage * kTile * L::kSV + 2 * t * L::kSV + g;
      float c[HDV / 8][4];
#pragma unroll
      for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t pb[4], ps[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(pa[i], pb[i], ps[i]);
        const T* v0 = vt + 8 * j * L::kSV;
#pragma unroll
        for (int n = 0; n < HDV / 8; ++n) {
          const float x0 = ld1(v0 + 8 * n);
          const float x1 = ld1(v0 + L::kSV + 8 * n);
          if constexpr (kSplit) {
            uint32_t vb0, vs0, vb1, vs1;
            split(x0, vb0, vs0);
            split(x1, vb1, vs1);
            mma(c[n], ps, vb0, vb1);
            mma(c[n], pb, vs0, vs1);
            mma(c[n], pb, vb0, vb1);
          } else {
            mma(c[n], ps, __float_as_uint(x0), __float_as_uint(x1));
            mma(c[n], pb, __float_as_uint(x0), __float_as_uint(x1));
          }
        }
      }
#pragma unroll
      for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = o[n][e] * corr[e / 2] + c[n][e];
    }
    __syncthreads();         // this stage is refilled next iteration
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  T* oh = out + static_cast<long long>(head) * sq * HDV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h == 0 ? r0 : r1;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    T* orow = oh + static_cast<long long>(row) * HDV + 2 * t;
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n)
      st2(orow + 8 * n, o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

template <int HD, int HDV, class T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, float scale, int causal,
                   cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(bh) * ((sq + kRows - 1) / kRows);
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX || skv < 1) return cudaErrorInvalidValue;
  constexpr size_t smem = TileLayout<HD, HDV, T>::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<HD, HDV, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // scores in log2 units: exp2f(x * scale * log2 e) = expf(x * scale)
  const float scale2 = scale * 1.4426950408889634f;
  flash_attention_kernel<HD, HDV, T>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), bh, sq, skv,
          scale2, causal);
  return cudaGetLastError();
}

template <int HD, int HDV>
cudaError_t launch_dtype(int bf16, const void* q, const void* k,
                         const void* v, void* out, int bh, int sq, int skv,
                         float scale, int causal, cudaStream_t s) {
  return bf16 ? launch<HD, HDV, __nv_bfloat16>(q, k, v, out, bh, sq, skv,
                                               scale, causal, s)
              : launch<HD, HDV, float>(q, k, v, out, bh, sq, skv, scale,
                                       causal, s);
}

template <int HD>
cudaError_t launch_hdv(int hdv, const void* q, const void* k, const void* v,
                       void* out, int bh, int sq, int skv, float scale,
                       int causal, int bf16, cudaStream_t s) {
  switch (hdv) {
    case 8: return launch_dtype<HD, 8>(bf16, q, k, v, out, bh, sq, skv, scale, causal, s);
    case 16: return launch_dtype<HD, 16>(bf16, q, k, v, out, bh, sq, skv, scale, causal, s);
    case 32: return launch_dtype<HD, 32>(bf16, q, k, v, out, bh, sq, skv, scale, causal, s);
    case 64: return launch_dtype<HD, 64>(bf16, q, k, v, out, bh, sq, skv, scale, causal, s);
    case 128: return launch_dtype<HD, 128>(bf16, q, k, v, out, bh, sq, skv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 kernel on the tensor cores: TMA, mbarriers, wgmma.
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kRows = 128;         // query rows a block
constexpr int kTile = 128;         // kv rows a tile
constexpr int kChunk = 64;         // bf16 columns of one 128-byte-swizzled box
constexpr int kConsumers = 2;      // warpgroups, 64 query rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer one
constexpr int kStages = 2;         // the K/V ring
constexpr int kRowBytes = kChunk * 2;             // 128
constexpr int kBoxBytes = kTile * kRowBytes;      // one (128, 64) bf16 box
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte-aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes): Q (hd / 64 boxes), then K and V of each
// stage, then the barriers.  A tile of hd = 128 is two boxes, columns 0-63
// and 64-127, each (128 rows, 128 bytes).
template <int HD>
struct Layout {
  static constexpr int kChunks = HD / kChunk;
  static constexpr int kTileBytes = kChunks * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;                       // + stage
  static constexpr int kV = kK + kStages * kTileBytes;        // + stage
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, then full and empty for each stage of the K and the V ring;
  // 1024 bytes of alignment slack
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One (128 rows, 64 columns) box of a (BH, S, hd) tensor into shared
// memory, completing on `bar`; rows past S are filled with zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// A shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the fence, commit and wait.
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, float32) += A (64 x 16) B (16 x 128); A and B bf16 in shared
// memory, both K-major (their 16-element dimension contiguous).
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128, float32) += A (64 x 16) B (16 x 128); A bf16 in registers
// (four bf16 pairs a thread), B bf16 in shared memory, MN-major (its
// 128-element dimension contiguous: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16) B (16 x 64); A bf16 in registers
// (four bf16 pairs a thread), B bf16 in shared memory, MN-major (its
// 64-element dimension contiguous: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (HD == 128)
    wgmma_rs_n128(o, a, b);
  else
    wgmma_rs_n64(o, a, b);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One warpgroup's share of a block: 64 query rows, their online-softmax
// state and accumulator; this thread holds rows row0 and row0 + 8.
template <int HD, int P_TERMS>
struct Consumer {
  float o[HD / 2];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  uint32_t ph[8][4], pl[8][4];   // p_hi, p_lo as PV's A fragments
  int quad, row0, first;

  // Issue S = Q K^T for one K tile (k-step kk reads 32 bytes at column
  // 16 kk of both) and commit it as one group.
  __device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t q_addr,
                                          uint32_t k_addr) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    own(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, sw128_desc(q_addr + off, 16, 1024),
                    sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  }

  // Issue O += P V for one V tile (V's k-step kk is its rows 16 kk .. 16 kk
  // + 15) and commit it as one group.
  __device__ __forceinline__ void issue_pv(uint32_t v_addr) {
    own(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      own(ph[kk]);
      if (P_TERMS == 2) own(pl[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv =
          sw128_desc(v_addr + kk * 16 * kRowBytes, kBoxBytes, 1024);
      wgmma_pv<HD>(o, ph[kk], dv);
      if (P_TERMS == 2) wgmma_pv<HD>(o, pl[kk], dv);
    }
    wgmma_commit();
  }

  // After the PV group has completed: O and P are this thread's again.
  __device__ __forceinline__ void release_pv() {
    own(o);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      own(ph[kk]);
      if (P_TERMS == 2) own(pl[kk]);
    }
  }

  // The scale (times log2 e) on the float32 scores of key tile kv0, the
  // mask on the diagonal tile (and on keys past Skv), then the online
  // softmax, with exp2f: p = exp2(s scale log2 e - m) = exp(s scale -
  // m ln 2).  Leaves p in sc and the accumulator's correction in corr.
  __device__ __forceinline__ void softmax(float (&sc)[64], float (&corr)[2],
                                          int kv0, float scale2, int skv,
                                          int causal) {
    const bool edge =
        (causal && kv0 + kTile - 1 > first) || kv0 + kTile > skv;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i / 2) % 2;
      const int col = kv0 + 8 * (i / 4) + 2 * quad + i % 2;
      float x = sc[i] * scale2;
      if (edge && (col >= skv || (causal && col > row0 + 8 * h))) x = kNegInf;
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int h = (i / 2) % 2;
      const float p = exp2f(sc[i] - m[h]);
      sc[i] = p;
      psum[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
      psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
      l[h] = l[h] * corr[h] + psum[h];
    }
  }

  // p as bf16 A fragments: p_hi = bf16(p), p_lo = bf16(p - p_hi).
  __device__ __forceinline__ void to_fragments(const float (&sc)[64]) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = sc[8 * kk + 2 * r];
        const float b = sc[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        ph[kk][r] = bits(hi);
        if (P_TERMS == 2)
          pl[kk][r] = bits(__floats2bfloat162_rn(a - __low2float(hi),
                                                 b - __high2float(hi)));
      }
  }
};

// Accumulator layout of a wgmma m64nNk16 (float32), for thread t of the
// warpgroup: register i holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2)
// % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2.  So a row's values lie on
// the 4 threads of a quad, and registers 8 kk .. 8 kk + 7 of S are, packed
// in pairs, the A fragment of the PV product's k-step kk (columns 16 kk ..
// 16 kk + 15).  P_TERMS = 2 runs PV on p_hi and p_lo; 1 on bf16(p) alone
// (kept to measure what the split buys).
//
// A consumer overlaps each tile's softmax with the previous tile's PV
// product (FlashAttention-3's order): it issues S_t and PV_(t-1) together,
// waits for S_t, runs the softmax while PV_(t-1) runs, then waits for it,
// rescales O and builds P_t.  K and V have rings of their own, so a K tile
// is released as soon as its S is done.
template <int HD, int P_TERMS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* out, int bh, int sq, int skv,
                       float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  // full and empty barriers of stage s of the K (ring 0) and V (ring 1)
  // rings
  auto bar_full = [&](int ring, int s) {
    return bar_q + 8u * (1 + ring * kStages + s);
  };
  auto bar_empty = [&](int ring, int s) {
    return bar_q + 8u * (1 + (2 + ring) * kStages + s);
  };
  auto k_addr = [&](int s) { return base + L::kK + s * L::kTileBytes; };
  auto v_addr = [&](int s) { return base + L::kV + s * L::kTileBytes; };

  // Heavy causal blocks (the last query rows) are issued first.
  const int n_q = (sq + kRows - 1) / kRows;
  const int head = blockIdx.x % bh;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x / bh)) * kRows;
  const int q_last = min(q0 + kRows, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_tiles = (kv_end + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int ring = 0; ring < 2; ++ring)
      for (int s = 0; s < kStages; ++s) {
        mbar_init(bar_full(ring, s), 1);
        mbar_init(bar_empty(ring, s), 128 * kConsumers);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == kConsumers) {
    // The producer warpgroup gives up registers to the consumers; its
    // first thread issues every load: Q, then K_t and V_t in turn, each
    // into its ring's stage once the consumers have released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(bar_q, L::kTileBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(base + L::kQ + c * kBoxBytes, &tq, bar_q, c * kChunk, q0,
                 head);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const uint32_t parity = (t / kStages - 1) & 1;
        if (t >= kStages) mbar_wait(bar_empty(0, s), parity);
        mbar_expect_tx(bar_full(0, s), L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(k_addr(s) + c * kBoxBytes, &tk, bar_full(0, s),
                   c * kChunk, t * kTile, head);
        if (t >= kStages) mbar_wait(bar_empty(1, s), parity);
        mbar_expect_tx(bar_full(1, s), L::kTileBytes);
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(v_addr(s) + c * kBoxBytes, &tv, bar_full(1, s),
                   c * kChunk, t * kTile, head);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  Consumer<HD, P_TERMS> w;
  const int tid = threadIdx.x % 128;
  const float scale2 = scale * kLog2e;   // scores in log2 units: exp2f
  w.quad = tid % 4;
  w.first = q0 + group * 64;
  w.row0 = w.first + (tid / 32) * 16 + (tid % 32) / 4;
  const uint32_t q_addr = base + L::kQ + group * 64 * kRowBytes;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) w.o[i] = 0.f;
  mbar_wait(bar_q, 0);

  float corr[2];
  {  // tile 0: S, softmax, P (O is still zero)
    float sc[64];
    mbar_wait(bar_full(0, 0), 0);
    w.issue_s(sc, q_addr, k_addr(0));
    wgmma_wait_all();
    own(sc);
    mbar_arrive(bar_empty(0, 0));
    w.softmax(sc, corr, 0, scale2, skv, causal);
    w.to_fragments(sc);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int sp = (t - 1) % kStages;
    float sc[64];
    mbar_wait(bar_full(0, s), (t / kStages) & 1);
    w.issue_s(sc, q_addr, k_addr(s));
    mbar_wait(bar_full(1, sp), ((t - 1) / kStages) & 1);
    w.issue_pv(v_addr(sp));
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    own(sc);
    mbar_arrive(bar_empty(0, s));     // K_t is read
    w.softmax(sc, corr, t * kTile, scale2, skv, causal);
    wgmma_wait_all();
    w.release_pv();
    mbar_arrive(bar_empty(1, sp));    // V_(t-1) is read
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) w.o[i] *= corr[(i / 2) % 2];
    w.to_fragments(sc);
  }
  {  // the last tile's PV
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(bar_full(1, sp), ((n_tiles - 1) / kStages) & 1);
    w.issue_pv(v_addr(sp));
    wgmma_wait_all();
    w.release_pv();
    mbar_arrive(bar_empty(1, sp));
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w.row0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(w.l[h], 1e-30f);
    __nv_bfloat16* orow = out + (static_cast<long long>(head) * sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * w.quad) =
          __floats2bfloat162_rn(w.o[4 * j + 2 * h] / denom,
                                w.o[4 * j + 2 * h + 1] / denom);
  }
}

// A 3-D tensor map of a contiguous (BH, S, hd) bf16 tensor, boxes of (1,
// 128, 64) with the 128-byte swizzle; rows past S read as zeros.
bool encode(CUtensorMap* map, const void* p, int bh, int s, int hd) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(s) * hd * 2};
  const cuuint32_t box[3] = {kChunk, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int P_TERMS>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int bh, int sq, int skv, float scale, int causal,
                   cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(bh) * ((sq + kRows - 1) / kRows);
  if (blocks == 0) return cudaSuccess;
  if (blocks > INT_MAX || skv < 1) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, bh, sq, HD) || !encode(&tk, k, bh, skv, HD) ||
      !encode(&tv, v, bh, skv, HD))
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, P_TERMS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<HD>::kBytes);
  if (e != cudaSuccess) return e;
  flash_wgmma_kernel<HD, P_TERMS>
      <<<static_cast<unsigned>(blocks), kThreads, Layout<HD>::kBytes,
         stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), bh, sq, skv,
                   scale, causal);
  return cudaGetLastError();
}

}  // namespace wg

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

// q, k, v (bh, s, hd) and out (bh, sq, hd), all contiguous bfloat16 with
// 16-byte-aligned bases; hd 64 or 128 (hdv = hd).  p_terms: 2 (p_hi and
// p_lo, what the wrapper runs) or 1 (bf16(p) alone).  Returns a
// cudaError_t (0 on success); the launch is asynchronous on `stream`.
extern "C" int flash_attention_wgmma_launch(int device, const void* q,
                                            const void* k, const void* v,
                                            void* out, int bh, int sq,
                                            int skv, int hd, float scale,
                                            int causal, int p_terms,
                                            void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 128 && p_terms == 2)
    return wg::launch<128, 2>(q, k, v, out, bh, sq, skv, scale, causal, s);
  if (hd == 128 && p_terms == 1)
    return wg::launch<128, 1>(q, k, v, out, bh, sq, skv, scale, causal, s);
  if (hd == 64 && p_terms == 2)
    return wg::launch<64, 2>(q, k, v, out, bh, sq, skv, scale, causal, s);
  if (hd == 64 && p_terms == 1)
    return wg::launch<64, 1>(q, k, v, out, bh, sq, skv, scale, causal, s);
  return cudaErrorInvalidValue;
}
