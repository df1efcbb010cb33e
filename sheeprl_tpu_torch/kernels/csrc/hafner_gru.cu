// The Hafner LayerNorm-GRU for Hopper (sm_90a), forward only: one step and
// a whole sequence.
//
// Replaces the TPU kernels `_cell_kernel` / `hafner_cell` and `_seq_kernel` /
// `hafner_sequence` in sheeprl_tpu/kernels/pallas_tpu.py (the Pallas cell of
// the DreamerV2 RSSM recurrent core, and the same cell scanned over T with h
// carried). One step computes, for every batch row,
//
//   z  = [h | x] . W + b                     W is the joint [H+X, 3H] kernel, h rows first
//   z  = LayerNorm(z) * ln_scale + ln_bias   over the 3H lanes, two-pass f32 statistics
//   r  = sigmoid(z_r), c = tanh(r * z_c), u = sigmoid(z_u - 1)
//   h' = u * c + (1 - u) * h
//
// with the bias and the LayerNorm each optional (null pointers).
//
// What bounds it on an H100. At the DreamerV2 width (H=600, X=400) W is
// 7.2 MB of f32 and the step does 2*B*1000*1800 FLOP. Kept at f32 accuracy
// on the tensor cores (3 TF32 passes, below) that is 3x the TF32 work at 495
// TFLOP/s: one pass over W from device memory (2.2 us) bounds the step up to
// about B=64, the tensor cores from there on (35 us at B=1600, where the
// training imagination runs). So the product runs on `wgmma` at every B, and:
// - at small B (up to 64 rows) the blocks are small and many: one warpgroup,
//   64 features and the whole batch each, with K split across blocks so that
//   about two blocks per SM each stream a slice of W once; the chain of
//   loads a block waits on, not the bytes, sets the time there;
// - at large B a block of three warpgroups takes 192 features by 64 or 128
//   batch rows, one block per SM in one wave (130 blocks at B=801 and 1600):
//   W is read once per batch tile (13 times at B=1600) and [h | x] once per
//   192 features (10 times), where 64-feature blocks would read it 29 times.
// The LayerNorm needs the whole 3H row before any gate, and a row is spread
// over the feature tiles, so a step is two launches on one stream:
//
// 1. hafner_product_kernel: partial products of [a | b] . W over a K range,
//    a [M, Ka] and b [M, Kb] (Kb may be 0), W [Ka+Kb, N]. It computes the
//    transpose, z^T = W^T . [a | b]^T, because wgmma takes f32 (TF32)
//    operands from shared memory only K-major, and W is stored N-major (and
//    updated in place by the optimizer, so no transposed copy is kept):
//    - the wgmma M is 64 output features per warpgroup (grid x: ceil(N /
//      (64 * kWG)) tiles, the last one masked), the wgmma N is NT batch rows
//      (grid y; NT = 8 ... 128, product_plan), and grid z splits K into
//      ranges of `split_chunks` chunks of kChunk = 32 rows;
//    - A = W^T comes from registers: each thread loads its fragment straight
//      from device memory (two float2 per k8 step: output features are
//      permuted so that a fragment's two rows are adjacent columns of W), and
//      splits it into hi = tf32(w) and lo = tf32(w - hi) with cvt.rna;
//    - B = [a | b]^T is K-major as stored ([M, K] row-major). The block's
//      threads load each chunk one chunk ahead into registers, split it into
//      hi and lo, and write both to one of two shared-memory stages in
//      wgmma's canonical no-swizzle K-major layout (8 x 16-byte core
//      matrices), which every warpgroup of the block reads;
//    - per k8 step, three wgmma.m64nNk8.f32.tf32 accumulate
//      w_hi.a_hi + w_hi.a_lo + w_lo.a_hi in f32 registers ("3xTF32": the
//      dropped w_lo.a_lo term is below f32 rounding; one TF32 pass alone
//      keeps about three decimal digits). The tensor cores' own rounding of
//      the f32 sum makes the product's error grow with K faster than an
//      f32 FMA chain's (PERF.md has the readings);
//    - a warpgroup writes the next chunk's B operand while its wgmmas run,
//      and waits for them only before it overwrites their A registers; the
//      other warpgroups (and, at small B, other blocks) keep the tensor cores
//      busy while it converts;
//    - the block writes its split's partial z [S, M, N], float2 stores.
//    Ragged edges load as zeros: K past Ka+Kb, features past N, rows past M.
// 2. hafner_gates_kernel: one block per batch row sums the S partials, the
//    bias and, for a sequence step, the input projection's partials zx into
//    shared memory (and writes that z out when the caller keeps it for the
//    gradient), takes the LayerNorm statistics over the row in two passes
//    (the mean, then the mean of squared deviations, as models/norm.py does),
//    and runs the affine and the gates. It stays a second launch: fusing it
//    into the product's epilogue would need the row's statistics across
//    10-29 blocks (a cluster holds at most 16), and it takes 12-16 us at
//    B=1600 beside the product's 85 us (PERF.md).
//
// A step of the cell is [h | x] . W (a = h, b = x), then the gates. The
// sequence (xs [T, B, X] -> hs [T, B, H]) first projects every input at once,
// zx = xs . W[H:] (one product launch over M = T*B rows, the Pallas kernel's
// `xs_ref[0] . w[Hp:]` hoisted out of the time loop: a real GEMM at M = 800
// on the three-warpgroup path), then runs the recurrence over T in one of two
// variants, chosen by hafner_sequence_plan before the launch:
//
// - persistent (B <= 64, and every block of the grid co-resident with its
//   slice of W[:H] in shared memory: up to about H = 630 on an H100 at B=64,
//   where 30 clusters of 4 fit at one block per SM, a little more at small
//   B; the occupancy query decides): ONE
//   cooperative launch, hafner_recurrence_kernel, which loads W[:H] from
//   device memory once and keeps it on chip for all T steps. At B=16 a step
//   is 104 MFLOP of TF32 work (0.2 us on the tensor cores), so its time is
//   latency: the chain of a step's dependent phases and its grid barriers.
//   The layout keeps that chain short:
//   - features are permuted so that one wgmma M tile of 64 rows holds the
//     three gate columns (j, H+j, 2H+j) of 21 hidden units (plus one zero
//     row): ceil(H/21) unit groups, 29 at H=600, and a unit's gates never
//     leave its tile;
//   - K = H is split over a cluster of kKSplit = 4 blocks; each block holds
//     its [64 x H/4] slice of W[:H]^T as TF32 hi and lo in shared memory,
//     K-major (W is transposed once, when it is loaded), so both wgmma
//     operands come from shared memory (the SS form): 116 blocks at H=600,
//     about 100 KB each at B=16, of two warpgroups (four at N=64), each
//     running the product over a share of the block's K slice; every warp
//     stages h and gates a batch row;
//   - a step: each block stages its K slice of h_{t-1} (from L2) as hi/lo,
//     runs kq/8 x 3 wgmma.m64nNk8 into registers, writes its partial to its
//     shared memory; the cluster sums the four partials over distributed
//     shared memory (each block a quarter of the batch rows) and adds zx[t]
//     and the bias; each unit group publishes per-row LayerNorm partials
//     (mean and M2 over its columns) to a small global scratch; grid
//     barrier; every block merges the groups' partials by Chan's formula
//     (the two-pass statistics of models/norm.py, merged exactly), runs the
//     affine and the gates for its units and rows, and writes h_t; grid
//     barrier. Without LayerNorm the first barrier goes.
//   The grid barrier is a build constant (kGridSync): cooperative_groups'
//   grid sync or the hand-written one below, timed against each other by
//   tools/bench_variants.py; hafner_sync_floor times a step's
//   synchronisation alone.
// - multi-launch (past those limits, e.g. H=2048): T steps of h . W[:H]
//   (a = h, Kb = 0) and the gate kernel with zx[t] added, 2 launches a step,
//   h through device memory and W[:H] read again every step.
//
// Both variants can write the pre-LayerNorm z [T, B, 3H] (with the bias)
// for the gradient, which then recomputes no product.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                 // the gate kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kWgThreads = 128;               // threads of one warpgroup
constexpr int kTileM = 64;                    // output features per warpgroup (the wgmma M)
constexpr int kWideWG = 3;                    // warpgroups per product block past 64 batch rows
constexpr int kChunk = 32;                    // K rows per pipeline step
constexpr int kSteps = kChunk / 8;            // wgmma k8 steps per chunk
constexpr int kCoreFloats = 32;               // one core matrix: 8 rows of 16 bytes
constexpr uint32_t kLbo = 128;                // bytes between K-adjacent core matrices
constexpr uint32_t kSbo = 128 * (kChunk / 4); // bytes between N-adjacent core matrices
constexpr int kMaxSmem = 232448;              // a block's shared-memory ceiling on sm_90
// the persistent recurrence
constexpr int kUnits = 21;       // hidden units per unit group: 3 x 21 gate columns + 1 zero row = one wgmma M tile
constexpr int kKSplit = 4;       // blocks per cluster, each a K slice of W[:H]
constexpr int kPartStride = 68;  // floats per batch row of a block's partial tile (64 + 4: no bank conflicts)
constexpr int kHPad = 32;        // floats a warp keeps of h_{t-1} at its group's units (one a lane)
constexpr int kMaxGroups = 64;   // unit groups a row's LayerNorm statistics merge (two a lane)
constexpr int kGridSync = 1;     // the grid barrier: 1 cooperative_groups' grid sync, 0 the hand-written one

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the block; every thread gets it. `red` holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  __syncthreads();  // `red` may be reused
  return t;
}

// ---------------------------------------------------------------------------
// wgmma and TF32 helpers
// ---------------------------------------------------------------------------

// Round to TF32 (10 mantissa bits), to nearest, ties away from zero; the
// result is an f32 bit pattern with the low 13 bits zero.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

// Float offset, in a no-swizzle K-major operand of `kgroups` 16-byte column
// groups a row, of row n, column group j (k = 4j .. 4j+3): core matrix
// (n / 8, j), its row n % 8.
__device__ __forceinline__ int kmajor_offset(int n, int j, int kgroups) {
  return ((n >> 3) * kgroups + j) * kCoreFloats + 4 * (n & 7);
}

__device__ __forceinline__ int stage_offset(int n, int j) { return kmajor_offset(n, j, kChunk / 4); }

// Matrix descriptor of k8 step s (core-matrix columns 2s and 2s+1) of a
// no-swizzle K-major operand in shared memory whose 8-row groups are `sbo`
// bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(const float* base, int s, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(base + 2 * s * kCoreFloats));
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((kLbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

__device__ __forceinline__ uint64_t smem_desc(const float* stage, int s) { return kmajor_desc(stage, s, kSbo); }

// Keep the compiler from moving reads or writes of a register across the
// asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int NA>
__device__ __forceinline__ void fence_operands(float (&acc)[NA], uint32_t (&ahi)[kSteps][4],
                                               uint32_t (&alo)[kSteps][4]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fence_reg(ahi[s][r]);
      fence_reg(alo[s][r]);
    }
  }
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// d[64 x N] += A[64 x 8] . B[8 x N]: A (TF32) from four registers a thread,
// B from shared memory through `desc`, f32 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc);

#define D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : D4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : D4(0), D4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28),
        D4(32), D4(36), D4(40), D4(44), D4(48), D4(52), D4(56), D4(60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x N] += A[64 x 8] . B[8 x N], both operands from shared memory (the
// SS form) through their descriptors.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tf32_ss<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : D4(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : D4(0), D4(4)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
      : "l"(da), "l"(db), "r"(1));
}

#undef D4

// ---------------------------------------------------------------------------
// the product
// ---------------------------------------------------------------------------

// This thread's A fragment of chunk c: wr[s] = {W[k][f0], W[k][f0+1],
// W[k+4][f0], W[k+4][f0+1]} with k = c*kChunk + 8s + (lane & 3), which are
// the fragment's a0..a3 (rows g and g+8, columns t and t+4) when fragment
// row g is feature f0 and row g+8 is feature f0+1. Zeros past K and N.
template <bool kVec>
__device__ __forceinline__ void load_w_frag(float (&wr)[kSteps][4], const float* __restrict__ w, int c, int f0, int K,
                                            int N) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = c * kChunk + 8 * s + (threadIdx.x & 3) + 4 * half;
      const float* p = w + static_cast<size_t>(k) * N + f0;
      if (kVec) {
        float2 v = make_float2(0.f, 0.f);
        if (k < K && f0 < N) v = __ldg(reinterpret_cast<const float2*>(p));
        wr[s][2 * half] = v.x;
        wr[s][2 * half + 1] = v.y;
      } else {
        wr[s][2 * half] = k < K && f0 < N ? __ldg(p) : 0.f;
        wr[s][2 * half + 1] = k < K && f0 + 1 < N ? __ldg(p + 1) : 0.f;
      }
    }
  }
}

// Address of [a | b][row, k]: a [M, Ka] then b [M, Kb], both row-major.
__device__ __forceinline__ const float* element(const float* a, const float* b, int row, int k, int Ka, int Kb) {
  return k < Ka ? a + static_cast<size_t>(row) * Ka + k : b + static_cast<size_t>(row) * Kb + (k - Ka);
}

// One chunk of [a | b] (NT rows from n0, K columns c*kChunk ...) over the
// kBlock threads of a block: kPer floats a thread, zeros past M and K. The
// 16-byte path gives a thread float4s; element e of the chunk's NT*8
// float4s is row 8*(e >> 6) + (e & 7), column group ((e >> 5) & 1) * 4 +
// ((e >> 3) & 3), so that 8 neighbouring lanes fill one 128-byte core matrix
// (no bank conflicts) and 4 lanes read 64 contiguous bytes of a row. The
// scalar path gives element e = row e / kChunk, column e % kChunk.
template <int NT, int kBlock, bool kVec>
struct ActChunk {
  static constexpr int kFloat4s = NT * kChunk / 4;
  static constexpr int kPer = kVec ? 4 * ((kFloat4s + kBlock - 1) / kBlock) : (NT * kChunk + kBlock - 1) / kBlock;
  float v[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ a, const float* __restrict__ b, int c, int n0, int M,
                                       int Ka, int Kb) {
    const int K = Ka + Kb;
    if (kVec) {
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        const int e = threadIdx.x + kBlock * i;
        const int n = 8 * (e >> 6) + (e & 7);
        const int k = c * kChunk + 4 * (((e >> 5) & 1) * 4 + ((e >> 3) & 3));
        const int row = n0 + n;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < kFloat4s && row < M && k < K) {
          x = __ldg(reinterpret_cast<const float4*>(element(a, b, row, k, Ka, Kb)));
        }
        v[4 * i] = x.x;
        v[4 * i + 1] = x.y;
        v[4 * i + 2] = x.z;
        v[4 * i + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + kBlock * i;
        const int row = n0 + e / kChunk;
        const int k = c * kChunk + e % kChunk;
        float x = 0.f;
        if (e < NT * kChunk && row < M && k < K) x = __ldg(element(a, b, row, k, Ka, Kb));
        v[i] = x;
      }
    }
  }

  // Split into TF32 hi and lo and write both to a stage: row n, column kk of
  // the chunk goes to core matrix (n / 8, kk / 4), its row n % 8, lane kk % 4.
  __device__ __forceinline__ void store(float* hi, float* lo) const {
    if (kVec) {
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        const int e = threadIdx.x + kBlock * i;
        if (e >= kFloat4s) continue;
        const int off = stage_offset(8 * (e >> 6) + (e & 7), ((e >> 5) & 1) * 4 + ((e >> 3) & 3));
        uint32_t h[4], l[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) split_tf32(v[4 * i + u], h[u], l[u]);
        *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = threadIdx.x + kBlock * i;
        if (e >= NT * kChunk) continue;
        const int n = e / kChunk, kk = e % kChunk;
        const int off = stage_offset(n, kk >> 2) + (kk & 3);
        uint32_t h, l;
        split_tf32(v[i], h, l);
        hi[off] = __uint_as_float(h);
        lo[off] = __uint_as_float(l);
      }
    }
  }
};

// kVec: Ka, Kb and N multiples of 4 and every pointer 16-byte aligned.
// NT: batch rows per block (the wgmma N). kWG: warpgroups per block, each
// with its own 64 output features and the block's shared B operand. Each
// split covers `split_chunks` chunks of K. Dynamic shared memory: two stages
// of {hi, lo} [NT x kChunk].
template <int NT, int kWG, bool kVec>
__global__ void __launch_bounds__(kWgThreads * kWG, 1) hafner_product_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ w,
    float* __restrict__ zpart, int M, int Ka, int Kb, int N, int split_chunks) {
  extern __shared__ __align__(128) float smem[];
  constexpr int kStage = NT * kChunk;  // floats of hi (and of lo) in one stage

  const int K = Ka + Kb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // features of fragment rows g and g+8 of this warp's 16 rows of its warpgroup's 64
  const int f0 = blockIdx.x * kTileM * kWG + 16 * warp + 2 * (lane >> 2);
  const int n0 = blockIdx.y * NT;
  const int chunks = (K + kChunk - 1) / kChunk;
  const int q0 = blockIdx.z * split_chunks;
  const int nq = min(split_chunks, chunks - q0);

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  float wr[kSteps][4];
  ActChunk<NT, kWgThreads * kWG, kVec> act;
  load_w_frag<kVec>(wr, w, q0, f0, K, N);
  act.load(a, b, q0, n0, M, Ka, Kb);

  uint32_t ahi[kSteps][4], alo[kSteps][4];
  for (int q = 0; q < nq; ++q) {
    // the chunk's B operand into stage q % 2 while chunk q-1's wgmmas run
    // (the stage was last read by chunk q-2, whose wgmmas every warpgroup
    // waited for before the barrier of chunk q-1); then, once chunk q-1's
    // wgmmas are done, its A fragments into registers; then the next chunk's
    // loads go out, to land while this chunk's wgmmas run
    float* hi = smem + (q & 1) * 2 * kStage;
    float* lo = hi + kStage;
    act.store(hi, lo);
    wgmma_wait_all();
    fence_operands(acc, ahi, alo);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(wr[s][r], ahi[s][r], alo[s][r]);
    }
    if (q + 1 < nq) {
      load_w_frag<kVec>(wr, w, q0 + q + 1, f0, K, N);
      act.load(a, b, q0 + q + 1, n0, M, Ka, Kb);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic-proxy writes -> wgmma reads
    __syncthreads();

    fence_operands(acc, ahi, alo);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint64_t dhi = smem_desc(hi, s);
      const uint64_t dlo = smem_desc(lo, s);
      wgmma_tf32<NT>(acc, ahi[s], dhi);
      wgmma_tf32<NT>(acc, ahi[s], dlo);
      wgmma_tf32<NT>(acc, alo[s], dhi);
    }
    wgmma_commit();
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) fence_reg(acc[i]);

  // acc[4j + {0, 1, 2, 3}] = z^T at (row g, col 8j+2t), (g, 8j+2t+1),
  // (g+8, 8j+2t), (g+8, 8j+2t+1): features f0 / f0+1 of batch rows n, n+1
  if (f0 >= N) return;
  float* zs = zpart + static_cast<size_t>(blockIdx.z) * M * N;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + 8 * j + 2 * t + r;
      if (n >= M) continue;
      float* p = zs + static_cast<size_t>(n) * N + f0;
      if (kVec) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j + r], acc[4 * j + 2 + r]);
      } else {
        p[0] = acc[4 * j + r];
        if (f0 + 1 < N) p[1] = acc[4 * j + 2 + r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the LayerNorm and the gates
// ---------------------------------------------------------------------------

// Four floats p[j .. j+3]: one 16-byte load (kVec), else zeros at and past `limit`.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int j, int limit) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p + j));
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = j + u < limit ? __ldg(p + j + u) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A gate group's operands at columns j .. j+3 of each gate: the LayerNorm's
// scale and bias (when `norm`) and h.
template <bool kVec>
__device__ __forceinline__ void load_gate_operands(float4 (&sc)[3], float4 (&lb)[3], float4& hv,
                                                   const float* __restrict__ ln_scale,
                                                   const float* __restrict__ ln_bias, const float* __restrict__ hrow,
                                                   int j, int H, bool norm) {
  if (norm) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      sc[g] = load4<kVec>(ln_scale + g * H, j, H);
      lb[g] = load4<kVec>(ln_bias + g * H, j, H);
    }
  }
  hv = load4<kVec>(hrow, j, H);
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// One block per batch row: z = bias + the splits' partials [+ the input
// projection's partials zx, `zx_splits` planes `zx_plane` floats apart], then
// the LayerNorm and the gates. Dynamic shared memory holds the row's 3H
// floats. `zsave` (may be null) receives z; it may be `zpart` itself when
// there is one split (each thread reads its elements before writing them).
// kEarly (for grids of fewer rows than SMs, where a block's chain of loads
// sets the time): a thread's first gate group's operands are loaded before
// the partial sums, so that their latency hides behind them; with many rows
// the registers they hold would cost occupancy instead.
template <bool kVec, bool kEarly>
__global__ void __launch_bounds__(kThreads) hafner_gates_kernel(
    const float* zpart, int splits, const float* __restrict__ zx, int zx_splits, size_t zx_plane,
    const float* __restrict__ h, const float* __restrict__ bias, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float* zsave, float* __restrict__ out, int B, int H, float eps) {
  extern __shared__ float4 zrow4[];
  float* zrow = reinterpret_cast<float*>(zrow4);
  __shared__ float red[kWarps];
  const int N = 3 * H;
  const size_t row = blockIdx.x;
  const size_t plane = static_cast<size_t>(B) * N;
  const int nzx = zx != nullptr ? zx_splits : 0;
  const bool norm = ln_scale != nullptr;

  const int j0 = 4 * threadIdx.x;
  float4 sc[3], lb[3], hv;
  if (kEarly && j0 < H) load_gate_operands<kVec>(sc, lb, hv, ln_scale, ln_bias, h + row * H, j0, H, norm);

  // z = bias + the splits' partials; on the 16-byte path the partials of a
  // column group are loaded kBatch planes at a time (predicated past the
  // last), so that kBatch loads are in flight whatever the number of splits
  // (16 where a block's chain of loads sets the time: up to 16 splits in
  // one round trip)
  constexpr int kBatch = kEarly ? 16 : 8;
  float sum = 0.f;
  if (kVec) {
    const float4* zp = reinterpret_cast<const float4*>(zpart) + row * (N / 4);
    const float4* zq = reinterpret_cast<const float4*>(zx) + row * (N / 4);
    const float4* b4 = reinterpret_cast<const float4*>(bias);
    for (int j4 = threadIdx.x; j4 < N / 4; j4 += kThreads) {
      float4 s = bias != nullptr ? __ldg(b4 + j4) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (splits == 1) {
        add4(s, zp[j4]);
      } else {
        for (int p0 = 0; p0 < splits; p0 += kBatch) {
          float4 v[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            v[u] = p0 + u < splits ? zp[(p0 + u) * (plane / 4) + j4] : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) add4(s, v[u]);
        }
      }
      for (int q = 0; q < nzx; ++q) add4(s, __ldg(zq + q * (zx_plane / 4) + j4));
      zrow4[j4] = s;
      if (zsave != nullptr) reinterpret_cast<float4*>(zsave)[row * (N / 4) + j4] = s;
      sum += (s.x + s.y) + (s.z + s.w);
    }
  } else {
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float s = bias != nullptr ? bias[j] : 0.f;
      for (int p = 0; p < splits; ++p) s += zpart[p * plane + row * N + j];
      for (int q = 0; q < nzx; ++q) s += zx[q * zx_plane + row * N + j];
      zrow[j] = s;
      if (zsave != nullptr) zsave[row * N + j] = s;
      sum += s;
    }
  }
  float mean = 0.f, rstd = 1.f;
  if (norm) {
    mean = block_sum(sum, red) / N;  // its barrier also publishes zrow
    float sq = 0.f;
    for (int j = threadIdx.x; j < N; j += kThreads) {
      const float d = zrow[j] - mean;
      sq += d * d;
    }
    rstd = rsqrtf(block_sum(sq, red) / N + eps);
  } else {
    __syncthreads();
  }

  for (int j = j0; j < H; j += 4 * kThreads) {
    if (!kEarly || j != j0) load_gate_operands<kVec>(sc, lb, hv, ln_scale, ln_bias, h + row * H, j, H, norm);
    float zg[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int u = 0; u < 4; ++u) zg[g][u] = j + u < H ? zrow[g * H + j + u] : 0.f;
      if (norm) {
        zg[g][0] = (zg[g][0] - mean) * rstd * sc[g].x + lb[g].x;
        zg[g][1] = (zg[g][1] - mean) * rstd * sc[g].y + lb[g].y;
        zg[g][2] = (zg[g][2] - mean) * rstd * sc[g].z + lb[g].z;
        zg[g][3] = (zg[g][3] - mean) * rstd * sc[g].w + lb[g].w;
      }
    }
    const float hp[4] = {hv.x, hv.y, hv.z, hv.w};
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float reset = sigmoid_f(zg[0][u]);
      const float cand = tanhf(reset * zg[1][u]);
      const float update = sigmoid_f(zg[2][u] - 1.f);
      o[u] = update * cand + (1.f - update) * hp[u];
    }
    if (kVec) {
      *reinterpret_cast<float4*>(out + row * H + j) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j + u < H) out[row * H + j + u] = o[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the persistent recurrence
// ---------------------------------------------------------------------------

// A barrier across the whole cooperative grid. kGridSync = 0: one thread a
// block adds to one word with release semantics (block 0 adds 2^31 - (blocks
// - 1), every other block 1, so that a barrier flips the word's top bit and
// leaves its low bits as they were: no reset between barriers, launches or
// graph replays) and spins on relaxed loads until the bit flips, then an
// acquire fence.
__device__ __forceinline__ void grid_sync(unsigned* word) {
  if constexpr (kGridSync == 1) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
      const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (blocks - 1) : 1u;
      unsigned old, now;
      asm volatile("atom.add.release.gpu.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(word), "r"(inc) : "memory");
      do {
        asm volatile("ld.relaxed.gpu.u32 %0, [%1];\n" : "=r"(now) : "l"(word) : "memory");
      } while (((now ^ old) & 0x80000000u) == 0);
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    __syncthreads();
  }
}

// Warps of the recurrence kernel's block for NT batch rows: eight, or one a
// row it gates past that (16 at NT = 64). Every warp stages h and gates a
// row; every warpgroup runs the product over a share of the K slice.
__host__ __device__ constexpr int recurrence_warps(int nt) { return nt / kKSplit > 8 ? nt / kKSplit : 8; }

// Shared memory of the recurrence kernel in bytes, for NT batch rows (the
// wgmma N) and kq rows of K a block: W's slice and h's as hi and lo, the
// partial tile, the rows the block gates (z and h_{t-1}) and the tile's
// bias and LayerNorm columns.
size_t recurrence_smem_bytes(int nt, int kq) {
  return sizeof(float) * (2 * static_cast<size_t>(kTileM) * kq + 2 * static_cast<size_t>(nt) * kq +
                          static_cast<size_t>(nt) * kPartStride + (nt / kKSplit) * kTileM +
                          recurrence_warps(nt) * kHPad + 3 * kTileM);
}

// One block per (unit group g, K slice q), the K slices of a group one
// cluster; every block co-resident (cooperative launch). zx: the input
// projection's `zx_splits` partial planes, `zx_plane` floats apart (null
// without inputs). stats: [2, B, groups] (mean, M2) scratch, by step parity.
// zsave (may be null): z [T, B, 3H]. hs: [T, B, H], read back as h_{t-1}.
// kVec: H % 4 == 0 and h0, hs 16-byte aligned.
template <int NT, bool kVec>
__global__ void __launch_bounds__(32 * recurrence_warps(NT), 1) hafner_recurrence_kernel(
    const float* __restrict__ h0, const float* __restrict__ zx, int zx_splits, size_t zx_plane,
    const float* __restrict__ w, const float* __restrict__ bias, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float2* stats, unsigned* barrier, float* zsave, float* hs, int T, int B,
    int H, int kq, float eps) {
  constexpr int kWarpsRec = recurrence_warps(NT);
  constexpr int kBlock = 32 * kWarpsRec;
  constexpr int kWG = kWarpsRec / 4;  // warpgroups, each a share of the block's K slice
  constexpr int kRows = NT / kKSplit;  // batch rows a block gates, at most: one a warp
  constexpr int kBatch = NT == 64 ? 4 : 8;  // float4 loads a lane keeps in flight while staging h
  extern __shared__ __align__(128) float smem[];
  float* a_hi = smem;                   // [64 x kq] W[:H]^T slice, K-major
  float* a_lo = a_hi + kTileM * kq;
  float* b_hi = a_lo + kTileM * kq;     // [NT x kq] h_{t-1} slice, K-major
  float* b_lo = b_hi + NT * kq;
  float* part = b_lo + NT * kq;         // [NT][kPartStride] this block's partial z^T, by batch row
  float* zrow = part + NT * kPartStride;  // [kRows][64] z of the rows this block gates
  float* hprev = zrow + kRows * kTileM;   // [warps][kHPad] h_{t-1} of each warp's row at the group's units
  float* cbias = hprev + kWarpsRec * kHPad;  // [64] each: the tile's bias, LayerNorm scale and shift
  float* cscale = cbias + kTileM;
  float* cshift = cscale + kTileM;

  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());  // K slice; and this block gates batch rows q, q+4, ...
  const int g = blockIdx.x / kKSplit;                     // unit group: hidden units u0 .. u0+ug-1
  const int groups = gridDim.x / kKSplit;
  const int u0 = g * kUnits;
  const int ug = min(kUnits, H - u0);
  const int k0 = q * kq;
  const int kn = max(0, min(kq, H - k0));                 // rows of K this block holds
  const int N = 3 * H;
  const bool norm = ln_scale != nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kgroups = kq / 4;
  const uint32_t sbo = 128u * kgroups;  // bytes between 8-row groups, of both operands
  const int rows_mine = B > q ? (B - q + kKSplit - 1) / kKSplit : 0;
  // warpgroup (the wgmma descriptors depend on it), broadcast from lane 0 so
  // that the compiler can prove it warp-uniform, as CUTLASS does
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  // warp i gates batch row n = q + 4i (when i < rows_mine)
  const bool live = warp < rows_mine;
  const int n_mine = q + kKSplit * warp;

  // W[:H]^T's slice, once for all T steps: tile row m = gate * 21 + u is
  // feature gate * H + u0 + u; rows 63 and past the group's units are zero.
  // The prologue's loops run the same count in every thread (64 kq and
  // 2 NT kq are multiples of the block) and its stores take no branch: a
  // thread-dependent loop or branch here made ptxas serialise the step
  // loop's wgmmas (its C7520 warning)
  for (int i = 0; i < kTileM * kq / kBlock; ++i) {
    const int e = threadIdx.x + i * kBlock;
    const int kk = e / kTileM, m = e % kTileM;
    const int gate = m / kUnits, u = m % kUnits;
    const bool in = m < 3 * kUnits && u < ug && kk < kn;
    const float v = in ? __ldg(w + static_cast<size_t>(k0 + kk) * N + gate * H + u0 + u) : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int off = kmajor_offset(m, kk >> 2, kgroups) + (kk & 3);
    a_hi[off] = __uint_as_float(hi);
    a_lo[off] = __uint_as_float(lo);
  }
  for (int i = 0; i < 2 * NT * kq / kBlock; ++i) b_hi[threadIdx.x + i * kBlock] = 0.f;  // b_lo too
  {
    // column m of the tile, written alike by every thread whose index is m mod 64
    const int m = threadIdx.x % kTileM, gate = m / kUnits, u = m % kUnits;
    const bool col = m < 3 * kUnits && u < ug;
    const int f = gate * H + u0 + u;
    cbias[m] = col && bias != nullptr ? __ldg(bias + f) : 0.f;
    cscale[m] = col && norm ? __ldg(ln_scale + f) : 0.f;
    cshift[m] = col && norm ? __ldg(ln_bias + f) : 0.f;
  }
  hprev[warp * kHPad + lane] = live && lane < ug ? __ldg(h0 + static_cast<size_t>(n_mine) * H + u0 + lane) : 0.f;
  const float* part_of[kKSplit];
#pragma unroll
  for (int r = 0; r < kKSplit; ++r) part_of[r] = cluster.map_shared_rank(part, r);
  // the operands' descriptors at k8 step 0; step s is 2s core matrices (256
  // bytes, 16 in the descriptor's address field) further along K
  const uint64_t desc_ahi = kmajor_desc(a_hi, 0, sbo), desc_alo = kmajor_desc(a_lo, 0, sbo);
  const uint64_t desc_bhi = kmajor_desc(b_hi, 0, sbo), desc_blo = kmajor_desc(b_lo, 0, sbo);
  __syncthreads();  // the zeroed B operand before any thread stages into it

  float acc[NT / 2];
  for (int t = 0; t < T; ++t) {
    // zx[t]'s first partial plane at this warp's row and the tile's columns
    // (lane, lane + 32), loaded first and not used until after the product,
    // so that it lands meanwhile
    float zxv[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = lane + 32 * cc, u = c % kUnits;
      const bool load = zx_splits > 0 && live && c < 3 * kUnits && u < ug;
      zxv[cc] = load ? __ldg(zx + (static_cast<size_t>(t) * B + n_mine) * N + (c / kUnits) * H + u0 + u) : 0.f;
    }

    // h_{t-1}'s K slice as the B operand, split into TF32 hi and lo (written
    // by other blocks in this launch: loads through L2, never the read-only
    // path). 16-byte path: a warp takes tiles of 8 rows x 4 column groups, so
    // that 8 neighbouring lanes fill one 128-byte core matrix (no bank
    // conflicts) and 4 lanes read 64 contiguous bytes of a row; kBatch loads
    // a lane in flight before any is used (register loads measured faster
    // here than cp.async into shared memory).
    const float* hsrc = t == 0 ? h0 : hs + static_cast<size_t>(t - 1) * B * H;
    if (kVec) {
      const int tiles_k = (kn + 15) / 16, tiles = (B + 7) / 8 * tiles_k;
      const int n8 = lane & 7, j4 = lane >> 3;
      for (int t0 = warp; t0 < tiles; t0 += kBatch * kWarpsRec) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int tile = t0 + b * kWarpsRec;
          const int n = 8 * (tile / tiles_k) + n8, j = 4 * (tile % tiles_k) + j4;
          v[b] = tile < tiles && n < B && 4 * j < kn
                     ? __ldcg(reinterpret_cast<const float4*>(hsrc + static_cast<size_t>(n) * H + k0 + 4 * j))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int tile = t0 + b * kWarpsRec;
          const int n = 8 * (tile / tiles_k) + n8, j = 4 * (tile % tiles_k) + j4;
          if (tile < tiles && n < B && 4 * j < kn) {
            const int off = kmajor_offset(n, j, kgroups);
            uint32_t hi[4], lo[4];
            split_tf32(v[b].x, hi[0], lo[0]);
            split_tf32(v[b].y, hi[1], lo[1]);
            split_tf32(v[b].z, hi[2], lo[2]);
            split_tf32(v[b].w, hi[3], lo[3]);
            *reinterpret_cast<uint4*>(b_hi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<uint4*>(b_lo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          }
        }
      }
    } else {
      for (int n = warp; n < B; n += kWarpsRec) {
        for (int kk = lane; kk < kn; kk += 32) {
          uint32_t hi, lo;
          split_tf32(__ldcg(hsrc + static_cast<size_t>(n) * H + k0 + kk), hi, lo);
          const int off = kmajor_offset(n, kk >> 2, kgroups) + (kk & 3);
          b_hi[off] = __uint_as_float(hi);
          b_lo[off] = __uint_as_float(lo);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic-proxy writes -> wgmma reads
    __syncthreads();

    // this block's partial z^T [64 x NT] over its K slice, 3xTF32: every
    // warpgroup takes its share of the k8 steps (all issue wgmma, so none is
    // on a divergent path, which would serialise them), then the
    // warpgroups' sums go into `part` in warpgroup order
    {
      const int steps = kq / (8 * kWG);  // the same count for every warpgroup: no divergent wgmma
      const uint64_t first = 16u * wg * steps;
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) {
        acc[i] = 0.f;
        fence_reg(acc[i]);
      }
      wgmma_fence();
      for (int s = 0; s < steps; ++s) {
        const uint64_t step = first + 16u * s;
        wgmma_tf32_ss<NT>(acc, desc_ahi + step, desc_bhi + step);
        wgmma_tf32_ss<NT>(acc, desc_ahi + step, desc_blo + step);
        wgmma_tf32_ss<NT>(acc, desc_alo + step, desc_bhi + step);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) fence_reg(acc[i]);

      // acc[4j + {0, 1, 2, 3}] = z^T at (row r, col n), (r, n+1), (r+8, n),
      // (r+8, n+1) with r = 16 (warp % 4) + lane / 4, n = 8j + 2 (lane % 4)
      const int r = 16 * (warp & 3) + (lane >> 2), n0 = 2 * (lane & 3);
      for (int w = 0; w < kWG; ++w) {
        if (wg == w) {
#pragma unroll
          for (int j = 0; j < NT / 8; ++j) {
            const int n = 8 * j + n0;
            float* p0 = part + n * kPartStride + r;
            float* p1 = p0 + kPartStride;
            p0[0] = w == 0 ? acc[4 * j] : p0[0] + acc[4 * j];
            p1[0] = w == 0 ? acc[4 * j + 1] : p1[0] + acc[4 * j + 1];
            p0[8] = w == 0 ? acc[4 * j + 2] : p0[8] + acc[4 * j + 2];
            p1[8] = w == 0 ? acc[4 * j + 3] : p1[8] + acc[4 * j + 3];
          }
        }
        __syncthreads();
      }
    }
    cluster.sync();  // the cluster's four partials are written and visible

    // z of this warp's row: the four K slices' partials (distributed shared
    // memory, in rank order), zx[t] and the bias; the group's LayerNorm
    // partial (mean and M2 over its columns)
    float z[2], sum = 0.f;
    bool col[2];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = lane + 32 * cc, u = c % kUnits;
      col[cc] = live && c < 3 * kUnits && u < ug;
      float v = 0.f;
      if (col[cc]) {
#pragma unroll
        for (int r = 0; r < kKSplit; ++r) v += part_of[r][n_mine * kPartStride + c];
        const size_t at = (static_cast<size_t>(t) * B + n_mine) * N + (c / kUnits) * H + u0 + u;
        float x = zxv[cc];
        for (int sp = 1; sp < zx_splits; ++sp) x += __ldg(zx + sp * zx_plane + at);
        v += x + cbias[c];
        if (zsave != nullptr) zsave[at] = v;
      }
      z[cc] = v;
      if (live) zrow[warp * kTileM + c] = v;
      sum += v;
    }
    if (norm && live) {
      const float mean = warp_sum(sum) / (3 * ug);
      float sq = 0.f;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const float d = col[cc] ? z[cc] - mean : 0.f;
        sq += d * d;
      }
      sq = warp_sum(sq);
      if (lane == 0) stats[(static_cast<size_t>(t & 1) * B + n_mine) * groups + g] = make_float2(mean, sq);
    }
    if (norm) {
      grid_sync(barrier);  // every group's statistics are published
    } else {
      __syncwarp();
    }

    // the row's LayerNorm statistics from the groups' partials (lanes over
    // the groups) by Chan et al.'s formula for k groups: mean = sum_g n_g
    // mean_g / N, M2 = sum_g [M2_g + n_g (mean_g - mean)^2]; then the affine
    // and the gates of the group's units; h_t out
    if (live) {
      float mean = 0.f, rstd = 1.f;
      if (norm) {
        float2 s[kMaxGroups / 32];
        float cnt[kMaxGroups / 32], sum_g = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxGroups / 32; ++k) {
          const int gg = lane + 32 * k;
          cnt[k] = gg < groups ? 3.f * min(kUnits, H - gg * kUnits) : 0.f;
          s[k] = gg < groups ? __ldcg(stats + (static_cast<size_t>(t & 1) * B + n_mine) * groups + gg)
                             : make_float2(0.f, 0.f);
          sum_g += cnt[k] * s[k].x;
        }
        mean = warp_sum(sum_g) / N;
        float m2 = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxGroups / 32; ++k) {
          const float d = s[k].x - mean;
          m2 += s[k].y + cnt[k] * d * d;
        }
        rstd = rsqrtf(warp_sum(m2) / N + eps);
      }
      if (lane < ug) {
        float zg[3];
#pragma unroll
        for (int gate = 0; gate < 3; ++gate) {
          const int c = gate * kUnits + lane;
          zg[gate] = zrow[warp * kTileM + c];
          if (norm) zg[gate] = (zg[gate] - mean) * rstd * cscale[c] + cshift[c];
        }
        const float reset = sigmoid_f(zg[0]);
        const float cand = tanhf(reset * zg[1]);
        const float update = sigmoid_f(zg[2] - 1.f);
        const float hn = update * cand + (1.f - update) * hprev[warp * kHPad + lane];
        hprev[warp * kHPad + lane] = hn;
        hs[(static_cast<size_t>(t) * B + n_mine) * H + u0 + lane] = hn;
      }
    }
    if (t + 1 < T) grid_sync(barrier);  // h_t is whole before any block stages it
  }
  cluster.sync();  // no block leaves while a peer may still read its partial
}

// A step's synchronisation alone, at the recurrence's grid and cluster
// shape: `iters` x (one cluster barrier, two grid barriers), the floor under
// a LayerNorm step of hafner_recurrence_kernel.
__global__ void __launch_bounds__(32 * recurrence_warps(64), 1) hafner_sync_floor_kernel(unsigned* barrier, int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) {
    cluster.sync();
    grid_sync(barrier);
    grid_sync(barrier);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int sm_count_of_current_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// The product's block shape for M batch rows and N outputs: nt batch rows
// (the wgmma N) and wg warpgroups (64 output features each).
struct Plan {
  int nt, wg;
};

// Up to 64 rows, one warpgroup and the smallest wgmma N that holds M: many
// small blocks, W spread over the SMs by feature tiles and K splits. Past 64
// rows, kWideWG warpgroups share each chunk of [a | b] (which every feature
// tile reads again), and the batch tile is 64 rows while that still gives
// every SM a block, else 128: one block per SM, in one wave.
Plan product_plan(int M, int N, int sm_count) {
  if (M <= 64) return {M <= 8 ? 8 : (M <= 16 ? 16 : (M <= 32 ? 32 : 64)), 1};
  const int feature_tiles = (N + kTileM * kWideWG - 1) / (kTileM * kWideWG);
  return {((M + 63) / 64) * feature_tiles <= sm_count ? 64 : 128, kWideWG};
}

// Chunks of K per split for an [M, K] . [K, N] product: enough splits to
// give every SM two blocks with one warpgroup, one block with kWideWG; at
// most one split per chunk.
int chunks_per_split(int M, int K, int N, int sm_count) {
  const Plan p = product_plan(M, N, sm_count);
  const int chunks = (K + kChunk - 1) / kChunk;
  const int tiles = ((N + kTileM * p.wg - 1) / (kTileM * p.wg)) * ((M + p.nt - 1) / p.nt);
  int splits = (p.wg > 1 ? 1 : 2) * sm_count / tiles;
  splits = splits < 1 ? 1 : (splits > chunks ? chunks : splits);
  return (chunks + splits - 1) / splits;
}

// Raise a kernel's dynamic shared-memory limit once per device and size
// seen, so a launch inside CUDA-graph capture makes no attribute call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* set_for_device) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > set_for_device[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    set_for_device[dev] = smem;
  }
  return cudaSuccess;
}

template <bool kVec, int NT, int kWG>
cudaError_t launch_product_tile(const float* a, const float* b, const float* w, float* zpart, int M, int Ka, int Kb,
                                int N, int split_chunks, cudaStream_t stream) {
  static size_t set[64] = {};
  const int chunks = (Ka + Kb + kChunk - 1) / kChunk;
  const int splits = (chunks + split_chunks - 1) / split_chunks;
  const size_t smem = sizeof(float) * 2 * 2 * NT * kChunk;
  cudaError_t err = allow_smem(hafner_product_kernel<NT, kWG, kVec>, smem, set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileM * kWG - 1) / (kTileM * kWG), (M + NT - 1) / NT, splits);
  hafner_product_kernel<NT, kWG, kVec><<<grid, kWgThreads * kWG, smem, stream>>>(a, b, w, zpart, M, Ka, Kb, N,
                                                                                 split_chunks);
  return cudaGetLastError();
}

// Partial products zpart[S, M, N] of [a | b] . w, with the block shape
// product_plan gives.
template <bool kVec>
cudaError_t launch_product(const float* a, const float* b, const float* w, float* zpart, int M, int Ka, int Kb, int N,
                           int split_chunks, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = static_cast<cudaError_t>(sm_count_of_current_device(&sms));
  if (err != cudaSuccess) return err;
  const Plan p = product_plan(M, N, sms);
  if (p.wg == 1) {
    switch (p.nt) {
      case 8: return launch_product_tile<kVec, 8, 1>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
      case 16: return launch_product_tile<kVec, 16, 1>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
      case 32: return launch_product_tile<kVec, 32, 1>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
      default: return launch_product_tile<kVec, 64, 1>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
    }
  }
  if (p.nt == 64) return launch_product_tile<kVec, 64, kWideWG>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
  return launch_product_tile<kVec, 128, kWideWG>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
}

template <bool kVec>
cudaError_t launch_gates(const float* zpart, int splits, const float* zx, int zx_splits, size_t zx_plane,
                         const float* h, const float* bias, const float* ln_scale, const float* ln_bias, float* zsave,
                         float* out, int B, int H, float eps, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = static_cast<cudaError_t>(sm_count_of_current_device(&sms));
  if (err != cudaSuccess) return err;
  const size_t row_smem = sizeof(float) * 3 * static_cast<size_t>(H);
  if (B < sms) {
    static size_t set[64] = {};
    err = allow_smem(hafner_gates_kernel<kVec, true>, row_smem, set);
    if (err != cudaSuccess) return err;
    hafner_gates_kernel<kVec, true><<<B, kThreads, row_smem, stream>>>(zpart, splits, zx, zx_splits, zx_plane, h,
                                                                       bias, ln_scale, ln_bias, zsave, out, B, H, eps);
  } else {
    static size_t set[64] = {};
    err = allow_smem(hafner_gates_kernel<kVec, false>, row_smem, set);
    if (err != cudaSuccess) return err;
    hafner_gates_kernel<kVec, false><<<B, kThreads, row_smem, stream>>>(zpart, splits, zx, zx_splits, zx_plane, h,
                                                                        bias, ln_scale, ln_bias, zsave, out, B, H, eps);
  }
  return cudaGetLastError();
}

int n_splits(int K, int split_chunks) { return ((K + kChunk - 1) / kChunk + split_chunks - 1) / split_chunks; }

template <bool kVec>
int cell(const float* h, const float* x, const float* w, const float* bias, const float* ln_scale,
         const float* ln_bias, float* zpart, float* zsave, float* out, int B, int H, int X, int split_chunks,
         float eps, cudaStream_t stream) {
  cudaError_t err = launch_product<kVec>(h, x, w, zpart, B, H, X, 3 * H, split_chunks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gates<kVec>(zpart, n_splits(H + X, split_chunks), nullptr, 0, 0, h, bias,
                                             ln_scale, ln_bias, zsave, out, B, H, eps, stream));
}

// The persistent recurrence's shape for B batch rows and H hidden units:
// the wgmma N, K rows a block (a multiple of 8 x its warpgroups), unit groups, blocks and
// shared memory; `fits`: B <= 64, at most kMaxGroups unit groups, and the
// shared memory within a block's.
struct SeqShape {
  int nt, kq, groups, blocks;
  size_t smem;
  bool fits;
};

SeqShape sequence_shape(int B, int H) {
  SeqShape p;
  p.nt = B <= 8 ? 8 : (B <= 16 ? 16 : (B <= 32 ? 32 : 64));
  const int k_align = 8 * recurrence_warps(p.nt) / 4;  // k8 steps a multiple of the warpgroups
  p.kq = ((H + kKSplit - 1) / kKSplit + k_align - 1) / k_align * k_align;
  p.groups = (H + kUnits - 1) / kUnits;
  p.blocks = p.groups * kKSplit;
  p.smem = recurrence_smem_bytes(p.nt, p.kq);
  p.fits = B <= 64 && p.groups <= kMaxGroups && p.smem <= static_cast<size_t>(kMaxSmem);
  return p;
}

// A cooperative launch of the recurrence's grid for `p`, in clusters of
// kKSplit blocks.
struct CoopLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];

  CoopLaunch(const SeqShape& p, cudaStream_t stream) {
    cfg.gridDim = dim3(p.blocks);
    cfg.blockDim = dim3(32 * recurrence_warps(p.nt));
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kKSplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
  }
};

template <int NT, bool kVec>
cudaError_t allow_recurrence_smem(size_t smem) {
  static size_t set[64] = {};
  return allow_smem(hafner_recurrence_kernel<NT, kVec>, smem, set);
}

// Co-resident clusters of the recurrence kernel at this shape (the
// occupancy query). It raises both instances' shared-memory limit first, so
// that a later launch, inside a graph capture too, makes no attribute call.
template <int NT>
cudaError_t recurrence_clusters(const SeqShape& p, int* clusters) {
  cudaError_t err = allow_recurrence_smem<NT, true>(p.smem);
  if (err == cudaSuccess) err = allow_recurrence_smem<NT, false>(p.smem);
  if (err != cudaSuccess) return err;
  CoopLaunch l(p, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, hafner_recurrence_kernel<NT, true>, &l.cfg);
}

template <int NT, bool kVec>
cudaError_t launch_recurrence_tile(const SeqShape& p, const float* h0, const float* zx, int zx_splits,
                                   size_t zx_plane, const float* w, const float* bias, const float* ln_scale,
                                   const float* ln_bias, float2* stats, unsigned* barrier, float* zsave, float* hs,
                                   int T, int B, int H, float eps, cudaStream_t stream) {
  cudaError_t err = allow_recurrence_smem<NT, kVec>(p.smem);
  if (err != cudaSuccess) return err;
  CoopLaunch l(p, stream);
  err = cudaLaunchKernelEx(&l.cfg, hafner_recurrence_kernel<NT, kVec>, h0, zx, zx_splits, zx_plane, w, bias,
                           ln_scale, ln_bias, stats, barrier, zsave, hs, T, B, H, p.kq, eps);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_recurrence(const float* h0, const float* zx, int zx_splits, size_t zx_plane, const float* w,
                              const float* bias, const float* ln_scale, const float* ln_bias, float2* stats,
                              unsigned* barrier, float* zsave, float* hs, int T, int B, int H, float eps,
                              cudaStream_t stream) {
  const SeqShape p = sequence_shape(B, H);
  if (!p.fits) return cudaErrorInvalidValue;
  switch (p.nt) {
    case 8:
      return launch_recurrence_tile<8, kVec>(p, h0, zx, zx_splits, zx_plane, w, bias, ln_scale, ln_bias, stats,
                                             barrier, zsave, hs, T, B, H, eps, stream);
    case 16:
      return launch_recurrence_tile<16, kVec>(p, h0, zx, zx_splits, zx_plane, w, bias, ln_scale, ln_bias, stats,
                                              barrier, zsave, hs, T, B, H, eps, stream);
    case 32:
      return launch_recurrence_tile<32, kVec>(p, h0, zx, zx_splits, zx_plane, w, bias, ln_scale, ln_bias, stats,
                                              barrier, zsave, hs, T, B, H, eps, stream);
    default:
      return launch_recurrence_tile<64, kVec>(p, h0, zx, zx_splits, zx_plane, w, bias, ln_scale, ln_bias, stats,
                                              barrier, zsave, hs, T, B, H, eps, stream);
  }
}

template <bool kVec>
int sequence(const float* h0, const float* xs, const float* w, const float* bias, const float* ln_scale,
             const float* ln_bias, float* zx, float* zpart, float* zsave, float2* stats, unsigned* barrier,
             float* hs, int T, int B, int H, int X, int x_split_chunks, int h_split_chunks, float eps,
             bool persistent, cudaStream_t stream) {
  const int N = 3 * H;
  const size_t zx_plane = static_cast<size_t>(T) * B * N;
  cudaError_t err = cudaSuccess;
  if (X > 0) {  // zx = xs . W[H:] for all T*B rows at once
    err = launch_product<kVec>(xs, nullptr, w + static_cast<size_t>(H) * N, zx, T * B, X, 0, N, x_split_chunks,
                               stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int x_splits = X > 0 ? n_splits(X, x_split_chunks) : 0;
  if (persistent) {
    return static_cast<int>(launch_recurrence<kVec>(h0, X > 0 ? zx : nullptr, x_splits, zx_plane, w, bias,
                                                    ln_scale, ln_bias, stats, barrier, zsave, hs, T, B, H, eps,
                                                    stream));
  }
  const int h_splits = n_splits(H, h_split_chunks);
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? h0 : hs + static_cast<size_t>(t - 1) * B * H;
    err = launch_product<kVec>(h, nullptr, w, zpart, B, H, 0, N, h_split_chunks, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_gates<kVec>(zpart, h_splits, X > 0 ? zx + static_cast<size_t>(t) * B * N : nullptr, x_splits,
                             zx_plane, h, bias, ln_scale, ln_bias,
                             zsave != nullptr ? zsave + static_cast<size_t>(t) * B * N : nullptr,
                             hs + static_cast<size_t>(t) * B * H, B, H, eps, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Chunks of K per split for an [M, K] . [K, N] product on the current
// device; 0 when the device cannot be queried. The wrapper sizes the
// partial-product scratch with it: splits = ceil(ceil(K / chunk_rows) / result).
int hafner_split_chunks(int M, int K, int N) {
  int sms = 0;
  if (M < 1 || K < 1 || N < 1 || sm_count_of_current_device(&sms) != 0) return 0;
  return chunks_per_split(M, K, N, sms);
}

// Rows of W per chunk.
int hafner_chunk_rows() { return kChunk; }

// The product's block shape for an [M, K] . [K, N] product on the current
// device: batch rows per block (the wgmma N) and warpgroups per block.
// Returns a cudaError_t.
int hafner_product_shape(int M, int N, int* tile_rows, int* warpgroups) {
  int sms = 0;
  if (M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = sm_count_of_current_device(&sms);
  if (err != 0) return err;
  const Plan p = product_plan(M, N, sms);
  *tile_rows = p.nt;
  *warpgroups = p.wg;
  return 0;
}

// Launches one step on `stream`: the product kernel, then the LayerNorm and
// gate kernel. `zpart` is [splits, B, 3H] f32 scratch, split_chunks from
// hafner_split_chunks(B, H + X, 3H). `zsave` (may be null; may be `zpart`
// when there is one split) receives the pre-LayerNorm z [B, 3H] with the
// bias. `bias`, `ln_scale` and `ln_bias` may be null (no bias; no LayerNorm
// when `ln_scale` is null). `vec` selects 16-byte copies: H % 4 == 0,
// X % 4 == 0 and every pointer 16-byte aligned. Returns a cudaError_t: 0 when
// both launches were accepted.
int hafner_cell_forward(const float* h, const float* x, const float* w, const float* bias,
                        const float* ln_scale, const float* ln_bias, float* zpart, float* zsave, float* out, int B,
                        int H, int X, int split_chunks, float eps, int vec, void* stream) {
  if (B < 1 || H < 1 || X < 0 || split_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) return cell<true>(h, x, w, bias, ln_scale, ln_bias, zpart, zsave, out, B, H, X, split_chunks, eps, s);
  return cell<false>(h, x, w, bias, ln_scale, ln_bias, zpart, zsave, out, B, H, X, split_chunks, eps, s);
}

// The sequence's plan for B batch rows and H hidden units on the current
// device, made before a launch: out[0] = 1 when the persistent recurrence can
// run (B <= 64, its shared memory within a block's, and every one of its
// clusters co-resident), else 0 (the multi-launch recurrence); out[1..6] =
// the persistent kernel's wgmma N, K rows a block, unit groups, blocks,
// shared memory bytes a block and co-resident clusters (0 when not
// queried). Returns a cudaError_t.
int hafner_sequence_plan(int B, int H, int* out) {
  if (B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const SeqShape p = sequence_shape(B, H);
  int clusters = 0;
  cudaError_t err = cudaSuccess;
  if (p.fits) {
    switch (p.nt) {
      case 8: err = recurrence_clusters<8>(p, &clusters); break;
      case 16: err = recurrence_clusters<16>(p, &clusters); break;
      case 32: err = recurrence_clusters<32>(p, &clusters); break;
      default: err = recurrence_clusters<64>(p, &clusters); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  out[0] = p.fits && clusters >= p.groups ? 1 : 0;
  out[1] = p.nt;
  out[2] = p.kq;
  out[3] = p.groups;
  out[4] = p.blocks;
  out[5] = static_cast<int>(p.smem);
  out[6] = clusters;
  return 0;
}

// Launches a whole sequence on `stream`: xs [T, B, X] -> hs [T, B, H] from
// h0 [B, H]. `zx` is [x_splits, T, B, 3H] f32 scratch for the input
// projection (x_split_chunks from hafner_split_chunks(T * B, X, 3H); unused
// when X == 0). `persistent` (from hafner_sequence_plan) selects the
// recurrence: 1, one cooperative launch of the persistent kernel, with
// `stats` [2, B, groups] float2 scratch and `barrier` one zeroed word kept
// for the device (the hand-written grid barrier leaves it as it found it;
// two launches must not run at once on one word); 0, T steps of two
// launches, with `zpart` [h_splits, B, 3H] scratch (h_split_chunks from
// hafner_split_chunks(B, H, 3H)). `zsave` (may be null) receives the
// pre-LayerNorm z [T, B, 3H] with the bias. Returns a cudaError_t: 0 when
// every launch was accepted.
int hafner_sequence_forward(const float* h0, const float* xs, const float* w, const float* bias,
                            const float* ln_scale, const float* ln_bias, float* zx, float* zpart, float* zsave,
                            void* stats, unsigned* barrier, float* hs, int T, int B, int H, int X,
                            int x_split_chunks, int h_split_chunks, float eps, int vec, int persistent,
                            void* stream) {
  if (T < 1 || B < 1 || H < 1 || X < 0 || (X > 0 && x_split_chunks < 1) || (!persistent && h_split_chunks < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<float2*>(stats);
  if (vec) {
    return sequence<true>(h0, xs, w, bias, ln_scale, ln_bias, zx, zpart, zsave, st, barrier, hs, T, B, H, X,
                          x_split_chunks, h_split_chunks, eps, persistent != 0, s);
  }
  return sequence<false>(h0, xs, w, bias, ln_scale, ln_bias, zx, zpart, zsave, st, barrier, hs, T, B, H, X,
                         x_split_chunks, h_split_chunks, eps, persistent != 0, s);
}

// Launches hafner_sync_floor_kernel at the persistent recurrence's grid,
// cluster and shared-memory shape for (B, H): `iters` steps' worth of
// synchronisation (a cluster barrier and two grid barriers each). Returns a
// cudaError_t.
int hafner_sync_floor(int B, int H, int iters, unsigned* barrier, void* stream) {
  if (B < 1 || H < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const SeqShape p = sequence_shape(B, H);
  if (!p.fits) return static_cast<int>(cudaErrorInvalidValue);
  static size_t set[64] = {};
  cudaError_t err = allow_smem(hafner_sync_floor_kernel, p.smem, set);
  if (err != cudaSuccess) return static_cast<int>(err);
  CoopLaunch l(p, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&l.cfg, hafner_sync_floor_kernel, barrier, iters);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

const char* hafner_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
