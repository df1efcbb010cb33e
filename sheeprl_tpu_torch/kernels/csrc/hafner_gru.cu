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
// `xs_ref[0] . w[Hp:]` hoisted out of the time loop), then runs T steps of
// h . W[:H] (a = h, Kb = 0) and the gates with zx[t] added. h goes through
// device memory between steps; a persistent kernel that keeps h and a strip
// of W[:H] on chip across T is the faster Hopper design, not this one.

#include <cuda_runtime.h>

#include <cstdint>

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

// Float offset in a stage of row n, 16-byte column group j (k = 4j .. 4j+3):
// core matrix (n / 8, j), its row n % 8.
__device__ __forceinline__ int stage_offset(int n, int j) {
  return ((n >> 3) * (kChunk / 4) + j) * kCoreFloats + 4 * (n & 7);
}

// Matrix descriptor of k8 step s (core-matrix columns 2s and 2s+1) of a
// no-swizzle K-major stage in shared memory.
__device__ __forceinline__ uint64_t smem_desc(const float* stage, int s) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(stage + 2 * s * kCoreFloats));
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((kLbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((kSbo >> 4) & 0x3FFF) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

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

template <bool kVec>
int sequence(const float* h0, const float* xs, const float* w, const float* bias, const float* ln_scale,
             const float* ln_bias, float* zx, float* zpart, float* hs, int T, int B, int H, int X,
             int x_split_chunks, int h_split_chunks, float eps, cudaStream_t stream) {
  const int N = 3 * H;
  const size_t zx_plane = static_cast<size_t>(T) * B * N;
  cudaError_t err = cudaSuccess;
  if (X > 0) {  // zx = xs . W[H:] for all T*B rows at once
    err = launch_product<kVec>(xs, nullptr, w + static_cast<size_t>(H) * N, zx, T * B, X, 0, N, x_split_chunks,
                               stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int x_splits = X > 0 ? n_splits(X, x_split_chunks) : 0;
  const int h_splits = n_splits(H, h_split_chunks);
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? h0 : hs + static_cast<size_t>(t - 1) * B * H;
    err = launch_product<kVec>(h, nullptr, w, zpart, B, H, 0, N, h_split_chunks, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_gates<kVec>(zpart, h_splits, X > 0 ? zx + static_cast<size_t>(t) * B * N : nullptr, x_splits,
                             zx_plane, h, bias, ln_scale, ln_bias, nullptr, hs + static_cast<size_t>(t) * B * H, B,
                             H, eps, stream);
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

// Launches a whole sequence on `stream`: xs [T, B, X] -> hs [T, B, H] from
// h0 [B, H]. `zx` is [x_splits, T, B, 3H] f32 scratch for the input
// projection (x_split_chunks from hafner_split_chunks(T * B, X, 3H); unused
// when X == 0) and `zpart` [h_splits, B, 3H] for each step's recurrent
// product (h_split_chunks from hafner_split_chunks(B, H, 3H)). 1 + 2T
// launches. Returns a cudaError_t: 0 when every launch was accepted.
int hafner_sequence_forward(const float* h0, const float* xs, const float* w, const float* bias,
                            const float* ln_scale, const float* ln_bias, float* zx, float* zpart, float* hs, int T,
                            int B, int H, int X, int x_split_chunks, int h_split_chunks, float eps, int vec,
                            void* stream) {
  if (T < 1 || B < 1 || H < 1 || X < 0 || h_split_chunks < 1 || (X > 0 && x_split_chunks < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    return sequence<true>(h0, xs, w, bias, ln_scale, ln_bias, zx, zpart, hs, T, B, H, X, x_split_chunks,
                          h_split_chunks, eps, s);
  }
  return sequence<false>(h0, xs, w, bias, ln_scale, ln_bias, zx, zpart, hs, T, B, H, X, x_split_chunks,
                         h_split_chunks, eps, s);
}

const char* hafner_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
