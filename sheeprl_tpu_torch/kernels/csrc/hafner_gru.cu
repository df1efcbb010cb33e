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
// What bounds it. At the DreamerV2 width (H=600, X=400) W is 7.2 MB of f32
// and the step does 2*B*1000*1800 FLOP: one pass over W from device memory
// bounds it at small B, f32 FMA throughput from B=64 on (the training
// imagination runs B=1600). A single block per batch row would make every SM
// stream all of W, so the product splits the 3H output columns, the batch
// and, where that leaves SMs idle, the K rows of W across blocks. The
// LayerNorm needs the whole 3H row before any gate, and a row is spread over
// many blocks, so a step is two launches on one stream (the second pass; a
// cluster reduction would cap the column split at 16 blocks):
//
// 1. hafner_gemm_kernel: partial products of [a | b] . W over a K range, a
//    [M, Ka] and b [M, Kb] (Kb may be 0), W [Ka+Kb, N]. Grid (ceil(N / 64)
//    column tiles, ceil(M / TB) row tiles, S splits of K), 256 threads, TB =
//    1, 4 or 16 rows as M needs. A block copies [a | b] of its TB rows and its
//    K range into shared memory and streams its 64-column strip of W through
//    a ring of kStages shared-memory stages of kChunk rows with cp.async, so
//    several stages of W are in flight while the FMAs of an earlier one run.
//    Each thread owns 4 adjacent columns and every 16th row of W and keeps
//    TBx4 f32 accumulators; the 16 partial sums of a column are added through
//    shared memory and the block writes its split's partial z [S, M, N].
// 2. hafner_gates_kernel: one block per batch row sums the S partials, the
//    bias and, for a sequence step, the input projection's partials zx into
//    shared memory, takes the LayerNorm statistics over the row in two passes
//    (the mean, then the mean of squared deviations, as models/norm.py does),
//    and runs the affine and the gates.
//
// A step of the cell is [h | x] . W (a = h, b = x), then the gates. The
// sequence (xs [T, B, X] -> hs [T, B, H]) first projects every input at once,
// zx = xs . W[H:] (one product launch over M = T*B rows, the Pallas kernel's
// `xs_ref[0] . w[Hp:]` hoisted out of the time loop), then runs T steps of
// h . W[:H] (a = h, Kb = 0) and the gates with zx[t] added. h goes through
// device memory between steps; a persistent kernel that keeps h and a strip
// of W[:H] on chip across T is the faster Hopper design, not this one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = 64;                       // output columns per block
constexpr int kColGroups = kTileN / 4;           // threads across a tile row, 4 columns each
constexpr int kKSlices = kThreads / kColGroups;  // threads along the reduction dim
constexpr int kChunk = 32;                       // rows of W per pipeline stage
constexpr int kStages = 6;                       // W stages in flight (8 KB each)
constexpr int kRingFloats = kStages * kChunk * kTileN;
constexpr int kMaxSmem = 232448;                 // a block's shared-memory ceiling on sm_90

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

// Asynchronous global -> shared copies of 16 or 4 bytes; `pred` false fills
// the destination with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copy rows k0 .. k0+kChunk-1, columns col0 .. col0+63 of W into one ring
// stage [kChunk][kTileN]; zeros past the edges.
template <bool kVec>
__device__ __forceinline__ void load_w_stage(float* stage, const float* __restrict__ w, int k0, int col0,
                                             int K, int N) {
  if (kVec) {
    for (int e = threadIdx.x; e < kChunk * kColGroups; e += kThreads) {
      const int row = e / kColGroups;
      const int c = 4 * (e - row * kColGroups);
      const int k = k0 + row;
      const bool ok = k < K && col0 + c < N;
      cp_async16(stage + row * kTileN + c, ok ? w + static_cast<size_t>(k) * N + col0 + c : w, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kChunk * kTileN; e += kThreads) {
      const int row = e / kTileN;
      const int c = e - row * kTileN;
      const int k = k0 + row;
      const bool ok = k < K && col0 + c < N;
      cp_async4(stage + row * kTileN + c, ok ? w + static_cast<size_t>(k) * N + col0 + c : w, ok);
    }
  }
}

// kVec: Ka, Kb and N multiples of 4 and every pointer 16-byte aligned.
// TB: rows of [a | b] per block. Each split covers `split_chunks` chunks of K.
template <bool kVec, int TB>
__global__ void __launch_bounds__(kThreads) hafner_gemm_kernel(
    const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ w,
    float* __restrict__ zpart, int M, int Ka, int Kb, int N, int split_chunks) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int K = Ka + Kb;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * TB;
  const int col0 = blockIdx.x * kTileN;
  const int rows = min(TB, M - row0);
  const int chunks = (K + kChunk - 1) / kChunk;
  const int q0 = blockIdx.z * split_chunks;
  const int nq = min(split_chunks, chunks - q0);  // chunks of this split
  const int k0 = q0 * kChunk;
  const int span = split_chunks * kChunk;  // act row stride

  // 1. copy [a | b] of this tile's rows and this split's K range into
  //    act[r * span + (k - k0)] (zeros for rows past M and k past K), and the
  //    first kStages-1 stages of W; one commit group per stage
  float* act = smem;
  float* ring = smem + TB * span;
  if (kVec) {
    for (int e = tid; e < TB * span / 4; e += kThreads) {
      const int r = e / (span / 4);
      const int kk = 4 * (e - r * (span / 4));
      const int k = k0 + kk;
      const size_t row = static_cast<size_t>(row0 + min(r, rows - 1));
      const bool ok = r < rows && k < K;
      cp_async16(act + r * span + kk, ok ? (k < Ka ? a + row * Ka + k : b + row * Kb + (k - Ka)) : a, ok);
    }
  } else {
    for (int e = tid; e < TB * span; e += kThreads) {
      const int r = e / span;
      const int kk = e - r * span;
      const int k = k0 + kk;
      const size_t row = static_cast<size_t>(row0 + min(r, rows - 1));
      const bool ok = r < rows && k < K;
      cp_async4(act + e, ok ? (k < Ka ? a + row * Ka + k : b + row * Kb + (k - Ka)) : a, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nq) load_w_stage<kVec>(ring + s * kChunk * kTileN, w, k0 + s * kChunk, col0, K, N);
    cp_async_commit();
  }

  // 2. partial dot products over k = ks, ks + kKSlices, ...: wait for stage q,
  //    refill the slot stage q-1 used, then run stage q's FMAs. Rows past K
  //    are zeros in both act and the ring.
  const int cg = tid % kColGroups;
  const int ks = tid / kColGroups;
  float acc[TB][4];
#pragma unroll
  for (int r = 0; r < TB; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage q has landed for every thread; stage q-1 is consumed
    const int next = q + kStages - 1;
    if (next < nq) load_w_stage<kVec>(ring + (next % kStages) * kChunk * kTileN, w, k0 + next * kChunk, col0, K, N);
    cp_async_commit();
    const float* stage = ring + (q % kStages) * kChunk * kTileN;
    const float* a_q = act + q * kChunk;
#pragma unroll
    for (int p = 0; p < kChunk / kKSlices; ++p) {
      const int kk = ks + p * kKSlices;
      const float4 wv = *reinterpret_cast<const float4*>(stage + kk * kTileN + 4 * cg);
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float a = a_q[r * span + kk];
        acc[r][0] = fmaf(a, wv.x, acc[r][0]);
        acc[r][1] = fmaf(a, wv.y, acc[r][1]);
        acc[r][2] = fmaf(a, wv.z, acc[r][2]);
        acc[r][3] = fmaf(a, wv.w, acc[r][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // act and the ring are dead: the reduction buffer reuses their space

  // 3. add the kKSlices partial sums of each column (red[ks][r][cg], float4)
  //    and write this split's partial z
  float4* red = smem4;
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    red[(ks * TB + r) * kColGroups + cg] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  float* zs = zpart + static_cast<size_t>(blockIdx.z) * M * N;
  for (int o = tid; o < rows * kTileN; o += kThreads) {
    const int r = o / kTileN;
    const int cc = o - r * kTileN;
    const int col = col0 + cc;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kKSlices; ++q) s += smem[(q * TB + r) * kTileN + cc];
    zs[static_cast<size_t>(row0 + r) * N + col] = s;
  }
}

// Four floats p[j .. j+3]: one 16-byte load (kVec), else zeros at and past `limit`.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int j, int limit) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p + j));
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = j + u < limit ? __ldg(p + j + u) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One block per batch row: z = bias + the splits' partials [+ the input
// projection's partials zx, `zx_splits` planes `zx_plane` floats apart], then
// the LayerNorm and the gates. Dynamic shared memory holds the row's 3H floats.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) hafner_gates_kernel(
    const float* __restrict__ zpart, int splits, const float* __restrict__ zx, int zx_splits, size_t zx_plane,
    const float* __restrict__ h, const float* __restrict__ bias, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, float* __restrict__ out, int B, int H, float eps) {
  extern __shared__ float4 zrow4[];
  float* zrow = reinterpret_cast<float*>(zrow4);
  __shared__ float red[kWarps];
  const int N = 3 * H;
  const size_t row = blockIdx.x;
  const size_t plane = static_cast<size_t>(B) * N;
  const int nzx = zx != nullptr ? zx_splits : 0;

  // z = bias + the splits' partials; on the 16-byte path a thread's loads of
  // a column group are unrolled so that they are in flight together
  float sum = 0.f;
  if (kVec) {
    const float4* zp = reinterpret_cast<const float4*>(zpart) + row * (N / 4);
    const float4* zq = reinterpret_cast<const float4*>(zx) + row * (N / 4);
    const float4* b4 = reinterpret_cast<const float4*>(bias);
    for (int j4 = threadIdx.x; j4 < N / 4; j4 += kThreads) {
      float4 s = bias != nullptr ? __ldg(b4 + j4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int p = 0; p < splits; ++p) {
        const float4 v = __ldg(zp + p * (plane / 4) + j4);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      for (int q = 0; q < nzx; ++q) {
        const float4 v = __ldg(zq + q * (zx_plane / 4) + j4);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      zrow4[j4] = s;
      sum += (s.x + s.y) + (s.z + s.w);
    }
  } else {
    for (int j = threadIdx.x; j < N; j += kThreads) {
      float s = bias != nullptr ? bias[j] : 0.f;
      for (int p = 0; p < splits; ++p) s += zpart[p * plane + row * N + j];
      for (int q = 0; q < nzx; ++q) s += zx[q * zx_plane + row * N + j];
      zrow[j] = s;
      sum += s;
    }
  }
  float mean = 0.f, rstd = 1.f;
  const bool norm = ln_scale != nullptr;
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

  for (int j = 4 * threadIdx.x; j < H; j += 4 * kThreads) {
    float zg[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int u = 0; u < 4; ++u) zg[g][u] = j + u < H ? zrow[g * H + j + u] : 0.f;
      if (norm) {
        const float4 s = load4<kVec>(ln_scale + g * H, j, H);
        const float4 b = load4<kVec>(ln_bias + g * H, j, H);
        zg[g][0] = (zg[g][0] - mean) * rstd * s.x + b.x;
        zg[g][1] = (zg[g][1] - mean) * rstd * s.y + b.y;
        zg[g][2] = (zg[g][2] - mean) * rstd * s.z + b.z;
        zg[g][3] = (zg[g][3] - mean) * rstd * s.w + b.w;
      }
    }
    const float4 hv = load4<kVec>(h + row * H, j, H);
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

int tile_rows(int M) { return M == 1 ? 1 : (M <= 8 ? 4 : 16); }

// Chunks of K per split for an [M, K] . [K, N] product: enough splits to
// give every SM two blocks (16 warps to hide the latency of shared and
// global loads), and few enough chunks per split that act fits in shared
// memory beside the ring.
int chunks_per_split(int M, int K, int N, int sm_count) {
  const int chunks = (K + kChunk - 1) / kChunk;
  const int tiles = ((N + kTileN - 1) / kTileN) * ((M + tile_rows(M) - 1) / tile_rows(M));
  int splits = 2 * sm_count / tiles;
  splits = splits < 1 ? 1 : (splits > chunks ? chunks : splits);
  int per = (chunks + splits - 1) / splits;
  const int fit = (kMaxSmem / static_cast<int>(sizeof(float)) - kRingFloats) / (tile_rows(M) * kChunk);
  return per < fit ? per : fit;
}

int sm_count_of_current_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
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

template <bool kVec, int TB>
cudaError_t launch_gemm_tb(const float* a, const float* b, const float* w, float* zpart, int M, int Ka, int Kb,
                           int N, int split_chunks, cudaStream_t stream) {
  static size_t set[64] = {};
  const int chunks = (Ka + Kb + kChunk - 1) / kChunk;
  const int splits = (chunks + split_chunks - 1) / split_chunks;
  const size_t gemm_smem = sizeof(float) * (static_cast<size_t>(TB) * split_chunks * kChunk + kRingFloats);
  const size_t red_smem = sizeof(float) * kKSlices * TB * kTileN;
  const size_t smem = gemm_smem > red_smem ? gemm_smem : red_smem;
  cudaError_t err = allow_smem(hafner_gemm_kernel<kVec, TB>, smem, set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kTileN - 1) / kTileN, (M + TB - 1) / TB, splits);
  hafner_gemm_kernel<kVec, TB><<<grid, kThreads, smem, stream>>>(a, b, w, zpart, M, Ka, Kb, N, split_chunks);
  return cudaGetLastError();
}

// Partial products zpart[S, M, N] of [a | b] . w, with the row tile M needs.
template <bool kVec>
cudaError_t launch_gemm(const float* a, const float* b, const float* w, float* zpart, int M, int Ka, int Kb, int N,
                        int split_chunks, cudaStream_t stream) {
  const int tb = tile_rows(M);
  if (tb == 1) return launch_gemm_tb<kVec, 1>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
  if (tb == 4) return launch_gemm_tb<kVec, 4>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
  return launch_gemm_tb<kVec, 16>(a, b, w, zpart, M, Ka, Kb, N, split_chunks, stream);
}

template <bool kVec>
cudaError_t launch_gates(const float* zpart, int splits, const float* zx, int zx_splits, size_t zx_plane,
                         const float* h, const float* bias, const float* ln_scale, const float* ln_bias, float* out,
                         int B, int H, float eps, cudaStream_t stream) {
  static size_t set[64] = {};
  const size_t row_smem = sizeof(float) * 3 * static_cast<size_t>(H);
  cudaError_t err = allow_smem(hafner_gates_kernel<kVec>, row_smem, set);
  if (err != cudaSuccess) return err;
  hafner_gates_kernel<kVec><<<B, kThreads, row_smem, stream>>>(zpart, splits, zx, zx_splits, zx_plane, h, bias,
                                                                ln_scale, ln_bias, out, B, H, eps);
  return cudaGetLastError();
}

int n_splits(int K, int split_chunks) { return ((K + kChunk - 1) / kChunk + split_chunks - 1) / split_chunks; }

template <bool kVec>
int cell(const float* h, const float* x, const float* w, const float* bias, const float* ln_scale,
         const float* ln_bias, float* zpart, float* out, int B, int H, int X, int split_chunks, float eps,
         cudaStream_t stream) {
  cudaError_t err = launch_gemm<kVec>(h, x, w, zpart, B, H, X, 3 * H, split_chunks, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_gates<kVec>(zpart, n_splits(H + X, split_chunks), nullptr, 0, 0, h, bias,
                                             ln_scale, ln_bias, out, B, H, eps, stream));
}

template <bool kVec>
int sequence(const float* h0, const float* xs, const float* w, const float* bias, const float* ln_scale,
             const float* ln_bias, float* zx, float* zpart, float* hs, int T, int B, int H, int X,
             int x_split_chunks, int h_split_chunks, float eps, cudaStream_t stream) {
  const int N = 3 * H;
  const size_t zx_plane = static_cast<size_t>(T) * B * N;
  cudaError_t err = cudaSuccess;
  if (X > 0) {  // zx = xs . W[H:] for all T*B rows at once
    err = launch_gemm<kVec>(xs, nullptr, w + static_cast<size_t>(H) * N, zx, T * B, X, 0, N, x_split_chunks, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int x_splits = X > 0 ? n_splits(X, x_split_chunks) : 0;
  const int h_splits = n_splits(H, h_split_chunks);
  for (int t = 0; t < T; ++t) {
    const float* h = t == 0 ? h0 : hs + static_cast<size_t>(t - 1) * B * H;
    err = launch_gemm<kVec>(h, nullptr, w, zpart, B, H, 0, N, h_split_chunks, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_gates<kVec>(zpart, h_splits, X > 0 ? zx + static_cast<size_t>(t) * B * N : nullptr, x_splits,
                             zx_plane, h, bias, ln_scale, ln_bias, hs + static_cast<size_t>(t) * B * H, B, H, eps,
                             stream);
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

// Launches one step on `stream`: the product kernel, then the LayerNorm and
// gate kernel. `zpart` is [splits, B, 3H] f32 scratch, split_chunks from
// hafner_split_chunks(B, H + X, 3H). `bias`, `ln_scale` and `ln_bias` may be
// null (no bias; no LayerNorm when `ln_scale` is null). `vec` selects 16-byte
// copies: H % 4 == 0, X % 4 == 0 and every pointer 16-byte aligned. Returns a
// cudaError_t: 0 when both launches were accepted.
int hafner_cell_forward(const float* h, const float* x, const float* w, const float* bias,
                        const float* ln_scale, const float* ln_bias, float* zpart, float* out, int B, int H,
                        int X, int split_chunks, float eps, int vec, void* stream) {
  if (B < 1 || H < 1 || X < 0 || split_chunks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) return cell<true>(h, x, w, bias, ln_scale, ln_bias, zpart, out, B, H, X, split_chunks, eps, s);
  return cell<false>(h, x, w, bias, ln_scale, ln_bias, zpart, out, B, H, X, split_chunks, eps, s);
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
