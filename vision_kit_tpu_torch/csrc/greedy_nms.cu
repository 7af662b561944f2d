// Exact greedy-NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_kit_tpu/ops/pallas_nms.py:_nms_kernel
// (wrapped by pallas_greedy_keep), and on the serving path the XLA blocked
// scan _greedy_keep_blocked that vision_kit_tpu/ops/nms.py:postprocess_raw
// calls. Box i (score-descending order, class offset already added) is kept
// iff valid[i] and no earlier kept box j has IoU(i, j) > thres, with
// IoU = inter / max(area_i + area_j - inter, 1e-9).
//
// Bound: the work is IoU pairs, about 14 f32 operations each, on ~17 bytes
// of input per box, so the kernel is bound by operations, not bytes. The
// greedy walk itself is a K-step serial chain.
//
// Design: one block per image. The K boxes and their areas go into shared
// memory. All threads build the suppression bitmask: row i, word w holds
// bit (j - 64 w) for each j > i in that word with IoU(i, j) > thres. The
// mask lives in dynamic shared memory (K * ceil(K/64) * 8 bytes: 32 KB at
// K=512, 128 KB at K=1024); on the H100's 227 KB per block that holds up to
// K=1280, and a larger K is refused. Then one warp walks the rows in score
// order over a `removed` bitset in shared memory that starts as ~valid: row
// i is kept iff its bit is clear, and a kept row ORs its mask row into
// `removed`. No global-memory traffic happens inside the walk.
//
// Exactness: the mask must be bit-equal to the plain PyTorch version, so
// every arithmetic step is an explicitly rounded intrinsic in the same
// order as that version (no FMA contraction of area_i + area_j - inter),
// and the file is built with -fmad=false and without fast math.
//
// The clamp is the TPU kernel's 1e-9. The JAX blocked scan goes through
// box_iou_pairwise, whose clamp is 1e-6; the two differ only for pairs
// whose union is below 1e-6 px^2, i.e. zero-area boxes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ bool over(float4 a, float area_a, float4 b,
                                     float area_b, float thres) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  float iou = __fdiv_rn(inter, fmaxf(uni, 1e-9f));
  return iou > thres;
}

__global__ void __launch_bounds__(kThreads)
greedy_nms_keep_kernel(const float4* __restrict__ boxes,
                       const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep,
                       int k, int words, float thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* sbox = reinterpret_cast<float4*>(smem);
  float* sarea = reinterpret_cast<float*>(sbox + k);
  // 8-byte arrays after the 4-byte one: round the offset up to 8
  size_t off = (reinterpret_cast<size_t>(sarea + k) + 7) & ~size_t(7);
  unsigned long long* removed = reinterpret_cast<unsigned long long*>(off);
  unsigned long long* mask = removed + words;

  const int b = blockIdx.x;
  const float4* gbox = boxes + size_t(b) * k;
  const uint8_t* gvalid = valid + size_t(b) * k;
  uint8_t* gkeep = keep + size_t(b) * k;

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float4 bx = gbox[i];
    sbox[i] = bx;
    sarea[i] = area_of(bx);
  }
  // removed starts as ~valid; bits past k stay clear and are never read
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long bits = 0ull;
    int j0 = w * 64;
    int j1 = min(j0 + 64, k);
    for (int j = j0; j < j1; ++j)
      if (!gvalid[j]) bits |= 1ull << (j - j0);
    removed[w] = bits;
  }
  __syncthreads();

  // one warp per (row i, word w): lanes test j = 64 w + lane and
  // 64 w + 32 + lane, and two ballots assemble the word. Rows of invalid
  // boxes are never ORed in the walk, so they are left zero.
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int total = k * words;
  for (int t = threadIdx.x >> 5; t < total; t += nwarps) {
    int i = t / words;
    int w = t - i * words;
    int j0 = w * 64;
    bool live = !((removed[i >> 6] >> (i & 63)) & 1ull);
    unsigned long long bits = 0ull;
    if (live && j0 + 63 > i) {  // warp-uniform: some j > i in this word
      float4 bi = sbox[i];
      float ai = sarea[i];
      int ja = j0 + lane;
      int jb = ja + 32;
      bool oa = ja > i && ja < k && over(bi, ai, sbox[ja], sarea[ja], thres);
      bool ob = jb > i && jb < k && over(bi, ai, sbox[jb], sarea[jb], thres);
      unsigned lo = __ballot_sync(0xffffffffu, oa);
      unsigned hi = __ballot_sync(0xffffffffu, ob);
      bits = (static_cast<unsigned long long>(hi) << 32) | lo;
    }
    if (lane == 0) mask[t] = bits;
  }
  __syncthreads();

  if (threadIdx.x >= 32) return;
  for (int i = 0; i < k; ++i) {
    bool kept = !((removed[i >> 6] >> (i & 63)) & 1ull);
    __syncwarp();  // every lane has read word i>>6 before any lane ORs into it
    if (lane == 0) gkeep[i] = kept ? 1 : 0;
    if (kept) {
      const unsigned long long* row = mask + size_t(i) * words;
      for (int w = (i >> 6) + lane; w < words; w += 32) removed[w] |= row[w];
    }
    __syncwarp();
  }
}

// Raises the kernel's dynamic shared-memory limit to the current device's
// per-block maximum, once per device. Returns that maximum in bytes, or a
// negative CUDA error code.
int configure_smem() {
  static int limit[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -int(err);
  if (dev < 64 && limit[dev] > 0) return limit[dev];
  int max_bytes = 0;
  err = cudaDeviceGetAttribute(&max_bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -int(err);
  err = cudaFuncSetAttribute(greedy_nms_keep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_bytes);
  if (err != cudaSuccess) return -int(err);
  if (dev < 64) limit[dev] = max_bytes;
  return max_bytes;
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32, valid (B, K) bool, keep (B, K) bool out. Launches on
// `stream`. Returns 0 on success, -1 if K boxes need more shared memory
// than the device gives a block, else the CUDA error code.
int greedy_nms_keep(const void* boxes, const void* valid, void* keep,
                    int batch, int k, float thres, void* stream) {
  if (batch == 0 || k == 0) return 0;
  int words = (k + 63) / 64;
  // boxes, areas, the `removed` words (after an 8-byte alignment pad), mask
  size_t smem = size_t(k) * (sizeof(float4) + sizeof(float)) + 8 +
                size_t(words) * 8 + size_t(k) * words * 8;
  int limit = configure_smem();
  if (limit < 0) return -limit;
  if (smem > size_t(limit)) return -1;
  greedy_nms_keep_kernel<<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, words, thres);
  return int(cudaGetLastError());
}

}  // extern "C"
