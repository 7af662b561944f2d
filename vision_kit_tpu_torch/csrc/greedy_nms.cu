// Exact greedy-NMS keep mask for Hopper (sm_90a).
//
// Replaces the TPU kernel vision_kit_tpu/ops/pallas_nms.py:32 `_nms_kernel`
// (launched by pallas_greedy_keep at :92), and on the serving path the XLA
// blocked scan _greedy_keep_blocked that vision_kit_tpu/ops/nms.py
// :postprocess_raw calls. Box i (score-descending order, class offset
// already added) is kept iff valid[i] and no earlier kept box j has
// IoU(i, j) > thres, with IoU = inter / max(area_i + area_j - inter, 1e-9).
//
// Bound on the H100: operations, then the serial walk. The IoU pairs the
// result needs (each kept box against every later valid box, about 14 f32
// operations each) are 0.003 ms of work at B=128, K=512 on the whole card,
// and the input is 18 bytes per box; what the card cannot spread is the
// greedy chain, where box i's fate needs every earlier kept box.
//
// Design: two kernels on the caller's stream.
// (a) nms_mask_kernel builds the suppression mask over the whole grid:
//     one 256-thread block per (row block, column block at or above it,
//     image). Blocks whose 64 rows are all invalid exit at once (the
//     candidates come sorted by score, so the gated tail is skipped
//     whole). The 64 column boxes and their areas go to shared memory;
//     four threads test a row box against 16 columns each and write their
//     16 bits of one 64-bit word, mask[b][i][cb]: bit c is set iff column
//     j = 64 cb + c
//     overlaps row i above thres, for j > i off the diagonal and for every
//     j != i on it (IoU is symmetric bit for bit, so the diagonal word of
//     row i also says which earlier rows of its block overlap it). The
//     mask lives in device memory, (B, 64 W, W) words for W = ceil(K / 64)
//     (1 MB at B=8, K=1024; 4 MB at B=128, K=512), inside the 50 MB L2, so
//     K has no shared-memory limit here. At B=8, K=1024 the grid has 1,088
//     blocks of 8 warps for 132 SMs. Rows of invalid boxes and words below
//     the diagonal are never written and never read. A pair that does not
//     intersect skips the division (see over()).
// (b) nms_walk_kernel walks the rows in 64-row blocks, one warp per image.
//     For block w, live = valid rows not yet removed; a block with no live
//     row costs one test. The diagonal word is resolved in registers, lane
//     l holding rows l and l + 32: each step keeps every live row that no
//     live earlier row of the block overlaps (always the lowest live row,
//     the one __ffsll picks, and every other row whose fate no longer
//     depends on an open one), then clears the kept rows and the rows they
//     suppress from live (two ballots and two OR-reductions), until no
//     live bit is left. The steps are the depth of the suppression chain in
//     the block, not the number of rows kept. Then lane l ORs the kept
//     rows' words of column block w + 1 + l into `removed`, 8 rows' words
//     loaded at once for each group of 8 rows that holds a kept one.
//     Block w's rows of the mask (a contiguous 64 W-word strip) are in
//     shared memory by then: TMA bulk copies keep up to 16 strips (up to
//     96 KB) in flight ahead of the walk, only for blocks with a valid
//     row. `keep` is written as whole 64-row words expanded to bytes.
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

#include "bulk_copy.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kMaxStages = 16;
constexpr int kQuarters = 4;  // mask-kernel threads per row, 16 columns each
constexpr size_t kStripBudget = 96 * 1024;  // shared bytes of strips in flight

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ bool over(float4 a, float area_a, float4 b,
                                     float area_b, float thres) {
  float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  float inter = __fmul_rn(iw, ih);
  float uni = fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  // 0 / uni is +0 for every uni but NaN, and a zero numerator would send
  // the IEEE division down its slow path: most pairs do not intersect
  float iou = inter == 0.0f && uni == uni ? 0.0f : __fdiv_rn(inter, uni);
  return iou > thres;
}

__global__ void __launch_bounds__(64 * kQuarters)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                int k, int words, float thres) {
  // blockIdx.x counts the tiles at or above the diagonal, row block by row
  // block: (0, 0), (0, 1), ..., (0, W - 1), (1, 1), ...
  int rb = 0;
  int cb = blockIdx.x;
  while (cb >= words - rb) cb -= words - rb++;
  cb += rb;
  const int b = blockIdx.y;
  __shared__ float4 sbox[64];
  __shared__ float sarea[64];
  const int t = threadIdx.x;
  const int row = t & 63;
  const int quarter = t >> 6;  // a warp's 32 rows share their 16 columns
  const int i = rb * 64 + row;
  const bool live = i < k && valid[size_t(b) * k + i];
  if (!__syncthreads_or(live)) return;
  const int j = cb * 64 + t;
  if (t < 64 && j < k) {
    float4 bx = boxes[size_t(b) * k + j];
    sbox[t] = bx;
    sarea[t] = area_of(bx);
  }
  __syncthreads();
  if (!live) return;
  const float4 bi = boxes[size_t(b) * k + i];
  const float ai = area_of(bi);
  const int n = k - cb * 64;  // columns of this block that exist, if < 64
  uint32_t bits = 0u;
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int c = quarter * 16 + u;
    if (c < n && (cb != rb || c != row) &&
        over(bi, ai, sbox[c], sarea[c], thres))
      bits |= 1u << u;
  }
  // the quarter's 16 bits of the little-endian 64-bit word
  reinterpret_cast<uint16_t*>(mask + (size_t(b) * 64 * words + i) * words + cb)[quarter] =
      static_cast<uint16_t>(bits);
}

__global__ void __launch_bounds__(32)
nms_walk_kernel(const uint8_t* __restrict__ valid,
                const u64* __restrict__ mask, uint8_t* __restrict__ keep,
                int k, int words, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int strip_words = 64 * words;
  u64* strips = reinterpret_cast<u64*>(smem);             // [stages][64 W]
  u64* removed = strips + size_t(stages) * strip_words;   // [W]
  u64* valid_bits = removed + words;                      // [W]
  uint64_t* bars = reinterpret_cast<uint64_t*>(valid_bits + words);

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const u64* gmask = mask + size_t(b) * strip_words * words;
  const uint8_t* gvalid = valid + size_t(b) * k;
  uint8_t* gkeep = keep + size_t(b) * k;

  if (lane == 0) bulk::barriers_init(bars, stages);
  // Validity word w is two ballots over coalesced byte loads; 16 words'
  // loads are in flight at once.
  for (int w0 = 0; w0 < words; w0 += 16) {
    bool v[32];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int r = 64 * (w0 + u) + lane;
      v[2 * u] = w0 + u < words && r < k && gvalid[r];
      v[2 * u + 1] = w0 + u < words && r + 32 < k && gvalid[r + 32];
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const u64 bits = __ballot_sync(0xffffffffu, v[2 * u]) |
                       (u64(__ballot_sync(0xffffffffu, v[2 * u + 1])) << 32);
      if (lane == u && w0 + u < words) {
        valid_bits[w0 + u] = bits;
        removed[w0 + u] = 0ull;
      }
    }
  }
  __syncwarp();

  // Every lane tracks the same state: per buffer, the parity of its next
  // completion and whether a copy into it is still unwaited.
  uint32_t parity = 0u;
  uint32_t pending = 0u;
  auto wait_copy = [&](int s) {
    bulk::wait(&bars[s], (parity >> s) & 1u);
    parity ^= 1u << s;
    pending &= ~(1u << s);
  };
  auto prefetch = [&](int w) {
    if (w >= words || valid_bits[w] == 0ull) return;
    const int s = w % stages;
    if ((pending >> s) & 1u) wait_copy(s);  // its last copy may still land
    if (lane == 0) {
      if (w >= stages) bulk::fence_before_copy();  // the buffer was read before
      bulk::load(strips + size_t(s) * strip_words,
                 gmask + size_t(w) * strip_words, strip_words * 8u, &bars[s]);
    }
    pending |= 1u << s;
  };

  for (int w = 0; w + 1 < stages; ++w) prefetch(w);
  for (int w = 0; w < words; ++w) {
    prefetch(w + stages - 1);
    u64 live = valid_bits[w] & ~removed[w];
    u64 kept = 0ull;
    if (live) {
      const int s = w % stages;
      wait_copy(s);
      const u64* strip = strips + size_t(s) * strip_words;
      // lane l's rows l and l + 32: their diagonal words, split into the
      // earlier rows that overlap them and the later rows they suppress
      const u64 d0 = strip[lane * words + w];
      const u64 d1 = strip[(lane + 32) * words + w];
      const u64 earlier0 = d0 & ((1ull << lane) - 1ull);
      const u64 earlier1 = d1 & ((1ull << (lane + 32)) - 1ull);
      const u64 later0 = d0 & ~earlier0;
      const u64 later1 = d1 & ~earlier1;
      do {
        const bool safe0 = ((live >> lane) & 1ull) && !(earlier0 & live);
        const bool safe1 = ((live >> (lane + 32)) & 1ull) && !(earlier1 & live);
        const u64 safe = u64(__ballot_sync(0xffffffffu, safe0)) |
                         (u64(__ballot_sync(0xffffffffu, safe1)) << 32);
        const u64 hit = (safe0 ? later0 : 0ull) | (safe1 ? later1 : 0ull);
        const u64 gone = u64(__reduce_or_sync(0xffffffffu, uint32_t(hit))) |
                         (u64(__reduce_or_sync(0xffffffffu, uint32_t(hit >> 32))) << 32);
        kept |= safe;
        live &= ~(safe | gone);
      } while (live);
      for (int w2 = w + 1 + lane; w2 < words; w2 += 32) {
        u64 acc = 0ull;
        for (int c0 = 0; c0 < 64; c0 += 8) {
          const unsigned byte = static_cast<unsigned>(kept >> c0) & 0xffu;
          if (byte) {  // 8 rows' words loaded at once, the unkept masked out
            u64 v[8];
#pragma unroll
            for (int r = 0; r < 8; ++r) v[r] = strip[(c0 + r) * words + w2];
#pragma unroll
            for (int r = 0; r < 8; ++r) acc |= v[r] & (0ull - ((byte >> r) & 1u));
          }
        }
        removed[w2] |= acc;
      }
      __syncwarp();
    }
    const int r0 = 64 * w + lane;
    if (r0 < k) gkeep[r0] = static_cast<uint8_t>((kept >> lane) & 1ull);
    if (r0 + 32 < k) gkeep[r0 + 32] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ull);
  }
  // no copy may land in shared memory after the block has exited
  for (int s = 0; s < stages; ++s)
    if ((pending >> s) & 1u) wait_copy(s);
}

// Per device: the opt-in shared memory per block, after raising the walk
// kernel's dynamic limit to it once.
int walk_smem_max() {
  static int limit[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -int(err);
  if (dev < 64 && limit[dev] > 0) return limit[dev];
  int max_bytes = 0;
  err = cudaDeviceGetAttribute(&max_bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return -int(err);
  err = cudaFuncSetAttribute(nms_walk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_bytes);
  if (err != cudaSuccess) return -int(err);
  if (dev < 64) limit[dev] = max_bytes;
  return max_bytes;
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32 (16-byte aligned), valid (B, K) bool, keep (B, K)
// bool out, mask (B, 64 W, W) 64-bit scratch for W = ceil(K / 64), its
// contents ignored. Launches both kernels on `stream`. Returns 0 on
// success, -1 if the walk's mask strips do not fit in the shared memory of
// a block, -2 for a batch beyond the grid's limit, else the CUDA error
// code.
int greedy_nms_keep(const void* boxes, const void* valid, void* keep,
                    void* mask, int batch, int k, float thres, void* stream) {
  if (batch == 0 || k == 0) return 0;
  if (batch > 65535) return -2;
  const int words = (k + 63) / 64;
  const int limit = walk_smem_max();
  if (limit < 0) return -limit;
  // strips, the removed and validity words, the barriers
  const size_t fixed = size_t(words) * 16 + kMaxStages * 8;
  const size_t strip = size_t(words) * 64 * 8;
  int stages = int(kStripBudget / strip);
  if (stages > words) stages = words;
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < 2) stages = 2;
  const size_t smem = stages * strip + fixed;
  if (smem > size_t(limit)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words * (words + 1) / 2, batch), 64 * kQuarters, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<u64*>(mask), k, words, thres);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  nms_walk_kernel<<<batch, 32, smem, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const u64*>(mask),
      static_cast<uint8_t*>(keep), k, words, stages);
  return int(cudaGetLastError());
}

}  // extern "C"
