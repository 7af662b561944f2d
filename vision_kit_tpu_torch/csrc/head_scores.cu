// Head-map candidate scores for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/archive/bench_pallas_score.py:59 (the inner
// `kernel` of main(), launched by pallas_scores at :81), which computes
// stage 1 of vision_kit_tpu/ops/nms.py:postprocess_raw: for each anchor of
// each cell, best class = first index of the max class logit, and score =
// sigmoid(obj) * sigmoid(best logit) in f32. Fused here: the optional
// `classes` mask (a masked logit never wins; with every class masked the
// class is 0 and the score 0, as argmax and sigmoid(-inf) give) and the conf
// gate (a score <= conf becomes -1e9). Output: (B, N) f32 scores and (B, N)
// i32 classes over all levels, each level at its offset in (iy, ix, ia)
// order.
//
// Bound on the H100: bytes. Each row (one cell: na anchors x (5 + nc)
// channels, 255 for YOLOv5 at 80 classes) is read once from the head conv's
// channels_last output, in place, and 8 bytes are written per anchor: at
// batch 128 on v5s@640 that is 574 MB, 0.171 ms at 3.35 TB/s. The
// arithmetic, a compare per logit and two sigmoids per anchor, needs about
// half of the SMs' issue slots in that time, so it must stay lean: padding
// each 255-wide row to 256 lanes and reducing all of them under masks for
// every anchor would make the kernel bound by instructions instead.
//
// Design:
// - One launch covers every level: the wrapper's level table (base, rows,
//   cells, output offset, first tile) travels by value.
// - A tile is kTileRows = 64 consecutive rows of one level: one contiguous
//   span of 64 * na * no elements (32,640 bytes in bf16), 16-byte aligned
//   when the level's base is. Persistent blocks, as many as fit on the SMs,
//   walk the flat tile list of all levels.
// - Staging: one thread copies each tile into shared memory with one TMA
//   bulk copy (cp.async.bulk, mbarrier completion); 2 or 3 tiles are in
//   flight per block, so the reduction of one overlaps the loads of the
//   next. The copy size is rounded down to 16 bytes; the few bytes left of
//   a ragged last tile are loaded plainly.
// - Reduction: an anchor's segment (x, y, w, h, obj, nc logits) is reduced
//   by a group of 8 lanes, each over every 8th logit (max, first index on
//   ties, in f32, which holds every bf16/f16 value exactly), combined by 3
//   shuffle steps. A warp owns 32 segments; in round r its 4 groups reduce
//   segments r, r+8, r+16, r+24 and lane q*8+r keeps group q's result, so
//   after 8 rounds lane l holds segment l and computes its two sigmoids:
//   one sigmoid pass for 32 segments, not one per group.
// - Output: lane l writes segment l's score and class, so a warp writes
//   two contiguous 128-byte runs.
// - The classes mask is copied into shared memory once per block.
//
// Exactness: classes equal the plain version's; the sigmoid is
// 1 / (1 + expf(-x)) with an IEEE division, as PyTorch computes it, built
// without fast math and with -fmad=false.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxStages = 3;
constexpr int kGroup = 8;  // lanes per segment
constexpr float kGated = -1e9f;

struct Level {
  const unsigned char* base;  // 16-byte aligned (B, ny, nx, na, no) map
  long long rows;             // B * ny * nx
  int cells;                  // ny * nx
  int out_offset;             // first column of this level in (B, N)
  int tile_begin;             // first flat tile index of this level
};

struct Levels {
  Level level[kMaxLevels];
  int n_levels;
  int n_tiles;
  int tile_rows;
  int row_bytes;
};

struct Tile {
  Level level;
  const unsigned char* src;
  long long row0;
  int rows;
  uint32_t bulk;  // bytes moved by the bulk copy (a multiple of 16)
  uint32_t rest;  // bytes after those, loaded plainly (< 16)
};

__device__ __forceinline__ Tile tile_of(const Levels& lv, int t) {
  Tile tile;
  tile.level = lv.level[0];
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l)  // static indices: no local copy
    if (l < lv.n_levels && t >= lv.level[l].tile_begin) tile.level = lv.level[l];
  tile.row0 = static_cast<long long>(t - tile.level.tile_begin) * lv.tile_rows;
  long long left = tile.level.rows - tile.row0;
  tile.rows = left < lv.tile_rows ? static_cast<int>(left) : lv.tile_rows;
  tile.src = tile.level.base + tile.row0 * lv.row_bytes;
  uint32_t bytes = static_cast<uint32_t>(tile.rows) * lv.row_bytes;
  tile.bulk = bytes & ~15u;
  tile.rest = bytes - tile.bulk;
  return tile;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename T, bool kMasked>
__global__ void __launch_bounds__(1024)
head_scores_kernel(const Levels lv, const uint8_t* __restrict__ classes,
                   float* __restrict__ scores, int* __restrict__ best_cls,
                   int na, int no, long long n_total, float conf, int stages,
                   int stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint8_t* allow = reinterpret_cast<uint8_t*>(bars + kMaxStages);
  const int nc = no - 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  if (tid == 0) {
    bulk::barriers_init(bars, stages);
    for (int k = 0; k < stages; ++k) {
      int t = blockIdx.x + k * gridDim.x;
      if (t >= lv.n_tiles) break;
      Tile tile = tile_of(lv, t);
      bulk::load(smem + k * stage_bytes, tile.src, tile.bulk, &bars[k]);
    }
  }
  if (kMasked) {
    for (int j = tid; j < nc; j += blockDim.x) allow[j] = classes[j];
  }
  __syncthreads();

  const int q = lane / kGroup;  // this lane's group in the warp
  const int g = lane % kGroup;  // its place in the group
  int it = 0;
  for (int t = blockIdx.x; t < lv.n_tiles; t += gridDim.x, ++it) {
    const int stage = it % stages;
    const Tile tile = tile_of(lv, t);
    unsigned char* buf = smem + stage * stage_bytes;
    bulk::wait(&bars[stage], (it / stages) & 1);
    if (tile.rest) {
      if (tid < static_cast<int>(tile.rest))
        buf[tile.bulk + tid] = tile.src[tile.bulk + tid];
      __syncthreads();
    }
    const T* x = reinterpret_cast<const T*>(buf);
    const int nseg = tile.rows * na;
    const Level& level = tile.level;
    for (int chunk = warp; chunk * 32 < nseg; chunk += nwarps) {
      // Segments past nseg (a ragged tile) read stale data inside the
      // buffer and are not written.
      float mine = -CUDART_INF_F;
      int mine_cls = nc;
      for (int r = 0; r < kGroup; ++r) {
        const T* logit = x + static_cast<long long>(chunk * 32 + q * kGroup + r) * no + 5;
        float best = -CUDART_INF_F;
        int idx = nc;  // none yet: only a logit above -inf is taken
#pragma unroll 5
        for (int j = g; j < nc; j += kGroup) {
          float v = to_float(logit[j]);
          if (kMasked && !allow[j]) continue;
          if (v > best) {
            best = v;
            idx = j;
          }
        }
#pragma unroll
        for (int d = kGroup / 2; d > 0; d >>= 1) {
          float other = __shfl_xor_sync(0xffffffffu, best, d);
          int other_idx = __shfl_xor_sync(0xffffffffu, idx, d);
          if (other > best || (other == best && other_idx < idx)) {
            best = other;
            idx = other_idx;
          }
        }
        if (g == r) {
          mine = best;
          mine_cls = idx;
        }
      }
      const int s = chunk * 32 + lane;  // == chunk * 32 + q * kGroup + g
      if (s < nseg) {
        float obj = to_float(x[static_cast<long long>(s) * no + 4]);
        float score = __fmul_rn(sigmoid(obj), sigmoid(mine));
        // rows < 2^31 (the wrapper checks): 32-bit division
        const unsigned row = static_cast<unsigned>(tile.row0) + s / na;
        const unsigned b = row / level.cells;
        const unsigned cell = row - b * level.cells;
        long long o = b * n_total + level.out_offset + cell * na + s % na;
        scores[o] = score > conf ? score : kGated;
        best_cls[o] = mine_cls < nc ? mine_cls : 0;
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (tid == 0) {
      int next = t + stages * gridDim.x;
      if (next < lv.n_tiles) {
        Tile tile_next = tile_of(lv, next);
        bulk::fence_before_copy();
        bulk::load(buf, tile_next.src, tile_next.bulk, &bars[stage]);
      }
    }
  }
}

using KernelFn = void (*)(const Levels, const uint8_t*, float*, int*, int, int,
                          long long, float, int, int);

KernelFn pick(int dtype, bool masked) {
  switch (dtype) {
    case 0:
      return masked ? head_scores_kernel<__nv_bfloat16, true>
                    : head_scores_kernel<__nv_bfloat16, false>;
    case 1:
      return masked ? head_scores_kernel<__half, true>
                    : head_scores_kernel<__half, false>;
    case 2:
      return masked ? head_scores_kernel<float, true>
                    : head_scores_kernel<float, false>;
  }
  return nullptr;
}

// Per device: SM count and the opt-in shared memory per block; and per
// kernel instance, whether its dynamic shared-memory limit was raised.
struct DeviceInfo {
  int sms = 0;
  int smem_max = 0;
  bool raised[6] = {};
  int occ_key[6] = {};  // threads * 2^20 + shared bytes of the cached count
  int occ_per_sm[6] = {};
};

cudaError_t device_info(DeviceInfo** out) {
  static DeviceInfo info[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    err = cudaDeviceGetAttribute(&d.smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = &d;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// One launch over `n_levels` head maps. Per level: base address (16-byte
// aligned), rows (B * ny * nx), cells (ny * nx), output column offset and
// first flat tile index; the wrapper computes them. dtype: 0 bf16, 1 f16,
// 2 f32. classes: (nc,) uint8 mask or null. scores (B, n_total) f32 and
// best_cls (B, n_total) i32 out. Launches on `stream`. Returns 0 on
// success, -1 if a tile does not fit the shared memory of a block, -2 for
// arguments the kernel does not take, else the CUDA error code.
int head_scores_launch(const long long* bases, const long long* rows,
                       const int* cells, const int* out_offsets,
                       const int* tile_begin, int n_levels, int n_tiles,
                       int tile_rows, const void* classes, void* scores,
                       void* best_cls, int dtype, int na, int no,
                       long long n_total, float conf, void* stream) {
  if (n_tiles == 0) return 0;
  static const int kSize[3] = {2, 2, 4};
  if (n_levels < 1 || n_levels > kMaxLevels || dtype < 0 || dtype > 2 ||
      no <= 5 || tile_rows * na > 1024 || (tile_rows * na) % 32 != 0)
    return -2;
  KernelFn kernel = pick(dtype, classes != nullptr);
  Levels lv;
  lv.n_levels = n_levels;
  lv.n_tiles = n_tiles;
  lv.tile_rows = tile_rows;
  lv.row_bytes = na * no * kSize[dtype];
  for (int l = 0; l < n_levels; ++l) {
    lv.level[l].base = reinterpret_cast<const unsigned char*>(bases[l]);
    lv.level[l].rows = rows[l];
    lv.level[l].cells = cells[l];
    lv.level[l].out_offset = out_offsets[l];
    lv.level[l].tile_begin = tile_begin[l];
  }
  DeviceInfo* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return int(err);
  const int stage_bytes = (tile_rows * lv.row_bytes + 127) & ~127;
  const int extra = kMaxStages * 8 + (no - 5);
  int stages = kMaxStages;
  while (stages > 2 && stages * stage_bytes + extra > d->smem_max) --stages;
  const int smem = stages * stage_bytes + extra;
  if (smem > d->smem_max) return -1;
  const int instance = dtype * 2 + (classes != nullptr);
  if (!d->raised[instance]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               d->smem_max);
    if (err != cudaSuccess) return int(err);
    d->raised[instance] = true;
  }
  const int threads = tile_rows * na;
  const int key = (threads << 20) + smem;
  if (d->occ_key[instance] != key) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return int(err);
    if (per_sm < 1) return -1;
    d->occ_key[instance] = key;
    d->occ_per_sm[instance] = per_sm;
  }
  int grid = d->occ_per_sm[instance] * d->sms;
  if (grid > n_tiles) grid = n_tiles;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const uint8_t*>(classes), static_cast<float*>(scores),
      static_cast<int*>(best_cls), na, no, n_total, conf, stages, stage_bytes);
  return int(cudaGetLastError());
}

}  // extern "C"
