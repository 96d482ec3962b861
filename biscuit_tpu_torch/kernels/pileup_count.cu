// K9 pileup_count: the count matrices of one pileup window, a scatter-add of
// one (site, code) pair per aligned read base.
//
// Replaces the XLA function pileup_count_window
// (biscuit_tpu/parallel/mesh.py), which forms idx = position * n_codes + stat,
// sends the data whose `valid` is false to a spill bin past the end, adds one
// at every idx (`counts.at[idx].add(1)`) and returns the counts without the
// spill bin, and the two calls of it in the pileup engine's _device_counts
// (biscuit_tpu/pileup/engine.py), which count 32 codes over the passing data
// and 1 code over every datum, the depth, then sum the 21 codes base * 3 +
// meth into the methylation counts cm [site, 3] and the base counts
// cb [site, 7] on the host.
//
// Two entry points, one kernel:
//  - pileup_window_counts (the engine's call): cm, cb and the depth of a
//    window in one launch, 11 words a site: [cm0..cm2, cb0..cb6, dp]. The
//    inputs are what the engine stages for the card: an int32 site index
//    (site * n_bams + sample), a uint8 code and a pass flag, 6 bytes a
//    datum. Every datum counts in dp whatever its flag; a passing datum
//    with a code in [0, 21) counts in cm and cb, one in [21, 32) in neither
//    (the JAX slice counts[:, :21] drops it).
//  - pileup_count_window (the general contract of mesh.py): a [window,
//    n_codes] matrix of the valid data, int32 or int64 indices.
// Integer counts do not depend on the order of the atomics, so both equal
// their plain versions exactly. Nothing is clamped or dropped silently: a
// datum whose site is outside [0, window) (any datum in the fused entry, a
// valid one in the general), a passing datum with a code outside [0, 32)
// (fused) or a valid one outside [0, n_codes) (general) counts in the word
// out[window * W] that the wrapper reads and raises on.
//
// Design: a block takes a contiguous chunk of data and finds the chunk's
// site span with a block reduction. The data arrive nearly sorted (each
// sample's reads in coordinate order), so at 30x of 150 bp reads a chunk of
// 8192 data spans about 420 sites: the block counts into [span, W] bins in
// shared memory with shared-memory atomics, then adds each nonzero bin to
// device memory once. A chunk whose span does not fit the block's bins
// (shuffled data, or the chunk where one sample's data end and the next
// sample's begin) adds straight into device memory with global atomics,
// inside the same kernel, and counts itself in out[window * W + 1], which
// the wrapper returns.
//
// What bounds it on an H100: bytes, each datum's 6 (fused) read once and
// the counts written once; the atomics of a chunk resolve in shared memory.
// The wrapper zeroes out (window * W + 2 words) before the launch.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
// dynamic shared memory for the bins: with the static words of the span
// reduction it stays under the 48 KB a block has without opting in, and
// four blocks fill an SM (1090 sites of 11 words: a sample at 30x of 150 bp
// reads spans about 420 sites a chunk, two samples in turn about 850)
constexpr int BIN_WORDS = 12000;
constexpr int FUSED_W = 11;             // cm 3, cb 7, dp 1
constexpr int N_BASE_METH = 21;         // NSTATUS_BASE * NSTATUS_METH
constexpr int MAX_CODE = 32;
// data a block: at 30x of 150 bp reads about 420 sites (18 KB of bins at 11
// words a site) and, for the general entry's 32 codes, about 290 (37 KB)
constexpr int64_t FUSED_CHUNK = 8192, GENERAL_CHUNK = 4096;

// The smallest and largest in-range site of the block's data (lo > hi when
// none is), on every thread.
__device__ void block_span(int& lo, int& hi) {
  __shared__ int s_lo[WARPS], s_hi[WARPS];
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = lane < WARPS ? s_lo[lane] : INT_MAX;
  hi = lane < WARPS ? s_hi[lane] : -1;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
}

// FUSED: P = int32 sites, C = uint8 codes, `pass` the pass flags, W = 11.
// Otherwise P = C = int32 or int64, `pass` the valid flags, W = n_codes.
template <bool FUSED, typename P, typename C>
__global__ void __launch_bounds__(THREADS)
pileup_count_kernel(const P* __restrict__ pos, const C* __restrict__ code,
                    const uint8_t* __restrict__ pass, int64_t n, int64_t chunk,
                    int window, int W, int32_t* __restrict__ out) {
  extern __shared__ int32_t bins[];
  const int64_t begin = (int64_t)blockIdx.x * chunk;
  const int64_t end = begin + chunk < n ? begin + chunk : n;
  const int tid = threadIdx.x;

  int lo = INT_MAX, hi = -1;
  for (int64_t i = begin + tid; i < end; i += THREADS) {
    if (!FUSED && !pass[i]) continue;
    const int64_t s = (int64_t)pos[i];
    if (s >= 0 && s < window) {
      lo = min(lo, (int)s);
      hi = max(hi, (int)s);
    }
  }
  block_span(lo, hi);
  const int64_t span = hi >= lo ? (int64_t)hi - lo + 1 : 0;
  const bool priv = span * W <= BIN_WORDS;  // uniform over the block
  const int n_bins = (int)(span * W);
  const int64_t base = (int64_t)lo * W;
  if (priv) {
    for (int k = tid; k < n_bins; k += THREADS) bins[k] = 0;
    __syncthreads();
  } else if (tid == 0) {
    atomicAdd(&out[(int64_t)window * W + 1], 1);
  }
  auto add = [&](int64_t word) {
    if (priv) atomicAdd(&bins[word - base], 1);
    else atomicAdd(&out[word], 1);
  };

  int refused = 0;
  for (int64_t i = begin + tid; i < end; i += THREADS) {
    const bool f = pass[i] != 0;
    if (!FUSED && !f) continue;
    const int64_t s = (int64_t)pos[i];
    if (s < 0 || s >= window) {
      ++refused;
      continue;
    }
    const int64_t c = (int64_t)code[i];
    if (FUSED) {
      add(s * FUSED_W + 10);
      if (f) {
        const int cc = (int)c;  // a uint8
        if (cc >= MAX_CODE) ++refused;
        else if (cc < N_BASE_METH) {
          add(s * FUSED_W + cc % 3);
          add(s * FUSED_W + 3 + cc / 3);
        }
      }
    } else if (c < 0 || c >= W) {
      ++refused;
    } else {
      add(s * W + c);
    }
  }
  if (refused) atomicAdd(&out[(int64_t)window * W], refused);
  if (priv) {
    __syncthreads();
    for (int k = tid; k < n_bins; k += THREADS) {
      const int v = bins[k];
      if (v) atomicAdd(&out[base + k], v);
    }
  }
}

template <bool FUSED, typename P, typename C>
int launch(const void* pos, const void* code, const void* pass, int64_t n,
           int64_t window, int64_t W, int64_t chunk, void* out,
           cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t blocks = (n + chunk - 1) / chunk;
  pileup_count_kernel<FUSED, P, C>
      <<<(unsigned)blocks, THREADS, BIN_WORDS * sizeof(int32_t), stream>>>(
          (const P*)pos, (const C*)code, (const uint8_t*)pass, n, chunk,
          (int)window, (int)W, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// out: int32 [window * 11 + 2], zeroed.
extern "C" int pileup_window_counts(const void* sites, const void* codes,
                                    const void* pass, int64_t n,
                                    int64_t window, void* out, void* stream) {
  return launch<true, int32_t, uint8_t>(sites, codes, pass, n, window,
                                        FUSED_W, FUSED_CHUNK, out,
                                        (cudaStream_t)stream);
}

// out: int32 [window * n_codes + 2], zeroed.
extern "C" int pileup_count_i32(const void* positions, const void* stat,
                                const void* valid, int64_t n, int64_t window,
                                int64_t n_codes, void* out, void* stream) {
  return launch<false, int32_t, int32_t>(positions, stat, valid, n, window,
                                         n_codes, GENERAL_CHUNK, out,
                                         (cudaStream_t)stream);
}

extern "C" int pileup_count_i64(const void* positions, const void* stat,
                                const void* valid, int64_t n, int64_t window,
                                int64_t n_codes, void* out, void* stream) {
  return launch<false, int64_t, int64_t>(positions, stat, valid, n, window,
                                         n_codes, GENERAL_CHUNK, out,
                                         (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
