// K9 pileup_count: the count matrices of one pileup window, a scatter-add of
// one (site, code) pair per aligned read base.
//
// Replaces the XLA function pileup_count_window
// (biscuit_tpu/parallel/mesh.py), which forms idx = position * n_codes + stat,
// sends the data whose `valid` is false to a spill bin past the end, adds one
// at every idx (`counts.at[idx].add(1)`) and returns the counts without the
// spill bin. Here one thread takes one datum at a time (grid-stride) and adds
// one with an int32 atomicAdd in device memory; a datum whose `valid` is
// false is skipped, which is what a spill bin that nobody reads amounts to.
// Integer counts do not depend on the order of the atomics, so the result
// equals the plain version's exactly.
//
// XLA drops an index past the end and wraps a negative one. This kernel
// never stores out of range and never clamps: a valid datum whose position
// is not in [0, window) or whose code is not in [0, n_codes) is counted in
// one extra word, counts[window * n_codes], which the wrapper reads and
// raises on.
//
// The wrapper zeroes `counts` (window * n_codes + 1 words) before the launch.
//
// What bounds it on an H100: bytes. Each datum is read once (two indices and
// one byte) and the counts are written once; the arithmetic is one multiply
// and two adds a datum. Positions come nearly sorted (reads in coordinate
// order), so the atomics of a warp fall into a few neighbouring sites and
// resolve in the L2; a window's counts (at most 200,000 x 32 words, 25.6 MB)
// fit in it. Bins private to a block in shared memory, and one launch for
// both count calls of a window, would cut the L2 traffic further.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

template <typename I>
__global__ void pileup_count_kernel(const I* __restrict__ positions,
                                    const I* __restrict__ stat,
                                    const uint8_t* __restrict__ valid,
                                    int64_t n, int64_t window, int64_t n_codes,
                                    int32_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int refused = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;
    const int64_t p = (int64_t)positions[i];
    const int64_t s = (int64_t)stat[i];
    if (p < 0 || p >= window || s < 0 || s >= n_codes) {
      ++refused;
      continue;
    }
    atomicAdd(&counts[p * n_codes + s], 1);
  }
  if (refused) atomicAdd(&counts[window * n_codes], refused);
}

template <typename I>
int launch(const void* positions, const void* stat, const void* valid,
           int64_t n, int64_t window, int64_t n_codes, void* counts,
           cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  pileup_count_kernel<I><<<(unsigned)blocks, THREADS, 0, stream>>>(
      (const I*)positions, (const I*)stat, (const uint8_t*)valid, n, window,
      n_codes, (int32_t*)counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pileup_count_i32(const void* positions, const void* stat,
                                const void* valid, int64_t n, int64_t window,
                                int64_t n_codes, void* counts, void* stream) {
  return launch<int32_t>(positions, stat, valid, n, window, n_codes, counts,
                         (cudaStream_t)stream);
}

extern "C" int pileup_count_i64(const void* positions, const void* stat,
                                const void* valid, int64_t n, int64_t window,
                                int64_t n_codes, void* counts, void* stream) {
  return launch<int64_t>(positions, stat, valid, n, window, n_codes, counts,
                         (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
