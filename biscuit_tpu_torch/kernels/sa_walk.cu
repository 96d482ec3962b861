// K4 sa_walk: the bwt_sa walk for a batch of ranks.
//
// Replaces the XLA while_loop sa_batch (biscuit_tpu/ops/seed_batch.py,
// `sa_batch`), which walked every job of the batch in lockstep until the
// last one reached a sampled rank. Here each thread walks one job until its
// own rank is a multiple of sa_intv, so a short walk does not wait for the
// longest one of its batch.
//
// Per step: one 32-byte (narrow) or 48-byte (wide) row of the fused occ+BWT
// table gives both the BWT character at the rank and its occurrence count
// (seed_batch._fused_tab), so a step is one dependent random read. The walk
// is latency-bound on those reads; enough jobs in flight (2^20 in a batch)
// hide it. Narrow indexes (strands < 2^31) use int32 ranks and 8-column
// rows; wide indexes use int64 ranks and 12-column rows with split lo/hi
// counts. The kernel is templated on both.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename R, int W>
__global__ void sa_walk_kernel(const uint32_t* __restrict__ tab,
                               const int64_t* __restrict__ L2,
                               const int64_t* __restrict__ primary,
                               const R* __restrict__ sa,
                               const int32_t* __restrict__ which,
                               const R* __restrict__ k, int64_t n64,
                               int64_t n_sa, int sa_shift,
                               R* __restrict__ out, int64_t n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int wh = which[idx];
  const R prim = (R)primary[wh];
  const uint32_t* t = tab + (int64_t)wh * n64 * W;
  const int64_t* l2 = L2 + wh * 5;
  const R mask = ((R)1 << sa_shift) - 1;
  R kk = k[idx];
  R add = 0;
  while (kk & mask) {
    // inverse Psi; the '$' row (rank == primary) maps to rank 0
    const R j = kk - (kk >= prim ? 1 : 0);
    const uint32_t* row = t + (int64_t)(j >> 6) * W;
    const int wi = (int)((j >> 4) & 3);
    const int tl = (int)(~j & 15);  // bases of word wi after position j
    const int c = (int)((row[W - 4 + wi] >> (tl << 1)) & 3u);
    int cnt = 0;
    for (int q = 0; q <= wi; ++q) {
      uint32_t wm = row[W - 4 + q];
      if (q == wi) wm = (wm >> (tl << 1)) << (tl << 1);  // cut after j
      const uint32_t inv = ~wm;
      const uint32_t hi = ((c & 2) ? wm : inv) >> 1;
      const uint32_t lo = (c & 1) ? wm : inv;
      cnt += __popc(hi & lo & 0x55555555u);
    }
    if (c == 0) cnt -= tl;  // the cut-off bases read as A (code 0)
    R acc;
    if constexpr (W == 12) {
      acc = (R)((uint64_t)row[c] | ((uint64_t)row[4 + c] << 32));
    } else {
      acc = (R)row[c];
    }
    kk = (kk == prim) ? (R)0 : (R)(l2[c] + (int64_t)acc + cnt);
    ++add;
  }
  out[idx] = add + sa[(int64_t)wh * n_sa + (int64_t)(kk >> sa_shift)];
}

template <typename R, int W>
int launch(const void* tab, const void* L2, const void* primary,
           const void* sa, const void* which, const void* k, int64_t n64,
           int64_t n_sa, int sa_shift, void* out, int64_t n,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  sa_walk_kernel<R, W><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint32_t*)tab, (const int64_t*)L2, (const int64_t*)primary,
      (const R*)sa, (const int32_t*)which, (const R*)k, n64, n_sa, sa_shift,
      (R*)out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sa_walk_narrow(const void* tab, const void* L2,
                              const void* primary, const void* sa,
                              const void* which, const void* k, int64_t n64,
                              int64_t n_sa, int sa_shift, void* out,
                              int64_t n, void* stream) {
  return launch<int32_t, 8>(tab, L2, primary, sa, which, k, n64, n_sa,
                            sa_shift, out, n, (cudaStream_t)stream);
}

extern "C" int sa_walk_wide(const void* tab, const void* L2,
                            const void* primary, const void* sa,
                            const void* which, const void* k, int64_t n64,
                            int64_t n_sa, int sa_shift, void* out, int64_t n,
                            void* stream) {
  return launch<int64_t, 12>(tab, L2, primary, sa, which, k, n64, n_sa,
                             sa_shift, out, n, (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
