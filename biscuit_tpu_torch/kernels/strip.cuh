// What the warp-per-lane DP kernels (sw_extend.cu, sw_local.cu, sw_global.cu)
// share: how a warp reads the codes, and where thread l keeps its strip of
// the DP row.
//
// A kernel is compiled for each strip width C of FOR_EACH_C (32 * C columns,
// the strip in C registers a thread) and once more as the wide instance,
// C = 0, which takes every wider query: there a strip is ceil(Lq / 32)
// columns, known only at launch, so it lies in memory as [k][thread] words
// (thread l's column k at word k * 32 + l: conflict-free in shared memory,
// coalesced in device memory). A block of the wide instance is one warp and
// the strips are its dynamic shared memory; a row too wide even for that
// (some thousand columns, see WIDE_SHARED) lies in a per-lane part of a
// device scratch the wrapper allocates. The code of a row is the same for
// every instance: it indexes a Strip.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // lanes of the batch a block (a warp each), C > 0
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a block of the wide instance may take: the 227 KB a
// block can have on sm_90, less room for the kernels' static arrays
constexpr int64_t WIDE_SHARED = 227 * 1024 - 4096;

// a sequence code (0..4; anything larger counts as 4) from a uint8 or an
// int32 array, as the caller has it
__device__ __forceinline__ int load_code(const void* p, size_t idx,
                                         int code_bytes) {
  const unsigned c = code_bytes == 4 ? (unsigned)((const int32_t*)p)[idx]
                                     : (unsigned)((const uint8_t*)p)[idx];
  return (int)min(c, 4u);
}

// the bases of target rows i0 .. i0 + 31 of one lane, one a thread (4 past
// the lane's last row)
__device__ __forceinline__ int load_tile(const void* target, size_t row0,
                                         int i0, int lane, int n_rows,
                                         int code_bytes) {
  const int r = i0 + lane;
  return r < n_rows ? load_code(target, row0 + r, code_bytes) : 4;
}

// thread l's strip of one array of the DP row: C registers, or for the wide
// instance the words k * 32 + l of array `a` of the lane's work memory
template <int C>
struct Strip {
  int v[C];
  __device__ __forceinline__ Strip(int32_t*, int, int, int) {}
  __device__ __forceinline__ int& operator[](int k) { return v[k]; }
};
template <>
struct Strip<0> {
  int32_t* p;
  __device__ __forceinline__ Strip(int32_t* mem, int a, int cols, int lane)
      : p(mem + (size_t)a * 32 * cols + lane) {}
  __device__ __forceinline__ int& operator[](int k) { return p[k * 32]; }
};

// columns a thread of the wide instance at query width Lq
__host__ __device__ constexpr int wide_cols(int Lq) { return (Lq + 31) / 32; }

// the dynamic shared memory, in bytes, that holds a wide lane's work memory
// of `words` words; 0 when it does not fit and the lane uses device scratch
inline int64_t wide_shared_bytes(int64_t words) {
  return words * 4 <= WIDE_SHARED ? words * 4 : 0;
}

// the launch shape of instance C over B lanes
template <int C>
struct Shape {
  static int blocks(int B) { return C ? (B + WARPS - 1) / WARPS : B; }
  static constexpr int threads = C ? WARPS * 32 : 32;
};

// dynamic shared memory above 48 KB has to be asked for, once a size
template <typename K>
int raise_shared(K kernel, int64_t bytes, int64_t& raised) {
  if (bytes <= raised) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc == cudaSuccess) raised = bytes;
  return (int)rc;
}

}  // namespace
