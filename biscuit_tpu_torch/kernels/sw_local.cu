// K7 sw_local: exact local alignment (ksw_align2's ksw_u8 / ksw_i16
// semantics, reference lib/aln/ksw.c:111-334) for a batch of mate-rescue
// lanes.
//
// Replaces the XLA function sw_local_kernel of biscuit_tpu/ops/sw_local.py.
// There every lane stepped the target rows in lockstep over a [B, Lq] plane,
// with F as a closed-form prefix scan, until the last lane stopped. Here one
// thread owns one lane and walks its target rows i < tlen and, in each row,
// the columns j < ext in order, so F is the serial lazy-F recurrence
// F(j) = max(F(j-1) - e_ins, tF(j-1)), F(0) = 0, which equals the closed
// form (sw_local.py:89-95). A lane stops at its own break row.
//
// The H and E rows live in device scratch in a lane-minor layout ([Lq, B],
// neighbouring threads on neighbouring words, as K1's), the query and target
// codes too. What bounds the kernel: a serial ext x tlen walk per thread,
// about 160 x 400 cells at rescue shapes, each a few integer ops and 16 bytes
// of L1/L2 traffic, with only B / 32 warps to hide the latency. The next
// column's H and E are loaded before this column's are stored, so that their
// loads overlap the cell's arithmetic.
//
// What must match sw_local_kernel bit for bit:
//  * striped padding: ext is qlen rounded up to 16 (u8 lanes) or 8 (i16
//    lanes); columns qlen <= j < ext score 0 against every target base and
//    count in the row maximum; columns j >= ext stay 0 (never touched);
//  * shift = (256 - min of the lane's matrix) & 0xFF on u8 lanes, 0 else;
//  * the break after the row's update, on u8 saturation
//    (gmax + shift >= 255) or gmax >= endsc, only in a row that raised gmax;
//  * te starts at -1, qe at 0 (np.argmax of an all-zero Hmax); qe is the
//    first column holding the maximum of the row that last raised gmax;
//  * imax_rows[i, b] is the row maximum (>= 0) for every row the lane ran,
//    NEGB for every row after it stopped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEGB = -(1 << 28);

__global__ void sw_local_kernel(
    const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
    const int32_t* __restrict__ matb, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ endscv,
    const int32_t* __restrict__ u8v, int32_t* __restrict__ hbuf,
    int32_t* __restrict__ ebuf, int32_t* __restrict__ out,
    int32_t* __restrict__ rows, int B, int Lq, int Lt, int o_del, int e_del,
    int o_ins, int e_ins) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  int32_t* h = hbuf + b;  // H(j) at h[j * B]
  int32_t* e = ebuf + b;
  const int qlen = qlens[b], tlen = tlens[b], endsc = endscv[b];
  const bool u8 = u8v[b] > 0;
  const int32_t* mat = matb + (size_t)b * 25;
  int mn = mat[0];
  for (int k = 1; k < 25; ++k) mn = min(mn, mat[k]);
  const int shift = u8 ? (256 - mn) & 0xFF : 0;
  const int lanes = u8 ? 16 : 8;
  const int ext = min((qlen + lanes - 1) / lanes * lanes, Lq);
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;

  for (int j = 0; j < ext; ++j) {
    h[j * sB] = 0;
    e[j * sB] = 0;
  }
  int gmax = 0, te = -1, qe = 0;
  int i = 0;
  const int n_rows = min(tlen, Lt);
  for (; i < n_rows && ext > 0; ++i) {
    const int tb = min((int)tT[(size_t)i * sB + b], 4);
    const int s0 = mat[tb * 5 + 0], s1 = mat[tb * 5 + 1],
              s2 = mat[tb * 5 + 2], s3 = mat[tb * 5 + 3],
              s4 = mat[tb * 5 + 4];
    int hd = 0;           // H of the previous row at column j - 1
    int hj = h[0], ej = e[0];  // H and E of the previous row at column j
    int f = 0, rmax = 0, rarg = 0;
    for (int j = 0; j < ext; ++j) {
      int hn = 0, en = 0;
      if (j + 1 < ext) {
        hn = h[(j + 1) * sB];
        en = e[(j + 1) * sB];
      }
      int s = 0;
      if (j < qlen) {
        const int qc = qT[(size_t)j * sB + b];
        s = qc == 0 ? s0 : qc == 1 ? s1 : qc == 2 ? s2 : qc == 3 ? s3 : s4;
      }
      const int M = max(hd + s, 0);
      const int H1 = max(M, ej);
      const int H = max(H1, f);
      h[j * sB] = H;
      e[j * sB] = max(ej - e_del, max(H - oe_del, 0));
      f = max(f - e_ins, max(H1 - oe_ins, 0));
      if (H > rmax) {
        rmax = H;
        rarg = j;
      }
      hd = hj;
      hj = hn;
      ej = en;
    }
    rows[(size_t)i * sB + b] = rmax;
    if (rmax > gmax) {
      gmax = rmax;
      te = i;
      qe = rarg;
      if ((u8 && gmax + shift >= 255) || gmax >= endsc) {
        ++i;
        break;
      }
    }
  }
  // a lane with ext == 0 (qlen 0) runs all its rows, each with maximum 0
  if (ext == 0)
    for (; i < n_rows; ++i) rows[(size_t)i * sB + b] = 0;
  for (; i < Lt; ++i) rows[(size_t)i * sB + b] = NEGB;
  out[0 * sB + b] = gmax;
  out[1 * sB + b] = te;
  out[2 * sB + b] = qe;
  out[3 * sB + b] = shift;
  out[4 * sB + b] = (u8 && gmax + shift >= 255) ? 1 : 0;
}

}  // namespace

extern "C" int sw_local(const void* qT, const void* tT, const void* matb,
                        const void* qlens, const void* tlens,
                        const void* endsc, const void* u8, void* hbuf,
                        void* ebuf, void* out, void* rows, int B, int Lq,
                        int Lt, int o_del, int e_del, int o_ins, int e_ins,
                        void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  sw_local_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qT, (const uint8_t*)tT, (const int32_t*)matb,
      (const int32_t*)qlens, (const int32_t*)tlens, (const int32_t*)endsc,
      (const int32_t*)u8, (int32_t*)hbuf, (int32_t*)ebuf, (int32_t*)out,
      (int32_t*)rows, B, Lq, Lt, o_del, e_del, o_ins, e_ins);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
