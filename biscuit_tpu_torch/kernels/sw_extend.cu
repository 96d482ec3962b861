// K1 sw_extend: banded affine-gap Smith-Waterman extension, exact
// ksw_extend2 (reference lib/aln/ksw.c:380-479), for a batch of lanes.
//
// Replaces the Pallas kernel _sw_kernel of biscuit_tpu/ops/pallas_sw.py
// (sw_extend_batch_pallas). On the TPU the lanes rode the 128-wide vector
// axis and every tile stepped its rows in lockstep, masked, until its last
// lane broke. Here one thread owns one lane and runs that lane's row loop
// until the lane itself breaks (m == 0, z-drop, band collapse or the end of
// its target), so a lane that dies early costs nothing more.
//
// Per lane the DP state h[0..Lq], e[0..Lq] lives in device memory in a
// lane-minor layout ([Lq+1, B], neighbouring threads on neighbouring
// words), which at the engine's shapes (B up to a few thousand, Lq ~150)
// stays in L2. Query and target are uint8 codes, also lane-minor. A cell
// costs a handful of integer ops and 16 bytes of L1/L2 traffic: the kernel
// is bound by that traffic and by the serial F chain along the row.
//
// What must match _sw_kernel bit for bit:
//  * the first row's closed-form decay (pallas_sw.py:97-102);
//  * h[beg] = h1_first and h[j+1] = H(j) inside the band; the JAX kernel
//    also zeroes every cell outside the band, so the cells the next row can
//    read beyond this row's band (h[end+1], e[end], e[end+1]) are zeroed;
//  * the end-side narrowing: the next row's end is last_nz + 2, with
//    last_nz the last nonzero h or e cell at or left of this row's end;
//  * gscore/max_ie at the query end, including the collapsed-band case;
//  * the z-drop test with e_del or e_ins chosen by di > dj, against the
//    previous maximum;
//  * mj when the row maximum is 0: the JAX kernel takes the rightmost column
//    of the padded row (Lq - 1).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sw_extend_kernel(
    const uint8_t* __restrict__ qT, const uint8_t* __restrict__ tT,
    const int32_t* __restrict__ matb, const int32_t* __restrict__ qlens,
    const int32_t* __restrict__ tlens, const int32_t* __restrict__ wv,
    const int32_t* __restrict__ h0v, int32_t* __restrict__ hbuf,
    int32_t* __restrict__ ebuf, int32_t* __restrict__ out, int B, int Lq,
    int Lt, int o_del, int e_del, int o_ins, int e_ins, int zdrop) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int32_t* h = hbuf + b;  // h[j] at h[(size_t)j * B]
  int32_t* e = ebuf + b;
  const size_t sB = (size_t)B;
  const int qlen = qlens[b], tlen = tlens[b], w = wv[b], h0 = h0v[b];
  const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
  const int32_t* mat = matb + (size_t)b * 25;

  // first row (ksw.c:395-397)
  const int h1v = max(h0 - oe_ins, 0);
  h[0] = h0;
  e[0] = 0;
  for (int j = 1; j <= Lq; ++j) {
    h[j * sB] = j <= qlen ? max(h1v - (j - 1) * e_ins, 0) : 0;
    e[j * sB] = 0;
  }

  int end = qlen, mx = h0, max_i = -1, max_j = -1, max_ie = -1;
  int gscore = -1, max_off = 0;
  const int n_rows = min(tlen, Lt);
  for (int i = 0; i < n_rows; ++i) {
    const int beg_i = max(i - w, 0);
    const int end_i = min(min(end, i + w + 1), qlen);
    const bool at_tail = end_i == qlen;
    const int h1_first =
        beg_i == 0 ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
    if (beg_i >= end_i) {  // band collapsed: the lane ends here
      if (at_tail && gscore <= h1_first) {
        gscore = max(gscore, h1_first);
        max_ie = i;
      }
      break;
    }
    const int tb = tT[(size_t)i * sB + b];
    const int s0 = mat[tb * 5 + 0], s1 = mat[tb * 5 + 1],
              s2 = mat[tb * 5 + 2], s3 = mat[tb * 5 + 3],
              s4 = mat[tb * 5 + 4];
    int hd = h[beg_i * sB];  // H of the previous row at the diagonal
    h[beg_i * sB] = h1_first;
    int last_nz = h1_first != 0 ? beg_i : -1;
    int f = 0, m_val = 0, mj = -1, hc = 0;
    for (int j = beg_i; j < end_i; ++j) {
      const int qc = qT[(size_t)j * sB + b];
      const int s = qc == 0 ? s0 : qc == 1 ? s1 : qc == 2 ? s2
                  : qc == 3 ? s3 : s4;
      const int M = hd ? hd + s : 0;
      const int Ej = e[j * sB];
      hd = h[(j + 1) * sB];
      hc = max(max(M, Ej), f);
      h[(j + 1) * sB] = hc;
      const int ne = max(Ej - e_del, max(M - oe_del, 0));
      e[j * sB] = ne;
      f = max(f - e_ins, max(M - oe_ins, 0));
      if (hc >= m_val) {
        m_val = hc;
        mj = j;
      }
      if (ne != 0) last_nz = max(last_nz, j);
      if (hc != 0) last_nz = j + 1;
    }
    if (m_val == 0) mj = Lq - 1;
    // cells the next row may read that this row did not write
    if (end_i + 1 <= Lq) {
      h[(end_i + 1) * sB] = 0;
      e[(end_i + 1) * sB] = 0;
    }
    e[end_i * sB] = 0;

    if (at_tail && gscore <= hc) {  // hc is H(end_i - 1)
      gscore = hc;
      max_ie = i;
    }
    const bool brk0 = m_val == 0;
    const bool improved = m_val > mx;
    const int di = i - max_i, dj = mj - max_j;
    const bool zd = di > dj ? (mx - m_val - (di - dj) * e_del > zdrop)
                            : (mx - m_val - (dj - di) * e_ins > zdrop);
    const bool zbrk = !improved && zdrop > 0 && zd && !brk0;
    if (improved) {
      mx = m_val;
      max_i = i;
      max_j = mj;
      max_off = max(max_off, abs(mj - i));
    }
    end = min(last_nz + 2, qlen);
    if (brk0 || zbrk) break;
  }
  out[0 * sB + b] = mx;
  out[1 * sB + b] = max_j + 1;
  out[2 * sB + b] = max_i + 1;
  out[3 * sB + b] = max_ie + 1;
  out[4 * sB + b] = gscore;
  out[5 * sB + b] = max_off;
}

}  // namespace

extern "C" int sw_extend(const void* qT, const void* tT, const void* matb,
                         const void* qlens, const void* tlens, const void* w,
                         const void* h0, void* hbuf, void* ebuf, void* out,
                         int B, int Lq, int Lt, int o_del, int e_del,
                         int o_ins, int e_ins, int zdrop, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  sw_extend_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)qT, (const uint8_t*)tT, (const int32_t*)matb,
      (const int32_t*)qlens, (const int32_t*)tlens, (const int32_t*)w,
      (const int32_t*)h0, (int32_t*)hbuf, (int32_t*)ebuf, (int32_t*)out, B,
      Lq, Lt, o_del, e_del, o_ins, e_ins, zdrop);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
