// Banded affine-gap local alignment over anti-diagonals, for NVIDIA Hopper.
//
// The same recurrence as ops/banded_align.py (the XLA scan, which is the
// reference this kernel must match bit for bit), laid out for a GPU:
//
//   * one warp per item; band cell w = j * 32 + lane, so a lane holds
//     C = W / 32 cells (registers j = 0 .. C-1);
//   * H, E, F and the diagonal-run/mismatch counters of the last two
//     anti-diagonals stay in registers; the +-1 band shift that follows
//     the 0/1 step of the band schedule is one warp shuffle per register;
//   * the item's query, target window and quality stream are staged in
//     shared memory once; the anti-diagonal loop runs inside the block;
//   * every step stores the warp's W arrow words as consecutive uint16,
//     in the reference's (S, I, W) layout;
//   * the best cell is tracked per lane and reduced across the warp once.
//
// Called from JAX through the FFI (ops/banded_gpu.py builds and registers
// it). Build: nvcc -arch=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
//             -I <jax.ffi.include_dir()> banded_dp.cu

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 4;
constexpr size_t kMaxSmem = 227 * 1024;

// H-source codes of the arrow word (ops/banded_align.py)
constexpr int32_t kDiag = 0, kUp = 1, kLeft = 2, kE = 3, kF = 4, kStop = 5,
                  kDiagStart = 6;

struct Scores {
  int32_t match, mismatch, n_score, ins, del, go, ge;
  int32_t qmode;       // 0: no qualities, 1: one stream, 2: two packed streams
  int32_t use_matrix;  // substitution scores from mat (-scoreMatrix)
  int32_t mat[25];     // query x target over A C G T N
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t smem_per_warp(int L, int T, int qmode) {
  return align16(L) + align16(T) + (qmode ? align16(2 * size_t(L)) : 0);
}

__device__ __forceinline__ int32_t floordiv15(int32_t a) {
  int32_t q = a / 15;
  return (a % 15 != 0 && a < 0) ? q - 1 : q;
}

// QV-scaled penalty, banded_align.qv_scaled_costs
__device__ __forceinline__ int32_t qv_cost(int32_t base, int32_t q) {
  q = min(max(q, 4), 30);
  return max(floordiv15(base * q + 7), 1);
}

// out[w] = x[w + d] for d in {-1, 0, 1}, `fill` outside the band.
template <int C>
__device__ __forceinline__ void shift(const int32_t (&x)[C], int32_t (&out)[C],
                                      int d, int32_t fill, int lane) {
  if (d > 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      // lane 31 takes cell (j + 1) * 32 from lane 0
      int32_t send = (lane == 0) ? x[(j + 1 < C) ? j + 1 : j] : x[j];
      int32_t v = __shfl_sync(kFull, send, (lane + 1) & 31);
      out[j] = (lane == 31 && j + 1 == C) ? fill : v;
    }
  } else if (d < 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      // lane 0 takes cell j * 32 - 1 from lane 31
      int32_t send = (lane == 31) ? x[(j > 0) ? j - 1 : j] : x[j];
      int32_t v = __shfl_sync(kFull, send, (lane + 31) & 31);
      out[j] = (lane == 0 && j == 0) ? fill : v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < C; ++j) out[j] = x[j];
  }
}

template <int C>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
banded_dp_kernel(const uint8_t* __restrict__ query,
                 const int32_t* __restrict__ qlen,
                 const uint8_t* __restrict__ target,
                 const int32_t* __restrict__ tlo,
                 const int32_t* __restrict__ thi,
                 const int32_t* __restrict__ qoff,
                 const uint16_t* __restrict__ qual, const Scores sc, int I,
                 int L, int T, int S, int per_item,
                 int32_t* __restrict__ out_score,
                 int32_t* __restrict__ out_a, int32_t* __restrict__ out_w,
                 uint16_t* __restrict__ arrows) {
  constexpr int W = 32 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= I) return;  // warps are independent: no block-wide barrier

  uint8_t* qs = smem + size_t(warp) * smem_per_warp(L, T, sc.qmode);
  uint8_t* ts = qs + align16(L);
  uint16_t* qus = reinterpret_cast<uint16_t*>(ts + align16(T));
  for (int k = lane; k < L; k += 32) qs[k] = query[size_t(i) * L + k];
  for (int k = lane; k < T; k += 32) ts[k] = target[size_t(i) * T + k];
  if (sc.qmode)
    for (int k = lane; k < L; k += 32) qus[k] = qual[size_t(i) * L + k];
  __syncwarp();

  const int32_t ql = qlen[i], tl = tlo[i], th = thi[i];
  const int32_t q_neutral = sc.qmode == 2 ? (15 | (15 << 8)) : 15;
  const size_t q_stride = per_item ? size_t(I) : 1;
  const int32_t* qo_ptr = qoff + (per_item ? i : 0);

  int32_t H1[C], H2[C], E1[C], F1[C], RM1[C], RM2[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    H1[j] = H2[j] = E1[j] = F1[j] = kInf;
    RM1[j] = RM2[j] = 0;  // diagonal run length | mismatches << 8
  }
  int32_t lbest = 0, la = 0, lw = 0;
  int32_t qo_prev = qo_ptr[0], s1_prev = 0;
  int32_t qo_next = qo_ptr[0];

  for (int a = 0; a < S; ++a) {
    const int32_t qo = qo_next;
    if (a + 1 < S) qo_next = qo_ptr[size_t(a + 1) * q_stride];
    const int32_t s1 = qo - qo_prev;  // 0 or 1
    const int32_t s2 = s1_prev;

    int32_t Hup[C], Hleft[C], Eleft[C], Fup[C], H2d[C], RM2d[C];
    if (s1 == 0) {
      shift<C>(H1, Hup, -1, kInf, lane);
      shift<C>(F1, Fup, -1, kInf, lane);
      shift<C>(H1, Hleft, 0, kInf, lane);
      shift<C>(E1, Eleft, 0, kInf, lane);
    } else {
      shift<C>(H1, Hup, 0, kInf, lane);
      shift<C>(F1, Fup, 0, kInf, lane);
      shift<C>(H1, Hleft, 1, kInf, lane);
      shift<C>(E1, Eleft, 1, kInf, lane);
    }
    shift<C>(H2, H2d, s1 + s2 - 1, kInf, lane);
    shift<C>(RM2, RM2d, s1 + s2 - 1, 0, lane);

    uint16_t* arow = arrows + (size_t(a) * I + i) * W;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int32_t w = j * 32 + lane;
      const int32_t qp = qo + w;
      const int32_t tp = a - qp;
      const int32_t qc = (qp >= 0 && qp < L) ? qs[qp] : 4;
      const int32_t tc = (tp >= 0 && tp < T) ? ts[tp] : 5;

      int32_t x_cell = sc.mismatch, ins_cell = sc.ins;
      if (sc.qmode) {
        const int32_t qu = (qp >= 0 && qp < L) ? qus[qp] : q_neutral;
        x_cell = qv_cost(sc.mismatch, sc.qmode == 2 ? (qu & 255) : qu);
        ins_cell = qv_cost(sc.ins, sc.qmode == 2 ? (qu >> 8) : qu);
      }
      const bool eq = qc == tc && qc < 4;
      int32_t sub;
      if (sc.use_matrix) {
        sub = qc <= 4 ? sc.mat[qc * 5 + min(tc, 4)] : 0;
      } else {
        sub = eq ? sc.match : ((qc >= 4 || tc >= 4) ? sc.n_score : x_cell);
      }

      const int32_t e_open = Hleft[j] + sc.go;
      int32_t En = min(Eleft[j], e_open) + sc.ge;
      const int32_t ebit = Eleft[j] <= e_open;
      const int32_t f_open = Hup[j] + sc.go;
      int32_t Fn = min(Fup[j], f_open) + sc.ge;
      const int32_t fbit = Fup[j] <= f_open;

      int32_t h = min(H2d[j], 0) + sub;
      int32_t src = H2d[j] > 0 ? kDiagStart : kDiag;
      int32_t v;
      v = Hup[j] + ins_cell;
      if (v < h) { h = v; src = kUp; }
      v = Hleft[j] + sc.del;
      if (v < h) { h = v; src = kLeft; }
      if (En < h) { h = En; src = kE; }
      if (Fn < h) { h = Fn; src = kF; }
      if (h >= 0) { h = 0; src = kStop; }

      const bool valid = qp < ql && tp >= tl && tp < th && tp >= 0;
      int32_t Hn = h;
      if (!valid) { Hn = En = Fn = kInf; src = kStop; }

      const int32_t R2 = RM2d[j] & 255, M2 = RM2d[j] >> 8;
      const int32_t mm = !eq;
      const bool is_diag = src == kDiag;
      const bool restart = R2 >= 63 || M2 >= 31;
      const int32_t Rn = is_diag ? (restart ? 1 : R2 + 1) : 0;
      const int32_t Mn = is_diag ? (restart ? mm : M2 + mm) : 0;
      const int32_t M_emit = src == kDiagStart ? mm : Mn;
      arow[w] = uint16_t(src | (ebit << 3) | (fbit << 4) | (Rn << 5) |
                         (M_emit << 11));

      if (Hn < lbest) { lbest = Hn; la = a; lw = w; }
      H2[j] = H1[j];
      H1[j] = Hn;
      E1[j] = En;
      F1[j] = Fn;
      RM2[j] = RM1[j];
      RM1[j] = Rn | (Mn << 8);
    }
    qo_prev = qo;
    s1_prev = s1;
  }

  // the first anti-diagonal reaching the minimum, then its first band cell
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const int32_t ob = __shfl_xor_sync(kFull, lbest, off);
    const int32_t oa = __shfl_xor_sync(kFull, la, off);
    const int32_t ow = __shfl_xor_sync(kFull, lw, off);
    if (ob < lbest || (ob == lbest && (oa < la || (oa == la && ow < lw)))) {
      lbest = ob;
      la = oa;
      lw = ow;
    }
  }
  if (lane == 0) {
    out_score[i] = lbest;
    out_a[i] = la;
    out_w[i] = lw;
  }
}

template <int C>
cudaError_t launch(cudaStream_t stream, const Scores& sc, int I, int L, int T,
                   int S, int per_item, const uint8_t* query,
                   const int32_t* qlen, const uint8_t* target,
                   const int32_t* tlo, const int32_t* thi, const int32_t* qoff,
                   const uint16_t* qual, int32_t* score, int32_t* best_a,
                   int32_t* best_w, uint16_t* arrows) {
  const size_t per_warp = smem_per_warp(L, T, sc.qmode);
  const int wpb = int(std::max<size_t>(
      1, std::min<size_t>(kMaxWarpsPerBlock, kMaxSmem / per_warp)));
  const size_t smem = per_warp * wpb;
  cudaError_t err = cudaFuncSetAttribute(
      banded_dp_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int grid = (I + wpb - 1) / wpb;
  banded_dp_kernel<C><<<grid, 32 * wpb, smem, stream>>>(
      query, qlen, target, tlo, thi, qoff, qual, sc, I, L, T, S, per_item,
      score, best_a, best_w, arrows);
  return cudaGetLastError();
}

ffi::Error BandedDpImpl(
    cudaStream_t stream, ffi::Buffer<ffi::U8> query,
    ffi::Buffer<ffi::S32> qlen, ffi::Buffer<ffi::U8> target,
    ffi::Buffer<ffi::S32> tlo, ffi::Buffer<ffi::S32> thi,
    ffi::Buffer<ffi::S32> qoff, ffi::Buffer<ffi::U16> qual, int32_t match,
    int32_t mismatch, int32_t n_score, int32_t insertion, int32_t deletion,
    int32_t affine_open, int32_t affine_extend, int32_t qmode,
    int32_t use_matrix, ffi::Span<const int32_t> matrix,
    ffi::ResultBuffer<ffi::S32> score, ffi::ResultBuffer<ffi::S32> best_a,
    ffi::ResultBuffer<ffi::S32> best_w,
    ffi::ResultBuffer<ffi::U16> arrows) {
  const auto qd = query.dimensions(), td = target.dimensions(),
             od = qoff.dimensions(), ad = arrows->dimensions();
  if (qd.size() != 2 || td.size() != 2 || od.size() != 2 || ad.size() != 3)
    return ffi::Error::InvalidArgument("banded_dp: bad operand ranks");
  const int I = int(qd[0]), L = int(qd[1]), T = int(td[1]), S = int(od[0]);
  const int W = int(ad[2]);
  if (S != L + T - 1 || ad[0] != S || ad[1] != I || td[0] != I)
    return ffi::Error::InvalidArgument("banded_dp: inconsistent shapes");
  if (od[1] != 1 && od[1] != I)
    return ffi::Error::InvalidArgument("banded_dp: qoff must be (S, 1) or (S, I)");
  if (matrix.size() != 25)
    return ffi::Error::InvalidArgument("banded_dp: matrix needs 25 entries");
  if (qmode != 0 && (qual.dimensions().size() != 2 ||
                     qual.dimensions()[0] != I || qual.dimensions()[1] != L))
    return ffi::Error::InvalidArgument("banded_dp: qual must be (I, L)");
  if (smem_per_warp(L, T, qmode) > kMaxSmem)
    return ffi::Error::InvalidArgument("banded_dp: item too long for shared memory");
  if (I == 0) return ffi::Error::Success();

  Scores sc;
  sc.match = match;
  sc.mismatch = mismatch;
  sc.n_score = n_score;
  sc.ins = insertion;
  sc.del = deletion;
  sc.go = affine_open;
  sc.ge = affine_extend;
  sc.qmode = qmode;
  sc.use_matrix = use_matrix;
  for (int k = 0; k < 25; ++k) sc.mat[k] = matrix[k];

  const int per_item = od[1] == I && I > 1;
  cudaError_t err;
  auto args = [&](auto kernel_launch) {
    return kernel_launch(stream, sc, I, L, T, S, per_item, query.typed_data(),
                         qlen.typed_data(), target.typed_data(),
                         tlo.typed_data(), thi.typed_data(), qoff.typed_data(),
                         qual.typed_data(), score->typed_data(),
                         best_a->typed_data(), best_w->typed_data(),
                         arrows->typed_data());
  };
  switch (W) {
    case 32: err = args(launch<1>); break;
    case 64: err = args(launch<2>); break;
    case 128: err = args(launch<4>); break;
    case 256: err = args(launch<8>); break;
    default:
      return ffi::Error::InvalidArgument("banded_dp: W must be 32, 64, 128 or 256");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("banded_dp: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    BandedDp, BandedDpImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::U8>>()   // query (I, L)
        .Arg<ffi::Buffer<ffi::S32>>()  // qlen (I,)
        .Arg<ffi::Buffer<ffi::U8>>()   // target (I, T)
        .Arg<ffi::Buffer<ffi::S32>>()  // tlo (I,)
        .Arg<ffi::Buffer<ffi::S32>>()  // thi (I,)
        .Arg<ffi::Buffer<ffi::S32>>()  // qoff (S, 1) shared or (S, I)
        .Arg<ffi::Buffer<ffi::U16>>()  // qual (I, L), or (1, 1) unused
        .Attr<int32_t>("match")
        .Attr<int32_t>("mismatch")
        .Attr<int32_t>("n_score")
        .Attr<int32_t>("insertion")
        .Attr<int32_t>("deletion")
        .Attr<int32_t>("affine_open")
        .Attr<int32_t>("affine_extend")
        .Attr<int32_t>("qmode")
        .Attr<int32_t>("use_matrix")
        .Attr<ffi::Span<const int32_t>>("matrix")
        .Ret<ffi::Buffer<ffi::S32>>()   // score (I,)
        .Ret<ffi::Buffer<ffi::S32>>()   // best_a (I,)
        .Ret<ffi::Buffer<ffi::S32>>()   // best_w (I,)
        .Ret<ffi::Buffer<ffi::U16>>()); // arrows (S, I, W)
