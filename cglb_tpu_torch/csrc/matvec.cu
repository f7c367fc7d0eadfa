// C entry points of the streaming kernel matvec (kernel 1) and its
// lengthscale gradient (kernel 2), bound with ctypes by ops/_build.py.  The
// kernels and what they replace are described in matvec_kernels.cuh; a
// coordinate width dp above 32 goes to the wide kernels of matvec_wide.cuh,
// which take both paths with the same arguments.

#include <climits>

#include "matvec.cuh"

namespace cglb {
namespace {

int dispatch(const Args& a, int family, int dp, int b, Op op) {
  if (dp > 32) {
    switch (family) {
      case RBF: return run_wide<RBF>(a, dp, b, op);
      case MAT32: return run_wide<MAT32>(a, dp, b, op);
      default: return kBadArgument;
    }
  }
  switch (family) {
    case RBF:
      return a.symmetric ? run_family<RBF, true>(a, dp, b, op)
                         : run_family<RBF, false>(a, dp, b, op);
    case MAT32:
      return a.symmetric ? run_family<MAT32, true>(a, dp, b, op)
                         : run_family<MAT32, false>(a, dp, b, op);
    default: return kBadArgument;
  }
}

bool bad_sizes(long long ni, long long nj, long long ldp, long long ldg) {
  return ni <= 0 || nj <= 0 || ni > INT_MAX || nj > INT_MAX ||
         ldp > INT_MAX || ldg > INT_MAX;
}

}  // namespace
}  // namespace cglb

extern "C" {

// geo[3] = {columns per block, rows per staged tile, resident blocks per SM}
// of the kernel that cglb_ls_grad (ls_grad != 0) or cglb_matvec with this
// tier and symmetry launches for these template arguments
int cglb_matvec_geometry(int family, int dp, int b, int accurate, int ls_grad,
                         int symmetric, int* geo) {
  cglb::Args a{};
  a.accurate = accurate != 0;
  a.ls_grad = ls_grad != 0;
  a.symmetric = symmetric != 0;
  a.geometry = geo;
  return cglb::dispatch(a, family, dp, b, cglb::kGeometry);
}

// The launch takes the columns [col_block0 * block columns, + ldo) of xc
// and the rows [0, row_end) of xr.  out [segments, b, ldo] (double when
// accurate, else float): segment s holds p [b, rows s*seg_rows ...] @
// rho(xr rows, xc columns); p is [b, ldp], zero past ni.  With row_out
// (symmetric: xr == xc), the segments hold the pairs i < c1 of each column
// block only and row_out [the launch's column blocks, b, row_end] fp32 the
// row side, every row of it written.  The general path takes all of xc and
// xr in one launch (col_block0 = 0, ldo = nj, row_end = ni); the symmetric
// one may take its column blocks in slabs, row_end then being the end of
// the slab's last block.
int cglb_matvec(const float* xr, long long ni, const float* xc, long long nj,
                const float* p, long long ldp, int b, int dp, int family,
                int accurate, int seg_rows, int segments, long long row_end,
                int col_block0, long long ldo, void* out, float* row_out,
                void* stream) {
  if (cglb::bad_sizes(ni, nj, ldp, 0) || row_end <= 0 || row_end > ni ||
      ldo <= 0 || ldo > nj || col_block0 < 0)
    return cglb::kBadArgument;
  cglb::Args a{};
  a.xr = xr;
  a.ni = static_cast<int>(ni);
  a.xc = xc;
  a.nj = static_cast<int>(nj);
  a.p = p;
  a.ldp = static_cast<int>(ldp);
  a.seg_rows = seg_rows;
  a.segments = segments;
  a.row_end = static_cast<int>(row_end);
  a.col_block0 = col_block0;
  a.ldo = static_cast<int>(ldo);
  a.out = out;
  a.row_out = row_out;
  a.accurate = accurate != 0;
  a.symmetric = row_out != nullptr;
  a.stream = static_cast<cudaStream_t>(stream);
  return cglb::dispatch(a, family, dp, b, cglb::kMatvec);
}

// partial [segments * ceil(nj / block columns), dp] fp64, block
// (segment s, column block c) in row s * (column blocks) + c; g is [b, ldg]
// (symmetric: xr == xc, and ldg a multiple of 4 with g zero past nj).  xs:
// above dp 32, xc with each column block's first point subtracted from its
// columns (the wide kernel's moment pass reads it); unread below.
int cglb_ls_grad(const float* xr, long long ni, const float* xc, long long nj,
                 const float* xs, const float* p, long long ldp,
                 const float* g, long long ldg, int b, int dp, int family,
                 int symmetric, int seg_rows, int segments, double* partial,
                 void* stream) {
  if (cglb::bad_sizes(ni, nj, ldp, ldg) || (dp > 32 && xs == nullptr))
    return cglb::kBadArgument;
  cglb::Args a{};
  a.xr = xr;
  a.ni = static_cast<int>(ni);
  a.xc = xc;
  a.nj = static_cast<int>(nj);
  a.xs = xs;
  a.p = p;
  a.ldp = static_cast<int>(ldp);
  a.g = g;
  a.ldg = static_cast<int>(ldg);
  a.seg_rows = seg_rows;
  a.segments = segments;
  a.row_end = a.ni;
  a.out = partial;
  a.accurate = true;
  a.ls_grad = true;
  a.symmetric = symmetric != 0;
  a.stream = static_cast<cudaStream_t>(stream);
  return cglb::dispatch(a, family, dp, b, cglb::kLsGrad);
}

}  // extern "C"
