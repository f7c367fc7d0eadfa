// Interface of kernels 1 and 2 between their C entry points (matvec.cu) and
// their instantiations (matvec_kernels.cuh, compiled once per family and
// path in matvec_<family>.cu and matvec_<family>_sym.cu, and the wide
// kernels of matvec_wide.cuh, once per family in matvec_wide_<family>.cu, so
// that nvcc builds the six in parallel).
#pragma once

#include "common.cuh"

namespace cglb {

enum Op { kMatvec, kLsGrad, kGeometry };

struct Args {
  const float* xr;
  int ni;
  const float* xc;
  int nj;
  const float* xs;  // kernel 2, wide: xc less each column block's first point
  const float* p;
  int ldp;
  const float* g;
  int ldg;
  int seg_rows;
  int segments;
  int row_end;     // rows the segments cover: [0, row_end), row_end <= ni
  int col_block0;  // kernel 1: the launch's first column block
  int ldo;         // kernel 1: columns of out from column block col_block0
  void* out;
  float* row_out;  // kernel 1, symmetric: [launch's blocks, b, row_end]
  bool accurate;
  bool ls_grad;
  bool symmetric;
  cudaStream_t stream;
  int* geometry;  // kGeometry: {block columns, stage rows, blocks per SM}
};

// kernels 1 and 2 of family FAM on the symmetric (SYM) or general path,
// for coordinate width dp in {8, 12, 32} and batch b in {1, 2, 4, 8}
template <int FAM, bool SYM>
int run_family(const Args& a, int dp, int b, Op op);

// the wide kernels 1 and 2 (matvec_wide.cuh) on the symmetric or general
// path, for a coordinate width dp > 32 that is a multiple of 8, batch b as
// above
template <int FAM>
int run_wide(const Args& a, int dp, int b, Op op);

}  // namespace cglb
