// The wide kernels 1 and 2 for RBF, both paths (matvec_wide.cuh).

#include "matvec_wide.cuh"

template int cglb::run_wide<cglb::RBF>(const cglb::Args&, int, int, cglb::Op);
