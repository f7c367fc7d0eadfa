// The wide kernels 1 and 2 for Matern32, both paths (matvec_wide.cuh).

#include "matvec_wide.cuh"

template int cglb::run_wide<cglb::MAT32>(const cglb::Args&, int, int,
                                         cglb::Op);
