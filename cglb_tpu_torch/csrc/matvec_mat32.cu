// Kernels 1 and 2 for Matern32, general path
// (matvec_kernels.cuh).

#include "matvec_kernels.cuh"

template int cglb::run_family<cglb::MAT32, false>(
    const cglb::Args&, int, int, cglb::Op);
