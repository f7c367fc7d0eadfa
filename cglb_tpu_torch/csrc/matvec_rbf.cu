// Kernels 1 and 2 for RBF, general path
// (matvec_kernels.cuh).

#include "matvec_kernels.cuh"

template int cglb::run_family<cglb::RBF, false>(
    const cglb::Args&, int, int, cglb::Op);
