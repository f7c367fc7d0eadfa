// Kernels 1 and 2 for RBF, symmetric path (one point set)
// (matvec_kernels.cuh).

#include "matvec_kernels.cuh"

template int cglb::run_family<cglb::RBF, true>(
    const cglb::Args&, int, int, cglb::Op);
