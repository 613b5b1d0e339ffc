// The double instances of csrc/plt.cu: the same templates compiled with
// zt_real = double, their C entry point named zt_plt_coefs_f64 (real.cuh).
// A file of its own, so that its nvcc runs beside the float file's.
#define ZT_F64
#include "plt.cu"
