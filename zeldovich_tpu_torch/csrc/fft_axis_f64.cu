// The double instances of csrc/fft_axis.cu: the same templates compiled with
// zt_real = double, their C entry points named *_f64 (real.cuh).  A file
// of its own, so that its nvcc runs beside the float file's.
#define ZT_F64
#include "fft_axis.cu"
