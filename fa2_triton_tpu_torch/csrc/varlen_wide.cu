// The packed forward, dq and dk/dv kernels of varlen.cu (B7, B8) at head
// dims 384 and 512, compiled apart from its head dims 64 / 128 / 256 so
// that the two sets of instantiations build in parallel (fa2_varlen calls
// fa2::launch_varlen_wide for them). The kernels and their design are in
// varlen.cu; this unit compiles it with FA2_WIDE defined.
#define FA2_WIDE
#include "varlen.cu"
