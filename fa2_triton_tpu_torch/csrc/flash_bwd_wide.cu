// The dq, dk/dv and dbias kernels of flash_bwd.cu at head dims 384 and 512,
// compiled apart from its head dims 64 / 128 / 256 so that the two sets of
// instantiations build in parallel (fa2_flash_bwd calls
// fa2::launch_bwd_wide for them). The kernels and their design are in
// flash_bwd.cu; this unit compiles it with FA2_WIDE defined.
#define FA2_WIDE
#include "flash_bwd.cu"
