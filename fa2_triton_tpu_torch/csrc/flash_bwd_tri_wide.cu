// Head dims 384 and 512 of flash_bwd_tri.cu (B13 tri-square and diag),
// compiled apart from its head dims 64 / 128 / 256 so that the two sets of
// instantiations build in parallel (fa2_flash_bwd_tri calls
// fa2::launch_tri_wide for them). The kernels and their design are in
// flash_bwd_tri.cu; this unit compiles it with FA2_WIDE defined.
#define FA2_WIDE
#include "flash_bwd_tri.cu"
