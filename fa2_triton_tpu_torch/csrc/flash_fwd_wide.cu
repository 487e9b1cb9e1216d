// The forward kernels of flash_fwd.cu at head dims 384 and 512, compiled
// apart from its head dims 64 / 128 / 256 so that the two sets of
// instantiations build in parallel (flash_fwd.cu's entry points call
// fa2::launch_fwd_wide for them). The kernels and their design are in
// flash_fwd.cu; this unit compiles it with FA2_WIDE defined.
#define FA2_WIDE
#include "flash_fwd.cu"
