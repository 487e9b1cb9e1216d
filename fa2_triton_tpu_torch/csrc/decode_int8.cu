// Decode attention over an int8 KV cache with per-(row, head) fp32 scales
// (B5 quant, B6 quant). The kernel and its design are in decode.cuh.
#include "decode.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_int8(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                     cudaStream_t s) {
  return run<int8_t, false>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2
