// Decode attention over an int8 KV cache at head dims 384 and 512 (B5
// quant, B6 quant), compiled apart from decode_int8.cu's head dims. The
// kernel and its design are in decode.cuh.
#include "decode.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_int8_wide(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                          cudaStream_t s) {
  return run<int8_t, true>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2
