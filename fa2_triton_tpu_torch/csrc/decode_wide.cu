// Decode attention over a cache stored in the compute type at head dims 384
// and 512 (B5 no-quant, B6 no-quant), compiled apart from decode.cu's head
// dims so that the two build in parallel. The kernel and its design are in
// decode.cuh.
#include "decode.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_dense_wide(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                           cudaStream_t s) {
  return run<void, true>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2
