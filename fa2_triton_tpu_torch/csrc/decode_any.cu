// Decode attention past head dim 512 over a cache stored in the compute type
// (B5 no-quant, B6 no-quant), compiled apart from the other cache kinds so
// that they build in parallel. The kernel and its design are in
// decode_any.cuh.
#include "decode_any.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_dense_any(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                          cudaStream_t s) {
  return run_any<void>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2
