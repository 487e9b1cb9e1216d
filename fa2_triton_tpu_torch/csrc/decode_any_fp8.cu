// Decode attention past head dim 512 over an fp8 (e4m3) KV cache (B5 quant,
// B6 quant), compiled apart from the other cache kinds so that they build in
// parallel. The kernel and its design are in decode_any.cuh.
#include "decode_any.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_fp8_any(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                        cudaStream_t s) {
  return run_any<__nv_fp8_e4m3>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2
