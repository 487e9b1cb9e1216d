// Decode attention over an fp8 (e4m3) KV cache with per-(row, head) fp32
// scales (B5 quant, B6 quant). The kernel and its design are in decode.cuh.
#include "decode.cuh"

namespace fa2 {
namespace dec {

cudaError_t run_fp8(int dtype, const DecParams& p, int B, int n_chunks, int D, int G,
                    cudaStream_t s) {
  return run<__nv_fp8_e4m3>(dtype, p, B, n_chunks, D, G, s);
}

}  // namespace dec
}  // namespace fa2
