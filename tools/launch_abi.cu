// K9 (gather_rows) behind a typed C entry, beside the packed one the port
// ships, for an A/B of the launch ABI (chip_smoke.gather_rows_host_split).
//
// The port's entries take a block of int64 slots and the stream
// (csrc/nr_entry.cuh): ctypes converts two arguments per launch.  The typed
// entry here is the form they replaced: one C argument per kernel argument,
// each converted by ctypes through argtypes, the stream last.  Both launch
// the same kernel through the same host function; only the ABI differs.
//
// Build (chip_smoke.tool_library does this): nvcc <the port's NVCC_FLAGS>
//   -I neural_renderer_v2_pytorch_tpu_torch/csrc -shared tools/launch_abi.cu

#include "gather_rows.cu"

extern "C" int nr_typed_gather_rows(const float* table, const int* ids, float* out, int bs,
                                    int n, int D, int P, long long ids_bstride, int planar,
                                    void* stream) {
  return gather_rows(stream, table, ids, out, bs, n, D, P, ids_bstride, planar);
}
