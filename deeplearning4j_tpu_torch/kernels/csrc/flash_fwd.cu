// The float32 kernels of flash_fwd.cuh (the bfloat16 ones are in
// flash_fwd_bf16.cu): each dtype builds as a library of its own, so the
// two compile in parallel (kernels/_build.py starts one nvcc per
// source).
#include "flash_fwd.cuh"

// q, o: (BH, Tq, D); k, v: (BH, Tk, D), all contiguous float32, D one of
// 16, 32, 64, 128 or a multiple of 128; kv_mask: (B, Tk) bytes or null;
// lse: (BH, Tq) f32. Launches on `stream` and returns cudaGetLastError().
extern "C" int dl4j_flash_fwd(const void* q, const void* k, const void* v,
    const void* kv_mask, void* o, void* lse, int dtype, int BH, int H, int Tq,
    int Tk, int D, int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype != dl4j::kFloat32) return cudaErrorInvalidValue;
  return dl4j::launch<float>(q, k, v, static_cast<const uint8_t*>(kv_mask),
                          o, static_cast<float*>(lse), BH, H, Tq, Tk, D,
                          causal, scale, device,
                          static_cast<cudaStream_t>(stream));
}
