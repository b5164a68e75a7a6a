// The bfloat16 kernels of flash_bwd_dkv.cuh (the float32 ones are in
// flash_bwd_dkv.cu): each dtype builds as a library of its own, so the
// two compile in parallel (kernels/_build.py starts one nvcc per
// source).
#include "flash_bwd_dkv.cuh"

// q, dout: (BH, Tq, D); k, v, dk, dv: (BH, Tk, D), all contiguous bfloat16,
// D one of 16, 32, 64, 128 or a multiple of 128; lse, delta: (BH, Tq) f32;
// kv_mask: (B, Tk) bytes or null. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int dl4j_flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* kv_mask,
    void* dk, void* dv, int dtype, int BH, int H, int Tq, int Tk, int D,
    int causal, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (dtype != dl4j::kBFloat16) return cudaErrorInvalidValue;
  return dl4j::launch<__nv_bfloat16>(
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(kv_mask),
      dk, dv, BH, H, Tq, Tk, D, causal, scale, device,
      static_cast<cudaStream_t>(stream));
}
