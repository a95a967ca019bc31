// A host stand-in for the part of cuda_bf16.h that the port's kernels run
// on the CPU in the tests use (csrc/instance_norm.cu): the bf16 storage
// types and their conversions, round to nearest even as the card's
// __float2bfloat16 and torch's .to(torch.bfloat16).
#pragma once
#include <cstdint>
#include <cstring>

#include "cuda_runtime.h"

struct alignas(2) __nv_bfloat16 {
  std::uint16_t bits;
};
struct alignas(4) __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const std::uint32_t u = std::uint32_t(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u)  // NaN: keep it a quiet NaN
    return {std::uint16_t((u >> 16) | 0x40u)};
  u += 0x7FFFu + ((u >> 16) & 1u);
  return {std::uint16_t(u >> 16)};
}

inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return make_float2(__bfloat162float(h.x), __bfloat162float(h.y));
}

inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}
