// The PSMNet convolutions' output geometry and fused epilogue, shared by
// conv3d.cu (the classifier's SIMT body), conv3d_tc.cu (the tensor-core
// convs) and cost_volume_tc.cu (the cost-volume conv), in their float32 and
// bf16 forms.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "bf16.cuh"

namespace conv {

// The epilogue is v * mul[o] + add[o], then + residual, then ReLU, in that
// order (psmnet.py:504-505: the residual joins before the ReLU), all in
// float32, then one store in T (bf16: rounded to nearest even). The
// residual is read in T. With round_first (the classifier's bf16 form),
// v * mul + add is rounded to T before the residual joins, and the sum is
// rounded again: the JAX package's classifier stores its conv in bf16 and
// adds the previous classifier's cost as a separate bf16 add
// (psmnet.py:976-989).
template <typename T>
struct OutT {
  T* out;  // (N, CO, D, H, W)
  const float* mul;
  const float* add;
  const T* res;  // (N, CO, D, H, W) or null
  int co, d, h, w, relu, round_first;
  __device__ __forceinline__ void store(int n, int o, int z, int y, int x, float v) const {
    const size_t idx = ((((size_t)n * co + o) * d + z) * h + y) * (size_t)w + x;
    v = v * __ldg(mul + o) + __ldg(add + o);
    if (res != nullptr) {
      if (round_first) v = elem_to_float(elem_from_float<T>(v));
      v += ldg_float(res + idx);
    }
    if (relu) v = fmaxf(v, 0.f);
    out[idx] = elem_from_float<T>(v);
  }
};

using Out = OutT<float>;

template <typename T = float>
inline OutT<T> make_out(void* out, const void* mul, const void* add, const void* res, int co,
                        int d, int h, int w, int relu, int round_first = 0) {
  return OutT<T>{static_cast<T*>(out), static_cast<const float*>(mul),
                 static_cast<const float*>(add), static_cast<const T*>(res), co, d, h, w, relu,
                 round_first};
}

// A grid of (row tiles x column tiles, d, n) blocks fits the launch limits.
inline bool grid_fits(int n, int d, int h, int w, int th, int tw) {
  const long long tiles = (long long)((h + th - 1) / th) * ((w + tw - 1) / tw);
  return n >= 1 && d >= 1 && h >= 1 && w >= 1 && n <= 65535 && d <= 65535 &&
         tiles <= 2147483647LL;
}

}  // namespace conv
