// OASIS AR(1) spike deconvolution for NVIDIA Hopper (sm_90a), one thread
// per trace.
//
// Replaces the Pallas TPU kernel `oasis_ar1_pallas`
// (calciumgan_tpu/ops/oasis_pallas.py:599-672; body `_oasis_kernel`
// :414-452, `_stack_machine` :150-274, `_make_recon_step` :395-411) and
// keeps its contract: the same (c, s, redo) for the same arguments, the same
// float32 merge decisions and the same redo bitmask, so the depth ladder and
// the float64 host redo of calciumgan_tpu_torch/ops/oasis.py drive it
// unchanged. Its plain PyTorch twin is calciumgan_tpu_torch/ops/oasis_torch.py.
//
// Design. The TPU kernel keeps the top pool at row 0 of a (D, 128) VMEM
// stack and rolls the whole stack by one row per push and per lane-masked
// merge, because Mosaic cannot index sublanes per lane. Here each thread
// owns one trace and keeps a stack pointer in a register: the stack is a
// ring of D slots in a (D, B) scratch (row r of trace b at r*B + b), and a
// push or merge moves the pointer instead of the data. Pallas row i is ring
// slot (top - i) mod D, so even a trace whose stack overflowed sees the same
// pools. Per timestep: push yy[t] as a singleton pool, then at most K merge
// attempts while v0/w0 < g^l1 * v1/w1 + s_min (and n >= 2), with the Pallas
// kernel's f32 arithmetic (expf of l1*log(g), two divisions); a violation
// left after K attempts sets bit 1, a stack deeper than D sets bit 0, and a
// decision within flag_tol*(1+|rhs|) sets bit 2. An attempt that finds no
// violation ends the step: the attempts left would repeat it unchanged.
// Reconstruction walks the thread's pools forward from the bottom of the
// stack: h = max(v/w, 0), c[t] = h*g^k, s[t] = c[t] - g*c[t-1], s[0] = 0.
// Built with -fmad=false so that no multiply-add is contracted and every
// product and sum rounds as in the plain PyTorch version.
//
// What bounds it on this card. Per frame a trace reads 4 B (fluorescence)
// and writes 8 B (c, s), time-major so that a warp's access is coalesced;
// the stack traffic is a few scattered 4 B accesses per merge attempt that
// stay mostly in the 50 MB L2. Bandwidth is not the limit: the serial chain
// of each timestep (expf, two divisions, compare, dependent stack loads)
// is, and the number of warps in flight that hide its latency, i.e.
// occupancy. Faster designs (stacks in shared memory or registers, float64
// pools instead of the band, no merge budget) are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void oasis_ar1_kernel(const float* __restrict__ yy,
                                 float* __restrict__ c,
                                 float* __restrict__ s,
                                 int* __restrict__ redo,
                                 float* __restrict__ vs,
                                 float* __restrict__ ws,
                                 float* __restrict__ ls,
                                 int T, int B, int D, float g, float log_g,
                                 float s_min, int K, float flag_tol) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t stride = (size_t)B;
  float* v = vs + b;
  float* w = ws + b;
  float* l = ls + b;

  int top = D - 1;  // the first push lands in slot 0
  int n = 0;        // pools on the stack (may exceed D: bit 0)
  int bits = 0;
  for (int t = 0; t < T; ++t) {
    top = (top + 1 == D) ? 0 : top + 1;
    v[top * stride] = yy[(size_t)t * stride + b];
    w[top * stride] = 1.0f;
    l[top * stride] = 1.0f;
    ++n;
    if (n > D) bits |= 1;
    // attempts 0..K-1 merge; attempt K only checks what is left
    for (int k = 0; k <= K; ++k) {
      const int below = (top == 0) ? D - 1 : top - 1;
      const float v0 = v[top * stride], w0 = w[top * stride];
      const float v1 = v[below * stride], w1 = w[below * stride];
      const float l1 = l[below * stride];
      const float gl = expf(l1 * log_g);
      const float lhs = v0 / w0;
      const float rhs = gl * (v1 / w1) + s_min;
      const bool active = n >= 2;
      if (flag_tol > 0.0f && active &&
          fabsf(lhs - rhs) < flag_tol * (1.0f + fabsf(rhs))) {
        bits |= 4;
      }
      if (!(active && lhs < rhs)) break;
      if (k == K) {
        bits |= 2;
        break;
      }
      v[below * stride] = v1 + gl * v0;
      w[below * stride] = w1 + gl * gl * w0;
      l[below * stride] = l1 + l[top * stride];
      top = below;
      --n;
    }
  }

  const int pools = n < D ? n : D;
  int pos = top - (pools - 1);
  if (pos < 0) pos += D;
  float h = fmaxf(v[pos * stride] / w[pos * stride], 0.0f);
  float len = l[pos * stride];
  float k = 0.0f;
  float c_prev = 0.0f;
  for (int t = 0; t < T; ++t) {
    if (k >= len) {
      pos = (pos + 1 == D) ? 0 : pos + 1;
      h = fmaxf(v[pos * stride] / w[pos * stride], 0.0f);
      len = l[pos * stride];
      k = 0.0f;
    }
    const float ct = h * expf(k * log_g);
    c[(size_t)t * stride + b] = ct;
    s[(size_t)t * stride + b] = (t == 0) ? 0.0f : ct - g * c_prev;
    c_prev = ct;
    k += 1.0f;
  }
  redo[b] = bits;
}

}  // namespace

// yy, c, s: (T, B) float32, time-major; redo: (B,) int32; stacks: (3, D, B)
// float32 scratch (v, w, lengths). Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int oasis_ar1_launch(const float* yy, float* c, float* s,
                                int* redo, float* stacks, int T, int B,
                                int D, float g, float log_g, float s_min,
                                int K, float flag_tol, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const size_t plane = (size_t)D * (size_t)B;
  oasis_ar1_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      yy, c, s, redo, stacks, stacks + plane, stacks + 2 * plane, T, B, D,
      g, log_g, s_min, K, flag_tol);
  return (int)cudaGetLastError();
}
