// OASIS AR(1) spike deconvolution for NVIDIA Hopper (sm_90a), one thread
// per trace, with either of the JAX package's two stack machines.
//
// Replaces the Pallas TPU kernels `oasis_ar1_pallas`
// (calciumgan_tpu/ops/oasis_pallas.py:599-672; body `_oasis_kernel`
// :414-452) and `oasis_ar1_pallas_long` (:509-596; body
// `_oasis_kernel_long` :455-506), each with the classic machine
// (`_stack_machine` :150-274) or the precise one (`_stack_machine_precise`
// :277-392), and `_make_recon_step` (:395-411). It keeps their contract: the
// same (c, s, redo) for the same arguments, the same float32 merge decisions
// and the same redo bitmask, so the depth ladders and the float64 host redo
// of calciumgan_tpu_torch/ops/oasis.py drive it unchanged. Its plain PyTorch
// twin is calciumgan_tpu_torch/ops/oasis_torch.py.
//
// Design. The TPU kernels keep the top pool at row 0 of a (D, 128) VMEM
// stack and roll the whole stack by one row per push and per lane-masked
// merge, because Mosaic cannot index sublanes per lane. Here each thread
// owns one trace and keeps a stack pointer in a register: the stack is a
// ring of D slots in a (D, B) scratch plane per field (row r of trace b at
// r*B + b), and a push or merge moves the pointer instead of the data.
// Pallas row i is ring slot (top - i) mod D, so even a trace whose stack
// overflowed sees the same pools. Per timestep: push yy[t] as a singleton
// pool, then at most K merge attempts while the top pool violates the
// constraint against its neighbour (and n >= 2); a violation left after K
// attempts sets bit 1, a stack deeper than D sets bit 0, and a decision
// within the band flag_tol sets bit 2. An attempt that finds no violation
// ends the step: the attempts left would repeat it unchanged. The
// reconstruction walks the thread's pools forward from the bottom of the
// stack: h = max(v/w, 0), c[t] = h*g^k, s[t] = c[t] - g*c[t-1], s[0] = 0.
//
// The classic machine decides v0/w0 < g^l1 * v1/w1 + s_min with v and w
// accumulated in float32. The precise machine carries v as a double-single
// pair (TwoProduct by Veltkamp splits, TwoSum) whose compensation term is
// stored in bfloat16, rounded to nearest even as Pallas stores it; it never
// stores w but evaluates w(l) = -expm1(2 l ln g)/(1 - g^2) from the exact
// length, takes g^l from a 12-bit split of ln g, and decides without a
// division: F = v0*w1 - w0*(g^l1*v1 + s_min*w1) < 0. Its constants and
// evaluation order are the JAX package's, so that every rounding is the
// same; w0 is 1 exactly for the pool just pushed, where Pallas drops the
// factor (multiplying by 1 is exact, so one form serves every attempt).
// Built with -fmad=false so that no multiply-add is contracted: the
// compensated sums are exact only if every product and sum rounds alone,
// and every rounding is then that of the plain PyTorch twin's separate ops.
//
// The time-chunked TPU kernel walks 2048-frame chunks only because a whole
// (T, 128) window does not fit in VMEM; here a thread walks its whole trace
// and its stacks stay in device memory, so one kernel serves any T.
//
// What bounds it on this card. Per frame a trace reads 4 B (fluorescence)
// and writes 8 B (c, s), time-major so that a warp's access is coalesced;
// the stack traffic is a few scattered accesses per merge attempt that stay
// mostly in the 50 MB L2. Bandwidth is not the limit: the serial chain of
// each timestep is (classic: expf, two divisions; precise: three to five
// expf, about 60 dependent float32 operations, dependent stack loads), and
// the number of warps in flight that hide its latency, i.e. occupancy. A
// 102-neuron recording is one block on one SM. Faster designs (stacks in
// shared memory or registers, several traces' work per SM, float64 pools
// instead of the band, no merge budget) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

struct Params {
  int T, B, D;
  float g, log_g, s_min;
  int K;
  float flag_tol;
  // precise machine only (oasis_pallas.py:288-290, computed on the host)
  float lng_hi, lng_lo, inv_1mg2;
};

// ---- precise-machine arithmetic (oasis_pallas.py:94-141, :292-304) ----

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

__device__ __forceinline__ void fast_two_sum(float a, float b, float& s,
                                             float& e) {
  s = a + b;
  e = b - (s - a);
}

__device__ __forceinline__ void veltkamp_split(float a, float& hi,
                                               float& lo) {
  const float c = a * 4097.0f;  // 2^12 + 1
  hi = c - (c - a);
  lo = a - hi;
}

__device__ __forceinline__ void two_product(float a, float b, float& p,
                                            float& e) {
  p = a * b;
  float ah, al, bh, bl;
  veltkamp_split(a, ah, al);
  veltkamp_split(b, bh, bl);
  e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl;
}

// float32(1/6): the cubic's coefficient
__device__ __forceinline__ float poly_expm1_small(float u) {
  return u * (1.0f + u * (0.5f + u * 0x1.555556p-3f));
}

// expm1(x_hi + x_lo) for x <= 0: Taylor to degree 10 above -0.5, exp - 1
// below; coefficients float32(1/k!), k = 2..9
__device__ __forceinline__ float expm1_neg(float x_hi, float x_lo) {
  const float x = x_hi + x_lo;
  const float t = x * (1.0f + x * (0.5f + x * (0x1.555556p-3f + x * (
      0x1.555556p-5f + x * (0x1.111112p-7f + x * (0x1.6c16c2p-10f + x * (
          0x1.a01a02p-13f + x * (0x1.a01a02p-16f + x * 0x1.71de3ap-19f))))))));
  const float e = expf(x_hi) * (1.0f + poly_expm1_small(x_lo));
  return (x > -0.5f) ? t : e - 1.0f;
}

// g^l, the exp argument exact for integer l <= 4096
__device__ __forceinline__ float gl_of(float l, const Params& p) {
  return expf(l * p.lng_hi) * (1.0f + poly_expm1_small(l * p.lng_lo));
}

// w(l) = (1 - g^(2l)) / (1 - g^2); w(1) == 1 exactly
__device__ __forceinline__ float w_of(float l, const Params& p) {
  if (l == 1.0f) return 1.0f;
  const float m = expm1_neg((2.0f * l) * p.lng_hi, (2.0f * l) * p.lng_lo);
  return -m * p.inv_1mg2;
}

// yy, c, s: (T, B) time-major; stacks: three (D, B) planes: v, then w
// (classic) or the bfloat16 v compensation in the plane's first half
// (precise), then the lengths.
template <bool Precise>
__global__ void oasis_ar1_kernel(const float* __restrict__ yy,
                                 float* __restrict__ c,
                                 float* __restrict__ s,
                                 int* __restrict__ redo,
                                 float* __restrict__ stacks, Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int T = p.T, D = p.D, K = p.K;
  const size_t stride = (size_t)p.B;
  const size_t plane = (size_t)D * stride;
  float* v = stacks + b;
  float* w = stacks + plane + b;
  __nv_bfloat16* ve = reinterpret_cast<__nv_bfloat16*>(stacks + plane) + b;
  float* l = stacks + 2 * plane + b;

  int top = D - 1;  // the first push lands in slot 0
  int n = 0;        // pools on the stack (may exceed D: bit 0)
  int bits = 0;
  for (int t = 0; t < T; ++t) {
    top = (top + 1 == D) ? 0 : top + 1;
    v[top * stride] = yy[(size_t)t * stride + b];
    if constexpr (Precise) {
      ve[top * stride] = __float2bfloat16_rn(0.0f);
    } else {
      w[top * stride] = 1.0f;
    }
    l[top * stride] = 1.0f;
    ++n;
    if (n > D) bits |= 1;
    // attempts 0..K-1 merge; attempt K only checks what is left
    for (int k = 0; k <= K; ++k) {
      const int below = (top == 0) ? D - 1 : top - 1;
      const bool active = n >= 2;
      bool viol, bord;
      if constexpr (Precise) {
        const float v0h = v[top * stride];
        const float v0e = __bfloat162float(ve[top * stride]);
        const float v1h = v[below * stride];
        const float v1e = __bfloat162float(ve[below * stride]);
        const float l0 = l[top * stride], l1 = l[below * stride];
        const float gl = gl_of(l1, p);
        const float w1 = w_of(l1, p);
        const float R = (gl * v1h + gl * v1e) + p.s_min * w1;
        const float v0w1 = v0h * w1 + v0e * w1;
        const float w0 = w_of(l0, p);
        const float F = v0w1 - w0 * R;
        viol = active && F < 0.0f;
        bord = active && fabsf(F) < p.flag_tol * (w0 * (w1 + fabsf(R)));
        if (viol && k < K) {
          // compensated merge mv = v1 + gl*v0
          float pr, pe, sm, se, mvh, mve;
          two_product(gl, v0h, pr, pe);
          two_sum(v1h, pr, sm, se);
          mve = ((se + pe) + gl * v0e) + v1e;
          fast_two_sum(sm, mve, mvh, mve);
          v[below * stride] = mvh;
          ve[below * stride] = __float2bfloat16_rn(mve);
          l[below * stride] = l1 + l0;
        }
      } else {
        const float v0 = v[top * stride], w0 = w[top * stride];
        const float v1 = v[below * stride], w1 = w[below * stride];
        const float l1 = l[below * stride];
        const float gl = expf(l1 * p.log_g);
        const float lhs = v0 / w0;
        const float rhs = gl * (v1 / w1) + p.s_min;
        viol = active && lhs < rhs;
        bord = active && fabsf(lhs - rhs) < p.flag_tol * (1.0f + fabsf(rhs));
        if (viol && k < K) {
          v[below * stride] = v1 + gl * v0;
          w[below * stride] = w1 + gl * gl * w0;
          l[below * stride] = l1 + l[top * stride];
        }
      }
      if (p.flag_tol > 0.0f && bord) bits |= 4;
      if (!viol) break;
      if (k == K) {
        bits |= 2;
        break;
      }
      top = below;
      --n;
    }
  }

  // pool heights h = max(v/w, 0)
  auto height = [&](int pos) -> float {
    if constexpr (Precise) {
      return fmaxf((v[pos * stride] + __bfloat162float(ve[pos * stride])) /
                       w_of(l[pos * stride], p),
                   0.0f);
    } else {
      return fmaxf(v[pos * stride] / w[pos * stride], 0.0f);
    }
  };
  const int pools = n < D ? n : D;
  int pos = top - (pools - 1);
  if (pos < 0) pos += D;
  float h = height(pos);
  float len = l[pos * stride];
  float k = 0.0f;
  float c_prev = 0.0f;
  for (int t = 0; t < T; ++t) {
    if (k >= len) {
      pos = (pos + 1 == D) ? 0 : pos + 1;
      h = height(pos);
      len = l[pos * stride];
      k = 0.0f;
    }
    const float ct = h * expf(k * p.log_g);
    c[(size_t)t * stride + b] = ct;
    s[(size_t)t * stride + b] = (t == 0) ? 0.0f : ct - p.g * c_prev;
    c_prev = ct;
    k += 1.0f;
  }
  redo[b] = bits;
}

template <bool Precise>
int launch(const float* yy, float* c, float* s, int* redo, float* stacks,
           const Params& p, void* stream) {
  const int threads = 128;
  const int blocks = (p.B + threads - 1) / threads;
  oasis_ar1_kernel<Precise><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      yy, c, s, redo, stacks, p);
  return (int)cudaGetLastError();
}

}  // namespace

// yy, c, s: (T, B) float32, time-major; redo: (B,) int32; stacks: (3, D, B)
// float32 scratch. Launch on `stream` and return cudaGetLastError() (0 on
// success); neither synchronises.

// The classic machine.
extern "C" int oasis_ar1_launch(const float* yy, float* c, float* s,
                                int* redo, float* stacks, int T, int B,
                                int D, float g, float log_g, float s_min,
                                int K, float flag_tol, void* stream) {
  const Params p{T, B, D, g, log_g, s_min, K, flag_tol, 0.0f, 0.0f, 0.0f};
  return launch<false>(yy, c, s, redo, stacks, p, stream);
}

// The precise machine; lng_hi, lng_lo: 12-bit split of log(g); inv_1mg2:
// float32(1 / (1 - g^2)).
extern "C" int oasis_ar1_precise_launch(const float* yy, float* c, float* s,
                                        int* redo, float* stacks, int T,
                                        int B, int D, float g, float log_g,
                                        float s_min, int K, float flag_tol,
                                        float lng_hi, float lng_lo,
                                        float inv_1mg2, void* stream) {
  const Params p{T, B, D, g, log_g, s_min, K, flag_tol, lng_hi, lng_lo,
                 inv_1mg2};
  return launch<true>(yy, c, s, redo, stacks, p, stream);
}
