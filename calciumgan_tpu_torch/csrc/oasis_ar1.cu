// OASIS AR(1) spike deconvolution for NVIDIA Hopper (sm_90a), one thread
// per trace, with either of the JAX package's two stack machines.
//
// Replaces the Pallas TPU kernels `oasis_ar1_pallas`
// (calciumgan_tpu/ops/oasis_pallas.py:603-672; body `_oasis_kernel`
// :414-452) and `oasis_ar1_pallas_long` (:513-596; body
// `_oasis_kernel_long` :455-506), each with the classic machine
// (`_stack_machine` :150-274) or the precise one (`_stack_machine_precise`
// :277-392), and `_make_recon_step` (:395-411). It keeps their contract: the
// same (c, s, redo) for the same arguments, the same float32 merge decisions
// and the same redo bitmask, so the depth ladders and the float64 host redo
// of calciumgan_tpu_torch/ops/oasis.py drive it unchanged. Its plain PyTorch
// twin is calciumgan_tpu_torch/ops/oasis_torch.py; the kernel equals it bit
// for bit on every lane, overflowed lanes included.
//
// The algorithm. The TPU kernels keep the top pool at row 0 of a (D, 128)
// VMEM stack and roll the whole stack by one row per push and per
// lane-masked merge, because Mosaic cannot index sublanes per lane. Here
// each thread owns one trace and a ring of D pool slots with a top index:
// Pallas row i is ring slot (top - i) mod D, so even a trace whose stack
// overflowed sees the same pools. Per timestep: push yy[t] as a singleton
// pool, then at most K merge attempts while the top pool violates the
// constraint against its neighbour (and n >= 2); a violation left after K
// attempts sets bit 1, a stack deeper than D sets bit 0, and a decision
// within the band flag_tol sets bit 2. An attempt that finds no violation
// ends the step: the attempts left would repeat it unchanged. The
// reconstruction walks the pools forward from the bottom of the stack:
// h = max(v/w, 0), c[t] = h*g^k, s[t] = c[t] - g*c[t-1], s[0] = 0.
//
// The classic machine decides v0/w0 < g^l1 * v1/w1 + s_min with v and w
// accumulated in float32. The precise machine carries v as a double-single
// pair (TwoProduct by Veltkamp splits, TwoSum) whose compensation term is
// rounded to bfloat16 (nearest even) as Pallas stores it; it never stores
// w but evaluates w(l) = -expm1(2 l ln g)/(1 - g^2) from the exact length,
// takes g^l from a 12-bit split of ln g, and decides without a division:
// F = v0*w1 - w0*(g^l1*v1 + s_min*w1) < 0. Its constants and evaluation
// order are the JAX package's, so that every rounding is the same; w0 is 1
// exactly for the pool just pushed, where Pallas drops the factor. Built
// with -fmad=false so that no multiply-add is contracted: the compensated
// sums are exact only if every product and sum rounds alone, and every
// rounding is then that of the plain PyTorch twin's separate ops.
//
// What bounds it on this card. The bytes the algorithm needs are 12 per
// frame (4 B of trace in, 8 B of c and s out, time-major so that a warp's
// access is coalesced): at 3.35 TB/s that is 0.77 ms for 104,448 x 2048
// traces and 7.3 us for one 102 x 20,000 recording. The float32 work is
// under 60 operations a frame, far under 67 TFLOP/s, so bandwidth is the
// bound. What held the first design far above it (34 ms, 28 ms) was where
// the pools lived: a (3, D, B) scratch in device memory, 80 MB at serving
// size (more than the 50 MB L2), with 5-8 dependent scattered loads per
// merge attempt (each lane its own top, one 32-byte sector per lane), and
// a serial chain per frame that few warps hide.
//
// What this design does about it (state only moves; the arithmetic is the
// same float32 operations in the same order):
// - The three top pools live in registers: slots top, top-1 and top-2.
//   A merge attempt reads registers only. A push writes slot top-2 back
//   and shifts the three down; a merge writes the abandoned top slot back
//   (the twin leaves the top pool's values there, and an overflowed lane
//   can read that slot again once it wraps), shifts up and loads slot
//   top-3, whose load does not depend on any decision and is first needed
//   at the next merge. So every slot outside the registers holds exactly
//   the twin's values, and a push on overflow overwrites the same slot as
//   the twin's (D >= 8, so it is never a cached one). Values that depend
//   only on the pool below the top (g^l1 and the decision's right-hand
//   side, w(l1) in the precise machine) and on the top (v0/w0, w(l0)) are
//   computed when that pool changes, from the same function of the same
//   values, so the bits are the same.
// - The ring lives in shared memory wherever a block of one warp of traces
//   fits (3 float32 fields x D slots x 32 lanes <= 232,448 B: D <= 605),
//   laid out [field][slot][lane] so that the bank is the lane whatever
//   each lane's top is: no bank conflicts. The bf16-rounded compensation
//   term is kept widened to float32 (the same value). Deeper rings keep the
//   (3, D, B) device-memory ring, with the same register tops. Which of the
//   two a launch takes is a pure function of (D, precise) computed by the
//   wrapper (ops/oasis_cuda.py: launch_plan); there is no switch.
// - Trace samples are loaded four frames ahead in registers, so the load
//   latency sits off the per-frame chain.
// Splitting one trace's chain across threads would change the merge order
// and so the float32 decisions; it is not done.

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

// One pool: v, then w (classic) or the bfloat16-valued compensation of v
// (precise), then the length.
struct Pool {
  float v, x, l;
};

// One trace's ring of D slots: field f of slot i at base[f*plane +
// i*stride]. Shared memory: int offsets, stride = lanes per block; device
// memory: size_t offsets, stride = B.
template <typename Index>
struct Ring {
  float* base;
  Index stride, plane;

  __device__ __forceinline__ Pool load(int i) const {
    const Index o = (Index)i * stride;
    return {base[o], base[plane + o], base[2 * plane + o]};
  }
  __device__ __forceinline__ void store(int i, const Pool& q) const {
    const Index o = (Index)i * stride;
    base[o] = q.v;
    base[plane + o] = q.x;
    base[2 * plane + o] = q.l;
  }
};

// The stack machine and the reconstruction of one trace.
template <bool Precise, typename Index>
__device__ __forceinline__ void run_trace(const float* __restrict__ yy,
                                          float* __restrict__ c,
                                          float* __restrict__ s, int* redo,
                                          const Ring<Index>& ring, int b,
                                          const Params& p) {
  const int T = p.T, D = p.D, K = p.K;
  const size_t stride = (size_t)p.B;
  auto dec = [D](int i) { return i == 0 ? D - 1 : i - 1; };
  auto inc = [D](int i) { return i + 1 == D ? 0 : i + 1; };

  // the twin's initial ring: v 0, w 1 (classic) or compensation 0, l 1
  const Pool empty{0.0f, Precise ? 0.0f : 1.0f, 1.0f};
  Pool p0 = empty, p1 = empty, p2 = empty;  // slots top, top-1, top-2
  // derived from p0: v0/w0 (classic) or w(l0) (precise)
  float d0 = Precise ? 1.0f : 0.0f;
  // derived from p1: g^l1; the classic right-hand side g^l1*v1/w1 + s_min
  // or the precise w(l1) and R = g^l1*v1 + s_min*w1
  float gl = 1.0f, rhs = 0.0f, w1 = 1.0f;
  auto below_from = [&](const Pool& q, float q_d0) {
    if constexpr (Precise) {
      gl = gl_of(q.l, p);
      w1 = q_d0;  // w(l) of the same l
      rhs = (gl * q.v + gl * q.x) + p.s_min * w1;
    } else {
      gl = expf(q.l * p.log_g);
      rhs = gl * q_d0 + p.s_min;  // q_d0 == q.v / q.x
    }
  };
  auto top_derived = [&](const Pool& q) {
    if constexpr (Precise) {
      return w_of(q.l, p);
    } else {
      return q.v / q.x;
    }
  };

  int top = D - 1;  // the first push lands in slot 0
  int n = 0;        // pools on the stack (may exceed D: bit 0)
  int bits = 0;

  auto frame = [&](float y) {
    // push: slot top-2 leaves the registers
    ring.store(dec(dec(top)), p2);
    p2 = p1;
    p1 = p0;
    below_from(p1, d0);
    top = inc(top);
    p0 = {y, Precise ? 0.0f : 1.0f, 1.0f};
    d0 = top_derived(p0);
    ++n;
    if (n > D) bits |= 1;
    // attempts 0..K-1 merge; attempt K only checks what is left
    for (int k = 0; k <= K; ++k) {
      const bool active = n >= 2;
      bool viol, bord;
      if constexpr (Precise) {
        const float v0w1 = p0.v * w1 + p0.x * w1;
        const float F = v0w1 - d0 * rhs;
        viol = active && F < 0.0f;
        bord = active && fabsf(F) < p.flag_tol * (d0 * (w1 + fabsf(rhs)));
      } else {
        viol = active && d0 < rhs;
        bord = active && fabsf(d0 - rhs) < p.flag_tol * (1.0f + fabsf(rhs));
      }
      if (p.flag_tol > 0.0f && bord) bits |= 4;
      if (!viol) break;
      if (k == K) {
        bits |= 2;
        break;
      }
      // merge the top pool into the one below; its slot keeps its values
      ring.store(top, p0);
      Pool m;
      if constexpr (Precise) {
        // compensated mv = v1 + gl*v0
        float pr, pe, sm, se, mvh, mve;
        two_product(gl, p0.v, pr, pe);
        two_sum(p1.v, pr, sm, se);
        mve = ((se + pe) + gl * p0.x) + p1.x;
        fast_two_sum(sm, mve, mvh, mve);
        m = {mvh, __bfloat162float(__float2bfloat16_rn(mve)), p1.l + p0.l};
      } else {
        m = {p1.v + gl * p0.v, p1.x + gl * gl * p0.x, p1.l + p0.l};
      }
      top = dec(top);
      --n;
      p0 = m;
      d0 = top_derived(p0);
      p1 = p2;
      below_from(p1, top_derived(p1));
      p2 = ring.load(dec(dec(top)));
    }
  };

  // the samples four frames ahead, in registers
  float ya = 0.0f, yb = 0.0f, yc = 0.0f, yd = 0.0f;
  auto fetch = [&](int t) { return t < T ? yy[(size_t)t * stride + b] : 0.0f; };
  float na = fetch(0), nb = fetch(1), nc = fetch(2), nd = fetch(3);
  for (int t0 = 0; t0 < T; t0 += 4) {
    ya = na; yb = nb; yc = nc; yd = nd;
    na = fetch(t0 + 4); nb = fetch(t0 + 5);
    nc = fetch(t0 + 6); nd = fetch(t0 + 7);
    for (int j = 0; j < 4 && t0 + j < T; ++j) {
      frame(j == 0 ? ya : j == 1 ? yb : j == 2 ? yc : yd);
    }
  }
  ring.store(top, p0);
  ring.store(dec(top), p1);
  ring.store(dec(dec(top)), p2);

  // pool heights h = max(v/w, 0)
  auto height = [&](const Pool& q) -> float {
    if constexpr (Precise) {
      return fmaxf((q.v + q.x) / w_of(q.l, p), 0.0f);
    } else {
      return fmaxf(q.v / q.x, 0.0f);
    }
  };
  const int pools = n < D ? n : D;
  int pos = top - (pools - 1);
  if (pos < 0) pos += D;
  Pool cur = ring.load(pos);
  Pool next = ring.load(inc(pos));
  float h = height(cur);
  float len = cur.l;
  float k = 0.0f;
  float c_prev = 0.0f;
  for (int t = 0; t < T; ++t) {
    if (k >= len) {
      pos = inc(pos);
      cur = next;
      next = ring.load(inc(pos));
      h = height(cur);
      len = cur.l;
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

// yy, c, s: (T, B) time-major. Shared: the ring in dynamic shared memory,
// [field][slot][lane] for the block's blockDim.x lanes; device: `stacks`,
// a (3, D, B) float32 scratch.
template <bool Precise, bool Shared>
__global__ void oasis_ar1_kernel(const float* __restrict__ yy,
                                 float* __restrict__ c,
                                 float* __restrict__ s,
                                 int* __restrict__ redo,
                                 float* __restrict__ stacks, Params p) {
  extern __shared__ float ring_smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;  // lanes are independent: no block barrier
  if constexpr (Shared) {
    const int lanes = blockDim.x;
    const Ring<int> ring{ring_smem + threadIdx.x, lanes, p.D * lanes};
    run_trace<Precise>(yy, c, s, redo, ring, b, p);
  } else {
    const Ring<size_t> ring{stacks + b, (size_t)p.B,
                            (size_t)p.D * (size_t)p.B};
    run_trace<Precise>(yy, c, s, redo, ring, b, p);
  }
}

template <bool Precise, bool Shared>
int launch(const float* yy, float* c, float* s, int* redo, float* stacks,
           const Params& p, int lanes, int shared_bytes, void* stream) {
  if constexpr (Shared) {
    // above 48 KB only by opt-in; the whole carveout to shared memory so
    // that as many one-warp blocks fit on an SM as the ring allows
    cudaError_t err = cudaFuncSetAttribute(
        oasis_ar1_kernel<Precise, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          oasis_ar1_kernel<Precise, true>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (p.B + lanes - 1) / lanes;
  oasis_ar1_kernel<Precise, Shared>
      <<<blocks, lanes, shared_bytes, (cudaStream_t)stream>>>(
          yy, c, s, redo, stacks, p);
  return (int)cudaGetLastError();
}

template <bool Precise>
int dispatch(const float* yy, float* c, float* s, int* redo, float* stacks,
             const Params& p, int shared, int lanes, int shared_bytes,
             void* stream) {
  // the plan of ops/oasis_cuda.py:launch_plan, checked: whole warps; the
  // shared ring is 3 float32 fields x D slots x lanes; the device ring is
  // the caller's scratch
  const long long ring_bytes = 12LL * p.D * lanes;
  if (lanes <= 0 || lanes % 32 != 0 || lanes > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (shared) {
    if (shared_bytes != ring_bytes) return (int)cudaErrorInvalidValue;
    return launch<Precise, true>(yy, c, s, redo, nullptr, p, lanes,
                                 shared_bytes, stream);
  }
  if (stacks == nullptr || shared_bytes != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<Precise, false>(yy, c, s, redo, stacks, p, lanes, 0, stream);
}

}  // namespace

// yy, c, s: (T, B) float32, time-major; redo: (B,) int32; stacks: (3, D, B)
// float32 scratch for the device-memory ring (shared == 0), unused (may be
// null) for the shared-memory ring (shared == 1, shared_bytes = 12*D*lanes);
// lanes: traces per block, a multiple of 32. Launch on `stream` and return
// the CUDA error (0 on success); neither synchronises.

// The classic machine.
extern "C" int oasis_ar1_launch(const float* yy, float* c, float* s,
                                int* redo, float* stacks, int T, int B,
                                int D, float g, float log_g, float s_min,
                                int K, float flag_tol, int shared, int lanes,
                                int shared_bytes, void* stream) {
  const Params p{T, B, D, g, log_g, s_min, K, flag_tol, 0.0f, 0.0f, 0.0f};
  return dispatch<false>(yy, c, s, redo, stacks, p, shared, lanes,
                         shared_bytes, stream);
}

// The precise machine; lng_hi, lng_lo: 12-bit split of log(g); inv_1mg2:
// float32(1 / (1 - g^2)).
extern "C" int oasis_ar1_precise_launch(const float* yy, float* c, float* s,
                                        int* redo, float* stacks, int T,
                                        int B, int D, float g, float log_g,
                                        float s_min, int K, float flag_tol,
                                        float lng_hi, float lng_lo,
                                        float inv_1mg2, int shared, int lanes,
                                        int shared_bytes, void* stream) {
  const Params p{T, B, D, g, log_g, s_min, K, flag_tol, lng_hi, lng_lo,
                 inv_1mg2};
  return dispatch<true>(yy, c, s, redo, stacks, p, shared, lanes,
                        shared_bytes, stream);
}
