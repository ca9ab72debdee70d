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
// under 60 operations a frame, far under 67 TFLOP/s. Neither binds: what
// does is the latency of each trace's dependent chain, a few hundred cycles
// a frame, and so how many traces run at once. What held the first design
// far above the bytes (34 ms, 28 ms) was where the pools lived: a (3, D, B)
// scratch in device memory, 80 MB at serving size (more than the 50 MB L2),
// with 5-8 dependent scattered loads per merge attempt (each lane its own
// top, one 32-byte sector per lane). Keeping the whole ring in shared memory
// instead costs 12 B x D a lane: at D 384 one warp's ring is 147,456 B, so
// one one-warp block fits on an SM's 232,448 B, and the 16,320 traces of a
// served batch at 16,384 frames (510 warps) ran in 4 waves of one warp an
// SM, each as long as one trace's chain.
//
// What this design does about it (state only moves; the arithmetic is the
// same float32 operations in the same order):
// - The three top pools live in registers: slots top, top-1 and top-2.
//   A merge attempt reads registers only. A push writes slot top-2 back
//   and shifts the three down; a merge writes the abandoned top slot back
//   (the twin leaves the top pool's values there, and an overflowed lane
//   can read that slot again once it wraps), shifts up and loads slot
//   top-3, whose load does not depend on any decision and is first needed
//   at the next merge. So every
//   slot outside the registers holds exactly the twin's values, and a push
//   on overflow overwrites the same slot as the twin's (D >= 8, so it is
//   never a cached one). Values that depend only on the pool below the top
//   (g^l1 and the decision's right-hand side, w(l1) in the precise machine)
//   and on the top (v0/w0, w(l0)) are computed when that pool changes, from
//   the same function of the same values, so the bits are the same.
// - A ring that fits, in a launch whose blocks are all resident at once,
//   lives whole in shared memory, one warp of traces per block, laid out
//   [field][slot][lane] so that the bank is the lane whatever each lane's
//   top is: no bank conflicts. The bf16-rounded compensation term is kept
//   widened to float32 (the same value).
// - Any other ring lives in a (3, D, B) device-memory scratch, and shared
//   memory holds a window of W consecutive stack positions of it, the same
//   [field][slot][lane] layout for one warp per block, so a block needs
//   12 B x W a lane whatever D is: 24,576 B, nine blocks an SM, and the
//   16,320 traces take one wave (four warps an SM). Positions are
//   absolute (the top pool's is n - 1; ring slot = position mod D, window
//   slot = position mod W); the window holds positions lo .. lo + W - 1 and
//   always the three register tops. It slides only when the stack leaves
//   it: a push past its top writes its oldest slot back to the device ring;
//   a merge whose top-3 lies below it writes its top slot back and fills
//   top-3 straight into the registers (a register slot is always written
//   before it leaves them). The slot just below the window is held in
//   registers (kept when it leaves the window, loaded from the ring after
//   each fill), so a fill waits on no load unless fills follow each other
//   faster than a load returns. W < D, so the window
//   never holds two positions of one ring slot, and it is a write-back
//   cache of the ring: every slot the twin reads holds the twin's values,
//   overflowed lanes included. It starts at lo = -3, positions that hold
//   the twin's initial pools, so a fill never reads a slot that was not
//   written back. The forward pass ends by writing the window back, and
//   the reconstruction reads the device ring. Each lane counts the slots
//   it moved (write-backs plus fills) into `moves`.
// - Which of the two a launch takes is a pure function of D, the machine,
//   B and the card's SM count, computed by the wrapper (ops/oasis_cuda.py:
//   launch_plan): the whole ring wherever it is no larger than a window
//   (up to WINDOW, 64, slots), or fits and the launch takes one wave of it
//   (102 or 2048 traces at D 512); the window everywhere else (16,320
//   traces at D 384, since a whole ring leaves one block an SM). Where both take one wave, a
//   whole ring's frame is faster: it never waits on the device ring.
//   There is no switch.
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
  int W;  // ring slots a lane keeps in shared memory: D, or a window
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

// Slots of one float32 field per lane: field f of slot i at base[f*plane +
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

__device__ __forceinline__ int ring_dec(int i, int D) {
  return i == 0 ? D - 1 : i - 1;
}
__device__ __forceinline__ int ring_inc(int i, int D) {
  return i + 1 == D ? 0 : i + 1;
}

// The whole ring of D slots in shared memory, top at slot `top`.
struct WholeRing {
  Ring<int> ring;
  int D;
  int top = D - 1;  // the first push lands in slot 0
  int moves = 0;    // nothing leaves shared memory

  // slot top-2 leaves the registers; the top moves up
  __device__ __forceinline__ void push(const Pool& p2) {
    ring.store(ring_dec(ring_dec(top, D), D), p2);
    top = ring_inc(top, D);
  }
  // a merge: the abandoned top keeps its values and the top moves down,
  // stored as soon as the merge is decided (measured faster here than at
  // the fill: PERF.md §6); then the new slot top-2 comes into the
  // registers
  __device__ __forceinline__ void pop(const Pool& p0) {
    ring.store(top, p0);
    top = ring_dec(top, D);
  }
  __device__ __forceinline__ Pool fill() {
    return ring.load(ring_dec(ring_dec(top, D), D));
  }
  __device__ __forceinline__ void finish(const Pool& p0, const Pool& p1,
                                         const Pool& p2) {
    ring.store(top, p0);
    ring.store(ring_dec(top, D), p1);
    ring.store(ring_dec(ring_dec(top, D), D), p2);
  }
  __device__ __forceinline__ const Ring<int>& pools() const { return ring; }
  __device__ __forceinline__ int top_slot() const { return top; }
};

// The ring of D slots in device memory behind a window of W (a power of
// two, 4 <= W < D) consecutive stack positions in shared memory: see "What
// this design does about it" above.
struct WindowRing {
  Ring<int> win;      // window slot = position & mask
  Ring<size_t> ring;  // ring slot = position mod D
  int D, mask;
  int a = -1;         // position of the top pool, n - 1
  int lo = -3;        // the window holds positions lo .. lo + mask
  int lo_r = D - 3, hi_r = mask - 3;  // their ring slots
  Pool below{};       // position lo - 1, held for the next fill
  Pool popped{};      // the abandoned top, stored at the fill
  int moves = 0;      // write-backs plus fills

  __device__ __forceinline__ void push(const Pool& p2) {
    win.store((a - 2) & mask, p2);
    ++a;
    if (a > lo + mask) {  // past the window: its oldest slot goes back
      below = win.load(lo & mask);
      ring.store(lo_r, below);
      ++lo;
      lo_r = ring_inc(lo_r, D);
      hi_r = ring_inc(hi_r, D);
      ++moves;
    }
  }
  // a merge: the abandoned top keeps its values and the top moves down,
  // both at the fill (measured faster here than storing first: PERF.md §6)
  __device__ __forceinline__ void pop(const Pool& p0) { popped = p0; }
  __device__ __forceinline__ Pool fill() {
    win.store(a & mask, popped);
    --a;
    if (a - 2 >= lo) return win.load((a - 2) & mask);
    // top-2 lies below the window: its top slot goes back, and the slot
    // below it, held since it left the window or since the last fill,
    // comes into the registers; the next one below is loaded for later
    ring.store(hi_r, win.load((lo + mask) & mask));
    --lo;
    lo_r = ring_dec(lo_r, D);
    hi_r = ring_dec(hi_r, D);
    moves += 2;
    const Pool filled = below;
    below = ring.load(ring_dec(lo_r, D));
    return filled;
  }
  // the registers into the window, the window back to the ring
  __device__ __forceinline__ void finish(const Pool& p0, const Pool& p1,
                                         const Pool& p2) {
    win.store(a & mask, p0);
    win.store((a - 1) & mask, p1);
    win.store((a - 2) & mask, p2);
    int r = lo_r;
    for (int i = 0; i <= mask; ++i) {
      ring.store(r, win.load((lo + i) & mask));
      r = ring_inc(r, D);
    }
  }
  __device__ __forceinline__ const Ring<size_t>& pools() const {
    return ring;
  }
  __device__ __forceinline__ int top_slot() const { return a % D; }
};

// The stack machine and the reconstruction of one trace.
template <bool Precise, typename Stack>
__device__ __forceinline__ void run_trace(const float* __restrict__ yy,
                                          float* __restrict__ c,
                                          float* __restrict__ s, int* redo,
                                          int* moves, Stack& st, int b,
                                          const Params& p) {
  const int T = p.T, D = p.D, K = p.K;
  const size_t stride = (size_t)p.B;

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

  int n = 0;  // pools on the stack (may exceed D: bit 0)
  int bits = 0;

  auto frame = [&](float y) {
    // push: slot top-2 leaves the registers
    st.push(p2);
    p2 = p1;
    p1 = p0;
    below_from(p1, d0);
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
      st.pop(p0);
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
      --n;
      p0 = m;
      d0 = top_derived(p0);
      p1 = p2;
      below_from(p1, top_derived(p1));
      p2 = st.fill();
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
  st.finish(p0, p1, p2);

  // pool heights h = max(v/w, 0)
  auto height = [&](const Pool& q) -> float {
    if constexpr (Precise) {
      return fmaxf((q.v + q.x) / w_of(q.l, p), 0.0f);
    } else {
      return fmaxf(q.v / q.x, 0.0f);
    }
  };
  const auto& ring = st.pools();
  const int top = st.top_slot();
  const int pools = n < D ? n : D;
  int pos = top - (pools - 1);
  if (pos < 0) pos += D;
  Pool cur = ring.load(pos);
  Pool next = ring.load(ring_inc(pos, D));
  float h = height(cur);
  float len = cur.l;
  float k = 0.0f;
  float c_prev = 0.0f;
  for (int t = 0; t < T; ++t) {
    if (k >= len) {
      pos = ring_inc(pos, D);
      cur = next;
      next = ring.load(ring_inc(pos, D));
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
  if (moves != nullptr) moves[b] = st.moves;
}

// yy, c, s: (T, B) time-major. Each lane's p.W slots in dynamic shared
// memory, [field][slot][lane] for the block's blockDim.x lanes: the whole
// ring (p.W == p.D) or, Windowed, the window over the lane's ring in
// `stacks`, a (3, D, B) float32 scratch.
template <bool Precise, bool Windowed>
__global__ void oasis_ar1_kernel(const float* __restrict__ yy,
                                 float* __restrict__ c,
                                 float* __restrict__ s,
                                 int* __restrict__ redo,
                                 int* __restrict__ moves,
                                 float* __restrict__ stacks, Params p) {
  extern __shared__ float ring_smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;  // lanes are independent: no block barrier
  const int lanes = blockDim.x;
  const Ring<int> shared{ring_smem + threadIdx.x, lanes, p.W * lanes};
  if constexpr (Windowed) {
    const Ring<size_t> ring{stacks + b, (size_t)p.B,
                            (size_t)p.D * (size_t)p.B};
    WindowRing st{shared, ring, p.D, p.W - 1};
    run_trace<Precise>(yy, c, s, redo, moves, st, b, p);
  } else {
    WholeRing st{shared, p.D};
    run_trace<Precise>(yy, c, s, redo, moves, st, b, p);
  }
}

template <bool Precise, bool Windowed>
int launch(const float* yy, float* c, float* s, int* redo, int* moves,
           float* stacks, const Params& p, int lanes, int shared_bytes,
           void* stream) {
  // above 48 KB only by opt-in; the whole carveout to shared memory so
  // that as many blocks fit on an SM as their slots allow
  cudaError_t err = cudaFuncSetAttribute(
      oasis_ar1_kernel<Precise, Windowed>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(oasis_ar1_kernel<Precise, Windowed>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + lanes - 1) / lanes;
  oasis_ar1_kernel<Precise, Windowed>
      <<<blocks, lanes, shared_bytes, (cudaStream_t)stream>>>(
          yy, c, s, redo, moves, stacks, p);
  return (int)cudaGetLastError();
}

template <bool Precise>
int dispatch(const float* yy, float* c, float* s, int* redo, int* moves,
             float* stacks, const Params& p, int lanes, int shared_bytes,
             void* stream) {
  // the plan of ops/oasis_cuda.py:launch_plan, checked: whole warps; 3
  // float32 fields x W slots x lanes of shared memory; W is the whole ring,
  // or a window (a power of two, 4 <= W < D) over the caller's scratch
  if (lanes <= 0 || lanes % 32 != 0 || lanes > 1024 ||
      (long long)shared_bytes != 12LL * p.W * lanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (p.W == p.D) {
    return launch<Precise, false>(yy, c, s, redo, moves, nullptr, p, lanes,
                                  shared_bytes, stream);
  }
  if (p.W < 4 || p.W >= p.D || (p.W & (p.W - 1)) != 0 || stacks == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<Precise, true>(yy, c, s, redo, moves, stacks, p, lanes,
                               shared_bytes, stream);
}

// ---- the exact float64 redo of flagged traces ----
//
// Replaces no TPU kernel: the JAX package, and the port until now, redo the
// traces that the float32 machines flag on the host, with the C++ float64
// OASIS (calciumgan_tpu_torch/csrc/oasis_host.cc: cg_oasis_ar1 under
// cg_deconvolve_batch). This kernel computes the same function on the card,
// so the flagged rows never leave it: the pool-adjacency machine with no
// depth limit on y widened to double (cg_deconvolve_batch passes lam 0, so
// the shifted input is y itself, bit for bit), then h = max(v/w, 0) with
// std::max's comparison (-0.0 stays -0.0), c frame by frame by dec *= g,
// s[t] = c[t] - g*c[t-1], s[0] = 0, and int8 s > threshold. The operations
// and their order are the host's, and each is an IEEE double operation
// rounded to nearest (the __d*_rn intrinsics: nothing is contracted or
// reassociated, whatever the flags). The one function the host takes from
// its library, pow, is not called here: g^l comes from a table of T + 1
// doubles that the host fills with the very std::pow call of cg_oasis_ar1
// (cg_pow_table). So the spikes equal the host's bit for bit.
//
// What bounds it on this card: the latency of one trace's dependent chain,
// a float64 division and a comparison a decision, about two decisions a
// frame; the bytes (4 B of trace in, 1 B of spikes out a frame, and the
// pool scratch, which stays near its top and so in L2) are no bound. What
// the design does about it:
// - One thread a trace: splitting a chain would change the order of its
//   float64 sums. Blocks are one warp, so that a few thousand traces
//   (sl16384-generate's ~2,200) still spread over the SMs.
// - The traces come gathered and time-major, (T, n), so a warp's load of a
//   frame is coalesced; samples are loaded four frames ahead.
// - The top pool and the two below it live in registers, with the top's
//   v/w and the right-hand side of the next decision cached (the same
//   function of the same values, so the same bits). The pool two below the
//   top is loaded after a merge, which does not wait on it; only the next
//   merge does.
// - Every other pool lives in a device-memory scratch of T slots a trace,
//   laid out [field][slot][lane] (v and w as double, the length as int32:
//   20 B a slot); the wrapper sizes its chunks of traces so that the
//   scratch stays under a fixed bound.
// - Each trace writes its int8 spikes straight into its row of the caller's
//   spike tensor, at any strides (the serving tensor is time-major).

__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double dsub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double ddiv(double a, double b) {
  return __ddiv_rn(a, b);
}

struct ExactParams {
  int T, n;  // frames; traces in this launch
  double g, s_min, threshold;
  long long out_row, out_time;  // strides of the int8 spike tensor
};

// y: (T, n) float32, time-major; rows: (n,) the traces' rows of `out`;
// gpow: (T + 1,) g^l; scratch: 20 * T * n bytes, [v][slot][lane] and
// [w][slot][lane] double, then [len][slot][lane] int32.
__global__ void oasis_exact_f64_kernel(const float* __restrict__ y,
                                       const long long* __restrict__ rows,
                                       const double* __restrict__ gpow,
                                       double* __restrict__ scratch,
                                       signed char* __restrict__ out,
                                       ExactParams p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.n) return;  // lanes are independent: no block barrier
  const int T = p.T;
  const size_t n = (size_t)p.n, plane = (size_t)T * n;
  double* V = scratch + b;
  double* W = scratch + plane + b;
  int* L = reinterpret_cast<int*>(scratch + 2 * plane) + b;
  auto store = [&](int i, double v, double w, int l) {
    V[i * n] = v;
    W[i * n] = w;
    L[i * n] = l;
  };

  // pools top (index top), below (top - 1) and below2 (top - 2); the
  // scratch holds every pool under top - 1 as cg_oasis_ar1 holds it
  double v0 = 0.0, w0 = 1.0, v1 = 0.0, w1 = 1.0, v2 = 0.0, w2 = 1.0;
  int l0 = 0, l1 = 0, l2 = 0;
  double d0 = 0.0;  // v0 / w0
  double gl = 1.0;  // g^l1
  double rhs = 0.0; // gl * (v1 / w1) + s_min
  int top = -1;

  auto frame = [&](double yt) {
    // push: the pool below leaves the registers for its slot
    if (top >= 1) store(top - 1, v1, w1, l1);
    v2 = v1; w2 = w1; l2 = l1;
    v1 = v0; w1 = w0; l1 = l0;
    if (top >= 0) {
      gl = gpow[l1];
      rhs = dadd(dmul(gl, d0), p.s_min);  // d0 == v1 / w1
    }
    ++top;
    v0 = yt;
    w0 = 1.0;
    l0 = 1;
    d0 = ddiv(v0, w0);
    while (top > 0) {
      if (d0 >= rhs) break;
      // v[p-1] += gl*v[p]; w[p-1] += gl*gl*w[p]; len[p-1] += len[p]; --p
      v0 = dadd(v1, dmul(gl, v0));
      w0 = dadd(w1, dmul(dmul(gl, gl), w0));
      l0 = l1 + l0;
      --top;
      d0 = ddiv(v0, w0);
      if (top > 0) {
        v1 = v2; w1 = w2; l1 = l2;
        gl = gpow[l1];
        rhs = dadd(dmul(gl, ddiv(v1, w1)), p.s_min);
        if (top >= 2) {
          v2 = V[(top - 2) * n];
          w2 = W[(top - 2) * n];
          l2 = L[(top - 2) * n];
        }
      }
    }
  };

  // the samples four frames ahead, in registers
  auto fetch = [&](int t) { return t < T ? y[(size_t)t * n + b] : 0.0f; };
  float na = fetch(0), nb = fetch(1), nc = fetch(2), nd = fetch(3);
  for (int t0 = 0; t0 < T; t0 += 4) {
    const float ya = na, yb = nb, yc = nc, yd = nd;
    na = fetch(t0 + 4); nb = fetch(t0 + 5);
    nc = fetch(t0 + 6); nd = fetch(t0 + 7);
    for (int j = 0; j < 4 && t0 + j < T; ++j) {
      frame((double)(j == 0 ? ya : j == 1 ? yb : j == 2 ? yc : yd));
    }
  }
  store(top, v0, w0, l0);
  if (top >= 1) store(top - 1, v1, w1, l1);

  // the pools from the bottom: c frame by frame, s and its spike
  signed char* row = out + rows[b] * p.out_row;
  double c_prev = 0.0;
  int t = 0;
  double nv = V[0], nw = W[0];
  int nl = L[0];
  for (int i = 0; i <= top; ++i) {
    const double v = nv, w = nw;
    const int len = nl;
    if (i < top) {  // the next pool's loads, off this pool's chain
      nv = V[(i + 1) * n];
      nw = W[(i + 1) * n];
      nl = L[(i + 1) * n];
    }
    const double q = ddiv(v, w);
    double dec = q < 0.0 ? 0.0 : q;  // std::max(q, 0.0)
    for (int k = 0; k < len; ++k, ++t) {
      const double s = t == 0 ? 0.0 : dsub(dec, dmul(p.g, c_prev));
      row[t * p.out_time] = s > p.threshold ? 1 : 0;
      c_prev = dec;
      dec = dmul(dec, p.g);
    }
  }
}

}  // namespace

// The exact float64 redo: y (T, n) float32, time-major, the traces to redo;
// rows (n,) int64, their rows of the int8 spike tensor `out`, whose strides
// (in elements) are out_row and out_time; gpow (T + 1,) double, g^l from
// cg_pow_table; scratch 20 * T * n bytes; lanes: traces per block, a
// multiple of 32. Launch on `stream` and return the CUDA error (0 on
// success); it does not synchronise.
extern "C" int oasis_exact_f64_launch(const float* y, const long long* rows,
                                      const double* gpow, double* scratch,
                                      signed char* out, int T, int n,
                                      double g, double s_min,
                                      double threshold, long long out_row,
                                      long long out_time, int lanes,
                                      void* stream) {
  if (lanes <= 0 || lanes % 32 != 0 || lanes > 1024 || T <= 0 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const ExactParams p{T, n, g, s_min, threshold, out_row, out_time};
  oasis_exact_f64_kernel<<<(n + lanes - 1) / lanes, lanes, 0,
                           (cudaStream_t)stream>>>(y, rows, gpow, scratch,
                                                   out, p);
  return (int)cudaGetLastError();
}

// yy, c, s: (T, B) float32, time-major; redo: (B,) int32; moves: (B,)
// int32, each lane's slots moved between its window and its ring (0 for a
// whole ring), or null; window: the ring slots a lane keeps in shared
// memory, D for the whole ring (stacks unused, may be null) or a power of
// two 4 <= window < D over stacks, a (3, D, B) float32 scratch; lanes:
// traces per block, a multiple of 32; shared_bytes = 12 * window * lanes.
// Launch on `stream` and return the CUDA error (0 on success); neither
// synchronises.

// The classic machine.
extern "C" int oasis_ar1_launch(const float* yy, float* c, float* s,
                                int* redo, int* moves, float* stacks, int T,
                                int B, int D, float g, float log_g,
                                float s_min, int K, float flag_tol,
                                int window, int lanes, int shared_bytes,
                                void* stream) {
  const Params p{T, B, D, window, g, log_g, s_min, K, flag_tol,
                 0.0f, 0.0f, 0.0f};
  return dispatch<false>(yy, c, s, redo, moves, stacks, p, lanes,
                         shared_bytes, stream);
}

// The precise machine; lng_hi, lng_lo: 12-bit split of log(g); inv_1mg2:
// float32(1 / (1 - g^2)).
extern "C" int oasis_ar1_precise_launch(const float* yy, float* c, float* s,
                                        int* redo, int* moves, float* stacks,
                                        int T, int B, int D, float g,
                                        float log_g, float s_min, int K,
                                        float flag_tol, float lng_hi,
                                        float lng_lo, float inv_1mg2,
                                        int window, int lanes,
                                        int shared_bytes, void* stream) {
  const Params p{T, B, D, window, g, log_g, s_min, K, flag_tol,
                 lng_hi, lng_lo, inv_1mg2};
  return dispatch<true>(yy, c, s, redo, moves, stacks, p, lanes,
                        shared_bytes, stream);
}
