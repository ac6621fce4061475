// Per-symbol demod recurrence for a batch of streams over one block: QPSK
// (block_demod_kernel) and OQPSK (block_demod_oqpsk_kernel).
//
// Replaces the Pallas TPU kernels of meteor_demod_tpu/kernels/block_demod.py
// (_make_kernel via make_pallas_batch_demod, and _make_kernel_dma via
// _make_dma_demod): the QPSK single-fire body _make_step, the OQPSK
// paired-fire body _make_paired_step_tiles with the block-entry completion
// pre-fire _kernel_prefire and its leading output row (_assemble_outs), and
// the device helpers _fast_sin_rows and _lut_tanh_rows. The TPU kernels
// select each fired tick from a prematerialized candidate window because the
// TPU vector unit cannot index per lane; here each thread reads its fired
// tick Ft[tau, {0,1}, b] directly, as demod/scalar.py does, so no window,
// DMA span or flag for a window miss exists (OQPSK still flags a deferred
// fire, which breaks the pairing's alignment).
//
// Design: one thread per stream; a thread block is two warps, one that runs
// 32 streams and one that stages their ticks, so a 128-stream fleet spreads
// over four SMs and ceil(B/32) blocks fill the card. The whole carry stays
// in registers for the block's S steps. Outputs are (rows, B), so
// neighbouring threads store to neighbouring addresses: S rows for QPSK, S+1
// for OQPSK (row 0 the pre-fire).
//
// What bounds it: latency, not bytes or operations, up to a few thousand
// streams. Every step depends on the previous one (timing phase -> gate ->
// fired tick -> AGC -> mix -> M&M/Costas -> next timing phase), about 2.6 k
// steps per 8192-sample block (2.9 k paired steps of two fires each for
// OQPSK at 80 ksym/s), and a warp executes in order, so a block costs steps x
// the clocks of one whole step, whatever the width. At
// B = 16896 the kernels read all of Ft near the memory rate instead. The
// design shortens the step three ways (PERF.md has each one's times, and the
// levers that lost: an fmodf fast path, an unconditional tick read, an
// inline sqrt, the tanh table in shared memory):
//  - The gate is O(1): an estimate ceil(diff / t_center) of the fired
//    candidate, then the gate's own predicate fl(k*tf) >= diff evaluated for
//    the estimate's neighbours (independent multiplies, no branch chain). The
//    first k that passes while k-1 fails is the serial search's k because
//    fl(k*tf) is non-decreasing in k for tf > 0; anything the neighbours
//    cannot prove runs the serial search itself (gate_search).
//  - The fired tick comes from shared memory. A warp's streams consume Ft's
//    rows monotonically, and in the tick-major (T, 2, B) layout the warp's
//    slice of a row is two runs of up to 128 bytes. The block's second warp
//    keeps a ring of kRing ticks topped up with cp.async ahead of the slowest
//    stream (at B = 1 as well: the copying warp is whole whatever the count
//    of streams), and the streams' warp spends one shared-memory store and
//    load a step on it: no copy, wait or barrier sits in the chain's
//    in-order code. A stream whose tick is not staged (it ran
//    ahead of the copies, or far ahead of the warp's slowest stream) reads
//    global memory, so the ring decides speed, never the result.
//  - Work that needs only the carry (the NCO's sine, cosine and phase
//    advance) comes before the gate, so that it overlaps the gate and the
//    tick read; the OQPSK Q fire's gain (a sqrt that only the next step
//    needs) comes after the loop update.
//
// Numerics: the decision contract is bitwise against the numpy oracle
// (demod/scalar.py) given the same FIR output. Every multiply and add of the
// AGC, mix, M&M and Costas chains is written with __fmul_rn / __fadd_rn /
// __fsub_rn, which the compiler never contracts into an FMA, and the file is
// built with -fmad=false, IEEE sqrt and division, and no fast math
// (kernels/_build.py).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRing = 128;                 // ticks a warp stages; power of two
constexpr int kRowFloats = 2 * kWarp;      // one staged tick: re[32], im[32]
// A thread block: the streams' warp and the copying warp; its shared memory:
// the ring and the two warps' words (pub[32], ready).
constexpr int kThreads = 2 * kWarp;
constexpr size_t kSharedBytes =
    (size_t)kRing * kRowFloats * sizeof(float) + (kWarp + 1) * sizeof(int);
static_assert((kRing & (kRing - 1)) == 0, "kRing must be a power of two");
static_assert(kSharedBytes <= 48 * 1024, "above 48 KB the launch needs "
              "cudaFuncAttributeMaxDynamicSharedMemorySize");
constexpr int kFlagWindowMiss = 1;
constexpr int kFlagUnconsumed = 2;

// Float parameters, in the order kernels/block_demod.py packs them.
struct Params {
  float a_t, b_t, a_p, b_p;
  float t_center, t_dev, fmax;
  float bias_keep, bias_pole, gain_pole, agc_target;
  float err_keep, err_pole, sweep, lock_th, unlock_th;
  float two_pi, half_pi, phase_scale, inv_q;
  float tanh_table[32];
  float inv_t_center;            // fl(1 / t_center): the gate's estimate
};
constexpr int kNumParams = sizeof(Params) / sizeof(float);

// Packed carry rows (kernels/block_demod.py _F_LEAVES / _I_LEAVES).
enum { F_TPHASE, F_TFREQ, F_TPREV, F_PPHASE, F_PFREQ, F_PERR, F_UPDOWN,
       F_GAIN, F_BIASRE, F_BIASIM, F_INPHASE, NF };
enum { I_LOCKED, I_LOCKED_ONCE, I_SLOT, I_TICK, I_FLAGS, NI };

// Q14 parabolic sine (sincos.c:12-34, dsp/sincos.py fast_sin).
__device__ __forceinline__ float fast_sin(float fx, const Params& p) {
  int xi = __float2int_rz(__fmul_rn(fx, p.phase_scale));   // trunc to zero
  int lo = xi & 0xFFFF;                                    // wrap mod 2**16
  int x16 = lo >= 0x8000 ? lo - 0x10000 : lo;
  int x = (x16 & 0x7FFF) - (1 << 14);
  int x2 = (x * x) >> 14;
  int y = 19900 - ((x2 * 3516) >> 14);
  y = (1 << 14) - ((x2 * y) >> 14);
  if (x16 < 0) y = -y;
  return __fmul_rn(__int2float_rn(y), p.inv_q);
}

// Truncating tanh lookup with index clamp (pll.c:153-159).
__device__ __forceinline__ float lut_tanh(float v, const Params& p) {
  float tv = fminf(fmaxf(truncf(v), -16.0f), 15.0f);
  return p.tanh_table[__float2int_rz(tv) + 16];
}

// ---- the timing gate -----------------------------------------------------

// Closed-form timing gate (demod/scalar.py gate_fire_np): fires at
// k = min{k in [1, kmax] : fl(k*tf) >= diff}, kmax = min(K, rem) and
// diff = fl(thresh - tp). `k` is the ticks consumed (kmax on a non-fire) and
// `prod` = fl(k*tf), the one add the timing phase advances by (0 when
// k == 0).
struct Gate {
  bool fired;
  int k;
  float prod;
};

// The gate as a serial search over k: the definition, and what gate()
// runs when its estimate proves nothing.
__device__ __forceinline__ Gate gate_search(float diff, float tf, int kmax) {
  for (int k = 1; k <= kmax; ++k) {
    const float prod = __fmul_rn(__int2float_rn(k), tf);
    if (prod >= diff) return {true, k, prod};
  }
  return {false, kmax, kmax > 0 ? __fmul_rn(__int2float_rn(kmax), tf) : 0.0f};
}

// The gate in O(1). pass(k) := k >= 1 and fl(k*tf) >= diff is non-decreasing
// in k when tf > 0 (k*tf grows with k and rounding keeps order), so the
// search's k is the one k with pass(k) and not pass(k-1). tf stays within
// t_center*(1 +- 2**-12), so ke = ceil(diff / t_center), clamped to [1, K],
// is off by at most one: pass is evaluated for ke-2 .. ke+1 with the
// search's own multiply and compare. If ke+1 fails too and kmax <= ke+1, no
// k fires. Whatever this cannot prove (tf <= 0 or NaN from a crafted carry,
// an estimate further off) goes to gate_search.
__device__ __forceinline__ Gate gate(float tp, float tf, float thresh, int rem,
                                     int K, const Params& p) {
  const float diff = __fsub_rn(thresh, tp);
  const int kmax = min(K, rem);
  const int ke = max(1, min(__float2int_ru(__fmul_rn(diff, p.inv_t_center)),
                            K));
  const float fk = __int2float_rn(ke);
  const float pm2 = __fmul_rn(__fsub_rn(fk, 2.0f), tf);
  const float pm1 = __fmul_rn(__fsub_rn(fk, 1.0f), tf);
  const float p0 = __fmul_rn(fk, tf);
  const float pp1 = __fmul_rn(__fadd_rn(fk, 1.0f), tf);
  const bool am2 = ke > 2 && pm2 >= diff;
  const bool am1 = ke > 1 && pm1 >= diff;
  const bool a0 = p0 >= diff;
  const bool ap1 = pp1 >= diff;
  const bool fm1 = am1 && !am2, f0 = a0 && !am1, fp1 = ap1 && !a0;
  const int kf = fm1 ? ke - 1 : (f0 ? ke : ke + 1);
  const float pf = fm1 ? pm1 : (f0 ? p0 : pp1);
  const bool found = fm1 || f0 || fp1;
  const bool none = !ap1 && ke + 1 >= kmax;
  if (tf > 0.0f && (found || none)) {
    if (found && kf <= kmax) return {true, kf, pf};
    return {false, kmax,
            kmax > 0 ? __fmul_rn(__int2float_rn(kmax), tf) : 0.0f};
  }
  return gate_search(diff, tf, kmax);
}

// ---- the block's ticks, staged per warp ------------------------------------

// A thread block is two warps: warp 0 runs 32 streams,
// warp 1 copies their ticks from Ft into a ring in shared memory ahead of
// them (stage_ticks), so the streams' warp executes no copy, wait or warp
// barrier. Tick r of the 32 streams lives at
// ticks[(r % kRing) * 64 + {0, 32} + lane]. The two warps talk through
// pub[lane], the tick each stream has reached (T when it needs no more),
// and ready, the count of ticks that have landed.
struct Ring {
  float* ticks;
  int* pub;
  int* ready;
};

__device__ __forceinline__ Ring ring_of(float* smem) {
  int* words = reinterpret_cast<int*>(smem + kRing * kRowFloats);
  return {smem, words, words + kWarp};
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v) : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared.b32 [%0], %1;"
               :: "r"((unsigned)__cvta_generic_to_shared(p)), "r"(v)
               : "memory");
}

// The copying warp. Each round it reads the streams' ticks, and tops the
// ring up to kRing ticks past the slowest one with cp.async; a round's
// copies are published (ready) one round later, when they have landed, so
// a round never waits for its own requests. The streams publish their tick
// one step late (Staged::step), so every tick a stream can still be reading
// is at or past the published one, and nothing it may read is overwritten.
//
// A row is two runs (re, im) of n streams: 2*n 4-byte pieces, or 2*n/4
// 16-byte pieces when every run is 16-byte aligned (B % 4 == 0 and Ft
// aligned; the streams start at a multiple of 32). Up to 32 pieces: 32/pieces
// rows go in one pass over the lanes; above (4-byte pieces, n > 16) a lane
// takes pieces lane and lane + 32 of one row.
__device__ __forceinline__ void stage_ticks(Ring ring, const float* Ft, int B,
                                            int T, int b0, int lane) {
  const float* base = Ft + b0;
  const int n = min(kWarp, B - b0);
  const bool vec = B % 4 == 0 && (uintptr_t)Ft % 16 == 0;
  const int w = vec ? 4 : 1;
  const int per_run = n / w;
  const int pieces = 2 * per_run;
  int rows_per_pass = 1, first_row = 0, col[2] = {lane, -1};
  if (pieces <= kWarp) {
    rows_per_pass = kWarp / pieces;
    first_row = lane / pieces;
    col[0] = lane - first_row * pieces;
    if (first_row >= rows_per_pass) first_row = -1;        // an idle lane
  } else if (lane + kWarp < pieces) {
    col[1] = lane + kWarp;
  }
  int goff[2], soff[2];
  for (int i = 0; i < 2; ++i) {
    const int c = col[i] < 0 ? 0 : col[i] / per_run;       // 0 re, 1 im
    const int j = col[i] < 0 ? 0 : col[i] - c * per_run;
    goff[i] = col[i] < 0 ? -1 : c * B + j * w;
    soff[i] = c * kWarp + j * w;
  }

  // Fill levels: ticks below `requested` have been requested, below `landing`
  // were requested before this round, below `published` are readable.
  int requested = 0, landing = 0, published = 0;
  for (;;) {
    const int head = __reduce_min_sync(
        0xffffffffu, *const_cast<volatile int*>(ring.pub + lane));
    if (head >= T) break;
    const int target = min(head + kRing, T);
    // Ticks before head are never read again; skipping them also keeps a
    // round within kRing rows, so no two of its copies share a slot.
    requested = max(requested, head);
    if (first_row >= 0) {
      for (int r = requested + first_row; r < target; r += rows_per_pass) {
        const float* src = base + 2 * (size_t)r * B;
        float* dst = ring.ticks + (r & (kRing - 1)) * kRowFloats;
        if (vec) {
          __pipeline_memcpy_async(dst + soff[0], src + goff[0], 16);
        } else {
          __pipeline_memcpy_async(dst + soff[0], src + goff[0], 4);
          if (goff[1] >= 0)
            __pipeline_memcpy_async(dst + soff[1], src + goff[1], 4);
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);    // the round before's copies have landed
    __syncwarp();
    if (landing > published) {
      if (lane == 0) store_release(ring.ready, landing);
      published = landing;
    } else if (target <= requested) {
      __nanosleep(64);           // nothing to copy, nothing to publish
    }
    landing = requested = max(requested, target);
  }
  __pipeline_wait_prior(0);
}

// A stream's view of its warp's ring.
struct Staged {
  Ring ring;
  int lane, ready, t_pub;

  // Top of a step; t is the stream's tick. Publishes the tick of the step
  // before: that step's reads may still be in flight, the ones before it
  // have returned (this step's t was computed from them).
  __device__ __forceinline__ void step(int t) {
    *const_cast<volatile int*>(ring.pub + lane) = t_pub;
    t_pub = t;
    ready = load_acquire(ring.ready);
  }

  // The FIR output of tick tau for stream b; 0 unless fired.
  __device__ __forceinline__ float2 tick(const float* __restrict__ Ft,
                                         bool fired, int tau, int B,
                                         int b) const {
    if (!fired) return make_float2(0.0f, 0.0f);
    if (tau < ready) {
      const float* s = ring.ticks + (tau & (kRing - 1)) * kRowFloats + lane;
      return make_float2(s[0], s[kWarp]);
    }
    return make_float2(Ft[(2 * (size_t)tau) * B + b],
                       Ft[(2 * (size_t)tau + 1) * B + b]);
  }
};

// Entry of a kernel's thread: sets the stream b this thread runs and its
// view of the ring. Warp 1 stages the block's ticks here and is done.
// Returns whether the thread has a stream to run.
__device__ __forceinline__ bool enter(float* smem, const float* Ft, int B,
                                      int T, int* b, Staged* st) {
  const int lane = threadIdx.x % kWarp;
  const int b0 = blockIdx.x * kWarp;
  *b = b0 + lane;
  const bool runs = threadIdx.x < kWarp && *b < B;
  st->ring = ring_of(smem);
  st->lane = lane;
  st->ready = st->t_pub = 0;
  if (threadIdx.x < kWarp) st->ring.pub[lane] = runs ? 0 : T;
  if (threadIdx.x == 0) *st->ring.ready = 0;
  __syncthreads();
  if (threadIdx.x >= kWarp) stage_ticks(st->ring, Ft, B, T, b0, lane);
  return runs;
}

// A stream needs no more ticks: lets the copying warp finish.
__device__ __forceinline__ void leave(const Staged& st, int T) {
  *const_cast<volatile int*>(st.ring.pub + st.lane) = T;
}

// QPSK (demod/scan.py _make_symbol_step): one fire per step, threshold
// 2*pi, and the loop update on every fired symbol. It keeps its own inline
// chain rather than the helpers the OQPSK kernel below is built on: built
// on them it computed the same bits 5.5-7.5 % slower on the H100
// (PERF.md).
__global__ void __launch_bounds__(kThreads)
block_demod_kernel(const float* __restrict__ Ft,
                   const float* __restrict__ fs_in,
                   const int* __restrict__ is_in,
                   float* __restrict__ fs_out, int* __restrict__ is_out,
                   float* __restrict__ sym_re, float* __restrict__ sym_im,
                   int* __restrict__ valid, int* __restrict__ lonce_out,
                   const Params p, int B, int S, int block_ticks, int K) {
  extern __shared__ __align__(16) float smem[];
  int b;
  Staged stage;
  if (!enter(smem, Ft, B, block_ticks, &b, &stage)) return;

  float tp = fs_in[F_TPHASE * B + b];
  float tf = fs_in[F_TFREQ * B + b];
  float prev = fs_in[F_TPREV * B + b];
  float pp = fs_in[F_PPHASE * B + b];
  float pf = fs_in[F_PFREQ * B + b];
  float perr = fs_in[F_PERR * B + b];
  float updown = fs_in[F_UPDOWN * B + b];
  float gain = fs_in[F_GAIN * B + b];
  float bre = fs_in[F_BIASRE * B + b];
  float bim = fs_in[F_BIASIM * B + b];
  int locked = is_in[I_LOCKED * B + b];
  int lonce = is_in[I_LOCKED_ONCE * B + b];
  int flags = is_in[I_FLAGS * B + b];
  int t = 0;                      // carry.tick is zeroed at block entry

  for (int s = 0; s < S; ++s) {
    stage.step(t);
    // ---- NCO sine, cosine and phase advance (pll.c:50-97): they need only
    // the carry, so they come first and overlap the gate and the tick read
    const float sn = fast_sin(-pp, p);
    const float cs = fast_sin(__fadd_rn(-pp, p.half_pi), p);
    float pp_adv = __fadd_rn(pp, pf);
    if (pp_adv >= p.two_pi) pp_adv = __fsub_rn(pp_adv, p.two_pi);
    // ---- closed-form timing gate: the phase advances by ONE add of the
    // selected product -----------------------------------------------------
    const Gate g = gate(tp, tf, p.two_pi, block_ticks - t, K, p);
    const bool fired = g.fired;
    tp = __fadd_rn(tp, g.prod);
    const int tau = t + g.k - 1;
    t += g.k;

    // ---- the fired tick (0 when not fired) ------------------------------
    const float2 z = stage.tick(Ft, fired, tau, B, b);
    const float z_re = z.x, z_im = z.y;

    // ---- AGC (agc.c:12-25) ----------------------------------------------
    const float bre_n = __fadd_rn(__fmul_rn(bre, p.bias_keep),
                                  __fmul_rn(p.bias_pole, z_re));
    const float bim_n = __fadd_rn(__fmul_rn(bim, p.bias_keep),
                                  __fmul_rn(p.bias_pole, z_im));
    const float zr = __fmul_rn(__fsub_rn(z_re, bre_n), gain);
    const float zi = __fmul_rn(__fsub_rn(z_im, bim_n), gain);
    const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(zr, zr),
                                           __fmul_rn(zi, zi)));
    float gain_n = __fadd_rn(gain, __fmul_rn(p.gain_pole,
                                             __fsub_rn(p.agc_target, mag)));
    gain_n = gain_n > 0.0f ? gain_n : 0.0f;

    // ---- PLL mix (pll.c:50-97) ------------------------------------------
    const float mre = __fsub_rn(__fmul_rn(zr, cs), __fmul_rn(zi, sn));
    const float mim = __fadd_rn(__fmul_rn(zr, sn), __fmul_rn(zi, cs));

    // ---- M&M retiming (timing.c:59-95) ----------------------------------
    const float sgn_prev = prev < 0.0f ? -1.0f : 1.0f;
    const float sgn_cur = mim < 0.0f ? -1.0f : 1.0f;
    const float err_t = __fsub_rn(__fmul_rn(sgn_prev, mim),
                                  __fmul_rn(sgn_cur, prev));
    const float tp_upd = __fsub_rn(tp, __fadd_rn(p.two_pi,
                                                 __fmul_rn(p.a_t, err_t)));
    float fd = __fsub_rn(__fsub_rn(tf, p.t_center), __fmul_rn(p.b_t, err_t));
    fd = fd < p.t_dev ? fd : p.t_dev;
    fd = fd > -p.t_dev ? fd : -p.t_dev;
    const float tf_upd = __fadd_rn(p.t_center, fd);

    // ---- Costas update (pll.c:99-130) -----------------------------------
    const float e = __fsub_rn(__fmul_rn(lut_tanh(mre, p), mim),
                              __fmul_rn(lut_tanh(mim, p), mre));
    const float pp_upd = fmodf(__fadd_rn(pp_adv, __fmul_rn(p.a_p, e)),
                               p.two_pi);
    float pf_upd = __fadd_rn(pf, __fmul_rn(p.b_p, e));
    const float err_upd = __fadd_rn(__fmul_rn(perr, p.err_keep),
                                    __fmul_rn(fabsf(e), p.err_pole));
    const bool lock_now = err_upd < p.lock_th && locked == 0;
    const bool unlock_now = err_upd > p.unlock_th && locked == 1;
    const int locked_upd = lock_now ? 1 : (unlock_now ? 0 : locked);
    const int lonce_upd = lock_now ? 1 : lonce;
    if (locked_upd == 0) pf_upd = __fadd_rn(pf_upd, __fmul_rn(p.sweep, updown));
    const float updown_upd = pf_upd >= p.fmax ? -1.0f
                             : (pf_upd <= -p.fmax ? 1.0f : updown);
    pf_upd = pf_upd < p.fmax ? pf_upd : p.fmax;
    pf_upd = pf_upd > -p.fmax ? pf_upd : -p.fmax;

    // ---- gated state writes ---------------------------------------------
    if (fired) {
      tp = tp_upd;
      tf = tf_upd;
      prev = mim;
      pp = pp_upd;
      pf = pf_upd;
      perr = err_upd;
      locked = locked_upd;
      lonce = lonce_upd;
      updown = updown_upd;
      gain = gain_n;
      bre = bre_n;
      bim = bim_n;
    }
    const size_t row = (size_t)s * B + b;
    sym_re[row] = mre;
    sym_im[row] = mim;
    valid[row] = fired ? 1 : 0;
    lonce_out[row] = lonce;
  }
  leave(stage, block_ticks);

  if (t < block_ticks) flags |= kFlagUnconsumed;
  fs_out[F_TPHASE * B + b] = tp;
  fs_out[F_TFREQ * B + b] = tf;
  fs_out[F_TPREV * B + b] = prev;
  fs_out[F_PPHASE * B + b] = pp;
  fs_out[F_PFREQ * B + b] = pf;
  fs_out[F_PERR * B + b] = perr;
  fs_out[F_UPDOWN * B + b] = updown;
  fs_out[F_GAIN * B + b] = gain;
  fs_out[F_BIASRE * B + b] = bre;
  fs_out[F_BIASIM * B + b] = bim;
  fs_out[F_INPHASE * B + b] = fs_in[F_INPHASE * B + b];
  is_out[I_LOCKED * B + b] = locked;
  is_out[I_LOCKED_ONCE * B + b] = lonce;
  is_out[I_SLOT * B + b] = is_in[I_SLOT * B + b];
  is_out[I_TICK * B + b] = 0;
  is_out[I_FLAGS * B + b] = flags;
}

// ---- OQPSK ---------------------------------------------------------------

// AGC (agc.c:12-25) on the fired tick z (0 on a non-fire): the new bias and
// gain, and the corrected sample (zr, zi).
struct Agc {
  float bre, bim, gain, zr, zi;
};

// The AGC's first half: the bias tracker and the corrected sample, the gain
// left as it came.
__device__ __forceinline__ Agc agc_sample(float2 z, float bre, float bim,
                                          float gain, const Params& p) {
  Agc a;
  a.bre = __fadd_rn(__fmul_rn(bre, p.bias_keep), __fmul_rn(p.bias_pole, z.x));
  a.bim = __fadd_rn(__fmul_rn(bim, p.bias_keep), __fmul_rn(p.bias_pole, z.y));
  a.zr = __fmul_rn(__fsub_rn(z.x, a.bre), gain);
  a.zi = __fmul_rn(__fsub_rn(z.y, a.bim), gain);
  a.gain = gain;
  return a;
}

// The AGC's second half: the gain after the sample (zr, zi) of agc_sample.
__device__ __forceinline__ void agc_gain(Agc& a, const Params& p) {
  const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(a.zr, a.zr),
                                         __fmul_rn(a.zi, a.zi)));
  const float g = __fadd_rn(a.gain, __fmul_rn(p.gain_pole,
                                              __fsub_rn(p.agc_target, mag)));
  a.gain = g > 0.0f ? g : 0.0f;
}

// Both halves.
__device__ __forceinline__ Agc agc(float2 z, float bre, float bim, float gain,
                                   const Params& p) {
  Agc a = agc_sample(z, bre, bim, gain, p);
  agc_gain(a, p);
  return a;
}

// The NCO's sine and cosine of -pp (pll.c:50-97).
struct Nco {
  float sn, cs;
};

__device__ __forceinline__ Nco nco(float pp, const Params& p) {
  return {fast_sin(-pp, p), fast_sin(__fadd_rn(-pp, p.half_pi), p)};
}

// PLL mix (pll.c:50-97): (zr + j zi) rotated by -pp, given nco(pp).
__device__ __forceinline__ float2 mix(const Agc& a, const Nco& n) {
  return make_float2(__fsub_rn(__fmul_rn(a.zr, n.cs), __fmul_rn(a.zi, n.sn)),
                     __fadd_rn(__fmul_rn(a.zr, n.sn), __fmul_rn(a.zi, n.cs)));
}

// One NCO phase advance per fire, wrapped below 2*pi.
__device__ __forceinline__ float advance(float pp, float pf, const Params& p) {
  const float a = __fadd_rn(pp, pf);
  return a >= p.two_pi ? __fsub_rn(a, p.two_pi) : a;
}

// The carry a kernel keeps in registers; a completed symbol updates the
// loop part (tp .. lonce).
struct State {
  float tp, tf, prev, pp, pf, perr, updown;
  int locked, lonce;
  float gain, bre, bim, inphase;
  int slot, flags;
};

__device__ __forceinline__ State load_state(const float* __restrict__ fs,
                                            const int* __restrict__ is,
                                            int B, int b) {
  State s;
  s.tp = fs[F_TPHASE * B + b];
  s.tf = fs[F_TFREQ * B + b];
  s.prev = fs[F_TPREV * B + b];
  s.pp = fs[F_PPHASE * B + b];
  s.pf = fs[F_PFREQ * B + b];
  s.perr = fs[F_PERR * B + b];
  s.updown = fs[F_UPDOWN * B + b];
  s.gain = fs[F_GAIN * B + b];
  s.bre = fs[F_BIASRE * B + b];
  s.bim = fs[F_BIASIM * B + b];
  s.inphase = fs[F_INPHASE * B + b];
  s.locked = is[I_LOCKED * B + b];
  s.lonce = is[I_LOCKED_ONCE * B + b];
  s.slot = is[I_SLOT * B + b];
  s.flags = is[I_FLAGS * B + b];
  return s;
}

// The carry after the block: tick reset to 0, FLAG_UNCONSUMED where the
// steps ran out before the block's ticks (t of them consumed).
__device__ __forceinline__ void store_state(State s, int t, int block_ticks,
                                            float* __restrict__ fs,
                                            int* __restrict__ is, int B,
                                            int b) {
  if (t < block_ticks) s.flags |= kFlagUnconsumed;
  fs[F_TPHASE * B + b] = s.tp;
  fs[F_TFREQ * B + b] = s.tf;
  fs[F_TPREV * B + b] = s.prev;
  fs[F_PPHASE * B + b] = s.pp;
  fs[F_PFREQ * B + b] = s.pf;
  fs[F_PERR * B + b] = s.perr;
  fs[F_UPDOWN * B + b] = s.updown;
  fs[F_GAIN * B + b] = s.gain;
  fs[F_BIASRE * B + b] = s.bre;
  fs[F_BIASIM * B + b] = s.bim;
  fs[F_INPHASE * B + b] = s.inphase;
  is[I_LOCKED * B + b] = s.locked;
  is[I_LOCKED_ONCE * B + b] = s.lonce;
  is[I_SLOT * B + b] = s.slot;
  is[I_TICK * B + b] = 0;
  is[I_FLAGS * B + b] = s.flags;
}

// The AGC's new bias and gain written into the carry (a fired tick's).
__device__ __forceinline__ void take_agc(State& s, const Agc& a) {
  s.bre = a.bre;
  s.bim = a.bim;
  s.gain = a.gain;
}

// The per-symbol loop update on the completed symbol (sym_re, sym_im): the
// M&M retime (timing.c:59-95) from the gate-advanced timing phase tp, and
// the Costas/lock/sweep update (pll.c:99-130) from the fire-advanced NCO
// phase pp; every other input is the carry before the symbol.
__device__ __forceinline__ void loop_update(State& s, float sym_re,
                                            float sym_im, float tp, float pp,
                                            const Params& p) {
  const float sgn_prev = s.prev < 0.0f ? -1.0f : 1.0f;
  const float sgn_cur = sym_im < 0.0f ? -1.0f : 1.0f;
  const float err_t = __fsub_rn(__fmul_rn(sgn_prev, sym_im),
                                __fmul_rn(sgn_cur, s.prev));
  s.tp = __fsub_rn(tp, __fadd_rn(p.two_pi, __fmul_rn(p.a_t, err_t)));
  float fd = __fsub_rn(__fsub_rn(s.tf, p.t_center), __fmul_rn(p.b_t, err_t));
  fd = fd < p.t_dev ? fd : p.t_dev;
  fd = fd > -p.t_dev ? fd : -p.t_dev;
  s.tf = __fadd_rn(p.t_center, fd);
  s.prev = sym_im;

  const float e = __fsub_rn(__fmul_rn(lut_tanh(sym_re, p), sym_im),
                            __fmul_rn(lut_tanh(sym_im, p), sym_re));
  s.pp = fmodf(__fadd_rn(pp, __fmul_rn(p.a_p, e)), p.two_pi);
  float pf = __fadd_rn(s.pf, __fmul_rn(p.b_p, e));
  s.perr = __fadd_rn(__fmul_rn(s.perr, p.err_keep),
                     __fmul_rn(fabsf(e), p.err_pole));
  const bool lock_now = s.perr < p.lock_th && s.locked == 0;
  const bool unlock_now = s.perr > p.unlock_th && s.locked == 1;
  s.locked = lock_now ? 1 : (unlock_now ? 0 : s.locked);
  if (lock_now) s.lonce = 1;
  if (s.locked == 0) pf = __fadd_rn(pf, __fmul_rn(p.sweep, s.updown));
  s.updown = pf >= p.fmax ? -1.0f : (pf <= -p.fmax ? 1.0f : s.updown);
  pf = pf < p.fmax ? pf : p.fmax;
  pf = pf > -p.fmax ? pf : -p.fmax;
  s.pf = pf;
}

// One row of the (rows, B) outputs.
__device__ __forceinline__ void put_row(float* __restrict__ sym_re,
                                        float* __restrict__ sym_im,
                                        int* __restrict__ valid,
                                        int* __restrict__ lonce_out, int row,
                                        int B, int b, float re, float im,
                                        bool ok, int lonce) {
  const size_t i = (size_t)row * B + b;
  sym_re[i] = re;
  sym_im[i] = im;
  valid[i] = ok ? 1 : 0;
  lonce_out[i] = lonce;
}

// OQPSK (demod/scan.py _make_paired_step and the pre-fire of
// make_block_demod): row 0 is the block-entry completion pre-fire, the Q
// fire of a symbol split across the block boundary (entry slot == 2); rows
// 1..S are the paired steps, each the I half-fire (transaction A, threshold
// slot*pi) and then the Q fire (transaction B, attempted only after A
// fired), with ONE loop update per completed symbol. B mixes with A's
// advanced NCO phase and runs its AGC from A's results; both gates use the
// entry timing frequency.
__global__ void __launch_bounds__(kThreads)
block_demod_oqpsk_kernel(const float* __restrict__ Ft,
                         const float* __restrict__ fs_in,
                         const int* __restrict__ is_in,
                         float* __restrict__ fs_out, int* __restrict__ is_out,
                         float* __restrict__ sym_re,
                         float* __restrict__ sym_im,
                         int* __restrict__ valid, int* __restrict__ lonce_out,
                         const Params p, int B, int S, int block_ticks,
                         int K) {
  extern __shared__ __align__(16) float smem[];
  int b;
  Staged stage;
  if (!enter(smem, Ft, B, block_ticks, &b, &stage)) return;
  State s = load_state(fs_in, is_in, B, b);
  const float pi = __fmul_rn(p.two_pi, 0.5f);   // fl(pi): two_pi is 2*fl(pi)
  int t = 0;                      // carry.tick is zeroed at block entry
  stage.step(t);

  // ---- block-entry completion pre-fire (row 0; zeros where not split) ---
  float pre_re = 0.0f, pre_im = 0.0f;
  bool pre_ok = false;
  if (s.slot == 2) {
    const Gate g = gate(s.tp, s.tf, p.two_pi, block_ticks, K, p);
    const float tp = __fadd_rn(s.tp, g.prod);
    t = g.k;
    const Agc a = agc(stage.tick(Ft, g.fired, t - 1, B, b), s.bre, s.bim,
                      s.gain, p);
    pre_re = s.inphase;
    pre_im = mix(a, nco(s.pp, p)).y;
    pre_ok = g.fired;
    State u = s;
    loop_update(u, pre_re, pre_im, tp, advance(s.pp, s.pf, p), p);
    take_agc(u, a);
    u.slot = 1;
    if (!g.fired) {
      // Deferred completion: the pairing below would run misaligned, so
      // the block is flagged for the oracle's replay.
      u = s;
      u.tp = tp;
      u.flags |= kFlagWindowMiss;
    }
    s = u;
  }
  put_row(sym_re, sym_im, valid, lonce_out, 0, B, b, pre_re, pre_im, pre_ok,
          s.lonce);

  for (int step = 0; step < S; ++step) {
    stage.step(t);
    // The NCO phase after A's fire, and the sine and cosine A's and B's
    // mixes need: they depend only on the carry, so they come first and
    // overlap the gates and the tick reads.
    const float pp_a = advance(s.pp, s.pf, p);
    const Nco n0 = nco(s.pp, p), n1 = nco(pp_a, p);
    // ---- transaction A: the I half-fire --------------------------------
    const Gate ga = gate(s.tp, s.tf, __fmul_rn(__int2float_rn(s.slot), pi),
                         block_ticks - t, K, p);
    const float tp1 = __fadd_rn(s.tp, ga.prod);
    const int t1 = t + ga.k;
    const Agc a = agc(stage.tick(Ft, ga.fired, t1 - 1, B, b), s.bre, s.bim,
                      s.gain, p);
    const float mreA = mix(a, n0).x;
    State s1 = s;                 // the carry after A
    if (ga.fired) {
      take_agc(s1, a);
      s1.pp = pp_a;
      if (s.slot == 1) s1.inphase = mreA;
      s1.slot = s.slot == 1 ? 2 : 1;
    }

    // ---- transaction B: the Q fire, attempted only after A fired -------
    Gate gb = {false, 0, 0.0f};
    if (ga.fired) {
      gb = gate(tp1, s.tf, __fmul_rn(__int2float_rn(s1.slot), pi),
                block_ticks - t1, K, p);
      if (!gb.fired && block_ticks - t1 > K) s1.flags |= kFlagWindowMiss;
    }
    const float tp2 = __fadd_rn(tp1, gb.prod);
    t = t1 + gb.k;
    Agc q = agc_sample(stage.tick(Ft, gb.fired, t - 1, B, b), s1.bre, s1.bim,
                       s1.gain, p);
    const float mimB = mix(q, ga.fired ? n1 : n0).y;
    const float pp2 = gb.fired ? advance(s1.pp, s.pf, p) : s1.pp;

    // ---- the symbol and ONE loop update (Q fires of slot 2 only) -------
    const bool do_update = gb.fired && s1.slot == 2;
    if (gb.fired) s1.slot = s1.slot == 1 ? 2 : 1;
    State u = s1;
    loop_update(u, s1.inphase, mimB, tp2, pp2, p);
    if (!do_update) {
      u = s1;
      u.tp = tp2;
      u.pp = pp2;
    }
    s1 = u;
    // B's gain is the next step's: its sqrt comes after the loop update.
    agc_gain(q, p);
    if (gb.fired) take_agc(s1, q);
    put_row(sym_re, sym_im, valid, lonce_out, step + 1, B, b, s1.inphase,
            mimB, do_update, s1.lonce);
    s = s1;
  }
  leave(stage, block_ticks);
  store_state(s, t, block_ticks, fs_out, is_out, B, b);
}

}  // namespace

extern "C" {

// Launch the QPSK (block_demod_launch) or OQPSK (block_demod_oqpsk_launch)
// recurrence on `stream` (a cudaStream_t) of the current device, which the
// caller sets to the device that holds the tensors. `params` is a host
// array of n_params floats laid out as Params. The outputs sym_re, sym_im,
// valid and lonce_out hold S rows of B for QPSK and S+1 for OQPSK. Return
// cudaErrorInvalidValue when n_params does not match Params, else
// cudaGetLastError() after the launch: 0 when the launch was accepted.
int block_demod_launch(const float* Ft, const float* fs_in, const int* is_in,
                       float* fs_out, int* is_out, float* sym_re,
                       float* sym_im, int* valid, int* lonce_out,
                       const float* params, int n_params, int B, int S,
                       int block_ticks, int K, void* stream) {
  if (n_params != kNumParams) return (int)cudaErrorInvalidValue;
  Params p;
  memcpy(&p, params, sizeof(Params));
  const int grid = (B + kWarp - 1) / kWarp;
  block_demod_kernel<<<grid, kThreads, kSharedBytes, (cudaStream_t)stream>>>(
          Ft, fs_in, is_in, fs_out, is_out, sym_re, sym_im, valid, lonce_out,
          p, B, S, block_ticks, K);
  return (int)cudaGetLastError();
}

int block_demod_oqpsk_launch(const float* Ft, const float* fs_in,
                             const int* is_in, float* fs_out, int* is_out,
                             float* sym_re, float* sym_im, int* valid,
                             int* lonce_out, const float* params,
                             int n_params, int B, int S, int block_ticks,
                             int K, void* stream) {
  if (n_params != kNumParams) return (int)cudaErrorInvalidValue;
  Params p;
  memcpy(&p, params, sizeof(Params));
  const int grid = (B + kWarp - 1) / kWarp;
  block_demod_oqpsk_kernel<<<grid, kThreads, kSharedBytes, (cudaStream_t)stream>>>(
          Ft, fs_in, is_in, fs_out, is_out, sym_re, sym_im, valid, lonce_out,
          p, B, S, block_ticks, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
