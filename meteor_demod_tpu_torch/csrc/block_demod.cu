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
// Design: one thread per stream, 128 threads per block, ceil(B/128) blocks.
// The whole carry stays in registers for the block's S steps. Outputs are
// (rows, B), so neighbouring threads store to neighbouring addresses: S rows
// for QPSK, S+1 for OQPSK (row 0 the pre-fire).
//
// What bounds it: every step depends on the previous one (timing phase ->
// fired tick -> AGC -> mix -> M&M/Costas -> next timing phase), a serial
// chain of about 2.6 k steps per 8192-sample block (2.9 k paired steps of
// two fires each for OQPSK at 80 ksym/s), and each fire makes one
// data-dependent load of the fired tick's two floats, scattered across the
// block's FIR output. So the kernel is bound by latency, not by bytes or
// operations; a batch of B < 132*128 streams does not even fill the card.
// Making it fast (more streams per SM, prefetching the next candidate ticks)
// is later work.
//
// Numerics: the decision contract is bitwise against the numpy oracle
// (demod/scalar.py) given the same FIR output. Every multiply and add of the
// AGC, mix, M&M and Costas chains is written with __fmul_rn / __fadd_rn /
// __fsub_rn, which the compiler never contracts into an FMA, and the file is
// built with -fmad=false, IEEE sqrt and division, and no fast math
// (kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
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
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;

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
    // ---- closed-form timing gate (demod/scalar.py gate_fire_np) ---------
    // k* = min{k in [1, min(K, rem)] : fl(k*tf) >= fl(2pi - tp)}; a
    // non-fire consumes min(rem, K) ticks. The phase advances by ONE add
    // of the selected product.
    const float diff = __fsub_rn(p.two_pi, tp);
    const int kmax = min(K, block_ticks - t);
    bool fired = false;
    int k_sel = kmax;
    float prod_sel = 0.0f;
    for (int k = 1; k <= kmax; ++k) {
      const float prod = __fmul_rn(__int2float_rn(k), tf);
      if (prod >= diff) {
        fired = true;
        k_sel = k;
        prod_sel = prod;
        break;
      }
    }
    if (!fired && kmax > 0) prod_sel = __fmul_rn(__int2float_rn(kmax), tf);
    tp = __fadd_rn(tp, prod_sel);
    const int tau = t + k_sel - 1;
    t += k_sel;

    // ---- the fired tick, read directly (0 when not fired) ---------------
    float z_re = 0.0f, z_im = 0.0f;
    if (fired) {
      z_re = Ft[(2 * (size_t)tau) * B + b];
      z_im = Ft[(2 * (size_t)tau + 1) * B + b];
    }

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
    const float sn = fast_sin(-pp, p);
    const float cs = fast_sin(__fadd_rn(-pp, p.half_pi), p);
    const float mre = __fsub_rn(__fmul_rn(zr, cs), __fmul_rn(zi, sn));
    const float mim = __fadd_rn(__fmul_rn(zr, sn), __fmul_rn(zi, cs));
    float pp_adv = __fadd_rn(pp, pf);
    if (pp_adv >= p.two_pi) pp_adv = __fsub_rn(pp_adv, p.two_pi);

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

// Closed-form timing gate (demod/scalar.py gate_fire_np): fires at
// k = min{k in [1, min(K, rem)] : fl(k*tf) >= fl(thresh - tp)}. `k` is the
// ticks consumed (min(rem, K) on a non-fire) and `prod` = fl(k*tf), the one
// add the timing phase advances by (0 when k == 0).
struct Gate {
  bool fired;
  int k;
  float prod;
};

__device__ __forceinline__ Gate gate(float tp, float tf, float thresh, int rem,
                                     int K) {
  const float diff = __fsub_rn(thresh, tp);
  const int kmax = min(K, rem);
  for (int k = 1; k <= kmax; ++k) {
    const float prod = __fmul_rn(__int2float_rn(k), tf);
    if (prod >= diff) return {true, k, prod};
  }
  return {false, kmax, kmax > 0 ? __fmul_rn(__int2float_rn(kmax), tf) : 0.0f};
}

// The FIR output of tick tau for stream b, read directly; 0 unless fired.
__device__ __forceinline__ float2 tick(const float* __restrict__ Ft,
                                       bool fired, int tau, int B, int b) {
  if (!fired) return make_float2(0.0f, 0.0f);
  return make_float2(Ft[(2 * (size_t)tau) * B + b],
                     Ft[(2 * (size_t)tau + 1) * B + b]);
}

// AGC (agc.c:12-25) on the fired tick z (0 on a non-fire): the new bias and
// gain, and the corrected sample (zr, zi).
struct Agc {
  float bre, bim, gain, zr, zi;
};

__device__ __forceinline__ Agc agc(float2 z, float bre, float bim, float gain,
                                   const Params& p) {
  Agc a;
  a.bre = __fadd_rn(__fmul_rn(bre, p.bias_keep), __fmul_rn(p.bias_pole, z.x));
  a.bim = __fadd_rn(__fmul_rn(bim, p.bias_keep), __fmul_rn(p.bias_pole, z.y));
  a.zr = __fmul_rn(__fsub_rn(z.x, a.bre), gain);
  a.zi = __fmul_rn(__fsub_rn(z.y, a.bim), gain);
  const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(a.zr, a.zr),
                                         __fmul_rn(a.zi, a.zi)));
  const float g = __fadd_rn(gain, __fmul_rn(p.gain_pole,
                                            __fsub_rn(p.agc_target, mag)));
  a.gain = g > 0.0f ? g : 0.0f;
  return a;
}

// PLL mix (pll.c:50-97): (zr + j zi) rotated by -pp.
__device__ __forceinline__ float2 mix(const Agc& a, float pp,
                                      const Params& p) {
  const float sn = fast_sin(-pp, p);
  const float cs = fast_sin(__fadd_rn(-pp, p.half_pi), p);
  return make_float2(__fsub_rn(__fmul_rn(a.zr, cs), __fmul_rn(a.zi, sn)),
                     __fadd_rn(__fmul_rn(a.zr, sn), __fmul_rn(a.zi, cs)));
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
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  State s = load_state(fs_in, is_in, B, b);
  const float pi = __fmul_rn(p.two_pi, 0.5f);   // fl(pi): two_pi is 2*fl(pi)
  int t = 0;                      // carry.tick is zeroed at block entry

  // ---- block-entry completion pre-fire (row 0; zeros where not split) ---
  float pre_re = 0.0f, pre_im = 0.0f;
  bool pre_ok = false;
  if (s.slot == 2) {
    const Gate g = gate(s.tp, s.tf, p.two_pi, block_ticks, K);
    const float tp = __fadd_rn(s.tp, g.prod);
    t = g.k;
    const Agc a = agc(tick(Ft, g.fired, t - 1, B, b), s.bre, s.bim, s.gain,
                      p);
    pre_re = s.inphase;
    pre_im = mix(a, s.pp, p).y;
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
    // ---- transaction A: the I half-fire --------------------------------
    const Gate ga = gate(s.tp, s.tf, __fmul_rn(__int2float_rn(s.slot), pi),
                         block_ticks - t, K);
    const float tp1 = __fadd_rn(s.tp, ga.prod);
    const int t1 = t + ga.k;
    const Agc a = agc(tick(Ft, ga.fired, t1 - 1, B, b), s.bre, s.bim,
                      s.gain, p);
    const float mreA = mix(a, s.pp, p).x;
    State s1 = s;                 // the carry after A
    if (ga.fired) {
      take_agc(s1, a);
      s1.pp = advance(s.pp, s.pf, p);
      if (s.slot == 1) s1.inphase = mreA;
      s1.slot = s.slot == 1 ? 2 : 1;
    }

    // ---- transaction B: the Q fire, attempted only after A fired -------
    Gate gb = {false, 0, 0.0f};
    if (ga.fired) {
      gb = gate(tp1, s.tf, __fmul_rn(__int2float_rn(s1.slot), pi),
                block_ticks - t1, K);
      if (!gb.fired && block_ticks - t1 > K) s1.flags |= kFlagWindowMiss;
    }
    const float tp2 = __fadd_rn(tp1, gb.prod);
    t = t1 + gb.k;
    const Agc q = agc(tick(Ft, gb.fired, t - 1, B, b), s1.bre, s1.bim,
                      s1.gain, p);
    const float mimB = mix(q, s1.pp, p).y;
    const float pp2 = gb.fired ? advance(s1.pp, s.pf, p) : s1.pp;

    // ---- the symbol and ONE loop update (Q fires of slot 2 only) -------
    const bool do_update = gb.fired && s1.slot == 2;
    if (gb.fired) {
      take_agc(s1, q);
      s1.slot = s1.slot == 1 ? 2 : 1;
    }
    State u = s1;
    loop_update(u, s1.inphase, mimB, tp2, pp2, p);
    if (!do_update) {
      u = s1;
      u.tp = tp2;
      u.pp = pp2;
    }
    s1 = u;
    put_row(sym_re, sym_im, valid, lonce_out, step + 1, B, b, s1.inphase,
            mimB, do_update, s1.lonce);
    s = s1;
  }
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
  const int grid = (B + kThreads - 1) / kThreads;
  block_demod_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Ft, fs_in, is_in, fs_out, is_out, sym_re, sym_im, valid, lonce_out, p,
      B, S, block_ticks, K);
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
  const int grid = (B + kThreads - 1) / kThreads;
  block_demod_oqpsk_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Ft, fs_in, is_in, fs_out, is_out, sym_re, sym_im, valid, lonce_out, p,
      B, S, block_ticks, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
