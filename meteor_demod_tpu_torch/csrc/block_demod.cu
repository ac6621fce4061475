// QPSK per-symbol demod recurrence for a batch of streams over one block.
//
// Replaces the Pallas TPU kernels of meteor_demod_tpu/kernels/block_demod.py
// (_make_kernel via make_pallas_batch_demod, and _make_kernel_dma via
// _make_dma_demod), QPSK single-fire body _make_step, with its device helpers
// _fast_sin_rows and _lut_tanh_rows. The TPU kernels select each fired tick
// from a prematerialized candidate window because the TPU vector unit cannot
// index per lane; here each thread reads its fired tick Ft[tau, {0,1}, b]
// directly, as demod/scalar.py does, so no window, DMA span or flag for a
// window miss exists.
//
// Design: one thread per stream, 128 threads per block, ceil(B/128) blocks.
// The whole carry stays in registers for the block's S steps. Outputs are
// (S, B) rows, so neighbouring threads store to neighbouring addresses.
//
// What bounds it: every step depends on the previous one (timing phase ->
// fired tick -> AGC -> mix -> M&M/Costas -> next timing phase), a serial
// chain of about 2.6 k steps per 8192-sample block, and each step makes one
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

}  // namespace

extern "C" {

// Launches the recurrence on `stream` (a cudaStream_t) of the current
// device, which the caller sets to the device that holds the tensors.
// `params` is a host array of n_params floats laid out as Params. Returns
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

}  // extern "C"
