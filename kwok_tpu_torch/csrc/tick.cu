// K fused lifecycle-tick substeps for one resource kind, one thread per row.
//
// Replaces the Pallas TPU kernel kwok_tpu/ops/pallas_tick.py::_kernel
// (launched by PallasTickKernel._build through pl.pallas_call), with its
// RNG helpers _mix and _uniform01. Semantics are that kernel's exactly:
// per substep s at now = now0 + s*dt,
//   1. first-match-wins over R < 32 rules (phase bit, deletion mode,
//      selector bit), then the optional weighted draw with sticky choice;
//   2. re-arm when the best rule changed, with a constant, uniform or
//      capped-exponential delay drawn from the counter hash;
//   3. fire when now >= fire_at: phase, cond = (cond & ~assign) | value,
//      gen += 1, dirty or deleted;
//   4. the schedule-anchored heartbeat wheel.
// The three masks are OR'd over the substeps; transition and heartbeat
// counts are summed per block and added with one int atomic per block.
//
// Bound. The work is a few dozen integer and float operations per row per
// substep, far below the card's rates; the bytes bound it. State is read
// once and written once per dispatch, whatever K is: reads are 30 B a row
// (active and has_deletion 1 B, phase/cond/sel/pending/fire_at/hb_due/gen
// 4 B each), writes are 27 B (six 4 B fields plus three 1 B masks), about
// 57 B a row. At 1,058,816 rows (1,048,576 pods + 10,240 nodes) that is
// about 60 MB, about 18 us at 3.35 TB/s.
//
// Design against that bound:
// - all K substeps run in registers; nothing but the final state and the
//   masks goes back to device memory (the Pallas kernel kept a VMEM block
//   resident for the same reason);
// - neighbouring threads own neighbouring rows, so every load and store
//   is coalesced; the ragged tail (capacity not a multiple of the block)
//   is masked, so any capacity is accepted;
// - the rule table (11 words x 32 rules) sits in shared memory.
//
// Arithmetic. The file is compiled with -fmad=false and the float steps
// that decide a transition use the _rn intrinsics as well, so
// now0 + s*dt, a + (b-a)*u and the weighted sums round exactly like the
// reference (no FMA contraction that could move now >= fire_at across a
// substep boundary). logf may differ from XLA's log by an ulp, so
// exponential delays agree to a tolerance, not bit for bit.

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRules = 32;
constexpr int kThreads = 256;

// Rule-table word rows, each kMaxRules wide (floats travel as their bits).
enum RuleRow {
  kFromMask = 0,
  kDeletion,
  kSelBit,
  kDelayKind,
  kDelayA,
  kDelayB,
  kToPhase,
  kCondAssign,
  kCondValue,
  kIsDelete,
  kWeight,
  kRuleRows,
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

// u in [1e-7, 1) from (row id, substep, seed): the top 23 hash bits become
// the mantissa of a float in [1, 2), minus 1 (exact).
__device__ __forceinline__ float uniform01(uint32_t gid, uint32_t step,
                                           uint32_t seed) {
  uint32_t h = mix32(gid ^ (step * 0x9E3779B9u) ^ seed);
  float f = __fsub_rn(__uint_as_float((h >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(f, 1e-7f);
}

// Bit `bit` of `word`; a shift by 32 or more reads 0, as XLA's does.
__device__ __forceinline__ bool bit_set(uint32_t word, int bit) {
  const uint32_t b = static_cast<uint32_t>(bit);
  return b < 32u && ((word >> b) & 1u) == 1u;
}

__global__ void __launch_bounds__(kThreads)
tick_kernel(int cap, int steps, float now0, float dt, uint32_t seed,
            int num_rules, int has_weights, float hb_interval,
            uint32_t hb_phase_mask, int hb_sel_bit,
            const int32_t* __restrict__ rules,
            const uint8_t* __restrict__ active,
            const uint8_t* __restrict__ has_deletion,
            const uint32_t* __restrict__ sel_bits,
            int32_t* __restrict__ phase, uint32_t* __restrict__ cond,
            int32_t* __restrict__ pending, float* __restrict__ fire_at,
            float* __restrict__ hb_due, int32_t* __restrict__ gen,
            uint8_t* __restrict__ o_dirty, uint8_t* __restrict__ o_deleted,
            uint8_t* __restrict__ o_hb, int32_t* __restrict__ counts) {
  __shared__ int32_t s_rules[kRuleRows * kMaxRules];
  __shared__ int32_t s_sum[2][kThreads / 32];
  for (int i = threadIdx.x; i < kRuleRows * kMaxRules; i += blockDim.x) {
    s_rules[i] = rules[i];
  }
  __syncthreads();
  const int32_t* fm = s_rules + kFromMask * kMaxRules;
  const int32_t* del = s_rules + kDeletion * kMaxRules;
  const int32_t* sbit = s_rules + kSelBit * kMaxRules;
  const int32_t* dk_t = s_rules + kDelayKind * kMaxRules;
  const int32_t* da_t = s_rules + kDelayA * kMaxRules;
  const int32_t* db_t = s_rules + kDelayB * kMaxRules;
  const int32_t* tp_t = s_rules + kToPhase * kMaxRules;
  const int32_t* ca_t = s_rules + kCondAssign * kMaxRules;
  const int32_t* cv_t = s_rules + kCondValue * kMaxRules;
  const int32_t* isdel_t = s_rules + kIsDelete * kMaxRules;
  const int32_t* w_t = s_rules + kWeight * kMaxRules;

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int trans = 0;
  int hbs = 0;
  if (row < cap) {
    const bool act = active[row] != 0;
    const bool hdel = has_deletion[row] != 0;
    const uint32_t sel = sel_bits[row];
    int ph = phase[row];
    uint32_t cd = cond[row];
    int pd = pending[row];
    float fa = fire_at[row];
    float hd = hb_due[row];
    int g = gen[row];
    bool dirty_acc = false, del_acc = false, hb_acc = false;
    const uint32_t gid = static_cast<uint32_t>(row);
    const float ivl = hb_interval;

    for (int s = 0; s < steps; ++s) {
      const float now = __fadd_rn(now0, __fmul_rn(static_cast<float>(s), dt));
      bool can_fire = false, fired_delete = false;
      if (num_rules > 0) {
        int best = -1;
        uint32_t match = 0;
        for (int r = 0; r < num_rules; ++r) {
          const bool phase_ok = bit_set(static_cast<uint32_t>(fm[r]), ph);
          const int dm = del[r];
          const bool del_ok = (dm == -1) || ((dm == 1) == hdel);
          const int sb = sbit[r];
          const bool sel_ok = (sb < 0) || bit_set(sel, sb);
          const bool m = act && phase_ok && del_ok && sel_ok;
          if (m) match |= 1u << r;
          if (best < 0 && m) best = r;
        }
        if (has_weights) {
          // sticky weighted choice among all matching weighted rules
          float total = 0.0f;
          for (int r = 0; r < num_rules; ++r) {
            const float w = __int_as_float(w_t[r]);
            total = __fadd_rn(total, ((match >> r) & 1u) ? w : 0.0f);
          }
          const float u2 = uniform01(gid, static_cast<uint32_t>(s),
                                     seed ^ 0x55AA55AAu);
          const float target = __fmul_rn(u2, total);
          float cum = 0.0f, wbest = 0.0f, wpend = 0.0f;
          int chosen = -1;
          bool pend_m = false;
          for (int r = 0; r < num_rules; ++r) {
            const float w = __int_as_float(w_t[r]);
            const bool m = (match >> r) & 1u;
            cum = __fadd_rn(cum, m ? w : 0.0f);
            if (chosen < 0 && cum > target) chosen = r;
            if (best == r) wbest = w;
            if (pd == r) {
              pend_m = pend_m || m;
              wpend = w;
            }
          }
          const bool use_weighted = (best >= 0) && (wbest > 0.0f);
          const bool pend_valid = (pd >= 0) && pend_m && (wpend > 0.0f);
          if (use_weighted) best = pend_valid ? pd : chosen;
        }

        const bool rearm = act && (best != pd) && (best >= 0);
        const int rid = best > 0 ? best : 0;
        const int dk = dk_t[rid];
        const float a = __int_as_float(da_t[rid]);
        const float b = __int_as_float(db_t[rid]);
        const float u = uniform01(gid, static_cast<uint32_t>(s), seed);
        const float d_uniform = __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), u));
        float d_exp = __fmul_rn(-a, logf(u));
        if (b > 0.0f) d_exp = fminf(d_exp, b);
        const float delay = dk == 0 ? a : (dk == 1 ? d_uniform : d_exp);
        pd = act ? best : -1;
        fa = rearm ? __fadd_rn(now, delay) : (pd >= 0 ? fa : INFINITY);

        can_fire = act && (pd >= 0) && (now >= fa);
        const int frid = pd > 0 ? pd : 0;
        fired_delete = can_fire && (isdel_t[frid] != 0);
        if (can_fire) {
          ph = tp_t[frid];
          cd = (cd & ~static_cast<uint32_t>(ca_t[frid])) |
               static_cast<uint32_t>(cv_t[frid]);
          pd = -1;
          fa = INFINITY;
          g += 1;
        }
      }
      const bool dirty = can_fire && !fired_delete;

      // heartbeat wheel, schedule-anchored (Go time.Ticker semantics)
      bool hb_on = false;
      if (hb_phase_mask != 0u || hb_sel_bit >= 0) {
        hb_on = act;
        if (hb_phase_mask != 0u) hb_on = hb_on && bit_set(hb_phase_mask, ph);
        if (hb_sel_bit >= 0) hb_on = hb_on && bit_set(sel, hb_sel_bit);
      }
      const bool entered = hb_on && isinf(hd);
      const bool hb_fired = hb_on && (now >= hd);
      const bool on_schedule = __fsub_rn(now, hd) < ivl;
      if (!hb_on) {
        hd = INFINITY;
      } else if (entered) {
        hd = __fadd_rn(now, ivl);
      } else if (hb_fired) {
        hd = on_schedule ? __fadd_rn(hd, ivl) : __fadd_rn(now, ivl);
      }

      dirty_acc = dirty_acc || dirty;
      del_acc = del_acc || fired_delete;
      hb_acc = hb_acc || hb_fired;
      trans += can_fire ? 1 : 0;
      hbs += hb_fired ? 1 : 0;
    }

    phase[row] = ph;
    cond[row] = cd;
    pending[row] = pd;
    fire_at[row] = fa;
    hb_due[row] = hd;
    gen[row] = g;
    o_dirty[row] = dirty_acc ? 1 : 0;
    o_deleted[row] = del_acc ? 1 : 0;
    o_hb[row] = hb_acc ? 1 : 0;
  }

  // block sums of the two counters: warp shuffle, then one atomic each
  for (int off = 16; off > 0; off >>= 1) {
    trans += __shfl_down_sync(0xffffffffu, trans, off);
    hbs += __shfl_down_sync(0xffffffffu, hbs, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[0][warp] = trans;
    s_sum[1][warp] = hbs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0, h = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      t += s_sum[0][w];
      h += s_sum[1][w];
    }
    if (t) atomicAdd(counts, t);
    if (h) atomicAdd(counts + 1, h);
  }
}

}  // namespace

extern "C" {

// Words in the rule table the caller packs: kRuleRows rows of kMaxRules.
int kwok_tick_table_words() { return kRuleRows * kMaxRules; }

// Launch on `stream`; `counts` must hold two zeroed int32. Returns
// cudaGetLastError() after the launch (0 = launched).
int kwok_tick_launch(int cap, int steps, float now0, float dt,
                     unsigned int seed, int num_rules, int has_weights,
                     float hb_interval, unsigned int hb_phase_mask,
                     int hb_sel_bit, const void* rules, const void* active,
                     const void* has_deletion, const void* sel_bits,
                     void* phase, void* cond, void* pending, void* fire_at,
                     void* hb_due, void* gen, void* o_dirty, void* o_deleted,
                     void* o_hb, void* counts, void* stream) {
  if (cap <= 0) return 0;
  if (num_rules < 0 || num_rules > kMaxRules) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (cap + kThreads - 1) / kThreads;
  tick_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cap, steps, now0, dt, seed, num_rules, has_weights, hb_interval,
      hb_phase_mask, hb_sel_bit, static_cast<const int32_t*>(rules),
      static_cast<const uint8_t*>(active),
      static_cast<const uint8_t*>(has_deletion),
      static_cast<const uint32_t*>(sel_bits), static_cast<int32_t*>(phase),
      static_cast<uint32_t*>(cond), static_cast<int32_t*>(pending),
      static_cast<float*>(fire_at), static_cast<float*>(hb_due),
      static_cast<int32_t*>(gen), static_cast<uint8_t*>(o_dirty),
      static_cast<uint8_t*>(o_deleted), static_cast<uint8_t*>(o_hb),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
