// The lifecycle tick for Hopper: K fused substeps per row, one thread per
// row, and the dispatch's packed wire written by the kernel itself.
//
// Replaces the Pallas TPU kernel kwok_tpu/ops/pallas_tick.py::_kernel
// (launched by PallasTickKernel._build through pl.pallas_call), with its
// RNG helpers _mix and _uniform01, and the XLA program around it that
// packs the wire (kwok_tpu/ops/tick.py, MultiTickKernel with pack=True
// and pack_rows=True). Semantics are that kernel's exactly: per substep s
// at now = now0 + s*dt,
//   1. first-match-wins over R <= 32 rules (phase bit, deletion mode,
//      selector bit), then the optional weighted draw with sticky choice;
//   2. re-arm when the best rule changed, with a constant, uniform or
//      capped-exponential delay drawn from the counter hash;
//   3. fire when now >= fire_at: phase, cond = (cond & ~assign) | value,
//      gen += 1, dirty or deleted;
//   4. the schedule-anchored heartbeat wheel.
//
// Two entries share the per-row substeps (tick_row), so they cannot
// drift apart:
// - kwok_tick_dispatch + kwok_tick_epilogue, the engine's path: ONE
//   launch ticks every kind (the grid covers the kinds' rows end to end;
//   a block finds its kind in the by-value argument block) and writes the
//   wire: phase and cond rows, the three masks packed MSB-first over
//   3*cap bits, per-block partial counters and next_due; then a
//   single-block epilogue sums the partials into the wire's header and
//   ORs in the mask bytes that two blocks share. Nothing else runs on
//   the device between these two launches and the wire's copy to the
//   host.
// - kwok_tick_launch, one kind, masks as bytes and counters by atomics,
//   for callers that want the masks unpacked.
//
// Wire (the JAX package's layout, read by unpack_wire): int32
// transitions per kind, int32 heartbeats per kind, float32 next_due per
// kind; per kind (3*cap+7)/8 mask bytes, bit j of the kind's segment at
// byte j/8, bit 7 - j%8, dirty at j = row, deleted at cap + row, hb_fired
// at 2*cap + row; per kind cap phase bytes (the low byte of the phase id),
// then cap little-endian uint32 cond words. Offsets are not 4-aligned in
// general.
//
// Bound. A few dozen integer and float operations per row and substep
// against 30 B read (active, has_deletion 1 B; sel, phase, cond, pending,
// fire_at, hb_due, gen 4 B) and 24 B of state written back plus 5 B and
// 3 bits of wire: about 59.4 B a row. At 1,058,816 rows that is 62.9 MB,
// 18.8 us at 3.35 TB/s; at K=1 the bytes bound it. At K=16 the integer
// and special-function issue grows with K and can pass the byte bound.
//
// Design against that bound:
// - every substep runs in registers; the state is read once and written
//   once, and the wire goes out from the same registers: no byte masks,
//   no second pass over the rows, no host-visible intermediate;
// - neighbouring threads own neighbouring rows, so loads and stores are
//   coalesced; the ragged tail is masked, so any capacity is accepted;
// - matching is by bitmasks built once per block in shared memory: a
//   32-entry table of the rules whose from_mask holds each phase, and per
//   row, once per dispatch, the mask of rules whose deletion and selector
//   tests it passes; a substep is match = row_mask & phase_mask[phase] and
//   best = ffs(match) - 1. Only the phase changes between substeps;
// - the hash draw and logf run only when the row re-arms (u is used only
//   there), and the weighted draw only when a weighted rule is best and
//   the sticky pending choice is not valid; the weighted walk visits only
//   the set bits of match in the same order, so cum > target decides as
//   the full loop did and the result is bit for bit the same;
// - a warp packs its 32 mask bits with __ballot_sync; the block lays its
//   run of each mask out in shared memory and writes the bytes it owns
//   whole; a byte it shares with a neighbouring block, mask or shard
//   (capacities not a multiple of 8, or rows split at an odd base) goes
//   to the block's record with its partial value, and the epilogue
//   clears the byte and ORs every partial in with word atomics (a
//   dispatch whose runs all start and end on a byte has no such byte,
//   and its epilogue skips that pass);
// - counters and next_due are reduced by warp shuffles per block and
//   written as per-block partials, so no output needs zeroing first: the
//   wrapper allocates the wire and the records with torch.empty.
//
// Row base. The counter hash draws from the GLOBAL row id, row_base +
// row: under the row split (kwok_tpu_torch/parallel/) each shard is
// launched on its own rows with row_base at its first global row, so a
// split dispatch draws exactly what the unsplit one draws (the Pallas
// kernel's gid), and it writes its rows at the same place on the wire
// (wire_row, out of a kind of `total` rows).
//
// Arithmetic. The file is compiled with -fmad=false and the float steps
// that decide a transition use the _rn intrinsics as well, so
// now0 + s*dt, a + (b-a)*u and the weighted sums round exactly like the
// reference (no FMA contraction that could move now >= fire_at across a
// substep boundary). logf may differ from XLA's log by an ulp, so
// exponential delays agree to a tolerance, not bit for bit.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRules = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxKinds = 8;
// bytes a block's run of one mask can touch: 256 bits, one byte more when
// the run does not start on a byte boundary
constexpr int kRunBytes = kThreads / 8 + 1;
// int32 words a block leaves for the epilogue: kind, transitions,
// heartbeats, next_due bits, then per mask (head key, head byte, tail
// key, tail byte); a key is a wire byte offset, -1 for none
constexpr int kRecordWords = 4 + 3 * 4;
// int64 words of one kind's descriptor (kwok_tick_dispatch's desc)
constexpr int kDescWords = 23;
constexpr int kEpilogueThreads = 1024;

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

// One kind's rules, laid out for matching by bitmasks (shared memory).
struct RuleCache {
  uint32_t phase_mask[32];  // rules whose from_mask holds phase p
  uint32_t sel_mask[32];    // rules whose selector bit is b
  uint32_t nosel_mask;      // rules with no selector bit
  uint32_t del_mask[2];     // rules whose deletion test passes, has_deletion 0 / 1
  uint32_t delete_mask;     // rules whose effect deletes the object
  int32_t delay_kind[kMaxRules];
  float delay_a[kMaxRules];
  float delay_b[kMaxRules];
  float weight[kMaxRules];
  int32_t to_phase[kMaxRules];
  uint32_t cond_assign[kMaxRules];
  uint32_t cond_value[kMaxRules];
};

// The block builds `c` from the kind's packed table; ends in a barrier.
__device__ void load_rules(RuleCache& c, const int32_t* __restrict__ rules,
                           int num_rules) {
  const int t = threadIdx.x;
  if (t < 32) {
    uint32_t pm = 0u, sm = 0u;
    for (int r = 0; r < num_rules; ++r) {
      if (bit_set(static_cast<uint32_t>(rules[kFromMask * kMaxRules + r]), t)) {
        pm |= 1u << r;
      }
      if (rules[kSelBit * kMaxRules + r] == t) sm |= 1u << r;
    }
    c.phase_mask[t] = pm;
    c.sel_mask[t] = sm;
    c.delay_kind[t] = rules[kDelayKind * kMaxRules + t];
    c.delay_a[t] = __int_as_float(rules[kDelayA * kMaxRules + t]);
    c.delay_b[t] = __int_as_float(rules[kDelayB * kMaxRules + t]);
    c.weight[t] = __int_as_float(rules[kWeight * kMaxRules + t]);
    c.to_phase[t] = rules[kToPhase * kMaxRules + t];
    c.cond_assign[t] = static_cast<uint32_t>(rules[kCondAssign * kMaxRules + t]);
    c.cond_value[t] = static_cast<uint32_t>(rules[kCondValue * kMaxRules + t]);
  } else if (t == 32) {
    uint32_t nosel = 0u, del0 = 0u, del1 = 0u, dele = 0u;
    for (int r = 0; r < num_rules; ++r) {
      const uint32_t bit = 1u << r;
      if (rules[kSelBit * kMaxRules + r] < 0) nosel |= bit;
      // (dm == -1) || ((dm == 1) == has_deletion)
      const int dm = rules[kDeletion * kMaxRules + r];
      if (dm == -1 || dm != 1) del0 |= bit;
      if (dm == -1 || dm == 1) del1 |= bit;
      if (rules[kIsDelete * kMaxRules + r] != 0) dele |= bit;
    }
    c.nosel_mask = nosel;
    c.del_mask[0] = del0;
    c.del_mask[1] = del1;
    c.delete_mask = dele;
  }
  __syncthreads();
}

// The rules whose deletion and selector tests a row passes (0 when the
// row is inactive): fixed for the dispatch, since only the phase changes.
__device__ __forceinline__ uint32_t row_rules(const RuleCache& c, bool act,
                                              bool hdel, uint32_t sel) {
  if (!act) return 0u;
  uint32_t m = c.nosel_mask;
  for (uint32_t s = sel; s != 0u; s &= s - 1u) m |= c.sel_mask[__ffs(s) - 1];
  return m & c.del_mask[hdel ? 1 : 0];
}

// The weighted pick among the matching rules: the first rule index r <
// num_rules whose running sum of matching weights exceeds u2 * total, or
// -1. Rules that do not match add nothing, so only the set bits of
// `match` are visited; a run of non-matching rules between them sees the
// same sum, and the first of them decides when that sum already exceeds
// the target.
__device__ __forceinline__ int weighted_pick(const RuleCache& c, uint32_t match,
                                             int num_rules, float u2) {
  float total = 0.0f;
  for (uint32_t m = match; m != 0u; m &= m - 1u) {
    total = __fadd_rn(total, c.weight[__ffs(m) - 1]);
  }
  const float target = __fmul_rn(u2, total);
  float cum = 0.0f;
  int next = 0;
  for (uint32_t m = match; m != 0u; m &= m - 1u) {
    const int r = __ffs(m) - 1;
    if (next < r && cum > target) return next;
    cum = __fadd_rn(cum, c.weight[r]);
    if (cum > target) return r;
    next = r + 1;
  }
  return (next < num_rules && cum > target) ? next : -1;
}

// One kind's scalars.
struct KindRule {
  int num_rules;
  int has_weights;
  int hb_sel_bit;
  uint32_t hb_phase_mask;
  float hb_interval;
};

// A row's mutable state, in registers.
struct Row {
  int ph;
  uint32_t cd;
  int pd;
  float fa;
  float hd;
  int g;
};

// What K substeps of one row give back besides its state.
struct RowOut {
  bool dirty;
  bool deleted;
  bool hb;
  int trans;
  int hbs;
};

// K substeps of one row: the kernel's semantics, shared by both entries.
__device__ __forceinline__ RowOut tick_row(const RuleCache& c, const KindRule& k,
                                           int steps, float now0, float dt,
                                           uint32_t seed, uint32_t gid, bool act,
                                           uint32_t rmask, uint32_t sel, Row& r) {
  RowOut o = {false, false, false, 0, 0};
  const float ivl = k.hb_interval;
  const bool hb_rules = k.hb_phase_mask != 0u || k.hb_sel_bit >= 0;
  // one substep per trip (no unrolling): the loop body is what every row
  // issues per substep, which the SASS operation count reads
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const float now = __fadd_rn(now0, __fmul_rn(static_cast<float>(s), dt));
    bool can_fire = false, fired_delete = false;
    if (k.num_rules > 0) {
      const uint32_t match =
          rmask & (static_cast<uint32_t>(r.ph) < 32u ? c.phase_mask[r.ph] : 0u);
      int best = match != 0u ? __ffs(match) - 1 : -1;
      if (k.has_weights && best >= 0 && c.weight[best] > 0.0f) {
        // sticky weighted choice among all matching weighted rules
        const int pd = r.pd;
        const bool pend_valid = pd >= 0 && pd < kMaxRules &&
                                ((match >> pd) & 1u) != 0u && c.weight[pd] > 0.0f;
        best = pend_valid
                   ? pd
                   : weighted_pick(c, match, k.num_rules,
                                   uniform01(gid, static_cast<uint32_t>(s),
                                             seed ^ 0x55AA55AAu));
      }
      const bool rearm = act && (best != r.pd) && (best >= 0);
      r.pd = act ? best : -1;
      if (rearm) {
        // the draw is used only here: u and logf only for a re-arm
        const int dk = c.delay_kind[best];
        const float a = c.delay_a[best];
        float delay = a;
        if (dk != 0) {
          const float b = c.delay_b[best];
          const float u = uniform01(gid, static_cast<uint32_t>(s), seed);
          if (dk == 1) {
            delay = __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), u));
          } else {
            delay = __fmul_rn(-a, logf(u));
            if (b > 0.0f) delay = fminf(delay, b);
          }
        }
        r.fa = __fadd_rn(now, delay);
      } else if (r.pd < 0) {
        r.fa = INFINITY;
      }

      can_fire = act && (r.pd >= 0) && (now >= r.fa);
      if (can_fire) {
        const int f = r.pd;
        fired_delete = ((c.delete_mask >> f) & 1u) != 0u;
        r.ph = c.to_phase[f];
        r.cd = (r.cd & ~c.cond_assign[f]) | c.cond_value[f];
        r.pd = -1;
        r.fa = INFINITY;
        r.g += 1;
      }
    }
    const bool dirty = can_fire && !fired_delete;

    // heartbeat wheel, schedule-anchored (Go time.Ticker semantics)
    bool hb_on = false;
    if (hb_rules) {
      hb_on = act;
      if (k.hb_phase_mask != 0u) hb_on = hb_on && bit_set(k.hb_phase_mask, r.ph);
      if (k.hb_sel_bit >= 0) hb_on = hb_on && bit_set(sel, k.hb_sel_bit);
    }
    const bool entered = hb_on && isinf(r.hd);
    const bool hb_fired = hb_on && (now >= r.hd);
    const bool on_schedule = __fsub_rn(now, r.hd) < ivl;
    if (!hb_on) {
      r.hd = INFINITY;
    } else if (entered) {
      r.hd = __fadd_rn(now, ivl);
    } else if (hb_fired) {
      r.hd = on_schedule ? __fadd_rn(r.hd, ivl) : __fadd_rn(now, ivl);
    }

    o.dirty = o.dirty || dirty;
    o.deleted = o.deleted || fired_delete;
    o.hb = o.hb || hb_fired;
    o.trans += can_fire ? 1 : 0;
    o.hbs += hb_fired ? 1 : 0;
  }
  return o;
}

// One kind's state columns.
struct Columns {
  const uint8_t* active;
  const uint8_t* has_deletion;
  const uint32_t* sel_bits;
  int32_t* phase;
  uint32_t* cond;
  int32_t* pending;
  float* fire_at;
  float* hb_due;
  int32_t* gen;
};

__device__ __forceinline__ Row load_row(const Columns& s, int row) {
  return Row{s.phase[row], s.cond[row], s.pending[row],
             s.fire_at[row], s.hb_due[row], s.gen[row]};
}

__device__ __forceinline__ void store_row(const Columns& s, int row, const Row& r) {
  s.phase[row] = r.ph;
  s.cond[row] = r.cd;
  s.pending[row] = r.pd;
  s.fire_at[row] = r.fa;
  s.hb_due[row] = r.hd;
  s.gen[row] = r.g;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// ------------------------------------------------- per-kind entry

__global__ void __launch_bounds__(kThreads)
tick_kernel(int cap, int row_base, int steps, float now0, float dt,
            uint32_t seed, KindRule k, const int32_t* __restrict__ rules,
            Columns st, uint8_t* __restrict__ o_dirty,
            uint8_t* __restrict__ o_deleted, uint8_t* __restrict__ o_hb,
            int32_t* __restrict__ counts) {
  __shared__ RuleCache c;
  __shared__ int s_sum[2][kWarps];
  load_rules(c, rules, k.num_rules);

  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  int trans = 0, hbs = 0;
  if (row < cap) {
    const bool act = st.active[row] != 0;
    const uint32_t sel = st.sel_bits[row];
    const uint32_t rmask = row_rules(c, act, st.has_deletion[row] != 0, sel);
    Row r = load_row(st, row);
    const uint32_t gid =
        static_cast<uint32_t>(row_base) + static_cast<uint32_t>(row);
    const RowOut o = tick_row(c, k, steps, now0, dt, seed, gid, act, rmask, sel, r);
    store_row(st, row, r);
    o_dirty[row] = o.dirty ? 1 : 0;
    o_deleted[row] = o.deleted ? 1 : 0;
    o_hb[row] = o.hb ? 1 : 0;
    trans = o.trans;
    hbs = o.hbs;
  }

  // block sums of the two counters: warp shuffle, then one atomic each
  trans = warp_sum(trans);
  hbs = warp_sum(hbs);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[0][warp] = trans;
    s_sum[1][warp] = hbs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0, h = 0;
    for (int w = 0; w < kWarps; ++w) {
      t += s_sum[0][w];
      h += s_sum[1][w];
    }
    if (t) atomicAdd(counts, t);
    if (h) atomicAdd(counts + 1, h);
  }
}

// ------------------------------------------------- fused dispatch

// One kind of a fused launch.
struct KindArgs {
  Columns st;
  const int32_t* rules;
  long long mask_off;   // wire byte offset of the kind's mask segment
  long long phase_off;  // ... of its phase rows
  long long cond_off;   // ... of its cond rows
  int cap;              // rows in this launch
  int row_base;         // global row id of row 0 (the hash's row id)
  int wire_row;         // the place of row 0 among the kind's wire rows
  int total;            // the kind's rows on the wire (its mask width)
  int first_block;      // the kind's first block in the grid
  int kind;             // the kind's index in the wire's header
  KindRule k;
};

struct DispatchArgs {
  KindArgs kinds[kMaxKinds];
  int n_kinds;
  int steps;
  float now0;
  float dt;
  uint32_t seed;
  uint8_t* wire;
  int32_t* records;
};

__global__ void __launch_bounds__(kThreads)
fused_tick_kernel(const __grid_constant__ DispatchArgs a) {
  __shared__ RuleCache c;
  __shared__ uint32_t s_bits[3][kWarps];
  __shared__ int s_sum[2][kWarps];
  __shared__ float s_due[kWarps];

  // the block's kind: the last whose first block is at or before it (a
  // kind of no rows has no block and shares its first block with the next)
  int kk = 0;
  while (kk + 1 < a.n_kinds && static_cast<int>(blockIdx.x) >= a.kinds[kk + 1].first_block) {
    ++kk;
  }
  const KindArgs& ka = a.kinds[kk];
  load_rules(c, ka.rules, ka.k.num_rules);

  const int local = (static_cast<int>(blockIdx.x) - ka.first_block) * kThreads;
  const int row = local + static_cast<int>(threadIdx.x);
  int trans = 0, hbs = 0;
  float due = INFINITY;
  bool m_dirty = false, m_deleted = false, m_hb = false;
  if (row < ka.cap) {
    const bool act = ka.st.active[row] != 0;
    const uint32_t sel = ka.st.sel_bits[row];
    const uint32_t rmask = row_rules(c, act, ka.st.has_deletion[row] != 0, sel);
    Row r = load_row(ka.st, row);
    const uint32_t gid =
        static_cast<uint32_t>(ka.row_base) + static_cast<uint32_t>(row);
    const RowOut o =
        tick_row(c, ka.k, a.steps, a.now0, a.dt, a.seed, gid, act, rmask, sel, r);
    store_row(ka.st, row, r);
    const long long wrow = static_cast<long long>(ka.wire_row) + row;
    a.wire[ka.phase_off + wrow] = static_cast<uint8_t>(r.ph);
    uint8_t* cp = a.wire + ka.cond_off + 4 * wrow;
    if ((ka.cond_off & 3) == 0) {
      *reinterpret_cast<uint32_t*>(cp) = r.cd;  // little-endian, aligned
    } else {
      cp[0] = static_cast<uint8_t>(r.cd);
      cp[1] = static_cast<uint8_t>(r.cd >> 8);
      cp[2] = static_cast<uint8_t>(r.cd >> 16);
      cp[3] = static_cast<uint8_t>(r.cd >> 24);
    }
    // next_due: the earliest armed fire_at or heartbeat of an active row
    if (act) due = fminf(r.pd >= 0 ? r.fa : INFINITY, r.hd);
    m_dirty = o.dirty;
    m_deleted = o.deleted;
    m_hb = o.hb;
    trans = o.trans;
    hbs = o.hbs;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t b0 = __ballot_sync(0xffffffffu, m_dirty);
  const uint32_t b1 = __ballot_sync(0xffffffffu, m_deleted);
  const uint32_t b2 = __ballot_sync(0xffffffffu, m_hb);
  trans = warp_sum(trans);
  hbs = warp_sum(hbs);
  due = warp_min(due);
  if (lane == 0) {
    s_bits[0][warp] = b0;
    s_bits[1][warp] = b1;
    s_bits[2][warp] = b2;
    s_sum[0][warp] = trans;
    s_sum[1][warp] = hbs;
    s_due[warp] = due;
  }
  __syncthreads();

  int32_t* rec = a.records + static_cast<long long>(blockIdx.x) * kRecordWords;
  if (threadIdx.x == 0) {
    int t = 0, h = 0;
    float d = INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      t += s_sum[0][w];
      h += s_sum[1][w];
      d = fminf(d, s_due[w]);
    }
    rec[0] = ka.kind;
    rec[1] = t;
    rec[2] = h;
    rec[3] = __float_as_int(d);
  }

  // The block's run of mask m: its rows [local, local + nrows) are bits
  // [p0, p0 + nrows) of the kind's segment. A byte wholly inside the run
  // is written here; the first and the last byte, when the run covers
  // them only in part, go to the record for the epilogue.
  const int nrows = min(kThreads, ka.cap - local);
  for (int idx = threadIdx.x; idx < 3 * kRunBytes; idx += kThreads) {
    const int m = idx / kRunBytes;
    const long long p0 = static_cast<long long>(m) * ka.total + ka.wire_row + local;
    const long long first = p0 >> 3;
    const long long last = (p0 + nrows - 1) >> 3;
    const long long byte = first + idx % kRunBytes;
    if (byte > last) continue;
    uint32_t v = 0u;
    for (int q = 0; q < 8; ++q) {
      const long long j = byte * 8 + q - p0;  // the bit's row within the run
      if (j >= 0 && j < nrows) {
        v |= ((s_bits[m][j >> 5] >> (j & 31)) & 1u) << (7 - q);
      }
    }
    const bool whole = byte * 8 >= p0 && byte * 8 + 8 <= p0 + nrows;
    const int key = whole ? -1 : static_cast<int>(ka.mask_off + byte);
    if (whole) a.wire[ka.mask_off + byte] = static_cast<uint8_t>(v);
    int32_t* slot = rec + 4 + 4 * m;
    if (byte == first) {
      slot[0] = key;
      slot[1] = static_cast<int32_t>(v);
      if (last == first) slot[2] = -1;  // one byte: recorded once, as the head
    } else if (byte == last) {
      slot[2] = key;
      slot[3] = static_cast<int32_t>(v);
    }
  }
}

// One block: the header from the per-block partials, then the shared mask
// bytes. One pass reads each record's head (kind, counters, due) as one
// 16-byte load into per-kind sums, which the block then reduces. With
// `edges`, every recorded byte is first cleared, then (after a barrier)
// the partial values are OR'd in; the word atomics touch only that byte's
// bits, so the bytes around it, written by the dispatch, stay as they are.
// Without `edges` (every run of every kind starts and ends on a byte) no
// record holds a byte and the edge passes are skipped.
__global__ void __launch_bounds__(kEpilogueThreads)
tick_wire_epilogue(uint8_t* __restrict__ wire, const int32_t* __restrict__ records,
                   int n_blocks, int n_kinds, int edges) {
  __shared__ int s_t[kEpilogueThreads / 32];
  __shared__ int s_h[kEpilogueThreads / 32];
  __shared__ float s_d[kEpilogueThreads / 32];
  int32_t* counters = reinterpret_cast<int32_t*>(wire);
  float* dues = reinterpret_cast<float*>(wire + 8 * n_kinds);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int t[kMaxKinds], h[kMaxKinds];
  float d[kMaxKinds];
#pragma unroll
  for (int k = 0; k < kMaxKinds; ++k) {
    t[k] = 0;
    h[k] = 0;
    d[k] = INFINITY;
  }
  for (int b = threadIdx.x; b < n_blocks; b += blockDim.x) {
    const int4 r = *reinterpret_cast<const int4*>(
        records + static_cast<long long>(b) * kRecordWords);
#pragma unroll
    for (int k = 0; k < kMaxKinds; ++k) {
      if (r.x == k) {
        t[k] += r.y;
        h[k] += r.z;
        d[k] = fminf(d[k], __int_as_float(r.w));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxKinds; ++k) {
    if (k >= n_kinds) break;
    int tk = warp_sum(t[k]);
    int hk = warp_sum(h[k]);
    float dk = warp_min(d[k]);
    if (lane == 0) {
      s_t[warp] = tk;
      s_h[warp] = hk;
      s_d[warp] = dk;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kEpilogueThreads / 32; ++w) {
        tk += s_t[w];
        hk += s_h[w];
        dk = fminf(dk, s_d[w]);
      }
      counters[k] = tk;
      counters[n_kinds + k] = hk;
      dues[k] = dk;
    }
    __syncthreads();
  }
  if (!edges) return;

  const int n_edges = n_blocks * 6;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = threadIdx.x; i < n_edges; i += blockDim.x) {
      const int32_t* e = records + static_cast<long long>(i / 6) * kRecordWords + 4 + 2 * (i % 6);
      const int key = e[0];
      if (key < 0) continue;
      unsigned int* word = reinterpret_cast<unsigned int*>(wire + (key & ~3));
      const unsigned int shift = 8u * static_cast<unsigned int>(key & 3);
      if (pass == 0) {
        atomicAnd(word, ~(0xFFu << shift));
      } else {
        atomicOr(word, (static_cast<unsigned int>(e[1]) & 0xFFu) << shift);
      }
    }
    __syncthreads();
  }
}

Columns columns(const void* active, const void* has_deletion, const void* sel_bits,
                void* phase, void* cond, void* pending, void* fire_at, void* hb_due,
                void* gen) {
  return Columns{static_cast<const uint8_t*>(active),
                 static_cast<const uint8_t*>(has_deletion),
                 static_cast<const uint32_t*>(sel_bits),
                 static_cast<int32_t*>(phase),
                 static_cast<uint32_t*>(cond),
                 static_cast<int32_t*>(pending),
                 static_cast<float*>(fire_at),
                 static_cast<float*>(hb_due),
                 static_cast<int32_t*>(gen)};
}

}  // namespace

extern "C" {

// Words in the rule table the caller packs: kRuleRows rows of kMaxRules.
int kwok_tick_table_words() { return kRuleRows * kMaxRules; }

// The layout constants the wrapper must agree with: 0 threads a block,
// 1 record words a block, 2 descriptor words a kind, 3 kinds at most.
int kwok_tick_constant(int which) {
  switch (which) {
    case 0: return kThreads;
    case 1: return kRecordWords;
    case 2: return kDescWords;
    case 3: return kMaxKinds;
    default: return -1;
  }
}

// Launch the per-kind entry on `stream`; `counts` must hold two zeroed
// int32; `row_base` is the global id of row 0 (0 unless the rows are one
// shard of a split). Returns cudaGetLastError() after the launch (0 =
// launched).
int kwok_tick_launch(int cap, int row_base, int steps, float now0, float dt,
                     unsigned int seed, int num_rules, int has_weights,
                     float hb_interval, unsigned int hb_phase_mask,
                     int hb_sel_bit, const void* rules, const void* active,
                     const void* has_deletion, const void* sel_bits,
                     void* phase, void* cond, void* pending, void* fire_at,
                     void* hb_due, void* gen, void* o_dirty, void* o_deleted,
                     void* o_hb, void* counts, void* stream) {
  if (cap <= 0) return 0;
  if (row_base < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (num_rules < 0 || num_rules > kMaxRules) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const KindRule k{num_rules, has_weights, hb_sel_bit, hb_phase_mask, hb_interval};
  const int blocks = (cap + kThreads - 1) / kThreads;
  tick_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cap, row_base, steps, now0, dt, seed, k, static_cast<const int32_t*>(rules),
      columns(active, has_deletion, sel_bits, phase, cond, pending, fire_at,
              hb_due, gen),
      static_cast<uint8_t*>(o_dirty), static_cast<uint8_t*>(o_deleted),
      static_cast<uint8_t*>(o_hb), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Launch the fused dispatch of `n_kinds` kinds on `stream`. `desc` holds
// kDescWords int64 words per kind: the nine state columns (active,
// has_deletion, sel_bits, phase, cond, pending, fire_at, hb_due, gen),
// the rule table, the mask, phase and cond offsets in `wire`, then cap,
// row_base, wire_row, total, kind, num_rules, has_weights, hb_sel_bit,
// hb_phase_mask and hb_interval's float32 bits. `records` holds
// kRecordWords int32 per block (blocks: the kinds' ceil(cap / kThreads)
// summed). Nothing needs zeroing. Returns cudaGetLastError() after the
// launch (0 = launched; no launch for zero rows).
int kwok_tick_dispatch(const long long* desc, int n_kinds, int steps, float now0,
                       float dt, unsigned int seed, void* wire, void* records,
                       void* stream) {
  if (n_kinds <= 0 || n_kinds > kMaxKinds) return static_cast<int>(cudaErrorInvalidValue);
  DispatchArgs a = {};
  int blocks = 0;
  for (int i = 0; i < n_kinds; ++i) {
    const long long* d = desc + static_cast<long long>(i) * kDescWords;
    KindArgs& ka = a.kinds[i];
    ka.st = columns(reinterpret_cast<const void*>(d[0]), reinterpret_cast<const void*>(d[1]),
                    reinterpret_cast<const void*>(d[2]), reinterpret_cast<void*>(d[3]),
                    reinterpret_cast<void*>(d[4]), reinterpret_cast<void*>(d[5]),
                    reinterpret_cast<void*>(d[6]), reinterpret_cast<void*>(d[7]),
                    reinterpret_cast<void*>(d[8]));
    ka.rules = reinterpret_cast<const int32_t*>(d[9]);
    ka.mask_off = d[10];
    ka.phase_off = d[11];
    ka.cond_off = d[12];
    ka.cap = static_cast<int>(d[13]);
    ka.row_base = static_cast<int>(d[14]);
    ka.wire_row = static_cast<int>(d[15]);
    ka.total = static_cast<int>(d[16]);
    ka.kind = static_cast<int>(d[17]);
    const uint32_t ivl_bits = static_cast<uint32_t>(d[22]);
    float ivl;
    memcpy(&ivl, &ivl_bits, sizeof ivl);
    ka.k = KindRule{static_cast<int>(d[18]), static_cast<int>(d[19]),
                    static_cast<int>(d[20]), static_cast<uint32_t>(d[21]), ivl};
    if (ka.cap < 0 || ka.row_base < 0 || ka.wire_row < 0 ||
        ka.wire_row + static_cast<long long>(ka.cap) > ka.total ||
        ka.k.num_rules < 0 || ka.k.num_rules > kMaxRules) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ka.first_block = blocks;
    blocks += (ka.cap + kThreads - 1) / kThreads;
  }
  a.n_kinds = n_kinds;
  a.steps = steps;
  a.now0 = now0;
  a.dt = dt;
  a.seed = seed;
  a.wire = static_cast<uint8_t*>(wire);
  a.records = static_cast<int32_t*>(records);
  if (blocks == 0) return 0;
  fused_tick_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch the epilogue on `stream`: `n_blocks` records (of one or several
// dispatch launches, in any order; 16-byte aligned) into the header of
// `wire` for `n_kinds` kinds and, when `edges` is not 0, its shared mask
// bytes (0 only when every launch's rows of every kind start and end on a
// byte of their mask runs: wire_row, cap and total multiples of 8).
// `wire` must be 4-aligned and hold every aligned word around a recorded
// byte (the rows that follow the masks always do). Returns
// cudaGetLastError() after the launch.
int kwok_tick_epilogue(void* wire, const void* records, int n_blocks, int n_kinds,
                       int edges, void* stream) {
  if (n_kinds <= 0 || n_kinds > kMaxKinds || n_blocks < 0 ||
      reinterpret_cast<uintptr_t>(records) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tick_wire_epilogue<<<1, kEpilogueThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(wire), static_cast<const int32_t*>(records), n_blocks,
      n_kinds, edges);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
