// Task-graph execution simulator + Metropolis MCMC strategy search.
//
// Native core of the strategy-search subsystem (the role of the reference's
// scripts/simulator.cc, re-designed): Python precomputes, for every op and
// every candidate ParallelConfig, the per-shard compute cost and the shard
// rectangles (output tile + input footprint per grid point, each pinned to a
// device).  This C++ library owns the hot loop: rectangle-intersection
// derived communication, two-tier (ICI/DCN) transfer costing, greedy
// list-scheduling by per-device ready time, parameter-sync costing, and the
// MCMC search over per-op config assignments.
//
// Per-proposal cost is ~O(affected ops), not O(whole graph):
//   * edge plans — the rectangle-intersection derived dependency/transfer
//     list of every (consumer, input, src_cfg, dst_cfg) pair — are computed
//     once per pair and memoized for the lifetime of the handle (shared by
//     all chains under a read/write lock);
//   * DeltaState caches an accepted assignment's full schedule (per-point
//     finish times, per-device free times before each op, per-op sync and
//     makespan contributions) and re-propagates a single-op proposal
//     forward from the changed op only, skipping ops whose producers and
//     devices are untouched and early-exiting once no dirty producer has a
//     consumer ahead and the device-free vector re-converges;
//   * the reclaimed budget funds N independent Metropolis chains on
//     std::thread (ffsim_mcmc_chains / ffsim_mcmc_chains_run) with
//     deterministic, barrier-synchronized best-state exchange.
// Delta results are bit-identical to full simulate() by construction
// (skipped ops reuse cached values, recomputed ops see bitwise-identical
// inputs, and the sync term is re-summed in full-path order); a cross-check
// mode (ffsim_set_crosscheck) verifies every delta against a full
// re-simulation and aborts on divergence.
//
// Exposed as a C ABI consumed via ctypes (flexflow_tpu/sim/native.py).
//
// Serialized input schema (two flat buffers):
//   ints:
//     n_devices, group_size,
//     n_ops,
//     per op:
//       n_inputs, producer_op_id[n_inputs] (-1 = graph input),
//       n_configs,
//       per config:
//         n_points,
//         per point:
//           device_id,
//           out_rect[8]   (lo0,hi0,...,lo3,hi3; hi exclusive; unused dims 0/1)
//           in_rect[8] x n_inputs
//   doubles:
//     intra_bw, cross_bw, latency,          (bytes/sec, sec)
//     per op: param_bytes,
//     per op, per config: compute_cost,     (sec, fwd+bwd per step)
//     per op, per config: param_replicas,   (gradient copies to merge)
//     per op, per config: collective_cost   (sec; in-op collectives — ring
//                                            rotation, MoE all-to-all, TP
//                                            grad all-reduce; sim/collectives.py)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <memory>
#include <mutex>
#include <random>
#include <shared_mutex>
#include <thread>
#include <vector>

namespace {

struct Rect {
  int64_t lo[4], hi[4];  // hi exclusive
  int64_t volume() const {
    int64_t v = 1;
    for (int d = 0; d < 4; d++) {
      int64_t e = hi[d] - lo[d];
      if (e <= 0) return 0;
      v *= e;
    }
    return v;
  }
};

inline int64_t intersect_volume(const Rect& a, const Rect& b) {
  int64_t v = 1;
  for (int d = 0; d < 4; d++) {
    int64_t lo = a.lo[d] > b.lo[d] ? a.lo[d] : b.lo[d];
    int64_t hi = a.hi[d] < b.hi[d] ? a.hi[d] : b.hi[d];
    if (hi <= lo) return 0;
    v *= hi - lo;
  }
  return v;
}

struct Point {
  int device;
  Rect out;
  std::vector<Rect> in;  // one footprint per op input
};

struct Config {
  std::vector<Point> points;
  double compute_cost = 0.0;
  double param_replicas = 1.0;
  double collective_cost = 0.0;
};

struct OpNode {
  std::vector<int> producers;  // per input: producer op id or -1
  std::vector<Config> configs;
  double param_bytes = 0.0;
};

// One scheduling constraint from a producer shard to a consumer shard:
// cost == 0 -> same-device dependency (producer must finish first);
// cost > 0  -> cross-device transfer, latency + bytes/bw precomputed so
// neither the full nor the delta path re-derives rectangle intersections.
// `bytes` is the transfer payload (intersection volume * 4), kept for the
// trace exporter; the hot paths read only `cost`.
struct Hop {
  int src_point, dst_point;
  double cost;
  double bytes;
};

struct Simulator {
  int n_devices = 1, group_size = 1;
  double intra_bw = 1.0, cross_bw = 1.0, latency = 0.0;
  std::vector<OpNode> ops;
  std::vector<int> last_consumer;  // per op: largest consumer op id, -1 none
  // memoized edge plans: per (op, input), one slot per (src_cfg, dst_cfg)
  // pair, filled on first use and shared by every chain.  Readers take the
  // shared lock; a miss computes the plan outside any lock (read-only op
  // data) and publishes it under the unique lock.
  std::vector<std::vector<std::vector<std::unique_ptr<std::vector<Hop>>>>>
      edges;
  mutable std::shared_mutex edge_mu;
  bool use_delta = true;    // ffsim_set_delta
  bool crosscheck = false;  // ffsim_set_crosscheck: delta vs full, abort

  double bw(int da, int db) const {
    if (da / group_size == db / group_size) return intra_bw;
    return cross_bw;
  }

  const std::vector<Hop>& edge_plan(int dst_op, int inp, int src_cfg,
                                    int dst_cfg) {
    auto& slots = edges[dst_op][inp];
    size_t idx = (size_t)src_cfg * ops[dst_op].configs.size() + dst_cfg;
    {
      std::shared_lock<std::shared_mutex> rl(edge_mu);
      if (slots[idx]) return *slots[idx];
    }
    int src_op = ops[dst_op].producers[inp];
    auto plan = std::make_unique<std::vector<Hop>>();
    const auto& sp = ops[src_op].configs[src_cfg].points;
    const auto& dp = ops[dst_op].configs[dst_cfg].points;
    for (size_t j = 0; j < dp.size(); j++) {
      const Rect& need = dp[j].in[inp];
      for (size_t i = 0; i < sp.size(); i++) {
        int64_t v = intersect_volume(sp[i].out, need);
        if (v <= 0) continue;
        if (sp[i].device == dp[j].device)
          plan->push_back({(int)i, (int)j, 0.0, 0.0});
        else
          plan->push_back({(int)i, (int)j,
                           latency + (double)v * 4.0 /
                               bw(sp[i].device, dp[j].device),
                           (double)v * 4.0});
      }
    }
    std::unique_lock<std::shared_mutex> wl(edge_mu);
    if (!slots[idx]) slots[idx] = std::move(plan);
    return *slots[idx];
  }

  // Schedule one op: producer-driven ready times via the memoized edge
  // plans, then greedy list scheduling by per-device free time.  Returns
  // the op's max finish.  `finish_of(src)` yields a producer's finish
  // array, `cfg_of(src)` its config index — callbacks so the delta path
  // can splice in recomputed/proposed values.
  template <class FinishOf, class CfgOf>
  double run_op(int o, int ci, FinishOf&& finish_of, CfgOf&& cfg_of,
                std::vector<double>& dev_free, std::vector<double>& ready,
                std::vector<double>& out_finish) {
    const Config& cfg = ops[o].configs[ci];
    size_t np = cfg.points.size();
    ready.assign(np, 0.0);
    for (size_t inp = 0; inp < ops[o].producers.size(); inp++) {
      int src = ops[o].producers[inp];
      if (src < 0) continue;
      const std::vector<double>& sf = finish_of(src);
      for (const Hop& h : edge_plan(o, (int)inp, cfg_of(src), ci)) {
        double t = sf[h.src_point] + h.cost;
        if (t > ready[h.dst_point]) ready[h.dst_point] = t;
      }
    }
    // per-shard compute + in-op collective time, serialized per device
    double per_point = cfg.compute_cost + cfg.collective_cost;
    out_finish.resize(np);
    double op_max = 0.0;
    for (size_t j = 0; j < np; j++) {
      int d = cfg.points[j].device;
      double start = ready[j] > dev_free[d] ? ready[j] : dev_free[d];
      double end = start + per_point;
      dev_free[d] = end;
      out_finish[j] = end;
      if (end > op_max) op_max = end;
    }
    return op_max;
  }

  // Parameter synchronization of ONE op: merging gradient replicas,
  // two-tier (reference update() models, scripts-equivalent semantics).
  double sync_of(int o, int ci) const {
    if (ops[o].param_bytes <= 0.0) return 0.0;
    const Config& cfg = ops[o].configs[ci];
    double r = cfg.param_replicas;
    if (r <= 1.0) return 0.0;
    // devices of this config grouped by node
    std::vector<char> dev_seen(n_devices, 0);
    std::vector<char> grp_seen(n_devices / group_size + 1, 0);
    int ndev = 0, ngrp = 0;
    for (const Point& p : cfg.points) {
      if (!dev_seen[p.device]) { dev_seen[p.device] = 1; ndev++; }
      int g = p.device / group_size;
      if (!grp_seen[g]) { grp_seen[g] = 1; ngrp++; }
    }
    double shard_bytes = ops[o].param_bytes / ((double)cfg.points.size() / r);
    int intra_cnt = ndev > ngrp ? ndev - ngrp : 0;
    double sync = 0.0;
    sync += intra_cnt > 0 ? shard_bytes * intra_cnt / ((double)intra_cnt + 1)
                                * 2.0 / intra_bw : 0.0;
    sync += ngrp > 1 ? shard_bytes * 2.0 * (ngrp - 1) / ngrp / cross_bw : 0.0;
    return sync;
  }

  // Makespan + sync of one training step under `assign` (config index per
  // op).  Ops arrive in topological order (graph is built front-to-back).
  double simulate(const std::vector<int>& assign) {
    size_t n = ops.size();
    std::vector<std::vector<double>> finish(n);
    std::vector<double> dev_free(n_devices, 0.0), ready;
    double makespan = 0.0;
    for (size_t o = 0; o < n; o++) {
      double m = run_op(
          (int)o, assign[o],
          [&](int s) -> const std::vector<double>& { return finish[s]; },
          [&](int s) { return assign[s]; }, dev_free, ready, finish[o]);
      if (m > makespan) makespan = m;
    }
    double sync = 0.0;
    for (size_t o = 0; o < n; o++) sync += sync_of((int)o, assign[o]);
    return makespan + sync;
  }

  // One exported timeline record (ffsim_simulate_trace).  Flat doubles so
  // the ctypes consumer reshapes to (n, TRACE_STRIDE) without a struct
  // mirror.  kind 0 = compute interval of one grid point; kind 1 = a
  // cross-device transfer (hop with cost > 0); kind 2 = the op's
  // parameter-sync term (laid after the makespan — it overlaps all
  // devices, so it gets no device lane).
  static constexpr int TRACE_STRIDE = 8;
  enum { TRACE_COMPUTE = 0, TRACE_XFER = 1, TRACE_SYNC = 2 };

  // Full simulation of `assign` that exports the schedule: same greedy
  // list-scheduling arithmetic as simulate()/run_op (kept separate so the
  // MCMC hot path stays untouched), but every scheduled interval is
  // emitted.  Writes at most `cap` records into `out` (records beyond the
  // capacity are counted, not written — callers probe with cap = 0, then
  // allocate); returns the total record count and stores makespan + sync
  // in *total_s.  Record layout per TRACE_STRIDE doubles:
  //   [0] kind  [1] op id  [2] point (compute) / src device (xfer) / -1
  //   [3] device (compute) / dst device (xfer) / -1
  //   [4] start sec  [5] duration sec  [6] payload bytes (xfer only)
  //   [7] the op's config index under `assign`
  int64_t simulate_trace(const std::vector<int>& assign, double* out,
                         int64_t cap, double* total_s) {
    size_t n = ops.size();
    std::vector<std::vector<double>> finish(n);
    std::vector<double> dev_free(n_devices, 0.0);
    double makespan = 0.0;
    int64_t cnt = 0;
    auto emit = [&](double kind, double op, double a, double b,
                    double start, double dur, double bytes, double cfg) {
      if (cnt < cap) {
        double* r = out + cnt * TRACE_STRIDE;
        r[0] = kind; r[1] = op; r[2] = a; r[3] = b;
        r[4] = start; r[5] = dur; r[6] = bytes; r[7] = cfg;
      }
      cnt++;
    };
    for (size_t o = 0; o < n; o++) {
      int ci = assign[o];
      const Config& cfg = ops[o].configs[ci];
      size_t np = cfg.points.size();
      std::vector<double> ready(np, 0.0);
      for (size_t inp = 0; inp < ops[o].producers.size(); inp++) {
        int src = ops[o].producers[inp];
        if (src < 0) continue;
        const std::vector<double>& sf = finish[src];
        const auto& sp = ops[src].configs[assign[src]].points;
        for (const Hop& h : edge_plan((int)o, (int)inp, assign[src], ci)) {
          double t = sf[h.src_point] + h.cost;
          if (t > ready[h.dst_point]) ready[h.dst_point] = t;
          if (h.cost > 0.0)  // the transfer occupies [src finish, +cost)
            emit(TRACE_XFER, (double)o, (double)sp[h.src_point].device,
                 (double)cfg.points[h.dst_point].device, sf[h.src_point],
                 h.cost, h.bytes, (double)ci);
        }
      }
      double per_point = cfg.compute_cost + cfg.collective_cost;
      finish[o].resize(np);
      for (size_t j = 0; j < np; j++) {
        int d = cfg.points[j].device;
        double start = ready[j] > dev_free[d] ? ready[j] : dev_free[d];
        double end = start + per_point;
        dev_free[d] = end;
        finish[o][j] = end;
        if (end > makespan) makespan = end;
        emit(TRACE_COMPUTE, (double)o, (double)j, (double)d, start,
             per_point, 0.0, (double)ci);
      }
    }
    double sync = 0.0, at = makespan;
    for (size_t o = 0; o < n; o++) {
      double s = sync_of((int)o, assign[o]);
      if (s > 0.0) {  // serialized after the makespan, full-path order
        emit(TRACE_SYNC, (double)o, -1.0, -1.0, at, s, 0.0,
             (double)assign[o]);
        at += s;
      }
      sync += s;
    }
    if (total_s) *total_s = makespan + sync;
    return cnt;
  }
};

// Cached schedule of one accepted assignment, supporting O(affected ops)
// re-simulation of single-op proposals (the SysML'19 delta simulation
// algorithm, re-derived for list scheduling).  Kept: per-(op, point)
// finish times, the device-free vector observed just before each op was
// scheduled, and per-op sync/makespan contributions.  propose() walks
// forward from the changed op; an op is recomputed only when a producer's
// finish times changed or the free time of one of its devices differs
// from the cached schedule, and the walk stops once no changed op has a
// consumer ahead and the device-free vector re-converges.  All arithmetic
// matches the full path bit-for-bit: skipped ops reuse cached values,
// recomputed ops see bitwise-identical inputs, and the sync term is
// re-summed in full-path order (incremental +/- updates would drift by
// ulps and could flip borderline Metropolis decisions).
struct DeltaState {
  std::vector<int> assign;
  std::vector<std::vector<double>> finish;   // per (op, point)
  std::vector<std::vector<double>> before;   // [n+1] dev-free before op o
  std::vector<double> op_sync, op_max;       // per-op contributions
  std::vector<double> prefix_max, suffix_max;
  double makespan = 0.0;
  bool valid = false;
  int64_t delta_evals = 0, full_evals = 0;
  // pending proposal (propose fills, commit applies)
  int p_op = -1, p_cfg = -1, p_exit = -1;
  double p_makespan = 0.0, p_sync = 0.0, p_total = 0.0;
  std::vector<std::vector<double>> s_finish, s_before;
  std::vector<double> s_opmax, s_devfree, s_ready;
  std::vector<char> s_recomputed, s_dirty;

  // Full simulation that also (re)builds the cached schedule.  Returns
  // makespan + sync, bitwise-equal to Simulator::simulate.
  double init(Simulator* sim, const std::vector<int>& a) {
    size_t n = sim->ops.size();
    assign = a;
    finish.resize(n);
    before.assign(n + 1, std::vector<double>(sim->n_devices, 0.0));
    op_sync.resize(n);
    op_max.resize(n);
    prefix_max.resize(n + 1);
    suffix_max.resize(n + 1);
    s_finish.resize(n);
    s_before.resize(n + 1);
    s_opmax.resize(n);
    s_recomputed.resize(n);
    s_dirty.resize(n);
    std::vector<double> dev_free(sim->n_devices, 0.0);
    makespan = 0.0;
    double sync = 0.0;
    for (size_t o = 0; o < n; o++) {
      before[o] = dev_free;
      op_max[o] = sim->run_op(
          (int)o, assign[o],
          [&](int s) -> const std::vector<double>& { return finish[s]; },
          [&](int s) { return assign[s]; }, dev_free, s_ready, finish[o]);
      if (op_max[o] > makespan) makespan = op_max[o];
      op_sync[o] = sim->sync_of((int)o, assign[o]);
    }
    before[n] = dev_free;
    for (size_t o = 0; o < n; o++) sync += op_sync[o];
    rebuild_extrema();
    valid = true;
    p_op = -1;
    full_evals++;
    return makespan + sync;
  }

  void rebuild_extrema() {
    size_t n = op_max.size();
    prefix_max[0] = 0.0;
    for (size_t o = 0; o < n; o++)
      prefix_max[o + 1] = std::max(prefix_max[o], op_max[o]);
    suffix_max[n] = 0.0;
    for (size_t o = n; o-- > 0;)
      suffix_max[o] = std::max(suffix_max[o + 1], op_max[o]);
  }

  // Cost of changing op `c` to config `cfg`, leaving the cached schedule
  // untouched until commit().  NaN if the state was never initialized.
  // `th` is an optional rejection threshold (Metropolis bound): the walk
  // aborts with +inf as soon as its makespan lower bound proves the total
  // must exceed `th` — the running max only grows and the sync term is
  // summed exactly upfront, so an abort implies t > th bit-for-bit and
  // the accept/reject decision is identical to a completed evaluation.
  double propose(Simulator* sim, int c, int cfg,
                 double th = std::numeric_limits<double>::infinity()) {
    size_t n = sim->ops.size();
    if (!valid || assign.size() != n) return std::nan("");
    if (sim->crosscheck)  // verify every delta in full, no shortcuts
      th = std::numeric_limits<double>::infinity();
    delta_evals++;
    // the proposal's sync term, re-summed in full-path order so completed
    // totals stay bitwise-identical to simulate() (incremental +/- updates
    // would drift by ulps and could flip borderline Metropolis decisions)
    double new_sync = sim->sync_of(c, cfg);
    double sync = 0.0;
    for (size_t o = 0; o < n; o++)
      sync += ((int)o == c) ? new_sync : op_sync[o];
    std::fill(s_recomputed.begin(), s_recomputed.end(), 0);
    std::fill(s_dirty.begin(), s_dirty.end(), 0);
    s_devfree = before[c];
    int last_dirty = -1;  // largest consumer index of any dirty op
    double run_max = prefix_max[c];
    int exit_at = (int)n;
    auto finish_of = [&](int s) -> const std::vector<double>& {
      return s_recomputed[s] ? s_finish[s] : finish[s];
    };
    auto cfg_of = [&](int s) { return s == c ? cfg : assign[s]; };
    for (int o = c; o < (int)n; o++) {
      if (o > c && last_dirty < o && s_devfree == before[o]) {
        exit_at = o;  // downstream re-converged: suffix is the cached one
        break;
      }
      int ci = (o == c) ? cfg : assign[o];
      const Config& cc = sim->ops[o].configs[ci];
      bool need = (o == c);
      if (!need)
        for (int src : sim->ops[o].producers)
          if (src >= 0 && s_dirty[src]) { need = true; break; }
      if (!need)
        for (const Point& p : cc.points)
          if (s_devfree[p.device] != before[o][p.device]) {
            need = true;
            break;
          }
      s_before[o] = s_devfree;
      if (!need) {
        // untouched: identical to the cached run — fast-forward its
        // devices to their cached post-op free times
        for (const Point& p : cc.points)
          s_devfree[p.device] = before[o + 1][p.device];
        if (op_max[o] > run_max) run_max = op_max[o];
      } else {
        s_recomputed[o] = 1;
        s_opmax[o] = sim->run_op(o, ci, finish_of, cfg_of, s_devfree,
                                 s_ready, s_finish[o]);
        if (s_opmax[o] > run_max) run_max = s_opmax[o];
        if (o == c || s_finish[o] != finish[o]) {
          s_dirty[o] = 1;
          if (sim->last_consumer[o] > last_dirty)
            last_dirty = sim->last_consumer[o];
        }
      }
      if (run_max + sync > th) {  // rejection certain: t >= run_max + sync
        p_op = -1;                // nothing committable
        return std::numeric_limits<double>::infinity();
      }
    }
    if (exit_at == (int)n) s_before[n] = s_devfree;
    p_makespan = exit_at < (int)n ? std::max(run_max, suffix_max[exit_at])
                                  : run_max;
    p_op = c;
    p_cfg = cfg;
    p_exit = exit_at;
    p_sync = new_sync;
    p_total = p_makespan + sync;
    if (sim->crosscheck) {
      std::vector<int> a = assign;
      a[c] = cfg;
      double full = sim->simulate(a);
      if (!(std::fabs(full - p_total) <= 1e-9)) {
        std::fprintf(stderr,
                     "ffsim delta cross-check FAILED: op %d cfg %d delta "
                     "%.17g vs full %.17g (|diff| %.3g)\n",
                     c, cfg, p_total, full, std::fabs(full - p_total));
        std::abort();
      }
    }
    return p_total;
  }

  // Adopt the last proposal into the cached schedule.
  void commit(Simulator* sim) {
    if (p_op < 0 || !valid) return;
    size_t n = sim->ops.size();
    assign[p_op] = p_cfg;
    for (int o = p_op; o < p_exit; o++) {
      before[o].swap(s_before[o]);
      if (s_recomputed[o]) {
        finish[o].swap(s_finish[o]);
        op_max[o] = s_opmax[o];
      }
    }
    if (p_exit == (int)n) before[n].swap(s_before[n]);
    op_sync[p_op] = p_sync;
    makespan = p_makespan;
    rebuild_extrema();
    p_op = -1;
  }
};

struct McmcCounters {
  int64_t accepted = 0, proposed = 0, delta_evals = 0, full_evals = 0;
};

// Advance one Metropolis chain by `iters` proposals: re-randomize one op's
// config, accept better moves always and worse moves with prob
// exp(-beta * delta) (reference: scripts/simulator.cc:1444-1471).  The
// acceptance draw happens BEFORE evaluation and is folded into a cost
// threshold th = cur_t - ln(u)/beta — accept iff t < th, the same decision
// as the textbook form (exp/log are strictly monotone), which lets the
// delta path abort a walk as soon as rejection is certain.  The RNG draw
// order is identical on the delta and full paths, so a fixed seed yields
// the same accepted sequence either way (delta totals are bitwise equal
// to full ones by construction).
void mcmc_advance(Simulator* sim, std::vector<int>& cur,
                  std::vector<int>& best, double& cur_t, double& best_t,
                  int64_t iters, double beta, std::mt19937_64& rng,
                  DeltaState* st, McmcCounters& k) {
  size_t n = sim->ops.size();
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  for (int64_t it = 0; it < iters; it++) {
    size_t o = rng() % n;
    size_t nc = sim->ops[o].configs.size();
    if (nc <= 1) continue;
    int old = cur[o];
    int prop = (int)(rng() % nc);
    if (prop == old) continue;
    k.proposed++;
    // u == 0 -> ln(u) = -inf -> th = +inf: accept anything, like exp > 0
    double th = cur_t - std::log(unif(rng)) / beta;
    double t;
    bool via_delta = st != nullptr && st->valid;
    if (via_delta) {
      t = st->propose(sim, (int)o, prop, th);
      k.delta_evals++;
    } else {
      cur[o] = prop;
      t = sim->simulate(cur);
      cur[o] = old;
      k.full_evals++;
    }
    if (t < th) {
      k.accepted++;
      if (via_delta) st->commit(sim);
      cur[o] = prop;
      cur_t = t;
      if (t < best_t) {
        best_t = t;
        best = cur;
      }
    }
  }
}

uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// Chain 0 uses the base seed verbatim so chains=1 reproduces the
// single-chain entry points; further chains derive via splitmix64.
uint64_t chain_seed(uint64_t base, int i) {
  return i == 0 ? base
                : splitmix64(base ^ (0x9E3779B97F4A7C15ull * (uint64_t)i));
}

struct ChainT {
  std::vector<int> cur, best;
  double cur_t = -1.0, best_t = -1.0;
  std::mt19937_64 rng;
  DeltaState st;
  McmcCounters k;
};

void write_chain_stats(const std::vector<ChainT>& chains, int64_t* stats) {
  if (!stats) return;
  for (size_t i = 0; i < chains.size(); i++) {
    stats[i * 4 + 0] += chains[i].k.accepted;
    stats[i * 4 + 1] += chains[i].k.proposed;
    stats[i * 4 + 2] += chains[i].k.delta_evals;
    stats[i * 4 + 3] += chains[i].k.full_evals;
  }
}

// One chunk of every chain, concurrently; join before returning.
void run_chains_round(Simulator* sim, std::vector<ChainT>& chains,
                      int64_t iters, double beta) {
  std::vector<std::thread> ts;
  ts.reserve(chains.size());
  for (size_t i = 0; i < chains.size(); i++)
    ts.emplace_back([sim, iters, beta, &chains, i]() {
      ChainT& ch = chains[i];
      if (sim->use_delta) {
        if (!ch.st.valid) {
          double t = ch.st.init(sim, ch.cur);
          ch.k.full_evals++;
          if (ch.cur_t < 0.0) ch.cur_t = t;
        }
      } else if (ch.cur_t < 0.0) {
        ch.cur_t = sim->simulate(ch.cur);
        ch.k.full_evals++;
      }
      if (ch.best_t < 0.0) ch.best_t = ch.cur_t;
      mcmc_advance(sim, ch.cur, ch.best, ch.cur_t, ch.best_t, iters, beta,
                   ch.rng, sim->use_delta ? &ch.st : nullptr, ch.k);
    });
  for (auto& t : ts) t.join();
}

int64_t read_i(const int64_t*& p) { return *p++; }

}  // namespace

extern "C" {

// Build a simulator from the serialized buffers. Returns opaque handle.
void* ffsim_create(const int64_t* ints, int64_t n_ints, const double* dbls,
                   int64_t n_dbls) {
  (void)n_ints;
  Simulator* sim = new Simulator();
  const int64_t* ip = ints;
  sim->n_devices = (int)read_i(ip);
  sim->group_size = (int)read_i(ip);
  if (sim->group_size <= 0) sim->group_size = sim->n_devices;
  int64_t n_ops = read_i(ip);
  sim->ops.resize(n_ops);
  const double* dp = dbls;
  sim->intra_bw = *dp++;
  sim->cross_bw = *dp++;
  sim->latency = *dp++;
  (void)n_dbls;
  for (int64_t o = 0; o < n_ops; o++) {
    OpNode& op = sim->ops[o];
    int64_t n_inputs = read_i(ip);
    op.producers.resize(n_inputs);
    for (int64_t i = 0; i < n_inputs; i++)
      op.producers[i] = (int)read_i(ip);
    int64_t n_configs = read_i(ip);
    op.configs.resize(n_configs);
    for (int64_t c = 0; c < n_configs; c++) {
      Config& cfg = op.configs[c];
      int64_t n_points = read_i(ip);
      cfg.points.resize(n_points);
      for (int64_t pt = 0; pt < n_points; pt++) {
        Point& point = cfg.points[pt];
        point.device = (int)read_i(ip);
        for (int d = 0; d < 4; d++) {
          point.out.lo[d] = read_i(ip);
          point.out.hi[d] = read_i(ip);
        }
        point.in.resize(n_inputs);
        for (int64_t i = 0; i < n_inputs; i++) {
          for (int d = 0; d < 4; d++) {
            point.in[i].lo[d] = read_i(ip);
            point.in[i].hi[d] = read_i(ip);
          }
        }
      }
    }
  }
  for (int64_t o = 0; o < n_ops; o++) sim->ops[o].param_bytes = *dp++;
  for (int64_t o = 0; o < n_ops; o++)
    for (auto& cfg : sim->ops[o].configs) cfg.compute_cost = *dp++;
  for (int64_t o = 0; o < n_ops; o++)
    for (auto& cfg : sim->ops[o].configs) cfg.param_replicas = *dp++;
  for (int64_t o = 0; o < n_ops; o++)
    for (auto& cfg : sim->ops[o].configs) cfg.collective_cost = *dp++;
  // edge-plan tables + consumer index for the delta walk's early exit
  sim->last_consumer.assign(n_ops, -1);
  sim->edges.resize(n_ops);
  for (int64_t o = 0; o < n_ops; o++) {
    OpNode& op = sim->ops[o];
    sim->edges[o].resize(op.producers.size());
    for (size_t i = 0; i < op.producers.size(); i++) {
      int src = op.producers[i];
      if (src < 0) continue;
      sim->edges[o][i].resize(sim->ops[src].configs.size() *
                              op.configs.size());
      if ((int)o > sim->last_consumer[src]) sim->last_consumer[src] = (int)o;
    }
  }
  return sim;
}

void ffsim_destroy(void* handle) { delete (Simulator*)handle; }

// Handle-level switches: delta re-simulation on/off (default on) and the
// debug cross-check (every delta verified against a full re-simulation;
// divergence > 1e-9 aborts the process).
void ffsim_set_delta(void* handle, int32_t on) {
  ((Simulator*)handle)->use_delta = on != 0;
}

void ffsim_set_crosscheck(void* handle, int32_t on) {
  ((Simulator*)handle)->crosscheck = on != 0;
}

double ffsim_simulate(void* handle, const int32_t* assign) {
  Simulator* sim = (Simulator*)handle;
  std::vector<int> a(sim->ops.size());
  for (size_t i = 0; i < a.size(); i++) a[i] = assign[i];
  return sim->simulate(a);
}

// Full simulate of `assign` that exports the per-op/per-point/per-hop
// timeline (the Perfetto trace source — obs/trace.py).  Two-call
// protocol: cap = 0 probes the record count, the second call fills
// `out` (Simulator::TRACE_STRIDE doubles per record; layout documented
// there).  `total_s` (optional) receives makespan + sync, equal to
// ffsim_simulate on the same assignment.
int64_t ffsim_simulate_trace(void* handle, const int32_t* assign,
                             double* out, int64_t cap, double* total_s) {
  Simulator* sim = (Simulator*)handle;
  std::vector<int> a(sim->ops.size());
  for (size_t i = 0; i < a.size(); i++) a[i] = assign[i];
  return sim->simulate_trace(a, out, cap, total_s);
}

// Delta-state lifecycle for callers that drive proposals themselves (the
// Python property tests; any future search variant).
void* ffsim_state_create(void* handle) {
  (void)handle;
  return new DeltaState();
}

void ffsim_state_destroy(void* state) { delete (DeltaState*)state; }

double ffsim_state_init(void* handle, void* state, const int32_t* assign) {
  Simulator* sim = (Simulator*)handle;
  std::vector<int> a(sim->ops.size());
  for (size_t i = 0; i < a.size(); i++) a[i] = assign[i];
  return ((DeltaState*)state)->init(sim, a);
}

double ffsim_state_propose(void* handle, void* state, int32_t op,
                           int32_t cfg) {
  return ((DeltaState*)state)->propose((Simulator*)handle, op, cfg);
}

void ffsim_state_commit(void* handle, void* state) {
  ((DeltaState*)state)->commit((Simulator*)handle);
}

// Metropolis MCMC (reference: scripts/simulator.cc:1444-1471): start from
// `assign`, `iters` proposals re-randomizing one op's config, accept better
// moves always and worse moves with prob exp(-beta * delta).  Writes the
// best assignment back into `assign`; returns its simulated time.
double ffsim_mcmc(void* handle, int32_t* assign, int64_t iters, double beta,
                  uint64_t seed) {
  Simulator* sim = (Simulator*)handle;
  size_t n = sim->ops.size();
  std::vector<int> cur(n), best(n);
  for (size_t i = 0; i < n; i++) cur[i] = best[i] = assign[i];
  std::mt19937_64 rng(seed);
  DeltaState st;
  double cur_t = sim->use_delta ? st.init(sim, cur) : sim->simulate(cur);
  double best_t = cur_t;
  McmcCounters k;
  mcmc_advance(sim, cur, best, cur_t, best_t, iters, beta, rng,
               sim->use_delta ? &st : nullptr, k);
  for (size_t i = 0; i < n; i++) assign[i] = best[i];
  return best_t;
}

// Chunk-resumable Metropolis MCMC with acceptance accounting (the obs
// subsystem's trajectory source).  The caller owns the chain: `cur` and
// `best` are the current and best assignments, `times[0]`/`times[1]` their
// simulated costs (pass times[0] < 0 on the first chunk to compute it).
// Runs `iters` proposals continuing that chain, writes the advanced state
// back, and adds the chunk's counts to stats[0] (accepted moves), stats[1]
// (evaluated proposals; self/singleton proposals are skipped and not
// counted), stats[2] (delta evaluations) and stats[3] (full simulations,
// including the per-chunk schedule re-anchor) — the caller's stats buffer
// must hold 4 int64.  Semantics per proposal are identical to ffsim_mcmc;
// a chunked run differs from one long call only in re-seeding per chunk.
// Returns the best cost.
double ffsim_mcmc_run(void* handle, int32_t* cur, int32_t* best,
                      double* times, int64_t iters, double beta,
                      uint64_t seed, int64_t* stats) {
  Simulator* sim = (Simulator*)handle;
  size_t n = sim->ops.size();
  std::vector<int> c(n), b(n);
  for (size_t i = 0; i < n; i++) { c[i] = cur[i]; b[i] = best[i]; }
  std::mt19937_64 rng(seed);
  DeltaState st;
  McmcCounters k;
  double cur_t;
  if (sim->use_delta) {
    double t = st.init(sim, c);
    k.full_evals++;
    cur_t = times[0] >= 0.0 ? times[0] : t;
  } else {
    cur_t = times[0] >= 0.0 ? times[0] : sim->simulate(c);
  }
  double best_t = times[1] >= 0.0 ? times[1] : cur_t;
  mcmc_advance(sim, c, b, cur_t, best_t, iters, beta, rng,
               sim->use_delta ? &st : nullptr, k);
  for (size_t i = 0; i < n; i++) { cur[i] = c[i]; best[i] = b[i]; }
  times[0] = cur_t;
  times[1] = best_t;
  stats[0] += k.accepted;
  stats[1] += k.proposed;
  stats[2] += k.delta_evals;
  stats[3] += k.full_evals;
  return best_t;
}

// N independent Metropolis chains on std::thread, all starting from
// `assign`, each with its own RNG (chain 0 = base seed, others derived by
// splitmix64) and its own delta state.  Chains run in barrier-synchronized
// rounds of `exchange_every` proposals; after each round every chain whose
// current cost is worse than the global best adopts it (ties break to the
// lowest chain id), so the result is reproducible for a fixed base seed
// regardless of thread scheduling.  Writes the global best assignment back
// into `assign`; `stats` (optional, n_chains x 4 int64) receives per-chain
// accepted/proposed/delta-eval/full-eval counts.  Returns the best cost.
double ffsim_mcmc_chains(void* handle, int32_t* assign, int64_t iters,
                         double beta, uint64_t seed, int32_t n_chains,
                         int64_t exchange_every, int64_t* stats) {
  Simulator* sim = (Simulator*)handle;
  size_t n = sim->ops.size();
  int nch = n_chains < 1 ? 1 : n_chains;
  if (iters <= 0) {
    std::vector<int> a(assign, assign + n);
    return sim->simulate(a);
  }
  if (exchange_every <= 0) exchange_every = iters;
  std::vector<ChainT> chains(nch);
  for (int i = 0; i < nch; i++) {
    chains[i].cur.assign(assign, assign + n);
    chains[i].best = chains[i].cur;
    chains[i].rng.seed(chain_seed(seed, i));
  }
  for (int64_t done = 0; done < iters; done += exchange_every) {
    int64_t step = std::min(exchange_every, iters - done);
    run_chains_round(sim, chains, step, beta);
    int gb = 0;
    for (int i = 1; i < nch; i++)
      if (chains[i].best_t < chains[gb].best_t) gb = i;
    for (int i = 0; i < nch; i++) {
      if (i == gb) continue;
      if (chains[gb].best_t < chains[i].cur_t) {
        chains[i].cur = chains[gb].best;
        chains[i].cur_t = chains[gb].best_t;
        chains[i].st.valid = false;  // re-anchored at next round start
      }
    }
  }
  int gb = 0;
  for (int i = 1; i < nch; i++)
    if (chains[i].best_t < chains[gb].best_t) gb = i;
  for (size_t i = 0; i < n; i++) assign[i] = chains[gb].best[i];
  write_chain_stats(chains, stats);
  return chains[gb].best_t;
}

// Chunk-resumable multi-chain variant (the obs subsystem's multi-chain
// trajectory source): the caller owns every chain's state — `curs` and
// `bests` are chain-major int32[n_chains * n_ops], `times` holds per-chain
// {cur_t, best_t} (pass cur_t < 0 on the first chunk) — and the per-chunk
// base seed.  Runs `iters` proposals on EACH chain concurrently (no
// internal exchange: the caller exchanges best states between chunks,
// deterministically, and emits one search_chunk record per chain per
// chunk).  `stats` (n_chains x 4 int64) accumulates per-chain counters as
// in ffsim_mcmc_run.  Returns the global best cost.
double ffsim_mcmc_chains_run(void* handle, int32_t* curs, int32_t* bests,
                             double* times, int64_t iters, double beta,
                             uint64_t seed, int32_t n_chains,
                             int64_t* stats) {
  Simulator* sim = (Simulator*)handle;
  size_t n = sim->ops.size();
  int nch = n_chains < 1 ? 1 : n_chains;
  std::vector<ChainT> chains(nch);
  for (int i = 0; i < nch; i++) {
    chains[i].cur.assign(curs + (size_t)i * n, curs + (size_t)(i + 1) * n);
    chains[i].best.assign(bests + (size_t)i * n,
                          bests + (size_t)(i + 1) * n);
    chains[i].cur_t = times[i * 2];
    chains[i].best_t = times[i * 2 + 1];
    chains[i].rng.seed(chain_seed(seed, i));
  }
  run_chains_round(sim, chains, iters, beta);
  int gb = 0;
  for (int i = 0; i < nch; i++) {
    ChainT& ch = chains[i];
    for (size_t j = 0; j < n; j++) {
      curs[(size_t)i * n + j] = ch.cur[j];
      bests[(size_t)i * n + j] = ch.best[j];
    }
    times[i * 2] = ch.cur_t;
    times[i * 2 + 1] = ch.best_t;
    if (ch.best_t < chains[gb].best_t) gb = i;
  }
  write_chain_stats(chains, stats);
  return chains[gb].best_t;
}

}  // extern "C"
