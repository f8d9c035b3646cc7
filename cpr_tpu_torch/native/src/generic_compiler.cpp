// Generic single-agent DAG-protocol MDP compiler, native edition.
//
// Reference counterpart: the Python model in cpr_tpu/mdp/generic/
// (model.py, dag.py, canon.py, protocols/*), itself a re-design of
// mdp/lib/models/generic_v1/model.py.  This file implements the SAME
// semantics — Release/Consider/Continue actions, alpha/gamma
// randomness, garbage collection, common-chain truncation, honest-loop
// reset, isomorphic-state merging by canonical labeling — as a
// single-pass C++ BFS, because on one host core the Python BFS tops out
// around 1k states/s while the capstone (BASELINE.md config 5: GhostDAG
// at full state space) needs millions of transitions.  The Python
// compiler stays the semantic anchor: tests assert state/transition
// counts and VI start values match it exactly on small cutoffs.
//
// Layout choices (vs the Python value types):
//   - a DAG is a fixed-size by-value struct: n, per-block parent
//     bitmask, attacker bitmask.  Block ids are dense and topologically
//     sorted (invariant), block 0 is genesis.
//   - sets of blocks are u32 bitmasks throughout (MAXN = 20).
//   - derived data (children/past/future/height) is recomputed on
//     demand with O(n^2) mask ops instead of cached per object.
//   - protocol miner-state is one int (head block id, or -1).
//
// C API (ctypes; see cpr_tpu/mdp/generic/native.py):
//   gmc_compile(...) -> handle          gmc_n_states/transitions/start
//   gmc_copy / gmc_copy_start           gmc_free, gmc_last_error

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_map>
#include <vector>

using u32 = uint32_t;
using u64 = uint64_t;

static const int MAXN = 20;
static const int ATTACKER = 0, DEFENDER = 1;

static inline int popcnt(u32 m) { return __builtin_popcount(m); }
static inline int lowbit(u32 m) { return __builtin_ctz(m); }

// ----------------------------------------------------------------- DAG

struct Dag {
    uint8_t n;
    u32 par[MAXN];  // parent mask per block
    u32 atk;        // attacker-mined blocks (genesis excluded, miner -1)

    bool operator==(const Dag& o) const {
        return n == o.n && atk == o.atk &&
               std::memcmp(par, o.par, n * sizeof(u32)) == 0;
    }
    u32 all_mask() const { return (n >= 32) ? ~0u : ((1u << n) - 1); }
    int miner_of(int b) const {
        return b == 0 ? -1 : ((atk >> b) & 1 ? ATTACKER : DEFENDER);
    }
};

static Dag genesis_dag() {
    Dag d;
    d.n = 1;
    d.par[0] = 0;
    d.atk = 0;
    return d;
}

struct Derived {
    u32 children[MAXN];
    u32 past[MAXN];
    int height[MAXN];
};

static void derive(const Dag& d, Derived& o) {
    for (int b = 0; b < d.n; b++) {
        o.children[b] = 0;
        o.past[b] = 0;
        o.height[b] = 0;
    }
    for (int b = 0; b < d.n; b++) {
        u32 ps = d.par[b];
        while (ps) {
            int p = lowbit(ps);
            ps &= ps - 1;
            o.children[p] |= 1u << b;
            o.past[b] |= o.past[p] | (1u << p);
            if (o.height[p] + 1 > o.height[b]) o.height[b] = o.height[p] + 1;
        }
    }
}

static u32 future_of(const Derived& dv, int n, int block) {
    u32 acc = 0, stack = dv.children[block];
    while (stack) {
        int b = lowbit(stack);
        stack &= stack - 1;
        if (!(acc & (1u << b))) {
            acc |= 1u << b;
            stack |= dv.children[b] & ~acc;
        }
    }
    (void)n;
    return acc;
}

struct DagOverflow {};  // thrown when a DAG outgrows the mask width

// append returns new block id; caller fills masks
static int dag_append(Dag& d, u32 parents, int miner) {
    if (d.n >= MAXN) throw DagOverflow();
    int b = d.n;
    d.par[b] = parents;
    if (miner == ATTACKER) d.atk |= 1u << b;
    d.n++;
    return b;
}

// ----------------------------------------------------------------- state

struct State {
    Dag dag;
    u32 avis, dvis, withheld, ignored;
    int16_t astate, dstate;  // protocol state: block id or -1

    bool operator==(const State& o) const {
        return avis == o.avis && dvis == o.dvis && withheld == o.withheld &&
               ignored == o.ignored && astate == o.astate &&
               dstate == o.dstate && dag == o.dag;
    }
};

static u64 mix(u64 h, u64 v) {
    h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
    return h;
}

struct StateHash {
    size_t operator()(const State& s) const {
        u64 h = s.dag.n;
        for (int b = 0; b < s.dag.n; b++) h = mix(h, s.dag.par[b]);
        h = mix(h, s.dag.atk);
        h = mix(h, s.avis);
        h = mix(h, s.dvis);
        h = mix(h, s.withheld);
        h = mix(h, s.ignored);
        h = mix(h, (u64)(uint16_t)s.astate << 16 | (uint16_t)s.dstate);
        return (size_t)h;
    }
};

// ----------------------------------------------------------------- view

struct View {
    const Dag& dag;
    const Derived& dv;
    u32 visible;
    int me;  // -1 for judge views

    u32 children(int b) const { return dv.children[b] & visible; }
    int height(int b) const { return dv.height[b]; }
    int miner_of(int b) const { return dag.miner_of(b); }
    u32 parents(int b) const { return dag.par[b]; }
    u32 tips(u32 subgraph) const {  // dag.py View.tips: unfiltered children
        u32 acc = 0, m = subgraph;
        while (m) {
            int b = lowbit(m);
            m &= m - 1;
            if (!(dv.children[b] & subgraph)) acc |= 1u << b;
        }
        return acc;
    }
};

// ----------------------------------------------------------------- protocols

struct Proto {
    virtual ~Proto() {}
    virtual int init(const View& v) const = 0;
    virtual u32 mining(const View& v, int pstate) const = 0;
    virtual int update(const View& v, int pstate, int block) const = 0;
    virtual void history(const View& v, int pstate,
                         std::vector<int>& out) const = 0;
    virtual double progress(const View& v, int block) const = 0;
    virtual void coinbase(const View& v, int block,
                          std::vector<std::pair<int, double>>& out) const = 0;
    virtual int relabel(int pstate, const int* new_ids) const = 0;
    virtual int color(const View& v, int pstate, int block) const = 0;
    virtual u32 keep(const View& v, int pstate) const = 0;
};

// -- bitcoin (protocols/bitcoin.py) -----------------------------------

struct Bitcoin : Proto {
    int init(const View&) const override { return 0; }
    u32 mining(const View&, int head) const override { return 1u << head; }
    int update(const View& v, int head, int block) const override {
        return v.height(block) > v.height(head) ? block : head;
    }
    void history(const View& v, int head, std::vector<int>& out) const override {
        out.clear();
        int b = head;
        while (true) {
            out.push_back(b);
            if (b == 0) break;
            b = lowbit(v.dag.par[b]);
        }
        std::reverse(out.begin(), out.end());
    }
    double progress(const View&, int) const override { return 1.0; }
    void coinbase(const View& v, int block,
                  std::vector<std::pair<int, double>>& out) const override {
        out.clear();
        out.emplace_back(v.miner_of(block), 1.0);
    }
    int relabel(int head, const int* new_ids) const override {
        return new_ids[head];
    }
    int color(const View&, int head, int block) const override {
        return block == head ? 1 : 0;
    }
    u32 keep(const View&, int head) const override { return 1u << head; }
};

// -- ghostdag (protocols/ghostdag.py) ---------------------------------

struct DagSub {
    Dag dag;
    u32 sub;
    bool operator==(const DagSub& o) const {
        return sub == o.sub && dag == o.dag;
    }
};
struct DagSubHash {
    size_t operator()(const DagSub& k) const {
        u64 h = k.dag.n;
        for (int b = 0; b < k.dag.n; b++) h = mix(h, k.dag.par[b]);
        h = mix(h, k.sub);
        return (size_t)h;
    }
};
struct Blue {
    u32 blue;
    std::vector<int8_t> hist;
};

struct GhostDag : Proto {
    int k;
    // memo shared across states; cleared when it grows past the cap —
    // but ONLY between top-level calls: unordered_map inserts keep
    // references valid (node-based), clear() does not, and outer
    // recursion frames hold references into the map
    mutable std::unordered_map<DagSub, Blue, DagSubHash> memo;
    mutable int depth = 0;
    explicit GhostDag(int k_) : k(k_) {}

    const Blue& blue_and_history(const Dag& dag, const Derived& dv,
                                 u32 subgraph) const {
        DagSub key{dag, subgraph};
        auto it = memo.find(key);
        if (it != memo.end()) return it->second;
        if (depth == 0 && memo.size() > (1u << 21)) memo.clear();
        depth++;

        Blue out;
        if (subgraph == 1) {  // genesis only
            out.blue = 1;
            out.hist = {0};
            depth--;
            return memo.emplace(key, std::move(out)).first->second;
        }
        // tips of the subgraph (children within subgraph)
        std::vector<int> tips;
        for (u32 m = subgraph; m;) {
            int b = lowbit(m);
            m &= m - 1;
            if (!(dv.children[b] & subgraph)) tips.push_back(b);
        }
        // recurse into each tip's past; pick max blue count, tie lowest id
        int b_max = -1, best_cnt = -1;
        std::vector<u32> blue_of(tips.size());
        std::vector<const std::vector<int8_t>*> hist_of(tips.size());
        for (size_t i = 0; i < tips.size(); i++) {
            int t = tips[i];
            const Blue& r = blue_and_history(dag, dv, dv.past[t] & subgraph);
            blue_of[i] = r.blue;
            hist_of[i] = &r.hist;
            int c = popcnt(r.blue);
            if (c > best_cnt || (c == best_cnt && t < b_max)) {
                best_cnt = c;
                b_max = t;
            }
        }
        size_t mi = 0;
        while (tips[mi] != b_max) mi++;
        u32 blue_set = blue_of[mi] | (1u << b_max);
        std::vector<int8_t> history(*hist_of[mi]);
        history.push_back((int8_t)b_max);

        auto anticone = [&](int b) {
            return subgraph & ~(1u << b) & ~(dv.past[b] & subgraph) &
                   ~(future_of(dv, dag.n, b) & subgraph);
        };
        u32 ac = anticone(b_max);
        std::vector<int> cand;
        for (u32 m = ac; m;) {
            cand.push_back(lowbit(m));
            m &= m - 1;
        }
        std::sort(cand.begin(), cand.end(), [&](int a, int b) {
            if (dv.height[a] != dv.height[b])
                return dv.height[a] < dv.height[b];
            return a < b;
        });
        for (int b : cand) {
            u32 s_mask = blue_set | (1u << b);
            bool ok = true;
            for (u32 m = s_mask; m && ok;) {
                int x = lowbit(m);
                m &= m - 1;
                if (popcnt(anticone(x) & s_mask) > k) ok = false;
            }
            if (ok) {
                blue_set |= 1u << b;
                history.push_back((int8_t)b);
            }
        }
        out.blue = blue_set;
        out.hist = std::move(history);
        depth--;
        return memo.emplace(key, std::move(out)).first->second;
    }

    int init(const View&) const override { return -1; }
    u32 mining(const View& v, int) const override { return v.tips(v.visible); }
    int update(const View&, int, int) const override { return -1; }
    void history(const View& v, int, std::vector<int>& out) const override {
        Derived dv2;  // view-independent derived is passed via v.dv
        (void)dv2;
        const Blue& r = blue_and_history(v.dag, v.dv, v.visible);
        out.assign(r.hist.begin(), r.hist.end());
    }
    double progress(const View&, int) const override { return 1.0; }
    void coinbase(const View& v, int block,
                  std::vector<std::pair<int, double>>& out) const override {
        out.clear();
        out.emplace_back(v.miner_of(block), 1.0);
    }
    int relabel(int, const int*) const override { return -1; }
    int color(const View&, int, int) const override { return 0; }
    u32 keep(const View& v, int) const override { return v.tips(v.visible); }
};

// -- parallel (protocols/parallel.py) ---------------------------------

struct Parallel : Proto {
    int k;
    explicit Parallel(int k_) : k(k_) {}
    bool is_vote(const View& v, int b) const {
        return popcnt(v.dag.par[b]) == 1;
    }
    int init(const View&) const override { return 0; }
    u32 mining(const View& v, int head) const override {
        std::vector<int> votes;
        for (u32 m = v.children(head); m;) {
            votes.push_back(lowbit(m));
            m &= m - 1;
        }
        if ((int)votes.size() >= k) {
            std::stable_sort(votes.begin(), votes.end(), [&](int a, int b) {
                bool na = v.miner_of(a) != v.me, nb = v.miner_of(b) != v.me;
                if (na != nb) return !na;
                return a < b;
            });
            u32 out = 0;
            for (int i = 0; i < k; i++) out |= 1u << votes[i];
            return out;
        }
        return 1u << head;
    }
    int update(const View& v, int head, int block) const override {
        if (is_vote(v, block)) block = lowbit(v.dag.par[block]);
        int bh = v.height(block), hh = v.height(head);
        if (bh > hh) return block;
        if (bh == hh && block != head) {
            if (popcnt(v.children(block)) > popcnt(v.children(head)))
                return block;
        }
        return head;
    }
    void history(const View& v, int head, std::vector<int>& out) const override {
        out.clear();
        int b = head;
        while (true) {
            if (!is_vote(v, b) || b == 0) out.push_back(b);
            if (b == 0) break;
            b = lowbit(v.dag.par[b]);
        }
        std::reverse(out.begin(), out.end());
    }
    double progress(const View&, int) const override { return (double)(k + 1); }
    void coinbase(const View& v, int block,
                  std::vector<std::pair<int, double>>& out) const override {
        out.clear();
        out.emplace_back(v.miner_of(block), 1.0);
        for (u32 m = v.dag.par[block]; m;) {
            out.emplace_back(v.miner_of(lowbit(m)), 1.0);
            m &= m - 1;
        }
    }
    int relabel(int head, const int* new_ids) const override {
        return new_ids[head];
    }
    int color(const View&, int head, int block) const override {
        return block == head ? 1 : 0;
    }
    u32 keep(const View& v, int head) const override {
        return (1u << head) | v.children(head);
    }
};

// -- ethereum whitepaper / byzantium (protocols/ethereum.py) ----------

struct Ethereum : Proto {
    int h;
    explicit Ethereum(int h_) : h(h_) {}

    // chain parent = lowest id among max-height parents (stable sort by
    // -height in the Python spec)
    int chain_parent(const View& v, int block, u32* uncles) const {
        int best = -1, bh = -1;
        for (u32 m = v.dag.par[block]; m;) {
            int p = lowbit(m);
            m &= m - 1;
            if (v.height(p) > bh) {
                bh = v.height(p);
                best = p;
            }
        }
        if (uncles) *uncles = v.dag.par[block] & ~(best >= 0 ? 1u << best : 0);
        return best;
    }
    void history(const View& v, int head, std::vector<int>& out) const override {
        out.clear();
        int b = head;
        while (b >= 0) {
            out.push_back(b);
            if (b == 0) break;
            b = chain_parent(v, b, nullptr);
        }
        std::reverse(out.begin(), out.end());
    }
    u32 available_uncles(const View& v, int head) const {
        std::vector<int> hist;
        history(v, head, hist);
        // window = hist[-h-1:-2]
        u32 window = 0;
        int n = (int)hist.size();
        int lo = std::max(0, n - h - 1), hi = std::max(0, n - 2);
        for (int i = lo; i < hi; i++) window |= 1u << hist[i];
        u32 out = 0;
        for (u32 m = v.visible; m;) {
            int b = lowbit(m);
            m &= m - 1;
            if (v.children(b)) continue;  // not a leaf
            int p = chain_parent(v, b, nullptr);
            if (p >= 0 && (window >> p & 1)) out |= 1u << b;
        }
        return out;
    }
    int init(const View&) const override { return 0; }
    u32 mining(const View& v, int head) const override {
        return (1u << head) | available_uncles(v, head);
    }
    int update(const View& v, int head, int block) const override {
        return v.height(block) > v.height(head) ? block : head;
    }
    double progress(const View&, int) const override { return 1.0; }
    void coinbase(const View& v, int block,
                  std::vector<std::pair<int, double>>& out) const override {
        out.clear();
        u32 uncles;
        chain_parent(v, block, &uncles);
        out.emplace_back(v.miner_of(block), 1.0);
        for (u32 m = uncles; m;) {
            out.emplace_back(v.miner_of(lowbit(m)), 1.0);
            m &= m - 1;
        }
    }
    int relabel(int head, const int* new_ids) const override {
        return new_ids[head];
    }
    int color(const View&, int head, int block) const override {
        return block == head ? 1 : 0;
    }
    u32 keep(const View& v, int head) const override {
        return (1u << head) | available_uncles(v, head);
    }
};

struct Byzantium : Ethereum {
    explicit Byzantium(int h_) : Ethereum(h_) {}
    u32 mining(const View& v, int head) const override {
        std::vector<int> uncles;
        for (u32 m = available_uncles(v, head); m;) {
            uncles.push_back(lowbit(m));
            m &= m - 1;
        }
        std::stable_sort(uncles.begin(), uncles.end(), [&](int a, int b) {
            bool na = v.miner_of(a) != v.me, nb = v.miner_of(b) != v.me;
            if (na != nb) return !na;
            return a < b;
        });
        u32 out = 1u << head;
        for (size_t i = 0; i < uncles.size() && i < 2; i++)
            out |= 1u << uncles[i];
        return out;
    }
    double progress(const View& v, int block) const override {
        u32 uncles;
        chain_parent(v, block, &uncles);
        return 1.0 + popcnt(uncles);
    }
    double weight(const View& v, int block) const {
        std::vector<int> hist;
        history(v, block, hist);
        double w = 0.0;
        for (size_t i = 1; i < hist.size(); i++) w += progress(v, hist[i]);
        return w;
    }
    int update(const View& v, int head, int block) const override {
        return weight(v, block) > weight(v, head) ? block : head;
    }
    void coinbase(const View& v, int block,
                  std::vector<std::pair<int, double>>& out) const override {
        out.clear();
        u32 uncles;
        chain_parent(v, block, &uncles);
        out.emplace_back(v.miner_of(block), 1.0 + 0.03125 * popcnt(uncles));
        int hb = v.height(block);
        double max_d = h + 1;
        for (u32 m = uncles; m;) {
            int u = lowbit(m);
            m &= m - 1;
            out.emplace_back(v.miner_of(u),
                             (max_d - (double)(hb - v.height(u))) / max_d);
        }
    }
};

// ------------------------------------------------- canonical labeling
// Exact port of cpr_tpu/mdp/generic/canon.py: directed 1-WL refinement
// + individualization search + lexicographically-smallest certificate,
// then (height, canonical position) sort to restore topological ids.

namespace canon {

struct Cert {  // (color, sorted new-id parents) rows, lexicographic
    std::vector<std::pair<int, std::vector<int>>> rows;
    bool operator<(const Cert& o) const { return rows < o.rows; }
};

static void refine(int n, const std::vector<std::vector<int>>& parents,
                   const std::vector<std::vector<int>>& children,
                   std::vector<int>& colors) {
    while (true) {
        bool discrete = true;
        {
            std::vector<int> seen(n, 0);
            std::vector<int> sorted_c(colors);
            std::sort(sorted_c.begin(), sorted_c.end());
            for (int i = 1; i < n; i++)
                if (sorted_c[i] == sorted_c[i - 1]) discrete = false;
            (void)seen;
        }
        if (discrete) return;
        // signature = (color, sorted parent colors, sorted child colors)
        typedef std::tuple<int, std::vector<int>, std::vector<int>> Sig;
        std::vector<Sig> sig(n);
        for (int v = 0; v < n; v++) {
            std::vector<int> pc, cc;
            for (int p : parents[v]) pc.push_back(colors[p]);
            for (int c : children[v]) cc.push_back(colors[c]);
            std::sort(pc.begin(), pc.end());
            std::sort(cc.begin(), cc.end());
            sig[v] = Sig(colors[v], std::move(pc), std::move(cc));
        }
        std::vector<Sig> uniq(sig);
        std::sort(uniq.begin(), uniq.end());
        uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
        std::vector<int> fresh(n);
        bool changed = false;
        for (int v = 0; v < n; v++) {
            int r = (int)(std::lower_bound(uniq.begin(), uniq.end(), sig[v]) -
                          uniq.begin());
            fresh[v] = r;
            if (r != colors[v]) changed = true;
        }
        if (!changed) return;
        colors.swap(fresh);
    }
}

static Cert certificate(const std::vector<int>& order,
                        const std::vector<std::vector<int>>& parents,
                        const std::vector<int>& orig_colors) {
    int n = (int)order.size();
    std::vector<int> new_id(n);
    for (int i = 0; i < n; i++) new_id[order[i]] = i;
    Cert c;
    c.rows.reserve(n);
    for (int b : order) {
        std::vector<int> ps;
        for (int p : parents[b]) ps.push_back(new_id[p]);
        std::sort(ps.begin(), ps.end());
        c.rows.emplace_back(orig_colors[b], std::move(ps));
    }
    return c;
}

static void search(int n, const std::vector<std::vector<int>>& parents,
                   const std::vector<std::vector<int>>& children,
                   std::vector<int> colors,
                   const std::vector<int>& orig_colors, Cert& best_cert,
                   std::vector<int>& best_order, bool& have_best) {
    refine(n, parents, children, colors);
    // first non-singleton cell by color value
    std::unordered_map<int, std::vector<int>> cells;
    for (int v = 0; v < n; v++) cells[colors[v]].push_back(v);
    std::vector<int> cell_colors;
    for (auto& kv : cells) cell_colors.push_back(kv.first);
    std::sort(cell_colors.begin(), cell_colors.end());
    const std::vector<int>* target = nullptr;
    for (int c : cell_colors)
        if (cells[c].size() > 1) {
            target = &cells[c];
            break;
        }
    if (!target) {
        std::vector<int> order(n);
        for (int i = 0; i < n; i++) order[i] = i;
        std::stable_sort(order.begin(), order.end(),
                         [&](int a, int b) { return colors[a] < colors[b]; });
        Cert c = certificate(order, parents, orig_colors);
        if (!have_best || c < best_cert) {
            best_cert = std::move(c);
            best_order = std::move(order);
            have_best = true;
        }
        return;
    }
    for (int v : *target) {
        std::vector<int> branched(colors);
        branched[v] = n;  // fresh color, larger than every rank
        search(n, parents, children, branched, orig_colors, best_cert,
               best_order, have_best);
    }
}

// returns canonical topologically-sorted order of blocks
static void canonical_order(const Dag& dag, const Derived& dv,
                            const int* colors, std::vector<int>& out) {
    int n = dag.n;
    out.resize(n);
    bool discrete = true;
    {
        u32 seen_bits[8] = {0};  // colors < 256
        for (int b = 0; b < n; b++) {
            int c = colors[b];
            if (seen_bits[c >> 5] & (1u << (c & 31))) {
                discrete = false;
                break;
            }
            seen_bits[c >> 5] |= 1u << (c & 31);
        }
    }
    if (discrete) {
        for (int i = 0; i < n; i++) out[i] = i;
        std::stable_sort(out.begin(), out.end(), [&](int a, int b) {
            if (dv.height[a] != dv.height[b])
                return dv.height[a] < dv.height[b];
            return colors[a] < colors[b];
        });
        return;
    }
    std::vector<std::vector<int>> parents(n), children(n);
    for (int b = 0; b < n; b++)
        for (u32 m = dag.par[b]; m;) {
            int p = lowbit(m);
            m &= m - 1;
            parents[b].push_back(p);
            children[p].push_back(b);
        }
    std::vector<int> orig(colors, colors + n);
    // dense starting ranks
    std::vector<int> uniq(orig);
    std::sort(uniq.begin(), uniq.end());
    uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
    std::vector<int> start(n);
    for (int v = 0; v < n; v++)
        start[v] = (int)(std::lower_bound(uniq.begin(), uniq.end(), orig[v]) -
                         uniq.begin());
    Cert best_cert;
    std::vector<int> order;
    bool have = false;
    search(n, parents, children, start, orig, best_cert, order, have);
    std::vector<int> pos(n);
    for (int i = 0; i < n; i++) pos[order[i]] = i;
    for (int i = 0; i < n; i++) out[i] = i;
    std::stable_sort(out.begin(), out.end(), [&](int a, int b) {
        if (dv.height[a] != dv.height[b]) return dv.height[a] < dv.height[b];
        return pos[a] < pos[b];
    });
}

}  // namespace canon

// ----------------------------------------------------------------- model

struct Transition {
    double prob;
    State state;
    double reward, progress;
};

struct Model {
    const Proto* proto;
    double alpha, gamma;
    int gc_mode;  // 0 none, 1 simple, 2 judge
    int dag_size_cutoff, height_cutoff;  // -1 = off
    bool merge_iso, truncate_cc, loop_honest, reward_cc, force_consider_own;
    State reset_attacker, reset_defender;  // loop_honest targets

    // scratch
    mutable std::vector<int> hist_a, hist_b;
    mutable std::vector<std::pair<int, double>> cb;

    State initial_state() const {
        State s;
        s.dag = genesis_dag();
        s.avis = s.dvis = 1;
        s.withheld = s.ignored = 0;
        Derived dv;
        derive(s.dag, dv);
        View av{s.dag, dv, s.avis, ATTACKER};
        View dvw{s.dag, dv, s.dvis, DEFENDER};
        s.astate = (int16_t)proto->init(av);
        s.dstate = (int16_t)proto->init(dvw);
        return s;
    }

    void deliver_defender(State& s, const Derived& dv, int block) const {
        s.dvis |= 1u << block;
        View v{s.dag, dv, s.dvis, DEFENDER};
        s.dstate = (int16_t)proto->update(v, s.dstate, block);
    }
    void do_consider(State& s, const Derived& dv, int block) const {
        s.ignored &= ~(1u << block);
        s.avis |= 1u << block;
        View v{s.dag, dv, s.avis, ATTACKER};
        s.astate = (int16_t)proto->update(v, s.astate, block);
    }
    void do_release(State& s, int block) const {
        s.withheld &= ~(1u << block);
    }
    u32 just_released(const State& s) const {
        return (s.dag.atk & ~s.withheld & ~s.dvis) & ~1u;
    }
    u32 defender_fresh(const State& s) const {
        u32 def = s.dag.all_mask() & ~s.dag.atk & ~1u;
        return def & ~s.dvis;
    }
    void do_communication(State& s, const Derived& dv, bool atk_fast) const {
        u32 rel = just_released(s), fresh = defender_fresh(s);
        u32 first = atk_fast ? rel : fresh, second = atk_fast ? fresh : rel;
        for (u32 m = first; m;) {
            deliver_defender(s, dv, lowbit(m));
            m &= m - 1;
        }
        for (u32 m = second; m;) {
            deliver_defender(s, dv, lowbit(m));
            m &= m - 1;
        }
    }
    void mine(State& s, const Derived& dv, int miner) const {
        if (miner == ATTACKER) {
            View v{s.dag, dv, s.avis, ATTACKER};
            u32 parents = proto->mining(v, s.astate);
            int b = dag_append(s.dag, parents, ATTACKER);
            s.ignored |= 1u << b;
            s.withheld |= 1u << b;
            if (force_consider_own) {
                Derived dv2;
                derive(s.dag, dv2);
                do_consider(s, dv2, b);
            }
            return;
        }
        View v{s.dag, dv, s.dvis, DEFENDER};
        u32 parents = proto->mining(v, s.dstate);
        int b = dag_append(s.dag, parents, DEFENDER);
        s.ignored |= 1u << b;
    }

    u32 to_release(const State& s) const {
        u32 out = 0;
        for (u32 m = s.withheld; m;) {
            int b = lowbit(m);
            m &= m - 1;
            if (!(s.dag.par[b] & s.withheld)) out |= 1u << b;
        }
        return out;
    }
    u32 to_consider(const State& s) const {
        u32 out = 0;
        for (u32 m = s.ignored; m;) {
            int b = lowbit(m);
            m &= m - 1;
            if (!(s.dag.par[b] & s.ignored)) out |= 1u << b;
        }
        return out;
    }

    // actions encoded: kind*64 + block; kinds 0 consider, 1 release, 2 cont
    void actions(const State& s, std::vector<int>& out) const {
        out.clear();
        if (height_cutoff >= 0) {
            Derived dv;
            derive(s.dag, dv);
            int mx = 0;
            for (int b = 0; b < s.dag.n; b++)
                if (dv.height[b] > mx) mx = dv.height[b];
            if (mx >= height_cutoff) {
                out.push_back(honest(s));
                return;
            }
        }
        if (dag_size_cutoff >= 0 && s.dag.n >= dag_size_cutoff) {
            out.push_back(honest(s));
            return;
        }
        for (u32 m = to_consider(s); m;) {
            out.push_back(0 * 64 + lowbit(m));
            m &= m - 1;
        }
        for (u32 m = to_release(s); m;) {
            out.push_back(1 * 64 + lowbit(m));
            m &= m - 1;
        }
        out.push_back(2 * 64);
    }
    int honest(const State& s) const {
        u32 tc = to_consider(s);
        if (tc) return 0 * 64 + lowbit(tc);
        u32 tr = to_release(s);
        if (tr) return 1 * 64 + lowbit(tr);
        return 2 * 64;
    }

    void measure(const State& s, const Derived& dv, const int* hist, int nh,
                 double& rew, double& prg) const {
        View v{s.dag, dv, s.dvis, DEFENDER};
        rew = prg = 0.0;
        for (int i = 0; i < nh; i++) {
            int b = hist[i];
            prg += proto->progress(v, b);
            proto->coinbase(v, b, cb);
            for (auto& mc : cb)
                if (mc.first == ATTACKER) rew += mc.second;
        }
    }

    State relabel_state(const State& s, const std::vector<int>& order) const {
        int new_ids[MAXN];
        for (int i = 0; i < MAXN; i++) new_ids[i] = -1;
        for (size_t i = 0; i < order.size(); i++) new_ids[order[i]] = (int)i;
        State o;
        o.dag.n = (uint8_t)order.size();
        o.dag.atk = 0;
        auto remap = [&](u32 mask) {
            u32 out = 0;
            for (u32 m = mask; m;) {
                int b = lowbit(m);
                m &= m - 1;
                if (new_ids[b] >= 0) out |= 1u << new_ids[b];
            }
            return out;
        };
        for (size_t i = 0; i < order.size(); i++) {
            int b = order[i];
            u32 ps = 0;
            for (u32 m = s.dag.par[b]; m;) {
                int p = lowbit(m);
                m &= m - 1;
                if (new_ids[p] >= 0) ps |= 1u << new_ids[p];
            }
            o.dag.par[i] = ps;
            if (i > 0 && (s.dag.atk >> b & 1)) o.dag.atk |= 1u << i;
        }
        o.avis = remap(s.avis);
        o.dvis = remap(s.dvis);
        o.withheld = remap(s.withheld);
        o.ignored = remap(s.ignored);
        o.astate = s.astate >= 0 ? (int16_t)proto->relabel(s.astate, new_ids)
                                 : s.astate;
        o.dstate = s.dstate >= 0 ? (int16_t)proto->relabel(s.dstate, new_ids)
                                 : s.dstate;
        return o;
    }

    State gc(const State& s) const {
        Derived dv;
        derive(s.dag, dv);
        u32 every = s.dag.all_mask();
        u32 keep = (every & ~s.avis) | (every & ~s.dvis);
        View av{s.dag, dv, s.avis, ATTACKER};
        View dw{s.dag, dv, s.dvis, DEFENDER};
        keep |= proto->keep(av, s.astate);
        keep |= proto->keep(dw, s.dstate);
        if (gc_mode == 2) {  // judge
            int dstate = s.dstate;
            u32 dvis = s.dvis;
            for (u32 m = every & ~dvis; m;) {
                int b = lowbit(m);
                m &= m - 1;
                dvis |= 1u << b;
                View v{s.dag, dv, dvis, DEFENDER};
                dstate = proto->update(v, dstate, b);
            }
            View v{s.dag, dv, dvis, DEFENDER};
            keep |= proto->keep(v, dstate);
        }
        keep |= 1;  // genesis
        u32 closed = keep;
        for (u32 m = keep; m;) {
            closed |= dv.past[lowbit(m)];
            m &= m - 1;
        }
        if (closed == every) return s;
        std::vector<int> order;
        for (u32 m = closed; m;) {
            order.push_back(lowbit(m));
            m &= m - 1;
        }
        return relabel_state(s, order);
    }

    // returns truncated state; cut history prefix in `cut`
    State truncate(const State& s, std::vector<int>& cut) const {
        cut.clear();
        Derived dv;
        derive(s.dag, dv);
        View av{s.dag, dv, s.avis, ATTACKER};
        View dw{s.dag, dv, s.dvis, DEFENDER};
        proto->history(av, s.astate, hist_a);
        proto->history(dw, s.dstate, hist_b);
        int next_genesis = 0;
        int lim = (int)std::min(hist_a.size(), hist_b.size());
        for (int i = 1; i < lim; i++) {
            int b = hist_a[i];
            if (b != hist_b[i]) break;
            u32 past = dv.past[b];
            u32 past_and_b = past | (1u << b);
            bool viable = true;
            for (u32 m = past; m && viable;) {
                int p = lowbit(m);
                m &= m - 1;
                if (dv.children[p] & ~past_and_b) viable = false;
            }
            if (viable) next_genesis = b;
        }
        if (next_genesis == 0) return s;
        for (size_t i = 1; i < hist_b.size(); i++) {
            cut.push_back(hist_b[i]);
            if (hist_b[i] == next_genesis) break;
        }
        u32 keep_mask =
            (1u << next_genesis) | future_of(dv, s.dag.n, next_genesis);
        std::vector<int> order;
        for (u32 m = keep_mask; m;) {
            order.push_back(lowbit(m));
            m &= m - 1;
        }
        return relabel_state(s, order);
    }

    State loop_honest_snap(const State& s) const {
        int last = s.dag.n - 1;
        if (last == 0) return s;
        u32 every = s.dag.all_mask();
        u32 last_bit = 1u << last;
        auto common = [&](const State& loop_state) -> State {
            if (s.dvis != (every & ~last_bit)) return s;
            Derived dv;
            derive(s.dag, dv);
            View av{s.dag, dv, s.avis, ATTACKER};
            View dw{s.dag, dv, s.dvis, DEFENDER};
            proto->history(av, s.astate, hist_a);
            proto->history(dw, s.dstate, hist_b);
            if (hist_a != hist_b) return s;
            u32 hist_mask = 0;
            for (size_t i = 0; i + 1 < hist_b.size(); i++)
                hist_mask |= 1u << hist_b[i];
            if (hist_mask != dv.past[hist_b.back()]) return s;
            return loop_state;
        };
        if (s.dag.miner_of(last) == ATTACKER && s.withheld == last_bit &&
            s.ignored == last_bit && s.avis == (every & ~last_bit))
            return common(reset_attacker);
        if (s.dag.miner_of(last) == DEFENDER && s.withheld == 0 &&
            s.ignored == last_bit && s.avis == (every & ~last_bit))
            return common(reset_defender);
        return s;
    }

    State normalize(const State& s) const {
        if (!merge_iso) return s;
        Derived dv;
        derive(s.dag, dv);
        View av{s.dag, dv, s.avis, ATTACKER};
        View dw{s.dag, dv, s.dvis, DEFENDER};
        int colors[MAXN];
        for (int b = 0; b < s.dag.n; b++) {
            int c = b == 0 ? 0 : (1 + s.dag.miner_of(b));
            c |= ((s.dvis >> b) & 1) << 2;
            c |= ((s.avis >> b) & 1) << 3;
            c |= ((s.withheld >> b) & 1) << 4;
            c |= ((s.ignored >> b) & 1) << 5;
            if (s.dvis & (1u << b))
                c |= proto->color(dw, s.dstate, b) << 6;
            if (s.avis & (1u << b))
                c |= proto->color(av, s.astate, b) << 7;
            colors[b] = c;
        }
        std::vector<int> order;
        canon::canonical_order(s.dag, dv, colors, order);
        bool identity = true;
        for (int i = 0; i < s.dag.n; i++)
            if (order[i] != i) {
                identity = false;
                break;
            }
        if (identity) return s;
        return relabel_state(s, order);
    }

    // defender-view measurement of a state's full history — hoisted out
    // of finalize so the BFS pays it once per state, not once per action
    void measure_state(const State& s, double& rew, double& prg) const {
        rew = prg = 0.0;
        if (reward_cc) return;
        Derived dv;
        derive(s.dag, dv);
        View dw{s.dag, dv, s.dvis, DEFENDER};
        proto->history(dw, s.dstate, hist_a);
        std::vector<int> h(hist_a);
        measure(s, dv, h.data() + 1, (int)h.size() - 1, rew, prg);
    }

    void finalize(const State& old, std::vector<Transition>& cases,
                  double old_rew, double old_prg) const {
        for (auto& t : cases) {
            double rew = 0.0, prg = 0.0;
            if (!reward_cc) {
                Derived dv;
                derive(t.state.dag, dv);
                View dw{t.state.dag, dv, t.state.dvis, DEFENDER};
                proto->history(dw, t.state.dstate, hist_a);
                std::vector<int> h(hist_a);
                double nr, np;
                measure(t.state, dv, h.data() + 1, (int)h.size() - 1, nr, np);
                rew = nr - old_rew;
                prg = np - old_prg;
            }
            if (gc_mode) t.state = gc(t.state);
            if (loop_honest) t.state = loop_honest_snap(t.state);
            if (truncate_cc) {
                State pre = t.state;
                std::vector<int> cut;
                t.state = truncate(t.state, cut);
                if (reward_cc) {
                    Derived dv;
                    derive(pre.dag, dv);
                    measure(pre, dv, cut.data(), (int)cut.size(), rew, prg);
                }
            }
            t.state = normalize(t.state);
            t.reward = rew;
            t.progress = prg;
        }
    }

    void apply(int action, const State& s, std::vector<Transition>& out,
               double old_rew, double old_prg) const {
        out.clear();
        int kind = action / 64, block = action % 64;
        Derived dv;
        derive(s.dag, dv);
        if (kind == 1) {  // release
            State n = s;
            do_release(n, block);
            out.push_back({1.0, n, 0.0, 0.0});
        } else if (kind == 0) {  // consider
            State n = s;
            do_consider(n, dv, block);
            out.push_back({1.0, n, 0.0, 0.0});
        } else {  // continue
            const double a = alpha, g = gamma;
            const double pc[2] = {g, 1.0 - g};
            const bool fast[2] = {true, false};
            const double pm[2] = {a, 1.0 - a};
            const int who[2] = {ATTACKER, DEFENDER};
            for (int ci = 0; ci < 2; ci++)
                for (int mi = 0; mi < 2; mi++) {
                    double p = pc[ci] * pm[mi];
                    if (p == 0.0) continue;
                    State n = s;
                    do_communication(n, dv, fast[ci]);
                    Derived dv2;
                    derive(n.dag, dv2);
                    mine(n, dv2, who[mi]);
                    out.push_back({p, n, 0.0, 0.0});
                }
        }
        finalize(s, out, old_rew, old_prg);
    }
};

// ----------------------------------------------------------------- BFS

struct Result {
    std::vector<int32_t> src, act, dst;
    std::vector<double> prob, reward, progress;
    std::vector<int32_t> start_sid;
    std::vector<double> start_p;
    int64_t n_states = 0;
    std::string error;
};

// thread_local: ctypes releases the GIL during gmc_compile, so two
// Python threads can compile concurrently; a shared global would let
// one thread's failure message clobber the other's nullptr-path report
static thread_local std::string g_last_error;

static Result* compile_impl(const std::string& proto_name, int k,
                            double alpha, double gamma, int dag_cutoff,
                            int height_cutoff, int gc_mode, int merge_iso,
                            int truncate_cc, int loop_honest, int reward_cc,
                            int force_consider_own, int64_t max_states) {
    // the BFS can transiently grow a DAG a few blocks past the cutoff
    // (post-cutoff honest mining before GC/truncation shrinks it), so
    // demand head-room against the u32-mask width rather than abort
    if (dag_cutoff < 0 && height_cutoff < 0) {
        g_last_error = "need dag_size_cutoff or traditional_height_cutoff "
                       "(the state space is unbounded without one)";
        return nullptr;
    }
    if (dag_cutoff > MAXN - 4) {
        g_last_error = "dag_size_cutoff too large for the native compiler: "
                       "max " + std::to_string(MAXN - 4) + " (DAGs are u" +
                       std::to_string(8 * sizeof(u32)) + " bitmasks capped "
                       "at MAXN=" + std::to_string(MAXN) + " blocks, with 4 "
                       "blocks of BFS head-room); use the Python compiler "
                       "for larger cutoffs";
        return nullptr;
    }
    // the Python anchor's constructor-time flag validation (model.py:97-102)
    if (truncate_cc && loop_honest) {
        g_last_error = "choose either truncate_common_chain or loop_honest";
        return nullptr;
    }
    if (reward_cc && !truncate_cc) {
        g_last_error = "reward_common_chain requires truncate_common_chain";
        return nullptr;
    }
    Proto* proto;
    if (proto_name == "bitcoin")
        proto = new Bitcoin();
    else if (proto_name == "ghostdag")
        proto = new GhostDag(k);
    else if (proto_name == "parallel")
        proto = new Parallel(k);
    else if (proto_name == "ethereum")
        proto = new Ethereum(k > 0 ? k : 7);
    else if (proto_name == "byzantium")
        proto = new Byzantium(k > 0 ? k : 7);
    else {
        g_last_error = "unknown protocol: " + proto_name;
        return nullptr;
    }

    Model m;
    m.proto = proto;
    m.alpha = alpha;
    m.gamma = gamma;
    m.gc_mode = gc_mode;
    m.dag_size_cutoff = dag_cutoff;
    m.height_cutoff = height_cutoff;
    m.merge_iso = merge_iso != 0;
    m.truncate_cc = truncate_cc != 0;
    m.loop_honest = loop_honest != 0;
    m.reward_cc = reward_cc != 0;
    m.force_consider_own = force_consider_own != 0;

    auto* res = new Result();

    std::unordered_map<State, int32_t, StateHash> ids;
    std::vector<State> queue_states;  // BFS by index
    auto id_of = [&](const State& s) -> int32_t {
        auto it = ids.find(s);
        if (it != ids.end()) return it->second;
        int32_t sid = (int32_t)ids.size();
        ids.emplace(s, sid);
        queue_states.push_back(s);
        return sid;
    };

    // start states
    if (m.loop_honest) {
        State init = m.initial_state();
        Derived dv;
        derive(init.dag, dv);
        State ra = init;
        m.mine(ra, dv, ATTACKER);
        m.reset_attacker = m.normalize(ra);
        State rd = init;
        m.mine(rd, dv, DEFENDER);
        m.reset_defender = m.normalize(rd);
        res->start_sid.push_back(id_of(m.reset_attacker));
        res->start_p.push_back(alpha);
        res->start_sid.push_back(id_of(m.reset_defender));
        res->start_p.push_back(1.0 - alpha);
    } else {
        State s0 = m.normalize(m.initial_state());
        res->start_sid.push_back(id_of(s0));
        res->start_p.push_back(1.0);
    }

    std::vector<int> acts;
    std::vector<Transition> trans;
    try {
    for (size_t qi = 0; qi < queue_states.size(); qi++) {
        if ((int64_t)ids.size() > max_states) {
            res->error = "state cap exceeded";
            g_last_error = res->error;
            delete proto;
            return res;  // partial result flagged by error
        }
        State s = queue_states[qi];  // copy: vector may reallocate
        int32_t sid = (int32_t)qi;
        m.actions(s, acts);
        double old_rew, old_prg;
        m.measure_state(s, old_rew, old_prg);
        for (size_t ai = 0; ai < acts.size(); ai++) {
            m.apply(acts[ai], s, trans, old_rew, old_prg);
            double total = 0.0;
            for (auto& t : trans) total += t.prob;
            if (std::fabs(total - 1.0) > 1e-9) {
                res->error = "probabilities do not sum to one";
                g_last_error = res->error;
                delete proto;
                return res;
            }
            for (auto& t : trans) {
                res->src.push_back(sid);
                res->act.push_back((int32_t)ai);
                res->dst.push_back(id_of(t.state));
                res->prob.push_back(t.prob);
                res->reward.push_back(t.reward);
                res->progress.push_back(t.progress);
            }
        }
    }
    } catch (const DagOverflow&) {
        res->error = "DAG exceeded the native mask width (MAXN blocks); "
                     "lower the cutoff or use the Python compiler";
        g_last_error = res->error;
        delete proto;
        return res;
    }
    res->n_states = (int64_t)ids.size();
    delete proto;
    return res;
}

extern "C" {

void* gmc_compile(const char* proto, int k, double alpha, double gamma,
                  int dag_cutoff, int height_cutoff, int gc_mode,
                  int merge_iso, int truncate_cc, int loop_honest,
                  int reward_cc, int force_consider_own, int64_t max_states) {
    try {
        Result* r = compile_impl(proto ? proto : "", k, alpha, gamma,
                                 dag_cutoff, height_cutoff, gc_mode,
                                 merge_iso, truncate_cc, loop_honest,
                                 reward_cc, force_consider_own, max_states);
        return (void*)r;
    } catch (const std::exception& e) {
        g_last_error = e.what();
        return nullptr;
    }
}

int64_t gmc_n_states(void* h) { return ((Result*)h)->n_states; }
int64_t gmc_n_transitions(void* h) {
    return (int64_t)((Result*)h)->src.size();
}
int64_t gmc_n_start(void* h) {
    return (int64_t)((Result*)h)->start_sid.size();
}
const char* gmc_error(void* h) {
    return h ? ((Result*)h)->error.c_str() : g_last_error.c_str();
}

void gmc_copy(void* h, int32_t* src, int32_t* act, int32_t* dst,
              double* prob, double* reward, double* progress) {
    Result* r = (Result*)h;
    size_t n = r->src.size();
    std::memcpy(src, r->src.data(), n * sizeof(int32_t));
    std::memcpy(act, r->act.data(), n * sizeof(int32_t));
    std::memcpy(dst, r->dst.data(), n * sizeof(int32_t));
    std::memcpy(prob, r->prob.data(), n * sizeof(double));
    std::memcpy(reward, r->reward.data(), n * sizeof(double));
    std::memcpy(progress, r->progress.data(), n * sizeof(double));
}

void gmc_copy_start(void* h, int32_t* sid, double* p) {
    Result* r = (Result*)h;
    std::memcpy(sid, r->start_sid.data(),
                r->start_sid.size() * sizeof(int32_t));
    std::memcpy(p, r->start_p.data(), r->start_p.size() * sizeof(double));
}

void gmc_free(void* h) { delete (Result*)h; }

}  // extern "C"
