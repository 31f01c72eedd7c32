// Approximate Minimum Degree (AMD) fill-reducing ordering.
//
// Native replacement for the ordering capability the reference reaches
// through UMFPACK's symbolic phase (reference: suitesparse/src/Numeric/
// LinearAlgebra/Umfpack/Internal.hs:137-138 — UMFPACK uses AMD/COLAMD
// internally).  Implemented from the published algorithm (Amestoy, Davis,
// Duff, "An Approximate Minimum Degree Ordering Algorithm", SIAM J. Matrix
// Anal. 1996): quotient-graph elimination with element absorption,
// supervariable detection by adjacency hashing, and the approximate
// external-degree bound that makes each elimination O(|Lk|) amortized.
//
// Input: symmetric pattern in CSR/CSC (either — pattern symmetric), diagonal
// entries ignored.  Output: perm such that A[perm,:][:,perm] has low fill.
//
// C API (ctypes):
//   ok = slt_amd(n, indptr, indices, perm_out)   // 0 on success
//
// Built into one host library together with symbolic.cpp
// (sparse_linear_tpu_torch/utils/native.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct AmdGraph {
  int n;
  std::vector<int64_t> pe;   // pe[i]: start of adjacency of node/element i in iw (-1 absorbed)
  std::vector<int> len;      // total list length of variable i
  std::vector<int> elen;     // leading elen[i] entries of the list are elements
  std::vector<int> nv;       // supervariable size (0 = removed / merged away)
  std::vector<int> degree;   // approximate external degree
  std::vector<int64_t> w;    // work/mark array (64-bit: marks advance by
                             // up to n per elimination and never wrap)
  std::vector<int> iw;       // adjacency pool
  int64_t pfree;             // first free slot in iw
  int64_t iwlen;

  // degree lists
  std::vector<int> head, next, last;

  int64_t wflg = 2;

  explicit AmdGraph(int n_) : n(n_) {}

  int64_t clear_flag() { return wflg; }

  void garbage_collect(int me) {
    // compact all live lists to the front of iw; me's partially built list
    // is not live yet (caller handles)
    (void)me;
    // mark live list heads by storing -(first entry)-1 at pe[i]
    for (int i = 0; i < n; ++i) {
      int64_t p = pe[i];
      if (p >= 0 && nv[i] != 0) {
        // live variable or element list
        int l = (elen[i] >= 0) ? len[i] : (w[i]);  // element length in w? see below
        (void)l;
      }
    }
    // simpler compaction: rebuild via ordered scan of (pe, length) pairs
    struct Item { int64_t p; int node; };
    std::vector<Item> items;
    items.reserve(n);
    for (int i = 0; i < n; ++i) {
      if (pe[i] >= 0 && list_len(i) > 0) items.push_back({pe[i], i});
    }
    std::sort(items.begin(), items.end(),
              [](const Item& a, const Item& b) { return a.p < b.p; });
    int64_t q = 0;
    for (auto& it : items) {
      int l = list_len(it.node);
      int64_t p = pe[it.node];
      pe[it.node] = q;
      for (int k = 0; k < l; ++k) iw[q++] = iw[p + k];
    }
    pfree = q;
  }

  int list_len(int i) const {
    if (nv[i] == 0 && elen[i] < 0) return 0;     // absorbed element
    if (elen[i] == -1) return 0;
    if (elen[i] >= 0) return len[i];             // variable
    return len[i];                                // element (len holds |Le|)
  }

  int64_t reserve(int need, int me) {
    if (pfree + need > iwlen) {
      garbage_collect(me);
      if (pfree + need > iwlen) {
        iwlen = std::max<int64_t>(iwlen * 2, pfree + need + n);
        iw.resize(iwlen);
      }
    }
    return pfree;
  }
};

}  // namespace

extern "C" int slt_amd(int n, const int64_t* indptr, const int* indices,
                       int* perm_out) {
  if (n <= 0) return 0;
  AmdGraph g(n);
  int64_t nz = 0;
  for (int j = 0; j < n; ++j)
    for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p)
      if (indices[p] != j) ++nz;

  g.iwlen = nz + nz / 5 + 2LL * n + 16;
  g.iw.assign(g.iwlen, 0);
  g.pe.assign(n, 0);
  g.len.assign(n, 0);
  g.elen.assign(n, 0);
  g.nv.assign(n, 1);
  g.degree.assign(n, 0);
  g.w.assign(n, 1);
  g.head.assign(n + 1, -1);
  g.next.assign(n, -1);
  g.last.assign(n, -1);

  // load strictly off-diagonal entries
  {
    int64_t q = 0;
    for (int j = 0; j < n; ++j) {
      g.pe[j] = q;
      for (int64_t p = indptr[j]; p < indptr[j + 1]; ++p) {
        int i = indices[p];
        if (i != j && i >= 0 && i < n) g.iw[q++] = i;
      }
      g.len[j] = static_cast<int>(q - g.pe[j]);
      g.degree[j] = g.len[j];
    }
    g.pfree = q;
  }

  // initial degree lists
  int mindeg = n;
  for (int i = 0; i < n; ++i) {
    int d = g.degree[i];
    if (d < mindeg) mindeg = d;
    g.next[i] = g.head[d];
    if (g.head[d] != -1) g.last[g.head[d]] = i;
    g.head[d] = i;
    g.last[i] = -1;
  }

  auto remove_from_list = [&](int i) {
    int d = g.degree[i];
    if (g.last[i] != -1)
      g.next[g.last[i]] = g.next[i];
    else if (g.head[d] == i)
      g.head[d] = g.next[i];
    if (g.next[i] != -1) g.last[g.next[i]] = g.last[i];
    g.next[i] = g.last[i] = -1;
  };
  auto add_to_list = [&](int i) {
    int d = g.degree[i];
    if (d > n - 1) d = n - 1;
    g.degree[i] = d;
    g.next[i] = g.head[d];
    if (g.head[d] != -1) g.last[g.head[d]] = i;
    g.head[d] = i;
    g.last[i] = -1;
    if (d < mindeg) mindeg = d;
  };

  std::vector<int> order;       // elimination order of supervariable reps
  order.reserve(n);
  std::vector<int> sv_next(n, -1);   // chain of variables merged into a rep
  std::vector<int> sv_tail(n);
  for (int i = 0; i < n; ++i) sv_tail[i] = i;
  std::vector<int> Lk;               // scratch: variables of current element
  Lk.reserve(256);
  std::vector<char> inlk(n, 0);      // Lk membership flags (cleared per step)

  int nleft = n;
  while (nleft > 0) {
    // pick min-degree supervariable
    while (mindeg <= n - 1 && g.head[std::min(mindeg, n - 1)] == -1) ++mindeg;
    int mdcap = std::min(mindeg, n - 1);
    int me = g.head[mdcap];
    if (me == -1) {  // should not happen; fall back to scan
      for (int d = 0; d <= n - 1; ++d)
        if (g.head[d] != -1) { me = g.head[d]; break; }
    }
    remove_from_list(me);

    int nvme = g.nv[me];
    order.push_back(me);
    nleft -= nvme;
    g.nv[me] = -nvme;  // mark eliminated (negative)

    // ---- form Lk = set of supervariables adjacent to me (through both
    // direct variable entries and element lists), excluding me
    int64_t mark = g.clear_flag();
    g.wflg = mark + 1;
    Lk.clear();
    {
      int64_t p = g.pe[me];
      int el = g.elen[me], ln = g.len[me];
      // elements first
      for (int k = 0; k < el; ++k) {
        int e = g.iw[p + k];
        if (g.elen[e] != -2) continue;  // not a live element (absorbed)
        int64_t pe_ = g.pe[e];
        for (int t = 0; t < g.len[e]; ++t) {
          int i = g.iw[pe_ + t];
          if (g.nv[i] > 0 && g.w[i] < mark) {
            g.w[i] = mark;
            Lk.push_back(i);
          }
        }
        // absorb element e into me
        g.elen[e] = -1;
        g.pe[e] = -1;
      }
      // then variables
      for (int k = el; k < ln; ++k) {
        int i = g.iw[p + k];
        if (i == me) continue;
        if (g.nv[i] > 0 && g.w[i] < mark) {
          g.w[i] = mark;
          Lk.push_back(i);
        }
      }
    }

    // me becomes element with list Lk
    {
      int need = static_cast<int>(Lk.size());
      int64_t q = g.reserve(need, me);
      g.pe[me] = q;
      for (int i : Lk) g.iw[q++] = i;
      g.pfree = q;
      g.len[me] = need;
      g.elen[me] = -2;  // live element marker
    }

    // ---- update each variable i in Lk
    // approximate degree: d_i = min(n - nleft, old_d + |Lk \ i|, sum |Le \ Lk|)
    // we use the standard two-pass with w[] counts: first pass computes
    // |Le ∩ Lk| for each element e adjacent to Lk members.
    mark = g.clear_flag();
    int64_t mark2 = mark;
    // pass-1 counts write values up to mark2 + n into w[]; the next
    // elimination's marks must clear them, so advance wflg past that
    g.wflg = mark2 + g.n + 2;
    // pass 1: for each i in Lk, for each element e in i's list, count
    // w[e] = |Le| - |Le ∩ Lk| incrementally: start w[e] = |Le| first time
    // seen, decrement by nv[i] each time a member of Lk touches it.
    for (int i : Lk) {
      int64_t p = g.pe[i];
      for (int k = 0; k < g.elen[i]; ++k) {
        int e = g.iw[p + k];
        if (g.elen[e] != -2) continue;
        if (g.w[e] < mark2) {
          // first touch: external size of Le
          int ext = 0;
          int64_t pe_ = g.pe[e];
          for (int t = 0; t < g.len[e]; ++t) {
            int v = g.iw[pe_ + t];
            if (g.nv[v] > 0) ext += g.nv[v];
          }
          g.w[e] = mark2 + ext;
        }
        g.w[e] -= g.nv[i];
      }
    }

    int lk_weight = 0;
    for (int i : Lk) lk_weight += g.nv[i];

    // pass 2: compact each i's list (drop absorbed elements, Lk members and
    // dead variables), compute the approximate external degree
    //   d_i = |Lk \ i| + sum_e |Le \ Lk| + |live direct vars not in Lk|
    // and detect supervariable merges by adjacency hash.
    for (int i : Lk) inlk[i] = 1;
    std::vector<std::pair<uint64_t, int>> hashes;
    hashes.reserve(Lk.size());
    std::vector<int> scratch;
    for (int i : Lk) {
      int old_deg = g.degree[i];
      remove_from_list(i);
      int64_t p = g.pe[i];
      scratch.clear();
      int new_elen = 0;
      int deg = 0;
      uint64_t h = 0;
      // elements: keep live ones with nonzero external contribution
      for (int k = 0; k < g.elen[i]; ++k) {
        int e = g.iw[p + k];
        if (g.elen[e] != -2 || e == me) continue;
        int ext = static_cast<int>(g.w[e] - mark2);  // |Le \ Lk| by weight
        if (ext < 0) ext = 0;
        if (ext == 0) {
          // element entirely inside Lk: absorb into me
          g.elen[e] = -1;
          g.pe[e] = -1;
          continue;
        }
        deg += ext;
        scratch.push_back(e);
        ++new_elen;
        h += static_cast<uint64_t>(e) + 1;  // order-independent
      }
      // me joins the element list
      scratch.push_back(me);
      ++new_elen;
      h += static_cast<uint64_t>(me) + 1;
      // variables: keep live ones not in Lk (Lk members are now adjacent
      // through me); they contribute their supervariable weight to d_i
      for (int k = g.elen[i]; k < g.len[i]; ++k) {
        int v = g.iw[p + k];
        if (v == me || g.nv[v] <= 0 || inlk[v]) continue;
        deg += g.nv[v];
        scratch.push_back(v);
        h += static_cast<uint64_t>(v) + 1;
      }
      // write back: the new list can be one longer than the old slot
      // (me appended with nothing dropped) — relocate in that case.
      int nl = static_cast<int>(scratch.size());
      if (nl <= g.len[i]) {
        for (int k = 0; k < nl; ++k) g.iw[p + k] = scratch[k];
      } else {
        int64_t q0 = g.reserve(nl, me);
        g.pe[i] = q0;
        for (int k = 0; k < nl; ++k) g.iw[q0 + k] = scratch[k];
        g.pfree = q0 + nl;
      }
      g.elen[i] = new_elen;
      g.len[i] = nl;
      // approximate external degree: min of the three Amestoy bounds —
      // worst case (everything left), growth bound (old degree can only
      // grow by the new element), and the computed element/variable sum
      // (which double-counts variables shared between elements).
      int lk_ext = lk_weight - g.nv[i];
      deg += lk_ext;
      int cap = nleft - g.nv[i];
      int growth = old_deg + lk_ext;
      if (deg > growth) deg = growth;
      if (deg > cap) deg = cap;
      if (deg < 0) deg = 0;
      g.degree[i] = deg;
      hashes.push_back({h, i});
    }
    for (int i : Lk) inlk[i] = 0;

    // supervariable detection: sort by hash, compare lists pairwise
    std::sort(hashes.begin(), hashes.end());
    for (size_t a = 0; a + 1 < hashes.size();) {
      size_t b = a + 1;
      while (b < hashes.size() && hashes[b].first == hashes[a].first) ++b;
      // candidates [a, b) share a hash: pairwise exact compare
      for (size_t x = a; x < b; ++x) {
        int i = hashes[x].second;
        if (g.nv[i] <= 0) continue;
        for (size_t y = x + 1; y < b; ++y) {
          int j = hashes[y].second;
          if (g.nv[j] <= 0) continue;
          if (g.len[i] != g.len[j] || g.elen[i] != g.elen[j]) continue;
          // exact set compare via marks
          int64_t cm = g.wflg;
          g.wflg = cm + 1;
          int64_t pi = g.pe[i];
          for (int k = 0; k < g.len[i]; ++k) g.w[g.iw[pi + k]] = cm;
          bool same = true;
          int64_t pj = g.pe[j];
          for (int k = 0; k < g.len[j]; ++k)
            if (g.w[g.iw[pj + k]] != cm) { same = false; break; }
          if (same) {
            // merge j into i
            g.nv[i] += g.nv[j];
            g.nv[j] = 0;
            g.elen[j] = -1;
            g.pe[j] = -1;
            sv_next[sv_tail[i]] = j;
            sv_tail[i] = sv_tail[j];
          }
        }
      }
      a = b;
    }

    // reinsert surviving Lk members into degree lists
    for (int i : Lk) {
      if (g.nv[i] > 0) add_to_list(i);
    }
  }

  // expand supervariable chains into the final permutation
  int pos = 0;
  for (int rep : order) {
    for (int v = rep; v != -1; v = sv_next[v]) perm_out[pos++] = v;
  }
  return (pos == n) ? 0 : 1;
}

// ---------------------------------------------------------------------------
// General-graph nested dissection (George-Liu automatic ND).
//
// The grid problems get geometric ND in Python (solve/ordering.py); this is
// the native ordering for UNSTRUCTURED symmetric patterns, where ND's
// O(separator^3) fronts beat AMD's local greedy choices on mesh-like graphs
// at scale.  Recursive level-set bisection: pseudo-peripheral BFS, separator
// level chosen as the thinnest balanced level, shrunk to the vertices with
// neighbors across the cut (a minimal one-sided separator), leaves ordered
// by the AMD engine above.
//
// C API (ctypes):
//   ok = slt_nd(n, indptr, indices, leaf, perm_out)   // 0 on success
// ---------------------------------------------------------------------------

namespace {

struct NdCtx {
  int n;
  const int64_t* indptr;
  const int* indices;
  std::vector<int> stamp;    // membership stamp per global node
  std::vector<int> level;    // BFS level per global node (valid when stamped)
  std::vector<int> seen;     // BFS visited stamp
  int cur = 0;               // current job stamp
  int bfs_cur = 0;           // current BFS stamp
  int* out;
  int cursor = 0;

  explicit NdCtx(int n_) : n(n_), stamp(n_, -1), level(n_, 0), seen(n_, -1) {}

  void emit(const std::vector<int>& nodes) {
    for (int v : nodes) out[cursor++] = v;
  }

  // AMD on the induced subgraph of `nodes` (local relabeling), append.
  void leaf_amd(const std::vector<int>& nodes, std::vector<int>& loc) {
    const int m = (int)nodes.size();
    if (m <= 2) { emit(nodes); return; }
    for (int i = 0; i < m; ++i) loc[nodes[i]] = i;
    std::vector<int64_t> sp(m + 1, 0);
    std::vector<int> si;
    si.reserve(16 * (size_t)m);
    for (int i = 0; i < m; ++i) {
      int g = nodes[i];
      for (int64_t p = indptr[g]; p < indptr[g + 1]; ++p) {
        int w = indices[p];
        if (w != g && stamp[w] == cur) si.push_back(loc[w]);
      }
      sp[i + 1] = (int64_t)si.size();
    }
    std::vector<int> lperm(m);
    if (slt_amd(m, sp.data(), si.data(), lperm.data()) == 0) {
      for (int k = 0; k < m; ++k) out[cursor++] = nodes[lperm[k]];
    } else {
      emit(nodes);
    }
    for (int i = 0; i < m; ++i) loc[nodes[i]] = -1;
  }

  // BFS over the stamped subgraph from `root`; fills `order` (discovery)
  // and level[]; returns the height (max level).
  int bfs(int root, const std::vector<int>& nodes, std::vector<int>& order) {
    (void)nodes;
    ++bfs_cur;
    order.clear();
    order.push_back(root);
    seen[root] = bfs_cur;
    level[root] = 0;
    int h = 0;
    for (size_t q = 0; q < order.size(); ++q) {
      int u = order[q];
      for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
        int w = indices[p];
        if (w == u || stamp[w] != cur || seen[w] == bfs_cur) continue;
        seen[w] = bfs_cur;
        level[w] = level[u] + 1;
        if (level[w] > h) h = level[w];
        order.push_back(w);
      }
    }
    return h;
  }
};

}  // namespace

extern "C" int slt_nd(int n, const int64_t* indptr, const int* indices,
                      int leaf, int* perm_out) {
  if (n <= 0) return 0;
  if (leaf < 4) leaf = 4;
  NdCtx W(n);
  W.indptr = indptr;
  W.indices = indices;
  W.out = perm_out;
  std::vector<int> loc(n, -1);  // shared local-id scratch for leaf AMD

  // explicit op stack: ("recurse", nodes) / ("emit", separator); children
  // are pushed before the separator so separators are eliminated LAST
  struct Job { std::vector<int> nodes; bool is_emit; };
  std::vector<Job> stack;
  {
    std::vector<int> all(n);
    for (int i = 0; i < n; ++i) all[i] = i;
    stack.push_back({std::move(all), false});
  }
  std::vector<int> order;
  int next_stamp = 0;

  while (!stack.empty()) {
    Job job = std::move(stack.back());
    stack.pop_back();
    if (job.is_emit) { W.emit(job.nodes); continue; }
    std::vector<int>& nodes = job.nodes;
    const int m = (int)nodes.size();
    // stamp membership for this job
    W.cur = ++next_stamp;
    for (int v : nodes) W.stamp[v] = W.cur;
    if (m <= leaf) { W.leaf_amd(nodes, loc); continue; }

    // connected components of the stamped subgraph
    std::vector<std::vector<int>> comps;
    {
      ++W.bfs_cur;
      int comp_stamp = W.bfs_cur;
      for (int v : nodes) {
        if (W.seen[v] == comp_stamp) continue;
        comps.emplace_back();
        std::vector<int>& c = comps.back();
        c.push_back(v);
        W.seen[v] = comp_stamp;
        for (size_t q = 0; q < c.size(); ++q) {
          int u = c[q];
          for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
            int w = indices[p];
            if (w == u || W.stamp[w] != W.cur || W.seen[w] == comp_stamp)
              continue;
            W.seen[w] = comp_stamp;
            c.push_back(w);
          }
        }
      }
    }

    for (std::vector<int>& comp : comps) {
      const int cm = (int)comp.size();
      // the component BFS above may have been invalidated by later comps'
      // stamps — re-stamp this component alone for the bisection phase
      W.cur = ++next_stamp;
      for (int v : comp) W.stamp[v] = W.cur;
      if (cm <= leaf) { W.leaf_amd(comp, loc); continue; }

      // pseudo-peripheral root: double BFS, tie-break by low degree
      int root = comp[0];
      int h = 0;
      for (int rep = 0; rep < 2; ++rep) {
        h = W.bfs(root, comp, order);
        if (h == 0) break;
        int best = order.back();
        int64_t bdeg = indptr[best + 1] - indptr[best];
        for (auto it = order.rbegin();
             it != order.rend() && W.level[*it] == h; ++it) {
          int64_t d = indptr[*it + 1] - indptr[*it];
          if (d < bdeg) { best = *it; bdeg = d; }
        }
        root = best;
      }
      if (h < 2) { W.leaf_amd(comp, loc); continue; }
      h = W.bfs(root, comp, order);

      // level sizes + cumulative counts
      std::vector<int> lsize(h + 1, 0);
      for (int v : comp) ++lsize[W.level[v]];
      // pick separator level j in [1, h-1]: thinnest level whose two
      // sides both hold >= 25% of the component; fallback = most balanced
      int bestj = -1;
      long bestw = 1L << 30;
      int fallj = 1;
      long fallbal = 1L << 30;
      long cum = lsize[0];
      for (int j = 1; j <= h - 1; ++j) {
        long below = cum;             // levels 0..j-1
        cum += lsize[j];
        long above = (long)cm - cum;  // levels j+1..h
        long bal = (below > above) ? below - above : above - below;
        if (bal < fallbal) { fallbal = bal; fallj = j; }
        if (below >= cm / 4 && above >= cm / 4 && lsize[j] < bestw) {
          bestw = lsize[j];
          bestj = j;
        }
      }
      const int j = (bestj >= 0) ? bestj : fallj;

      // separator: vertices of L_j with a neighbor in L_{j+1} (one-sided
      // shrink — the rest of L_j has no cross edges and joins side A)
      std::vector<int> A, B, S;
      A.reserve(cm);
      for (int v : comp) {
        int lv = W.level[v];
        if (lv < j) { A.push_back(v); continue; }
        if (lv > j) { B.push_back(v); continue; }
        bool cross = false;
        for (int64_t p = indptr[v]; p < indptr[v + 1]; ++p) {
          int w = indices[p];
          if (w != v && W.stamp[w] == W.cur && W.level[w] == j + 1) {
            cross = true;
            break;
          }
        }
        if (cross) S.push_back(v); else A.push_back(v);
      }
      if (A.empty() || B.empty() || S.empty() ||
          (int)S.size() >= cm - (int)S.size()) {
        // degenerate cut: no progress possible this way
        W.leaf_amd(comp, loc);
        continue;
      }
      // out-order: A, B, then S — push emit first, recurse last (LIFO)
      stack.push_back({std::move(S), true});
      stack.push_back({std::move(B), false});
      stack.push_back({std::move(A), false});
    }
  }
  return (W.cursor == n) ? 0 : 1;
}
