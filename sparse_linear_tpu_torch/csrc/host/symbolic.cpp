// Symbolic analysis engine for the multifrontal sparse LU.
//
// Native replacement for the capability the reference reaches through
// UMFPACK's symbolic phase (reference: suitesparse/src/Numeric/LinearAlgebra/
// Umfpack/Internal.hs:62,137-138 binds umfpack_*_symbolic): elimination tree,
// postorder, per-column factor structures, fundamental supernodes with
// relaxed amalgamation, and per-supernode frontal row lists.  The numeric
// phase consumes this schedule as batched dense front algebra on the card
// (sparse_linear_tpu_torch/solve/multifrontal.py).
//
// Input: the structurally-symmetrized pattern of the permuted matrix in CSC
// (== CSR, pattern symmetric), WITH diagonal entries present.
// All indices are int32, the port's index width.
//
// C API (ctypes):
//   nnz = slt_symmetrize(n, indptr, indices, perm, out_indptr, out_indices)
//                               -> the input above, built from A's CSR
//   handle = slt_analyze(n, indptr, indices, relax_small, relax_frac)
//   slt_sizes(handle, out[6])   -> nsuper, rows_total, lnnz, tree_height,
//                                  max_front, max_pivots
//   slt_arrays(handle, sup_start, sup_parent, sup_level, rows_ptr, rows)
//   slt_free(handle)
//
// A copy of the JAX package's engine of the same name, kept with the port so
// that it builds and loads its own.  Built with ordering.cpp by
// sparse_linear_tpu_torch/utils/native.py:
//   g++ -O2 -shared -fPIC symbolic.cpp ordering.cpp -o libslt_host_<hash>.so

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Symbolic {
  int n = 0;
  int nsuper = 0;
  int64_t lnnz = 0;
  std::vector<int> sup_start;   // (nsuper+1) first column of each supernode
  std::vector<int> sup_parent;  // (nsuper) parent supernode or -1
  std::vector<int> sup_level;   // (nsuper) distance from leaves (0 = leaf lvl)
  std::vector<int> rows_ptr;    // (nsuper+1) offsets into rows
  std::vector<int> rows;        // concatenated sorted frontal row lists; the
                                // first (#cols of s) entries are the pivots
};

// Liu's elimination-tree algorithm with path compression.
void etree(int n, const int* indptr, const int* indices,
           std::vector<int>& parent) {
  parent.assign(n, -1);
  std::vector<int> ancestor(n, -1);
  for (int j = 0; j < n; ++j) {
    for (int p = indptr[j]; p < indptr[j + 1]; ++p) {
      int i = indices[p];
      if (i >= j) continue;
      while (i != -1 && i < j) {
        int next = ancestor[i];
        ancestor[i] = j;
        if (next == -1) {
          parent[i] = j;
          break;
        }
        i = next;
      }
    }
  }
}

// Children lists from parent pointers, in column order.
void children_lists(int n, const std::vector<int>& parent,
                    std::vector<int>& head, std::vector<int>& next) {
  head.assign(n, -1);
  next.assign(n, -1);
  for (int j = n - 1; j >= 0; --j) {
    int p = parent[j];
    if (p != -1) {
      next[j] = head[p];
      head[p] = j;
    }
  }
}

// Iterative postorder of the forest.
void postorder(int n, const std::vector<int>& parent, std::vector<int>& post) {
  std::vector<int> head, next;
  children_lists(n, parent, head, next);
  post.clear();
  post.reserve(n);
  std::vector<int> stack;
  for (int r = 0; r < n; ++r) {
    if (parent[r] != -1) continue;
    stack.push_back(r);
    while (!stack.empty()) {
      int j = stack.back();
      int c = head[j];
      if (c != -1) {
        head[j] = next[c];  // consume
        stack.push_back(c);
      } else {
        post.push_back(j);
        stack.pop_back();
      }
    }
  }
}

Symbolic* analyze(int n, const int* indptr, const int* indices,
                  int relax_small, double relax_frac) {
  auto* sym = new Symbolic();
  sym->n = n;

  std::vector<int> parent;
  etree(n, indptr, indices, parent);

  // NOTE: column_structs frees child vectors after merging, but supernode
  // detection needs every column's structure.  Rebuild per-column structures
  // without freeing: memory O(|L|).
  std::vector<std::vector<int>> st(n);
  {
    std::vector<int> head, next, post;
    children_lists(n, parent, head, next);
    postorder(n, parent, post);
    std::vector<int> buf;
    for (int idx = 0; idx < n; ++idx) {
      int j = post[idx];
      buf.clear();
      for (int p = indptr[j]; p < indptr[j + 1]; ++p) {
        int i = indices[p];
        if (i > j) buf.push_back(i);
      }
      for (int c = head[j]; c != -1; c = next[c])
        for (int r : st[c])
          if (r > j) buf.push_back(r);
      std::sort(buf.begin(), buf.end());
      buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
      st[j] = buf;
    }
  }

  // fundamental supernodes: column j continues the current supernode iff
  // parent[j-1] == j and |struct(j)| == |struct(j-1)| - 1 (structures nest).
  std::vector<int> starts;
  starts.push_back(0);
  for (int j = 1; j < n; ++j) {
    bool cont = (parent[j - 1] == j) &&
                ((int)st[j].size() == (int)st[j - 1].size() - 1);
    if (!cont) starts.push_back(j);
  }
  starts.push_back(n);

  int ns0 = (int)starts.size() - 1;
  // supernode of each column
  std::vector<int> sup_of(n);
  for (int s = 0; s < ns0; ++s)
    for (int j = starts[s]; j < starts[s + 1]; ++j) sup_of[j] = s;

  // supernode parent: supernode of parent[last column]
  std::vector<int> sparent(ns0, -1);
  for (int s = 0; s < ns0; ++s) {
    int last = starts[s + 1] - 1;
    int p = parent[last];
    sparent[s] = (p == -1) ? -1 : sup_of[p];
  }

  // relaxed amalgamation: merge a supernode into its parent when the child
  // is small or the merge wastes little fill.  Front of s: rows(s) =
  // {cols of s} U struct(last col handled below).  We approximate the waste
  // test with sizes only (exact union computed afterwards).
  std::vector<int> merge_into(ns0);
  for (int s = 0; s < ns0; ++s) merge_into[s] = s;
  // process children before parents: supernodes are ordered by first column,
  // and sparent[s] > s always, so a reverse scan visits parents first; do a
  // forward scan instead so chains collapse upward.
  std::vector<int> ncols(ns0), nrows_below(ns0);
  for (int s = 0; s < ns0; ++s) {
    ncols[s] = starts[s + 1] - starts[s];
    nrows_below[s] = (int)st[starts[s + 1] - 1].size();
  }
  // exact structural-zero accounting for a candidate merged front:
  // front with pivot columns [c0, c1) and b below-rows (= the root
  // supernode's below-rows; children's below-rows are contained in the
  // parent's columns+below) has area (nc+b)^2, of which the dense Schur
  // block b^2 plus 2*cc[j]-1 per pivot column are structurally useful.
  std::vector<int64_t> useful_prefix(n + 1, 0);
  for (int j = 0; j < n; ++j)
    useful_prefix[j + 1] =
        useful_prefix[j] + (2 * ((int64_t)st[j].size() + 1) - 1);
  std::vector<int> eff_start(ns0);
  for (int s = 0; s < ns0; ++s) eff_start[s] = starts[s];
  for (int s = ns0 - 1; s >= 0; --s) {
    int p = sparent[s];
    if (p == -1) continue;
    int pr = merge_into[p];
    while (merge_into[pr] != pr) pr = merge_into[pr];
    // merged supernode columns must stay contiguous: the child's column
    // range must end exactly where the (already-merged) parent's begins
    if (starts[s + 1] != eff_start[pr]) continue;
    int64_t b = nrows_below[pr];
    int64_t mc = ncols[s] + ncols[pr];
    int64_t mf = mc + b;
    int c0 = starts[s];
    int c1 = c0 + (int)mc;
    int64_t useful = (useful_prefix[c1] - useful_prefix[c0]) + b * b;
    int64_t zeros_total = mf * mf - useful;
    double frac = mc <= 16 ? relax_frac
                  : mc <= 64 ? 0.5 * relax_frac
                  : mc <= 256 ? 0.2 * relax_frac
                              : 0.04 * relax_frac;
    int64_t child_front = ncols[s] + nrows_below[s];
    bool small = child_front <= relax_small &&
                 zeros_total <= relax_frac * (double)(mf * mf);
    bool cheap = zeros_total <= frac * (double)(mf * mf);
    if (small || cheap) {
      merge_into[s] = pr;
      ncols[pr] += ncols[s];
      eff_start[pr] = starts[s];
    }
  }

  // compact merged supernodes (merge_into chains point directly at targets
  // because parents were processed... ensure full collapse)
  for (int s = 0; s < ns0; ++s) {
    int t = s;
    while (merge_into[t] != t) t = merge_into[t];
    merge_into[s] = t;
  }
  // new supernode ids in order of first column
  std::vector<int> first_col(ns0, -1);
  for (int s = 0; s < ns0; ++s) {
    int t = merge_into[s];
    if (first_col[t] == -1 || starts[s] < first_col[t]) first_col[t] = starts[s];
  }
  std::vector<int> roots;
  for (int s = 0; s < ns0; ++s)
    if (merge_into[s] == s) roots.push_back(s);
  std::sort(roots.begin(), roots.end(),
            [&](int a, int b) { return first_col[a] < first_col[b]; });
  std::vector<int> new_id(ns0, -1);
  for (int k = 0; k < (int)roots.size(); ++k) new_id[roots[k]] = k;
  int nsuper = (int)roots.size();

  // rebuild column->supernode and starts
  std::vector<int> sup_of2(n), sstart(nsuper + 1, 0);
  for (int s = 0; s < ns0; ++s) {
    int t = new_id[merge_into[s]];
    for (int j = starts[s]; j < starts[s + 1]; ++j) sup_of2[j] = t;
  }
  // columns of a merged supernode are contiguous by construction
  for (int j = 0; j < n; ++j) sstart[sup_of2[j] + 1] = j + 1;
  sstart[0] = 0;

  // supernode parent over merged ids
  std::vector<int> sparent2(nsuper, -1);
  for (int t = 0; t < nsuper; ++t) {
    int last = sstart[t + 1] - 1;
    int p = parent[last];
    sparent2[t] = (p == -1) ? -1 : sup_of2[p];
  }

  // frontal rows: pivots (cols of s) followed by struct(last col of s)
  // restricted to rows outside s, UNION over all columns of s of their
  // structures (merged supernodes widen the union).
  sym->rows_ptr.assign(nsuper + 1, 0);
  std::vector<std::vector<int>> fronts(nsuper);
  {
    std::vector<int> buf;
    for (int t = 0; t < nsuper; ++t) {
      int c0 = sstart[t], c1 = sstart[t + 1];
      buf.clear();
      for (int j = c0; j < c1; ++j)
        for (int r : st[j])
          if (r >= c1) buf.push_back(r);
      std::sort(buf.begin(), buf.end());
      buf.erase(std::unique(buf.begin(), buf.end()), buf.end());
      auto& f = fronts[t];
      f.reserve((c1 - c0) + buf.size());
      for (int j = c0; j < c1; ++j) f.push_back(j);
      f.insert(f.end(), buf.begin(), buf.end());
    }
  }

  int64_t rows_total = 0, lnnz = 0;
  int max_front = 0, max_piv = 0;
  for (int t = 0; t < nsuper; ++t) {
    int fs = (int)fronts[t].size();
    int nc = sstart[t + 1] - sstart[t];
    rows_total += fs;
    lnnz += (int64_t)nc * fs;  // L columns (including pivot block)
    max_front = std::max(max_front, fs);
    max_piv = std::max(max_piv, nc);
  }
  sym->rows.reserve(rows_total);
  for (int t = 0; t < nsuper; ++t) {
    sym->rows_ptr[t + 1] = sym->rows_ptr[t] + (int)fronts[t].size();
    sym->rows.insert(sym->rows.end(), fronts[t].begin(), fronts[t].end());
  }

  // levels (distance from leaves) for the batched schedule
  sym->sup_level.assign(nsuper, 0);
  int height = 0;
  for (int t = 0; t < nsuper; ++t) {
    int p = sparent2[t];
    if (p != -1)
      sym->sup_level[p] = std::max(sym->sup_level[p], sym->sup_level[t] + 1);
  }
  for (int t = 0; t < nsuper; ++t) height = std::max(height, sym->sup_level[t]);

  sym->nsuper = nsuper;
  sym->lnnz = lnnz;
  sym->sup_start = std::move(sstart);
  sym->sup_parent = std::move(sparent2);
  (void)max_piv;
  sym->rows_ptr.back() = (int)rows_total;
  // stash sizes for slt_sizes
  sym->sup_level.push_back(height);      // appended: height
  sym->sup_level.push_back(max_front);   // appended: max front
  sym->sup_level.push_back(max_piv);     // appended: max pivots
  return sym;
}

}  // namespace

extern "C" {

// The canonical CSR of P (A + A^T + I) P^T, P sending node perm[k] to k:
// every row's columns sorted and unique, its diagonal present.  O(nnz + n),
// with no sort: each entry is scattered to its row and to its column, one
// counting-sort transpose puts every row's columns in ascending order (the
// scattered pattern is symmetric, so its transpose has the same rows), and
// repeats, now adjacent, are dropped as they arrive.  out_indices must hold
// 2 nnz(A) + n entries; the pattern's own nnz, which it returns, are the
// first ones.  Returns -1 when perm is not a permutation or an index lies
// outside [0, n).
int64_t slt_symmetrize(int n, const int64_t* indptr, const int* indices,
                       const int* perm, int64_t* out_indptr,
                       int* out_indices) {
  std::vector<int> iperm(n, -1);
  for (int k = 0; k < n; ++k) {
    int v = perm[k];
    if (v < 0 || v >= n || iperm[v] != -1) return -1;
    iperm[v] = k;
  }
  const int64_t nnz = indptr[n];
  // row lengths of the scattered pattern, then their offsets
  std::vector<int64_t> ptr(n + 1, 0);
  for (int i = 0; i < n; ++i) {
    ptr[iperm[i] + 1] += indptr[i + 1] - indptr[i] + 1;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int j = indices[p];
      if (j < 0 || j >= n) return -1;
      ++ptr[iperm[j] + 1];
    }
  }
  for (int r = 0; r < n; ++r) ptr[r + 1] += ptr[r];
  // scatter (row, col), (col, row) and the diagonal, unordered in each row
  std::vector<int> cols(2 * nnz + n);
  std::vector<int64_t> pos(ptr.begin(), ptr.end() - 1);
  for (int i = 0; i < n; ++i) {
    int r = iperm[i];
    cols[pos[r]++] = r;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int c = iperm[indices[p]];
      cols[pos[r]++] = c;
      cols[pos[c]++] = r;
    }
  }
  // transpose: rows visited in ascending order leave each row sorted
  std::copy(ptr.begin(), ptr.end() - 1, pos.begin());
  for (int r = 0; r < n; ++r)
    for (int64_t p = ptr[r]; p < ptr[r + 1]; ++p) {
      int c = cols[p];
      if (pos[c] == ptr[c] || out_indices[pos[c] - 1] != r)
        out_indices[pos[c]++] = r;
    }
  // close the gaps the repeats left
  int64_t q = 0;
  out_indptr[0] = 0;
  for (int r = 0; r < n; ++r) {
    for (int64_t p = ptr[r]; p < pos[r]; ++p) out_indices[q++] = out_indices[p];
    out_indptr[r + 1] = q;
  }
  return q;
}

void* slt_analyze(int n, const int* indptr, const int* indices,
                  int relax_small, double relax_frac) {
  return analyze(n, indptr, indices, relax_small, relax_frac);
}

void slt_sizes(void* handle, int64_t* out) {
  auto* sym = static_cast<Symbolic*>(handle);
  int nsuper = sym->nsuper;
  out[0] = nsuper;
  out[1] = sym->rows_ptr[nsuper];
  out[2] = sym->lnnz;
  out[3] = sym->sup_level[nsuper];      // height
  out[4] = sym->sup_level[nsuper + 1];  // max front
  out[5] = sym->sup_level[nsuper + 2];  // max pivots
}

void slt_arrays(void* handle, int* sup_start, int* sup_parent, int* sup_level,
                int* rows_ptr, int* rows) {
  auto* sym = static_cast<Symbolic*>(handle);
  int nsuper = sym->nsuper;
  std::copy(sym->sup_start.begin(), sym->sup_start.end(), sup_start);
  std::copy(sym->sup_parent.begin(), sym->sup_parent.end(), sup_parent);
  std::copy(sym->sup_level.begin(), sym->sup_level.begin() + nsuper, sup_level);
  std::copy(sym->rows_ptr.begin(), sym->rows_ptr.end(), rows_ptr);
  std::copy(sym->rows.begin(), sym->rows.end(), rows);
}

void slt_free(void* handle) { delete static_cast<Symbolic*>(handle); }

}  // extern "C"
