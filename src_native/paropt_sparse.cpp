// Native sparse linear algebra for the general-CSR constraint path.
//
// Role-equivalent of the reference's serial sparse kernels:
//   - ParOptAMD.{h,cpp}            : approximate-minimum-degree ordering
//   - ParOptSparseCholesky.{h,cpp} : sparse Cholesky factorization
//   - ParOptSparseUtils.{h,cpp}    : CSR utilities, C + A*D*A^T products
//
// Like the reference's ParOptQuasiDefSparseMat ("a simple serial LDL sparse
// matrix factorization", ParOptSparseMat.cpp:231-233) this path is serial
// per-host: irregular sparse factorization is a poor fit for the accelerator,
// so it runs on the host CPU while the device executes the dense/batched work.
//
// Algorithms are standard textbook forms (elimination tree, ereach,
// up-looking Cholesky; quotient-graph minimum degree), implemented from
// scratch.  C API only — consumed from Python via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// elimination tree of A (CSC/CSR of a symmetric matrix, pattern only)
// ---------------------------------------------------------------------------
void build_etree(int n, const int* rowp, const int* cols, int* parent,
                 std::vector<int>& ancestor) {
  ancestor.assign(n, -1);
  for (int k = 0; k < n; k++) {
    parent[k] = -1;
    for (int p = rowp[k]; p < rowp[k + 1]; p++) {
      int i = cols[p];
      // walk from i up to the root of its subtree, path-compressing
      while (i != -1 && i < k) {
        int inext = ancestor[i];
        ancestor[i] = k;
        if (inext == -1) {
          parent[i] = k;
        }
        i = inext;
      }
    }
  }
}

// reach of row k in the elimination tree: pattern of row k of L.
// Returns the row pattern in topological order in s[top..n-1].
int ereach(int n, const int* rowp, const int* cols, int k, const int* parent,
           int* s, int* w) {
  int top = n;
  w[k] = k;  // mark k
  for (int p = rowp[k]; p < rowp[k + 1]; p++) {
    int i = cols[p];
    if (i > k) continue;
    int len = 0;
    while (w[i] != k) {  // traverse up the etree
      s[len++] = i;
      w[i] = k;
      i = parent[i];
    }
    while (len > 0) {
      s[--top] = s[--len];
    }
  }
  return top;  // s[top..n-1] = pattern (excluding k)
}

struct CholHandle {
  int n = 0;
  // permutation (new = perm[old]); identity when natural ordering
  std::vector<int> perm, iperm;
  // permuted matrix pattern (upper-including-diagonal per row, CSR)
  std::vector<int> arowp, acols;
  std::vector<int> aval_src;  // map to original value array positions
  // elimination tree + column pointers of L (CSC-like, by column)
  std::vector<int> parent;
  std::vector<int> lp;    // size n+1
  std::vector<int> li;    // row indices of L (below diagonal)
  std::vector<double> lx; // values of L (below diagonal)
  std::vector<double> d;  // diagonal of L (L has sqrt'd diagonal)
  bool symbolic_done = false;
};

// build the permuted "lower" pattern: row k holds column indices j <= k
void build_permuted_lower(CholHandle* h, int n, const int* rowp,
                          const int* cols) {
  h->arowp.assign(n + 1, 0);
  std::vector<std::vector<std::pair<int, int>>> rows(n);
  // Map EVERY input entry to its permuted lower-triangle image (no
  // pi>=pj filter): half-stored single-triangle patterns then still
  // cover the full lower pattern after permutation, and a symmetric
  // pair (i,j)/(j,i) simply produces a duplicate that the dedupe below
  // collapses.
  for (int i = 0; i < n; i++) {
    int pi = h->perm[i];
    for (int p = rowp[i]; p < rowp[i + 1]; p++) {
      int pj = h->perm[cols[p]];
      int r = std::max(pi, pj);
      int c = std::min(pi, pj);
      rows[r].push_back({c, p});
    }
  }
  for (int r = 0; r < n; r++) {
    std::sort(rows[r].begin(), rows[r].end());
    // dedupe keeping the FIRST source position per (r,c) — one
    // convention for both the simplicial and supernodal factor paths
    // (for a symmetric input the duplicate holds the equal-valued
    // mirror entry; summing would double it)
    auto last = std::unique(
        rows[r].begin(), rows[r].end(),
        [](const std::pair<int, int>& a, const std::pair<int, int>& b) {
          return a.first == b.first;
        });
    rows[r].erase(last, rows[r].end());
    h->arowp[r + 1] = h->arowp[r] + (int)rows[r].size();
  }
  h->acols.resize(h->arowp[n]);
  h->aval_src.resize(h->arowp[n]);
  for (int r = 0; r < n; r++) {
    int base = h->arowp[r];
    for (size_t q = 0; q < rows[r].size(); q++) {
      h->acols[base + (int)q] = rows[r][q].first;
      h->aval_src[base + (int)q] = rows[r][q].second;
    }
  }
}

// ---------------------------------------------------------------------------
// Approximate minimum degree ordering (the role of ParOptAMD): quotient
// graph with element absorption, w-counter approximate external degrees,
// and indistinguishable-supervariable detection/merging.  Supervariables
// are expanded CONSECUTIVELY in the output ordering, which both reduces
// fill and creates the etree chains the supernodal factorization needs.
// ---------------------------------------------------------------------------
void min_degree_order(int n, const int* rowp, const int* cols, int* perm) {
  // nv: >=1 principal supervariable (value = # original columns); 0 =
  // absorbed into another supervariable; -1 = element; -2 = dead element
  std::vector<int> nv(n, 1);
  std::vector<std::vector<int>> A(n);  // variable: adjacent vars; element: L_e
  std::vector<std::vector<int>> E(n);  // adjacent elements (may hold stale)
  std::vector<int> deg(n, 0), esize(n, 0);
  std::vector<int> members_head(n, -1), members_next(n, -1),
      members_tail(n, -1);  // absorbed-column chains for output expansion

  for (int i = 0; i < n; i++) {
    for (int p = rowp[i]; p < rowp[i + 1]; p++) {
      int j = cols[p];
      if (j != i) A[i].push_back(j);
    }
    std::sort(A[i].begin(), A[i].end());
    A[i].erase(std::unique(A[i].begin(), A[i].end()), A[i].end());
    deg[i] = (int)A[i].size();
  }

  // degree buckets (doubly linked lists)
  std::vector<int> bhead(n + 1, -1), bnext(n, -1), bprev(n, -1);
  auto bucket_insert = [&](int i) {
    int d = deg[i];
    bnext[i] = bhead[d];
    bprev[i] = -1;
    if (bhead[d] != -1) bprev[bhead[d]] = i;
    bhead[d] = i;
  };
  auto bucket_remove = [&](int i) {
    int d = deg[i];
    if (bprev[i] != -1) {
      bnext[bprev[i]] = bnext[i];
    } else if (bhead[d] == i) {
      bhead[d] = bnext[i];
    }
    if (bnext[i] != -1) bprev[bnext[i]] = bprev[i];
    bnext[i] = bprev[i] = -1;
  };
  for (int i = 0; i < n; i++) bucket_insert(i);

  std::vector<int> markv(n, 0), w(n, -1);
  int markgen = 0;
  std::vector<int> Le, wlist, order;
  order.reserve(n);
  int mindeg = 0;

  int eliminated = 0;
  while (eliminated < n) {
    // pick a principal variable of minimum degree
    while (mindeg <= n && bhead[mindeg] == -1) mindeg++;
    int p = bhead[mindeg];
    bucket_remove(p);
    int nvp = nv[p];

    // ---- Le = (A_p ∪ ∪_{e∈E_p} L_e) \ {p, non-principal} ----
    markgen++;
    markv[p] = markgen;
    Le.clear();
    for (int e : E[p]) {
      if (nv[e] != -1) continue;  // dead element
      for (int i : A[e]) {
        if (nv[i] > 0 && markv[i] != markgen) {
          markv[i] = markgen;
          Le.push_back(i);
        }
      }
      nv[e] = -2;  // absorbed
      A[e].clear();
      A[e].shrink_to_fit();
    }
    for (int i : A[p]) {
      if (nv[i] > 0 && markv[i] != markgen) {
        markv[i] = markgen;
        Le.push_back(i);
      }
    }

    // p becomes an element with member list Le
    E[p].clear();
    A[p].assign(Le.begin(), Le.end());
    int le_size = 0;
    for (int i : Le) le_size += nv[i];
    esize[p] = le_size;
    nv[p] = -1;

    // ---- w counters: w[e] = |L_e \ Le| in Σnv units ----
    wlist.clear();
    for (int i : Le) {
      for (int e : E[i]) {
        if (nv[e] != -1 || e == p) continue;
        if (w[e] < 0) {
          w[e] = esize[e];
          wlist.push_back(e);
        }
        w[e] -= nv[i];
      }
    }
    // aggressive absorption: an old element whose members are all inside
    // Le is subsumed by the new element p — kill it so E lists converge
    // (which is what lets indistinguishable supervariables be detected)
    for (int e : wlist) {
      if (w[e] == 0) nv[e] = -2;
    }

    // ---- update each i in Le: prune lists, recompute degree ----
    for (int i : Le) {
      // A_i := A_i \ (Le ∪ dead); those entries are covered by element p
      int dA = 0;
      size_t t = 0;
      for (int a : A[i]) {
        if (nv[a] > 0 && markv[a] != markgen) {
          A[i][t++] = a;
          dA += nv[a];
        }
      }
      A[i].resize(t);
      // E_i := live elements + p; degree contribution |L_e \ Le| per element
      int dE = 0;
      t = 0;
      for (int e : E[i]) {
        if (nv[e] == -1 && e != p) {
          E[i][t++] = e;
          dE += (w[e] >= 0 ? w[e] : esize[e]);
        }
      }
      E[i].resize(t);
      E[i].push_back(p);
      int d = dA + dE + (le_size - nv[i]);
      if (d < 0) d = 0;
      if (d > n) d = n;
      bucket_remove(i);
      deg[i] = d;
      bucket_insert(i);
      if (d < mindeg) mindeg = d;
    }
    for (int e : wlist) w[e] = -1;

    // ---- indistinguishable supervariables: hash + exact compare in Le ----
    auto live_hash = [&](int i) {
      // hash over LIVE entries only (stale absorbed/dead ids would make
      // genuinely identical supervariables hash apart)
      long h = 0;
      for (int a : A[i]) {
        if (nv[a] > 0) h += a;
      }
      for (int e : E[i]) {
        if (nv[e] == -1) h += e;
      }
      return h;
    };
    for (size_t qi = 0; qi < Le.size(); qi++) {
      int i = Le[qi];
      if (nv[i] <= 0) continue;
      long hi = live_hash(i);
      for (size_t qj = qi + 1; qj < Le.size(); qj++) {
        int j = Le[qj];
        if (nv[j] <= 0) continue;
        if (live_hash(j) != hi) continue;
        std::vector<int> ai, aj;
        for (int a : A[i]) if (a != j && nv[a] > 0) ai.push_back(a);
        for (int a : A[j]) if (a != i && nv[a] > 0) aj.push_back(a);
        std::sort(ai.begin(), ai.end());
        std::sort(aj.begin(), aj.end());
        if (ai != aj) continue;
        std::vector<int> ei, ej;
        for (int e : E[i]) if (nv[e] == -1) ei.push_back(e);
        for (int e : E[j]) if (nv[e] == -1) ej.push_back(e);
        std::sort(ei.begin(), ei.end());
        std::sort(ej.begin(), ej.end());
        if (ei != ej) continue;
        // merge j into i: order j's columns right after i's.  The spliced
        // segment is [j, j's own member chain]: link j to its chain head
        // first so absorbed-of-absorbed columns aren't lost.
        bucket_remove(j);
        nv[i] += nv[j];
        members_next[j] = members_head[j];
        int seg_tail = (members_tail[j] == -1) ? j : members_tail[j];
        if (members_head[i] == -1) {
          members_head[i] = j;
        } else {
          members_next[members_tail[i]] = j;
        }
        members_tail[i] = seg_tail;
        nv[j] = 0;
        E[j].clear();
        A[j].clear();
      }
    }

    order.push_back(p);
    eliminated += nvp;
  }

  // expand supervariables: elimination order, each principal followed by
  // its absorbed member chain
  int pos = 0;
  for (int p : order) {
    perm[p] = pos++;
    for (int m = members_head[p]; m != -1; m = members_next[m]) {
      perm[m] = pos++;
    }
  }
}

// ---------------------------------------------------------------------------
// Nested-dissection ordering (the role of the reference's METIS_NodeND leg,
// ParOptSparseCholesky.cpp:7-78 / ordering enum ParOptSparseCholesky.h:7-11,
// implemented in-house — no METIS dependency): recursive bisection by BFS
// level sets from a pseudo-peripheral vertex, refined to a minimal vertex
// separator; parts are ordered first, the separator last; subgraphs at or
// below the leaf size are ordered by the quotient-graph minimum-degree
// routine above.  ND is what makes the supernodal factorization competitive
// on 2-D/3-D mesh-pattern Schur complements (wide dense separator panels).
// ---------------------------------------------------------------------------
class NDContext {
 public:
  NDContext(int n, const int* rowp, const int* cols, int leaf_size)
      : n_(n), leaf_size_(leaf_size), stampv_(n, -1), stamp_(0),
        level_(n, 0), local_(n, -1) {
    // deduped adjacency without the diagonal (pattern assumed symmetric,
    // as for min_degree_order)
    adjp_.assign(n + 1, 0);
    adj_.reserve(rowp[n]);
    for (int i = 0; i < n; i++) {
      size_t start = adj_.size();
      for (int p = rowp[i]; p < rowp[i + 1]; p++) {
        if (cols[p] != i) adj_.push_back(cols[p]);
      }
      std::sort(adj_.begin() + start, adj_.end());
      adj_.erase(std::unique(adj_.begin() + start, adj_.end()), adj_.end());
      adjp_[i + 1] = (int)adj_.size();
    }
    order_.reserve(n);
  }

  void run(int* perm) {
    std::vector<int> all(n_);
    for (int i = 0; i < n_; i++) all[i] = i;
    recurse(all);
    for (int pos = 0; pos < n_; pos++) perm[order_[pos]] = pos;
  }

 private:
  // BFS over the current member set from seed; fills levels_ & reached_.
  // Members are vertices with stampv_[v] == stamp_.
  void bfs(int seed) {
    reached_.clear();
    reached_.push_back(seed);
    level_[seed] = 0;
    visited_stamp_[seed] = stamp_;
    for (size_t qh = 0; qh < reached_.size(); qh++) {
      int v = reached_[qh];
      for (int p = adjp_[v]; p < adjp_[v + 1]; p++) {
        int w = adj_[p];
        if (stampv_[w] == stamp_ && visited_stamp_[w] != stamp_) {
          visited_stamp_[w] = stamp_;
          level_[w] = level_[v] + 1;
          reached_.push_back(w);
        }
      }
    }
  }

  void leaf_order(std::vector<int>& verts) {
    int m = (int)verts.size();
    if (m == 1) {
      order_.push_back(verts[0]);
      return;
    }
    // extract the subgraph in local indices and run minimum degree
    for (int i = 0; i < m; i++) local_[verts[i]] = i;
    std::vector<int> srowp(m + 1, 0), scols;
    for (int i = 0; i < m; i++) {
      int v = verts[i];
      for (int p = adjp_[v]; p < adjp_[v + 1]; p++) {
        int w = adj_[p];
        if (local_[w] >= 0 && stampv_[w] == stampv_[v]) {
          scols.push_back(local_[w]);
        }
      }
      srowp[i + 1] = (int)scols.size();
    }
    std::vector<int> lperm(m), lorder(m);
    min_degree_order(m, srowp.data(), scols.data(), lperm.data());
    for (int i = 0; i < m; i++) lorder[lperm[i]] = i;
    for (int i = 0; i < m; i++) order_.push_back(verts[lorder[i]]);
    for (int i = 0; i < m; i++) local_[verts[i]] = -1;
  }

  void recurse(std::vector<int>& verts) {
    int m = (int)verts.size();
    if (m == 0) return;
    if (m <= leaf_size_) {
      // stamp so leaf_order's subgraph extraction sees a consistent set
      stamp_++;
      for (int v : verts) stampv_[v] = stamp_;
      leaf_order(verts);
      return;
    }
    stamp_++;
    if ((int)visited_stamp_.size() < n_) visited_stamp_.assign(n_, -1);
    for (int v : verts) stampv_[v] = stamp_;

    bfs(verts[0]);
    if ((int)reached_.size() < m) {
      // disconnected: peel off EVERY component iteratively in this frame
      // (one-at-a-time recursion on the remainder would copy the O(m)
      // rest-vector per component — O(c^2) time and O(c) recursion depth
      // on c components, a hang on near-diagonal patterns)
      std::vector<std::vector<int>> comps;
      comps.push_back(reached_);
      for (int v : verts) {
        if (visited_stamp_[v] != stamp_) {
          bfs(v);  // visited marks persist across bfs calls (same stamp)
          comps.push_back(reached_);
        }
      }
      for (auto& comp : comps) recurse(comp);
      return;
    }

    // pseudo-peripheral seed: repeat BFS from the farthest vertex while
    // the eccentricity grows (cap the iterations)
    int ecc = level_[reached_.back()];
    for (int it = 0; it < 3; it++) {
      int far = reached_.back();
      int save_stamp = stamp_;
      stamp_++;  // fresh visited marks, same membership test via stampv_
      for (int v : verts) stampv_[v] = stamp_;
      bfs(far);
      (void)save_stamp;
      int ecc2 = level_[reached_.back()];
      if (ecc2 <= ecc) break;
      ecc = ecc2;
    }
    int h = level_[reached_.back()];
    if (h < 2) {
      // too shallow to split (near-clique); fall back to minimum degree
      leaf_order(verts);
      return;
    }

    // level-set sizes and the balanced cut with the thinnest level
    std::vector<int> lcount(h + 1, 0);
    for (int v : reached_) lcount[level_[v]]++;
    int best_l = -1, best_size = n_ + 1;
    int below = lcount[0];
    for (int l = 1; l < h; l++) {
      int above = m - below - lcount[l];
      if (below >= m / 4 && above >= m / 4 && lcount[l] < best_size) {
        best_size = lcount[l];
        best_l = l;
      }
      below += lcount[l];
    }
    if (best_l < 0) {
      // no balanced level: take the one closest to the median
      int cum = 0;
      for (int l = 0; l <= h; l++) {
        cum += lcount[l];
        if (cum >= m / 2) {
          best_l = std::max(1, std::min(l, h - 1));
          break;
        }
      }
    }

    // minimal vertex separator: members of level best_l adjacent to
    // level best_l + 1 (removing them disconnects below from above)
    std::vector<int> sep, partA, partB;
    for (int v : reached_) {
      int lv = level_[v];
      if (lv < best_l) {
        partA.push_back(v);
      } else if (lv > best_l) {
        partB.push_back(v);
      } else {
        bool boundary = false;
        for (int p = adjp_[v]; p < adjp_[v + 1]; p++) {
          int w = adj_[p];
          if (stampv_[w] == stamp_ && level_[w] == best_l + 1) {
            boundary = true;
            break;
          }
        }
        if (boundary) {
          sep.push_back(v);
        } else {
          partA.push_back(v);
        }
      }
    }
    if (partA.empty() || partB.empty() || sep.empty()) {
      leaf_order(verts);
      return;
    }
    recurse(partA);
    recurse(partB);
    // separator eliminated last (ascending keeps it deterministic)
    std::sort(sep.begin(), sep.end());
    for (int v : sep) order_.push_back(v);
  }

  int n_, leaf_size_;
  std::vector<int> adjp_, adj_;
  std::vector<int> stampv_;          // membership stamp per vertex
  int stamp_;
  std::vector<int> level_;
  std::vector<int> visited_stamp_{};  // BFS visited marks
  std::vector<int> local_;           // global -> subgraph index scratch
  std::vector<int> reached_;
  std::vector<int> order_;           // old indices in elimination order
};

void nested_dissection_order(int n, const int* rowp, const int* cols,
                             int* perm, int leaf_size = 96) {
  NDContext ctx(n, rowp, cols, leaf_size);
  ctx.run(perm);
}

// nnz(L) for a candidate ordering (diagonal included): symbolic-only pass
// used to pick between AMD and ND by actual fill
long long count_fill(int n, const int* rowp, const int* cols,
                     const int* perm) {
  CholHandle h;
  h.n = n;
  h.perm.assign(perm, perm + n);
  h.iperm.resize(n);
  for (int i = 0; i < n; i++) h.iperm[h.perm[i]] = i;
  build_permuted_lower(&h, n, rowp, cols);
  h.parent.resize(n);
  std::vector<int> ancestor;
  build_etree(n, h.arowp.data(), h.acols.data(), h.parent.data(), ancestor);
  std::vector<int> s(n), w(n, -1);
  long long nnz = n;  // diagonal
  for (int k = 0; k < n; k++) {
    int top = ereach(n, h.arowp.data(), h.acols.data(), k, h.parent.data(),
                     s.data(), w.data());
    nnz += n - top;
  }
  return nnz;
}

// order_type dispatch shared by both factorization paths:
// 0 = natural, 1 = minimum degree, 2 = nested dissection,
// 3 = auto (AMD vs ND by symbolic fill count)
void compute_ordering(int n, const int* rowp, const int* cols,
                      int order_type, int* perm) {
  if (order_type == 1) {
    min_degree_order(n, rowp, cols, perm);
  } else if (order_type == 2) {
    nested_dissection_order(n, rowp, cols, perm);
  } else if (order_type == 3) {
    std::vector<int> amd_perm(n), nd_perm(n);
    min_degree_order(n, rowp, cols, amd_perm.data());
    nested_dissection_order(n, rowp, cols, nd_perm.data());
    long long amd_fill = count_fill(n, rowp, cols, amd_perm.data());
    long long nd_fill = count_fill(n, rowp, cols, nd_perm.data());
    const std::vector<int>& pick = nd_fill < amd_fill ? nd_perm : amd_perm;
    std::copy(pick.begin(), pick.end(), perm);
  } else {
    for (int i = 0; i < n; i++) perm[i] = i;
  }
}

}  // namespace

extern "C" {

// Minimum-degree fill-reducing ordering.  perm[old] = new position.
// Returns 0 on success.
int paropt_amd_order(int n, const int* rowp, const int* cols, int* perm) {
  if (n <= 0) return 1;
  min_degree_order(n, rowp, cols, perm);
  return 0;
}

// Nested-dissection fill-reducing ordering.  perm[old] = new position.
// Returns 0 on success.
int paropt_nd_order(int n, const int* rowp, const int* cols, int* perm) {
  if (n <= 0) return 1;
  nested_dissection_order(n, rowp, cols, perm);
  return 0;
}

// Symbolic fill count nnz(L) (incl. diagonal) for a given ordering.
long long paropt_fill_count(int n, const int* rowp, const int* cols,
                            const int* perm) {
  return count_fill(n, rowp, cols, perm);
}

// order_type: 0 = natural, 1 = minimum degree, 2 = nested dissection,
// 3 = auto (AMD vs ND by symbolic fill count)
void* paropt_chol_create(int n, const int* rowp, const int* cols,
                         int order_type) {
  CholHandle* h = new CholHandle();
  h->n = n;
  h->perm.resize(n);
  h->iperm.resize(n);
  compute_ordering(n, rowp, cols, order_type, h->perm.data());
  for (int i = 0; i < n; i++) h->iperm[h->perm[i]] = i;

  build_permuted_lower(h, n, rowp, cols);

  // elimination tree on the permuted lower pattern
  h->parent.resize(n);
  std::vector<int> ancestor;
  build_etree(n, h->arowp.data(), h->acols.data(), h->parent.data(),
              ancestor);

  // symbolic: column counts of L via ereach
  std::vector<int> s(n), w(n, -1), counts(n, 0);
  for (int k = 0; k < n; k++) {
    int top = ereach(n, h->arowp.data(), h->acols.data(), k,
                     h->parent.data(), s.data(), w.data());
    for (int p = top; p < n; p++) {
      counts[s[p]]++;  // L(k, j) nonzero -> column j gains an entry
    }
  }
  h->lp.assign(n + 1, 0);
  for (int j = 0; j < n; j++) h->lp[j + 1] = h->lp[j] + counts[j];
  h->li.resize(h->lp[n]);
  h->lx.resize(h->lp[n]);
  h->d.resize(n);
  h->symbolic_done = true;
  return (void*)h;
}

int paropt_chol_nnz(void* vh) {
  CholHandle* h = (CholHandle*)vh;
  return h->lp[h->n] + h->n;
}

// Numeric factorization: values aligned with the (rowp, cols) passed to
// create.  Returns 0 on success, k+1 if the matrix is not positive definite
// at permuted column k.
int paropt_chol_factor(void* vh, const double* values) {
  CholHandle* h = (CholHandle*)vh;
  int n = h->n;
  // permuted lower values
  std::vector<double> aval(h->arowp[n]);
  for (int p = 0; p < h->arowp[n]; p++) {
    aval[p] = values[h->aval_src[p]];
  }
  std::vector<int> s(n), w(n, -1), lnext(n);
  std::vector<double> x(n, 0.0);
  for (int j = 0; j < n; j++) lnext[j] = h->lp[j];

  for (int k = 0; k < n; k++) {
    // scatter row k of A (lower part) into x
    int top = ereach(n, h->arowp.data(), h->acols.data(), k,
                     h->parent.data(), s.data(), w.data());
    double dk = 0.0;
    for (int p = h->arowp[k]; p < h->arowp[k + 1]; p++) {
      int j = h->acols[p];
      if (j == k) {
        dk = aval[p];
      } else {
        x[j] = aval[p];
      }
    }
    // sparse triangular solve: L(0:k-1, 0:k-1) l_k' = a_k
    for (int pp = top; pp < n; pp++) {
      int j = s[pp];
      double lkj = x[j] / h->d[j];
      x[j] = 0.0;
      // update x with column j of L
      for (int q = h->lp[j]; q < lnext[j]; q++) {
        x[h->li[q]] -= h->lx[q] * lkj;
      }
      dk -= lkj * lkj;
      // append L(k, j)
      int q = lnext[j]++;
      h->li[q] = k;
      h->lx[q] = lkj;
    }
    if (dk <= 0.0 || !std::isfinite(dk)) {
      return k + 1;
    }
    h->d[k] = std::sqrt(dk);
  }
  return 0;
}

// Solve A x = b in place for nrhs right-hand sides (column-major, each
// length n, in ORIGINAL ordering).
int paropt_chol_solve(void* vh, double* b, int nrhs) {
  CholHandle* h = (CholHandle*)vh;
  int n = h->n;
  std::vector<double> y(n);
  for (int r = 0; r < nrhs; r++) {
    double* brhs = b + (size_t)r * n;
    // permute
    for (int i = 0; i < n; i++) y[h->perm[i]] = brhs[i];
    // forward: L y = b
    for (int j = 0; j < n; j++) {
      y[j] /= h->d[j];
      for (int q = h->lp[j]; q < h->lp[j + 1]; q++) {
        y[h->li[q]] -= h->lx[q] * y[j];
      }
    }
    // backward: L' x = y
    for (int j = n - 1; j >= 0; j--) {
      for (int q = h->lp[j]; q < h->lp[j + 1]; q++) {
        y[j] -= h->lx[q] * y[h->li[q]];
      }
      y[j] /= h->d[j];
    }
    // unpermute
    for (int i = 0; i < n; i++) brhs[i] = y[h->perm[i]];
  }
  return 0;
}

void paropt_chol_destroy(void* vh) { delete (CholHandle*)vh; }

// ---------------------------------------------------------------------------
// C + A * D * A^T for CSR A [m x n], diagonal D [n], C diagonal [m].
// Two-phase: symbolic (pattern) then numeric.  (ParOptSparseUtils.h:8-49)
// ---------------------------------------------------------------------------

// Symbolic: computes row pointers of the (full, symmetric) product pattern.
// Call once with out_cols == nullptr to get nnz via out_rowp, then again
// with allocated out_cols.
int paropt_adat_symbolic(int m, int n, const int* rowp, const int* cols,
                         int* out_rowp, int* out_cols) {
  // build A^T (CSC of A) pattern
  std::vector<int> colp(n + 1, 0), crow(rowp[m]);
  for (int p = 0; p < rowp[m]; p++) colp[cols[p] + 1]++;
  for (int j = 0; j < n; j++) colp[j + 1] += colp[j];
  {
    std::vector<int> next(colp.begin(), colp.end() - 1);
    for (int i = 0; i < m; i++) {
      for (int p = rowp[i]; p < rowp[i + 1]; p++) {
        crow[next[cols[p]]++] = i;
      }
    }
  }
  std::vector<int> mark(m, -1);
  out_rowp[0] = 0;
  int nnz = 0;
  for (int i = 0; i < m; i++) {
    int cnt = 0;
    for (int p = rowp[i]; p < rowp[i + 1]; p++) {
      int k = cols[p];
      for (int q = colp[k]; q < colp[k + 1]; q++) {
        int j = crow[q];
        if (mark[j] != i) {
          mark[j] = i;
          if (out_cols) out_cols[nnz + cnt] = j;
          cnt++;
        }
      }
    }
    // ensure the diagonal is present
    if (mark[i] != i) {
      mark[i] = i;
      if (out_cols) out_cols[nnz + cnt] = i;
      cnt++;
    }
    if (out_cols) {
      std::sort(out_cols + nnz, out_cols + nnz + cnt);
    }
    nnz += cnt;
    out_rowp[i + 1] = nnz;
  }
  return 0;
}

// Numeric: fills out_vals for the pattern computed by adat_symbolic.
int paropt_adat_numeric(int m, int n, const int* rowp, const int* cols,
                        const double* vals, const double* dvec,
                        const double* cdiag, const int* out_rowp,
                        const int* out_cols, double* out_vals) {
  std::vector<int> colp(n + 1, 0), crow(rowp[m]), cpos(rowp[m]);
  for (int p = 0; p < rowp[m]; p++) colp[cols[p] + 1]++;
  for (int j = 0; j < n; j++) colp[j + 1] += colp[j];
  {
    std::vector<int> next(colp.begin(), colp.end() - 1);
    for (int i = 0; i < m; i++) {
      for (int p = rowp[i]; p < rowp[i + 1]; p++) {
        int q = next[cols[p]]++;
        crow[q] = i;
        cpos[q] = p;
      }
    }
  }
  std::vector<double> x(m, 0.0);
  std::vector<int> mark(m, -1);
  for (int i = 0; i < m; i++) {
    for (int p = rowp[i]; p < rowp[i + 1]; p++) {
      int k = cols[p];
      double aik_d = vals[p] * dvec[k];
      for (int q = colp[k]; q < colp[k + 1]; q++) {
        int j = crow[q];
        if (mark[j] != i) {
          mark[j] = i;
          x[j] = 0.0;
        }
        x[j] += aik_d * vals[cpos[q]];
      }
    }
    if (mark[i] != i) {
      mark[i] = i;
      x[i] = 0.0;
    }
    if (cdiag) x[i] += cdiag[i];
    for (int p = out_rowp[i]; p < out_rowp[i + 1]; p++) {
      int j = out_cols[p];
      out_vals[p] = (mark[j] == i) ? x[j] : 0.0;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Supernodal Cholesky (right-looking with dense panels) — the BLAS3-style
// factorization the reference uses (`ParOptSparseCholesky.h:13-28`:
// supernode aggregation of identical column patterns enables level-3 ops).
// Fundamental supernodes only (no relaxed amalgamation).
// ---------------------------------------------------------------------------

namespace {

struct SNHandle {
  int n = 0;
  std::vector<int> perm, iperm;
  std::vector<int> arowp, acols, aval_src;  // permuted lower pattern (rows)
  std::vector<int> parent;                  // etree
  // supernode partition
  int nsuper = 0;
  std::vector<int> sn_start;   // [nsuper+1] first column of each supernode
  std::vector<int> sn_of_col;  // [n]
  // per-supernode below-diagonal row structure (concatenated)
  std::vector<int> strp;       // [nsuper+1]
  std::vector<int> srows;      // row indices (global, ascending)
  // dense storage: per supernode a ((ns+r) x ns) column-major panel;
  // rows 0..ns-1 = diagonal block, ns..ns+r-1 = below-diagonal rows
  std::vector<long> panelp;    // [nsuper+1] offsets into values
  std::vector<double> vals;
  // scratch: global row -> local panel row within a target supernode
  std::vector<int> relind;
  std::vector<double> wscratch;  // row-major L21 copy for the update GEMM
};

// etree + per-column row patterns of L via ereach sweeps.  Memory O(nnz(L)).
void sn_colrows(SNHandle* h, std::vector<std::vector<int>>& colrows) {
  int n = h->n;
  h->parent.resize(n);
  std::vector<int> ancestor;
  build_etree(n, h->arowp.data(), h->acols.data(), h->parent.data(),
              ancestor);
  colrows.assign(n, {});
  std::vector<int> s(n), w(n, -1);
  for (int k = 0; k < n; k++) {
    int top = ereach(n, h->arowp.data(), h->acols.data(), k,
                     h->parent.data(), s.data(), w.data());
    for (int p = top; p < n; p++) {
      colrows[s[p]].push_back(k);  // L(k, s[p]) nonzero, k > s[p]
    }
  }
}

// Supernode partition with relaxed amalgamation.
//
// 1. Fundamental supernodes: maximal chains parent(j-1) == j with
//    |struct(j-1)| == |struct(j)| + 1 (identical patterns, zero padding).
// 2. Relaxed amalgamation on the SUPERNODAL elimination tree: a supernode
//    is merged into its parent supernode when the explicit-zero padding of
//    the merged dense panel stays under a width-dependent tolerance
//    (always merge narrow blocks, tolerate less padding as blocks widen).
//    Merged classes are connected subtrees, so every member column's rows
//    are covered by the class root's structure (etree containment).
// 3. The columns are then RELABELED so each merged class is contiguous —
//    emitting classes by root index and members in ascending order is a
//    topological reordering of the etree, which leaves fill invariant.
//
// This is the aggregation that turns the sparse factorization into dense
// block (level-3) operations — the same design the reference motivates in
// ParOptSparseCholesky.h:13-28.
void sn_symbolic(SNHandle* h, int norig, const int* rowp, const int* cols) {
  int n = h->n;
  std::vector<std::vector<int>> colrows;
  sn_colrows(h, colrows);

  // ---- 1. fundamental supernodes ----
  std::vector<int> fstart;
  fstart.push_back(0);
  for (int j = 1; j < n; j++) {
    bool merge = (h->parent[j - 1] == j) &&
                 (colrows[j - 1].size() == colrows[j].size() + 1);
    if (!merge) fstart.push_back(j);
  }
  fstart.push_back(n);
  int nf = (int)fstart.size() - 1;
  std::vector<int> fs_of_col(n);
  for (int s = 0; s < nf; s++) {
    for (int j = fstart[s]; j < fstart[s + 1]; j++) fs_of_col[j] = s;
  }
  // supernodal etree
  std::vector<int> sparent(nf, -1);
  for (int s = 0; s < nf; s++) {
    int pcol = h->parent[fstart[s + 1] - 1];
    if (pcol != -1) sparent[s] = fs_of_col[pcol];
  }

  // ---- 2. union-find amalgamation (children processed before parents) ----
  std::vector<int> uf(nf), w_cls(nf), root_cls(nf);
  std::vector<long> nz_cls(nf);
  std::function<int(int)> find = [&](int a) {
    while (uf[a] != a) {
      uf[a] = uf[uf[a]];
      a = uf[a];
    }
    return a;
  };
  for (int s = 0; s < nf; s++) {
    uf[s] = s;
    w_cls[s] = fstart[s + 1] - fstart[s];
    root_cls[s] = s;
    long nz = 0;
    for (int j = fstart[s]; j < fstart[s + 1]; j++) {
      nz += (long)colrows[j].size() + 1;
    }
    nz_cls[s] = nz;
  }
  const int max_width = 64;
  for (int s = 0; s < nf; s++) {
    if (sparent[s] == -1) continue;
    int a = find(s), b = find(sparent[s]);
    if (a == b) continue;
    int w = w_cls[a] + w_cls[b];
    if (w > max_width) continue;
    int rt = root_cls[b];  // class root (ancestor-most fundamental snode)
    long r = (long)colrows[fstart[rt + 1] - 1].size();
    long dense = (long)w * (w + 1) / 2 + (long)w * r;
    long nz = nz_cls[a] + nz_cls[b];
    double zfrac = (double)(dense - nz) / (double)dense;
    bool ok = (w <= 8) || (w <= 16 && zfrac <= 0.5) ||
              (w <= 48 && zfrac <= 0.25) || zfrac <= 0.10;
    if (!ok) continue;
    uf[a] = b;
    w_cls[b] = w;
    nz_cls[b] = nz;  // root_cls[b] unchanged (b is the ancestor side)
  }

  // ---- 3. relabel columns so each class is contiguous ----
  // class members collected in ascending fundamental order; classes are
  // emitted at their root's position
  {
    std::vector<std::vector<int>> members(nf);
    for (int s = 0; s < nf; s++) {
      members[find(s)].push_back(s);
    }
    std::vector<int> colmap(n);
    std::vector<int> new_start;
    new_start.push_back(0);
    int pos = 0;
    for (int s = 0; s < nf; s++) {
      if (find(s) != s) continue;  // emit whole class at its representative
      // NOTE: the representative after path compression is the ancestor
      // side (uf[a] = b), so emission happens at the class root
      for (int m : members[s]) {
        for (int j = fstart[m]; j < fstart[m + 1]; j++) colmap[j] = pos++;
      }
      new_start.push_back(pos);
    }
    // compose into the overall permutation and rebuild the pattern
    for (int i = 0; i < norig; i++) h->perm[i] = colmap[h->perm[i]];
    CholHandle tmp;
    tmp.perm = h->perm;
    build_permuted_lower(&tmp, norig, rowp, cols);
    h->arowp.swap(tmp.arowp);
    h->acols.swap(tmp.acols);
    h->aval_src.swap(tmp.aval_src);
    sn_colrows(h, colrows);  // fill is invariant; labels changed
    h->sn_start = new_start;
  }
  h->nsuper = (int)h->sn_start.size() - 1;
  h->sn_of_col.resize(n);
  for (int sI = 0; sI < h->nsuper; sI++) {
    for (int j = h->sn_start[sI]; j < h->sn_start[sI + 1]; j++) {
      h->sn_of_col[j] = sI;
    }
  }

  // supernode structure = rows of its LAST column below the supernode
  // (the class root's column, whose structure covers every member's rows)
  h->strp.assign(h->nsuper + 1, 0);
  for (int sI = 0; sI < h->nsuper; sI++) {
    int jend = h->sn_start[sI + 1];
    int cnt = 0;
    for (int r : colrows[jend - 1]) {
      if (r >= jend) cnt++;
    }
    h->strp[sI + 1] = h->strp[sI] + cnt;
  }
  h->srows.resize(h->strp[h->nsuper]);
  h->panelp.assign(h->nsuper + 1, 0);
  for (int sI = 0; sI < h->nsuper; sI++) {
    int j0 = h->sn_start[sI];
    int jend = h->sn_start[sI + 1];
    int ns = jend - j0;
    int q = h->strp[sI];
    for (int r : colrows[jend - 1]) {
      if (r >= jend) h->srows[q++] = r;
    }
    std::sort(h->srows.begin() + h->strp[sI],
              h->srows.begin() + h->strp[sI + 1]);
    long r = h->strp[sI + 1] - h->strp[sI];
    h->panelp[sI + 1] = h->panelp[sI] + (long)(ns + r) * ns;
  }
  h->vals.assign(h->panelp[h->nsuper], 0.0);
  h->relind.assign(n, -1);
}

}  // namespace

extern "C" {

void* paropt_snchol_create(int n, const int* rowp, const int* cols,
                           int order_type) {
  SNHandle* h = new SNHandle();
  h->n = n;
  h->perm.resize(n);
  h->iperm.resize(n);
  compute_ordering(n, rowp, cols, order_type, h->perm.data());
  {
    // reuse the simplicial helper for the permuted lower pattern
    CholHandle tmp;
    tmp.perm = h->perm;
    build_permuted_lower(&tmp, n, rowp, cols);
    h->arowp.swap(tmp.arowp);
    h->acols.swap(tmp.acols);
    h->aval_src.swap(tmp.aval_src);
  }
  // Postorder the elimination tree and compose it into the permutation:
  // postordering is a fill-equivalent reordering that makes etree chains
  // occupy CONSECUTIVE column indices, which is what lets supernodes form.
  {
    std::vector<int> parent(n);
    std::vector<int> ancestor;
    build_etree(n, h->arowp.data(), h->acols.data(), parent.data(), ancestor);
    // children lists (in increasing order) + roots
    std::vector<int> head(n + 1, -1), next(n, -1);
    for (int j = n - 1; j >= 0; j--) {
      int p = (parent[j] == -1) ? n : parent[j];
      next[j] = head[p];
      head[p] = j;
    }
    std::vector<int> post(n), stack;
    int q = 0;
    for (int r = head[n]; r != -1; r = next[r]) {
      // iterative DFS emitting nodes in postorder
      stack.push_back(r);
      while (!stack.empty()) {
        int v = stack.back();
        int c = head[v];
        if (c != -1) {
          head[v] = next[c];  // pop the child; revisit v afterwards
          stack.push_back(c);
        } else {
          stack.pop_back();
          post[v] = q++;
        }
      }
    }
    for (int i = 0; i < n; i++) h->perm[i] = post[h->perm[i]];
    CholHandle tmp;
    tmp.perm = h->perm;
    build_permuted_lower(&tmp, n, rowp, cols);
    h->arowp.swap(tmp.arowp);
    h->acols.swap(tmp.acols);
    h->aval_src.swap(tmp.aval_src);
  }
  sn_symbolic(h, n, rowp, cols);
  for (int i = 0; i < n; i++) h->iperm[h->perm[i]] = i;
  return (void*)h;
}

int paropt_snchol_nnz(void* vh) {
  SNHandle* h = (SNHandle*)vh;
  long nnz = 0;
  for (int sI = 0; sI < h->nsuper; sI++) {
    long ns = h->sn_start[sI + 1] - h->sn_start[sI];
    long r = h->strp[sI + 1] - h->strp[sI];
    nnz += ns * (ns + 1) / 2 + r * ns;
  }
  return (int)nnz;
}

int paropt_snchol_nsuper(void* vh) { return ((SNHandle*)vh)->nsuper; }

int paropt_snchol_factor(void* vh, const double* values) {
  SNHandle* h = (SNHandle*)vh;
  int n = h->n;
  std::fill(h->vals.begin(), h->vals.end(), 0.0);

  // scatter A's (permuted) lower entries into the panels
  for (int i = 0; i < n; i++) {
    for (int p = h->arowp[i]; p < h->arowp[i + 1]; p++) {
      int j = h->acols[p];  // j <= i, entry A(i, j)
      double aij = values[h->aval_src[p]];
      int sI = h->sn_of_col[j];
      int j0 = h->sn_start[sI];
      int jend = h->sn_start[sI + 1];
      int ns = jend - j0;
      long base = h->panelp[sI];
      int lc = j - j0;
      int lr;
      if (i < jend) {
        lr = i - j0;  // inside the diagonal block
      } else {
        // find i in the supernode structure
        const int* lo = h->srows.data() + h->strp[sI];
        const int* hi = h->srows.data() + h->strp[sI + 1];
        lr = ns + (int)(std::lower_bound(lo, hi, i) - lo);
      }
      h->vals[base + (long)lc * (ns + (h->strp[sI + 1] - h->strp[sI])) + lr]
          += aij;
    }
  }

  // right-looking supernodal factorization
  for (int sI = 0; sI < h->nsuper; sI++) {
    int j0 = h->sn_start[sI];
    int ns = h->sn_start[sI + 1] - j0;
    int r = h->strp[sI + 1] - h->strp[sI];
    int ld = ns + r;
    double* P = h->vals.data() + h->panelp[sI];

    // dense Cholesky of the ns x ns diagonal block (lower)
    for (int k = 0; k < ns; k++) {
      double d = P[(long)k * ld + k];
      for (int t = 0; t < k; t++) {
        double v = P[(long)t * ld + k];
        d -= v * v;
      }
      if (d <= 0.0 || !std::isfinite(d)) return j0 + k + 1;
      d = std::sqrt(d);
      P[(long)k * ld + k] = d;
      for (int i = k + 1; i < ld; i++) {
        double v = P[(long)k * ld + i];
        for (int t = 0; t < k; t++) {
          v -= P[(long)t * ld + i] * P[(long)t * ld + k];
        }
        P[(long)k * ld + i] = v / d;
      }
    }

    if (r == 0) continue;

    // copy L21 into a row-major scratch so the update dots are unit-stride
    std::vector<double>& W = h->wscratch;
    W.resize((size_t)r * ns);
    for (int iq = 0; iq < r; iq++) {
      for (int t = 0; t < ns; t++) {
        W[(size_t)iq * ns + t] = P[(long)t * ld + ns + iq];
      }
    }

    // scatter the Schur update U = L21 * L21^T into ancestor panels
    const int* R = h->srows.data() + h->strp[sI];
    // relative indices per target supernode are computed on the fly
    for (int jq = 0; jq < r; jq++) {
      int gj = R[jq];
      int tI = h->sn_of_col[gj];
      int tj0 = h->sn_start[tI];
      int tjend = h->sn_start[tI + 1];
      int tns = tjend - tj0;
      int tr = h->strp[tI + 1] - h->strp[tI];
      int tld = tns + tr;
      long tbase = h->panelp[tI];
      int tlc = gj - tj0;
      const int* tlo = h->srows.data() + h->strp[tI];
      const int* thi = h->srows.data() + h->strp[tI + 1];
      double* Tcol = h->vals.data() + tbase + (long)tlc * tld;
      const double* Lj = W.data() + (size_t)jq * ns;  // row jq of L21
      for (int iq = jq; iq < r; iq++) {
        int gi = R[iq];
        double u = 0.0;
        const double* Li = W.data() + (size_t)iq * ns;
        for (int t = 0; t < ns; t++) {
          u += Li[t] * Lj[t];
        }
        int tlr;
        if (gi < tjend) {
          tlr = gi - tj0;
        } else {
          tlr = tns + (int)(std::lower_bound(tlo, thi, gi) - tlo);
        }
        Tcol[tlr] -= u;
      }
    }
  }
  return 0;
}

int paropt_snchol_solve(void* vh, double* b, int nrhs) {
  SNHandle* h = (SNHandle*)vh;
  int n = h->n;
  std::vector<double> y(n);
  for (int q = 0; q < nrhs; q++) {
    double* brhs = b + (size_t)q * n;
    for (int i = 0; i < n; i++) y[h->perm[i]] = brhs[i];
    // forward: L y = b, supernode by supernode
    for (int sI = 0; sI < h->nsuper; sI++) {
      int j0 = h->sn_start[sI];
      int ns = h->sn_start[sI + 1] - j0;
      int r = h->strp[sI + 1] - h->strp[sI];
      int ld = ns + r;
      const double* P = h->vals.data() + h->panelp[sI];
      for (int k = 0; k < ns; k++) {
        double v = y[j0 + k];
        for (int t = 0; t < k; t++) {
          v -= P[(long)t * ld + k] * y[j0 + t];
        }
        y[j0 + k] = v / P[(long)k * ld + k];
      }
      const int* R = h->srows.data() + h->strp[sI];
      for (int iq = 0; iq < r; iq++) {
        double acc = 0.0;
        for (int t = 0; t < ns; t++) {
          acc += P[(long)t * ld + ns + iq] * y[j0 + t];
        }
        y[R[iq]] -= acc;
      }
    }
    // backward: L^T x = y
    for (int sI = h->nsuper - 1; sI >= 0; sI--) {
      int j0 = h->sn_start[sI];
      int ns = h->sn_start[sI + 1] - j0;
      int r = h->strp[sI + 1] - h->strp[sI];
      int ld = ns + r;
      const double* P = h->vals.data() + h->panelp[sI];
      const int* R = h->srows.data() + h->strp[sI];
      for (int k = ns - 1; k >= 0; k--) {
        double v = y[j0 + k];
        for (int iq = 0; iq < r; iq++) {
          v -= P[(long)k * ld + ns + iq] * y[R[iq]];
        }
        for (int t = k + 1; t < ns; t++) {
          v -= P[(long)k * ld + t] * y[j0 + t];
        }
        y[j0 + k] = v / P[(long)k * ld + k];
      }
    }
    for (int i = 0; i < n; i++) brhs[i] = y[h->perm[i]];
  }
  return 0;
}

void paropt_snchol_destroy(void* vh) { delete (SNHandle*)vh; }

}  // extern "C"
