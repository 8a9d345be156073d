// One ray's walk over a binary tree of triangle-row leaves, shared by the
// wavefront walks K3, K4a and K4b (tiles.cu) and the megakernel's world-mesh
// hit K1c (mega_common.cuh, which the adjoint K6 replays).
//
// The tree is ops/tiles.cluster_tree's: heap order, node 1 the root, node
// k's children 2k and 2k+1, leaf L + c the c-th run of consecutive rows of
// a Morton-ordered coefficient table. The walk descends nearest child first
// (by mesh.cuh's widened entry bound, which never drops a grazing hit) and
// prunes a node whose entry bound lies beyond the caller's reach, which the
// caller's leaf visit may lower as it finds hits.
//
// It keeps no stack. A 32-bit trail holds a bit for each level of the
// current node's path (bit 0 its own level): set where the sibling at that
// level is still pending. Going back, the walk climbs to the deepest set
// bit and takes that sibling, whose entry bound it computes again (the same
// arithmetic, so the same number) and tests against the reach of the
// moment. That is the order and the pruning of a stack of (node, entry)
// pairs, the deepest pending node first, at two registers for any depth:
// the megakernel, at its register cap, cannot hold a stack.
#pragma once
#include "mesh.cuh"

// Rows loaded and tested together: their loads are in flight at once.
#define QR_ROWS_A_STEP 8

// Is a node whose entry bound is `ent` within `reach`? kTies keeps a node
// at the reach, where a hit at equal t may still win on its row.
template <bool kTies>
__device__ __forceinline__ bool within(float ent, float reach) {
  return kTies ? ent <= reach : ent < reach;
}

// Tests rows r .. r + kStep - 1 against the ray (p, d), all loads first:
// hit[k] and t[k] as tri_hit gives them.
template <int kStep = QR_ROWS_A_STEP>
__device__ __forceinline__ void test_rows(const float4* rows, int r, V3 p,
                                          V3 d, float* t, bool* hit) {
  TriRow c[kStep];
#pragma unroll
  for (int k = 0; k < kStep; ++k) c[k] = load_row_ldg(rows, r + k);
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    float a, b, dn;
    hit[k] = tri_hit(c[k], p, d, t[k], a, b, dn);
  }
}

// Walks a tree of n_leaves leaves (a power of two, at most 2^16).
// enter(k, e): whether the ray may hit node k's box at all, with e its
// entry bound (box_entry). leaf(c, e): visits leaf c, whose entry bound is
// e, and returns true to end the walk. `reach` is read before each test,
// so a leaf visit that lowers it prunes what follows.
template <bool kTies, class Enter, class Leaf>
__device__ __forceinline__ void tree_walk(int n_leaves, const float& reach,
                                          const Enter& enter, Leaf&& leaf) {
  auto in = [&](int k, float& e) {
    return enter(k, e) && within<kTies>(e, reach);
  };
  // The deepest pending sibling still within reach, or 0.
  auto back = [&](int k, unsigned& trail, float& e) {
    for (;;) {
      while (trail && !(trail & 1u)) {
        trail >>= 1;
        k >>= 1;
      }
      if (!trail) return 0;
      trail ^= 1u;
      k ^= 1;
      if (in(k, e)) return k;
    }
  };
  float ent;
  int node = in(1, ent) ? 1 : 0;
  unsigned trail = 0;
  while (node) {
    while (node && node < n_leaves) {
      const int c = 2 * node;
      float e0, e1;
      const bool h0 = in(c, e0);
      const bool h1 = in(c + 1, e1);
      if (h0 || h1) {
        const bool near0 = h0 && (!h1 || e0 <= e1);
        node = near0 ? c : c + 1;
        ent = near0 ? e0 : e1;
        trail = (trail << 1) | (h0 && h1 ? 1u : 0u);
      } else {
        node = back(node, trail, ent);
      }
    }
    if (!node || leaf(node - n_leaves, ent)) return;
    node = back(node, trail, ent);
  }
}
