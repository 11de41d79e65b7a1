/* Kruskal single-linkage merge forest with equal-weight tie contraction.
 *
 * Native implementation of core/tree.py::build_merge_forest's hot loop (the
 * host-side global merge of the distributed pipeline — the analog of the
 * reference's UnionFindReducer + dendrogram assembly). Edges arrive sorted by
 * (w, u, v); the loop unions components, creates a merge node per accepted
 * edge, and contracts children whose tie-group anchor matches the current
 * weight (relative tolerance) into multi-way nodes.
 *
 * Children lists are kept as intrusive linked lists (head/tail/next indexed
 * by node id) so tie absorption is an O(1) splice; the caller flattens them.
 * Union-find uses path halving.
 *
 * Outputs (preallocated by the caller, m = edge count):
 *   dist[t], anchor[t], absorbed[t]  per created merge node t (0..t_count)
 *   sizes[node]      weighted member count per node, capacity n + m
 *                    (first n = point weights)
 *   child_head/tail  per merge node (capacity m); child_next over node ids
 *                    (capacity n + m) — intrusive child lists
 *   parent/top       POINT-root union-find and per-root merge-tree top,
 *                    capacity n (merge-node ids never enter the union-find)
 * Edge acceptance is implicit: cycle edges create no merge node. Returns
 * t_count (number of merge nodes created).
 */

#include <stdint.h>

static int64_t uf_find(int64_t *parent, int64_t x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

static double fabs_(double x) { return x < 0 ? -x : x; }

static int tied(double a, double b, double rtol) {
    double m = fabs_(a) > fabs_(b) ? fabs_(a) : fabs_(b);
    return fabs_(a - b) <= rtol * m;
}

int64_t build_merge_forest_c(
    int64_t n, int64_t m,
    const int64_t *u, const int64_t *v, const double *w,
    const double *point_weights, double tie_rtol,
    /* work + output buffers, all caller-allocated: */
    int64_t *parent,      /* (n) union-find over point ids               */
    int64_t *top,         /* (n) merge-tree root per point UF root       */
    double *sizes,        /* (n + m) weighted counts                     */
    double *dist,         /* (m) per merge node                          */
    double *anchor,       /* (m) tie-group anchor per merge node         */
    uint8_t *absorbed,    /* (m) node was contracted into a parent       */
    int64_t *child_head,  /* (m) first child node id or -1               */
    int64_t *child_tail,  /* (m) last child node id or -1                */
    int64_t *child_next   /* (n + m) next sibling node id or -1          */
) {
    int64_t next_node = n;
    for (int64_t i = 0; i < n; i++) {
        parent[i] = i;
        top[i] = i;
        sizes[i] = point_weights[i];
        child_next[i] = -1;
    }
    for (int64_t i = 0; i < m; i++) {
        int64_t ra = uf_find(parent, u[i]);
        int64_t rb = uf_find(parent, v[i]);
        if (ra == rb) continue;
        int64_t ta = top[ra], tb = top[rb];
        double wi = w[i];
        int64_t node = next_node++;
        int64_t t = node - n;
        dist[t] = wi;
        anchor[t] = wi;
        absorbed[t] = 0;
        child_head[t] = -1;
        child_tail[t] = -1;
        child_next[node] = -1;
        int64_t kids[2] = {ta, tb};
        for (int j = 0; j < 2; j++) {
            int64_t c = kids[j];
            if (c >= n && tied(anchor[c - n], wi, tie_rtol)) {
                /* contract the equal-weight child: splice its list in */
                absorbed[c - n] = 1;
                if (anchor[c - n] < anchor[t]) anchor[t] = anchor[c - n];
                if (child_head[c - n] >= 0) {
                    if (child_tail[t] < 0) {
                        child_head[t] = child_head[c - n];
                    } else {
                        child_next[child_tail[t]] = child_head[c - n];
                    }
                    child_tail[t] = child_tail[c - n];
                }
            } else {
                if (child_tail[t] < 0) {
                    child_head[t] = c;
                } else {
                    child_next[child_tail[t]] = c;
                }
                child_tail[t] = c;
            }
        }
        sizes[node] = sizes[ta] + sizes[tb];
        parent[rb] = ra;
        top[ra] = node;
    }
    return next_node - n;
}

/* Flatten the intrusive child lists into CSR form: kid_flat holds every
 * non-absorbed node's children concatenated in node order (list order
 * preserved — the order the Python builder would produce), kid_count[t] the
 * per-node count (0 for absorbed nodes). Returns the total kid count. The
 * caller slices kid_flat by cumulative kid_count; the array layer
 * (core/tree_vec.py) consumes it directly instead of re-flattening Python
 * lists. */
int64_t flatten_children_c(
    int64_t t_count,
    const uint8_t *absorbed,
    const int64_t *child_head,
    const int64_t *child_next,
    int64_t *kid_flat,   /* (n + m) capacity */
    int64_t *kid_count   /* (t_count) */
) {
    int64_t k = 0;
    for (int64_t t = 0; t < t_count; t++) {
        if (absorbed[t]) {
            kid_count[t] = 0;
            continue;
        }
        int64_t start = k;
        for (int64_t c = child_head[t]; c >= 0; c = child_next[c]) {
            kid_flat[k++] = c;
        }
        kid_count[t] = k - start;
    }
    return k;
}
