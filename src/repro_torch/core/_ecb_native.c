/* Native inner engine for the ECB forest builder (ecb_forest.py).
 *
 * This is a line-for-line port of FastIncrementalBuilder's run loop:
 * descending start times, per-ts candidate batch in ascending rank,
 * findInsertion (incidence bisect + parent climb), the zipper merge of
 * the two ancestor chains with LCA expiry, and the per-ts delta flush.
 * No MSF prefilter: insert's own cycle check (l == r) rejects non-MSF
 * candidates, and a rejected attempt costs two bisects + climbs here,
 * not a Python frame. Entry order within one ts differs from the Python
 * builders (insertion order vs set order) but pack_index canonicalizes
 * by (id, ts), so packed indices are bit-identical — tests assert this.
 *
 * Compiled on demand by ecb_native.py with the host cc; if that fails
 * the Python builders serve identically (slower).
 *
 * Return codes: 0 ok; 1 entry buffers too small (true counts in out,
 * caller re-runs with larger buffers); 2 forest invariant violated;
 * 3 out of memory.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define NONE (-1)

typedef struct {
    int64_t *key;   /* packed ranks, ascending */
    int32_t *node;
    int32_t len, cap;
} Inc;

static int inc_bisect(const Inc *inc, int64_t key) {
    int lo = 0, hi = inc->len;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (inc->key[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

static int inc_add(Inc *inc, int64_t key, int32_t node) {
    if (inc->len == inc->cap) {
        int ncap = inc->cap ? inc->cap * 2 : 4;
        int64_t *nk = (int64_t *)realloc(inc->key, (size_t)ncap * sizeof(int64_t));
        if (!nk) return 3;
        inc->key = nk;
        int32_t *nn = (int32_t *)realloc(inc->node, (size_t)ncap * sizeof(int32_t));
        if (!nn) return 3;
        inc->node = nn;
        inc->cap = ncap;
    }
    int i = inc_bisect(inc, key);
    memmove(inc->key + i + 1, inc->key + i,
            (size_t)(inc->len - i) * sizeof(int64_t));
    memmove(inc->node + i + 1, inc->node + i,
            (size_t)(inc->len - i) * sizeof(int32_t));
    inc->key[i] = key;
    inc->node[i] = node;
    inc->len++;
    return 0;
}

static int inc_remove(Inc *inc, int64_t key, int32_t node) {
    int i = inc_bisect(inc, key);
    if (i >= inc->len || inc->node[i] != node) return 2;
    memmove(inc->key + i, inc->key + i + 1,
            (size_t)(inc->len - i - 1) * sizeof(int64_t));
    memmove(inc->node + i, inc->node + i + 1,
            (size_t)(inc->len - i - 1) * sizeof(int32_t));
    inc->len--;
    return 0;
}

typedef struct {
    Inc *inc;                       /* per graph vertex */
    int32_t *n_parent, *n_child0, *n_child1;
    int64_t *n_rank;
    const int32_t *n_u;
    uint8_t *n_in;
    /* dirty node / vertex tracking: stamp + insertion-order list */
    uint8_t *dn_stamp, *dv_stamp;
    int32_t *dn_list, *dv_list;
    int64_t dn_len, dv_len;
} State;

#define DIRTY_NODE(st, x) do { \
    if (!(st)->dn_stamp[x]) { (st)->dn_stamp[x] = 1; \
        (st)->dn_list[(st)->dn_len++] = (x); } } while (0)
#define DIRTY_VERT(st, x) do { \
    if (!(st)->dv_stamp[x]) { (st)->dv_stamp[x] = 1; \
        (st)->dv_list[(st)->dv_len++] = (x); } } while (0)

/* findInsertion for one endpoint: component maximum below rk, its old
 * parent (the lowest incident node above rk), and the consumed slot. */
static int find_side(State *st, int32_t vert, int64_t rk,
                     int32_t *child, int32_t *attach, int *via) {
    Inc *inc = &st->inc[vert];
    int i = inc_bisect(inc, rk);
    if (i > 0) {
        int32_t ch = inc->node[i - 1];
        const int32_t *parent = st->n_parent;
        const int64_t *rank = st->n_rank;
        int32_t p = parent[ch];
        while (p != NONE && rank[p] < rk) {
            ch = p;
            p = parent[ch];
        }
        *child = ch;
        *attach = p;
        if (p == NONE) { *via = NONE; return 0; }
        if (st->n_child0[p] == ch) *via = 0;
        else if (st->n_child1[p] == ch) *via = 1;
        else return 2;
        return 0;
    }
    if (i >= inc->len) {
        *child = NONE; *attach = NONE; *via = NONE;
        return 0;
    }
    int32_t at = inc->node[i];
    int v = (st->n_u[at] == vert) ? 0 : 1;
    int32_t taken = v == 0 ? st->n_child0[at] : st->n_child1[at];
    if (taken != NONE) return 2;
    *child = NONE; *attach = at; *via = v;
    return 0;
}

int ecb_run(
    int32_t n, int32_t t_max, int64_t stride, int64_t R,
    const int32_t *esrc, const int32_t *edst,
    const int64_t *e_sorted, const int64_t *c_sorted, const int64_t *neg_ts,
    int32_t *n_edge, int32_t *n_ct, int32_t *n_u, int32_t *n_v,
    int64_t *n_rank, int32_t *n_live_from, int32_t *n_live_to,
    int32_t *n_parent, int32_t *n_child0, int32_t *n_child1, uint8_t *n_in,
    int64_t ent_cap, int32_t *ent_node, int32_t *ent_ts,
    int32_t *ent_l, int32_t *ent_r, int32_t *ent_p,
    int64_t vent_cap, int32_t *vent_vert, int32_t *vent_ts,
    int32_t *vent_node,
    int64_t *out)
{
    int rc = 0;
    int64_t num_nodes = 0, ent_len = 0, vent_len = 0;
    int64_t i;

    Inc *inc = (Inc *)calloc((size_t)n ? (size_t)n : 1, sizeof(Inc));
    uint8_t *dn_stamp = (uint8_t *)calloc((size_t)R ? (size_t)R : 1, 1);
    uint8_t *dv_stamp = (uint8_t *)calloc((size_t)n ? (size_t)n : 1, 1);
    int32_t *dn_list = (int32_t *)malloc(((size_t)R ? (size_t)R : 1)
                                         * sizeof(int32_t));
    int32_t *dv_list = (int32_t *)malloc(((size_t)n ? (size_t)n : 1)
                                         * sizeof(int32_t));
    /* last recorded (l, r, p) per node / entry node per vertex;
     * -2 = never recorded (NONE = -1 is a legal value) */
    int32_t *last3 = (int32_t *)malloc(((size_t)(3 * R) ? (size_t)(3 * R) : 1)
                                       * sizeof(int32_t));
    int32_t *last_vent = (int32_t *)malloc(((size_t)n ? (size_t)n : 1)
                                           * sizeof(int32_t));
    if (!inc || !dn_stamp || !dv_stamp || !dn_list || !dv_list
            || !last3 || !last_vent) { rc = 3; goto done; }
    for (i = 0; i < 3 * R; i++) last3[i] = -2;
    for (i = 0; i < n; i++) last_vent[i] = -2;

    State st;
    st.inc = inc;
    st.n_parent = n_parent; st.n_child0 = n_child0; st.n_child1 = n_child1;
    st.n_rank = n_rank; st.n_u = n_u; st.n_in = n_in;
    st.dn_stamp = dn_stamp; st.dv_stamp = dv_stamp;
    st.dn_list = dn_list; st.dv_list = dv_list;
    st.dn_len = 0; st.dv_len = 0;

    int64_t pos = 0;  /* neg_ts ascending = ts descending: one sweep */
    int32_t ts;
    for (ts = t_max; ts >= 1; ts--) {
        while (pos < R && neg_ts[pos] == -(int64_t)ts) {
            int64_t e = e_sorted[pos];
            int64_t c = c_sorted[pos];
            pos++;
            int32_t uu = esrc[e], vv = edst[e];
            if (uu == vv) continue;   /* degenerate self-loop */
            int64_t rk = c * stride + e;
            int32_t l, eu, r, ev;
            int va, vb;
            rc = find_side(&st, uu, rk, &l, &eu, &va);
            if (rc) goto done;
            rc = find_side(&st, vv, rk, &r, &ev, &vb);
            if (rc) goto done;
            if (l != NONE && l == r) continue;   /* cycle: not in MSF */

            if (num_nodes >= R) { rc = 2; goto done; }
            int32_t x = (int32_t)num_nodes++;
            n_edge[x] = (int32_t)e;
            n_ct[x] = (int32_t)c;
            n_u[x] = uu;
            n_v[x] = vv;
            n_rank[x] = rk;
            n_live_from[x] = 1;
            n_live_to[x] = ts;
            n_parent[x] = NONE;
            n_in[x] = 1;
            n_child0[x] = l;
            n_child1[x] = r;
            if (l != NONE) { n_parent[l] = x; DIRTY_NODE(&st, l); }
            if (r != NONE) { n_parent[r] = x; DIRTY_NODE(&st, r); }
            rc = inc_add(&inc[uu], rk, x);
            if (rc) goto done;
            rc = inc_add(&inc[vv], rk, x);
            if (rc) goto done;
            DIRTY_VERT(&st, uu);
            DIRTY_VERT(&st, vv);
            DIRTY_NODE(&st, x);

            /* zipper merge of the two ancestor chains (WE cascade);
             * (a, va) and (b, vb) are the chain heads and the slot each
             * hands to the node hung beneath it */
            int32_t cur = x, a = eu, b = ev;
            for (;;) {
                if (a == NONE && b == NONE) { n_parent[cur] = NONE; break; }
                if (a == NONE || b == NONE) {
                    int32_t t; int s;
                    if (a != NONE) { t = a; s = va; } else { t = b; s = vb; }
                    n_parent[cur] = t;
                    if (s == 0) n_child0[t] = cur; else n_child1[t] = cur;
                    DIRTY_NODE(&st, t);
                    break;
                }
                if (a == b) {
                    /* Lemma 5.7: the meeting node is the LCA -> expired */
                    int32_t p = n_parent[a];
                    n_parent[cur] = p;
                    if (p != NONE) {
                        if (n_child0[p] == a) n_child0[p] = cur;
                        else if (n_child1[p] == a) n_child1[p] = cur;
                        else { rc = 2; goto done; }
                        DIRTY_NODE(&st, p);
                    }
                    n_in[a] = 0;
                    n_live_from[a] = ts + 1;
                    rc = inc_remove(&inc[n_u[a]], n_rank[a], a);
                    if (rc) goto done;
                    rc = inc_remove(&inc[n_v[a]], n_rank[a], a);
                    if (rc) goto done;
                    DIRTY_VERT(&st, n_u[a]);
                    DIRTY_VERT(&st, n_v[a]);
                    break;
                }
                int32_t lo; int vlo;
                if (n_rank[a] < n_rank[b]) { lo = a; vlo = va; }
                else { lo = b; vlo = vb; b = a; vb = va; }
                int32_t nxt = n_parent[lo];
                n_parent[cur] = lo;
                if (vlo == 0) n_child0[lo] = cur; else n_child1[lo] = cur;
                DIRTY_NODE(&st, lo);
                if (nxt != NONE) {
                    if (n_child0[nxt] == lo) va = 0;
                    else if (n_child1[nxt] == lo) va = 1;
                    else { rc = 2; goto done; }
                }
                cur = lo; a = nxt;
            }
        }

        /* per-ts delta flush */
        for (i = 0; i < st.dn_len; i++) {
            int32_t x = st.dn_list[i];
            st.dn_stamp[x] = 0;
            if (!n_in[x]) continue;
            int32_t l = n_child0[x], r = n_child1[x], p = n_parent[x];
            int32_t *lx = last3 + 3 * (int64_t)x;
            if (lx[0] != l || lx[1] != r || lx[2] != p) {
                lx[0] = l; lx[1] = r; lx[2] = p;
                if (ent_len < ent_cap) {
                    ent_node[ent_len] = x;
                    ent_ts[ent_len] = ts;
                    ent_l[ent_len] = l;
                    ent_r[ent_len] = r;
                    ent_p[ent_len] = p;
                }
                ent_len++;
            }
        }
        st.dn_len = 0;
        for (i = 0; i < st.dv_len; i++) {
            int32_t vert = st.dv_list[i];
            st.dv_stamp[vert] = 0;
            int32_t node = inc[vert].len ? inc[vert].node[0] : NONE;
            if (last_vent[vert] != node) {
                last_vent[vert] = node;
                if (vent_len < vent_cap) {
                    vent_vert[vent_len] = vert;
                    vent_ts[vent_len] = ts;
                    vent_node[vent_len] = node;
                }
                vent_len++;
            }
        }
        st.dv_len = 0;
    }
    if (pos != R) rc = 2;
    if (!rc && (ent_len > ent_cap || vent_len > vent_cap)) rc = 1;

done:
    if (inc) {
        for (i = 0; i < n; i++) { free(inc[i].key); free(inc[i].node); }
        free(inc);
    }
    free(dn_stamp); free(dv_stamp); free(dn_list); free(dv_list);
    free(last3); free(last_vent);
    out[0] = num_nodes;
    out[1] = ent_len;
    out[2] = vent_len;
    return rc;
}
