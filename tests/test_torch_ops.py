"""Op-level bit parity: the PyTorch port (partisan_tpu_torch) against the
JAX reference on the CPU.  Inputs come from numpy with fixed seeds; every
comparison is exact (tolerance 0 — the only float work, hash_bernoulli's
compare, is exact by construction)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from partisan_tpu import faults as jf
from partisan_tpu.ops import exchange as jx
from partisan_tpu.ops import gossip as jg
from partisan_tpu.ops import plane as jpl
from partisan_tpu.ops import rng as jr
from partisan_tpu.ops import views as jv
from partisan_tpu_torch import faults as tf
from partisan_tpu_torch.ops import exchange as tx
from partisan_tpu_torch.ops import gossip as tg
from partisan_tpu_torch.ops import plane as tpl
from partisan_tpu_torch.ops import rng as tr
from partisan_tpu_torch.ops import views as tv
from partisan_tpu_torch import types as tt

torch.set_num_threads(1)

WIRE_NP = [np.int8, np.int32, np.int32, np.int8, np.int16] + \
    [np.int32, np.int32, np.int8] + [np.int32] * 8   # msg_words=16


def t(x):
    return torch.from_numpy(np.array(x))


def u64(x):
    """A uint32 JAX array as int64 numpy (the port's representation)."""
    return np.asarray(x).astype(np.int64)


def records(rng, shape, n, live=0.5):
    """Random plane-major record stack (numpy planes, wire dtypes)."""
    ws = []
    for i, dt in enumerate(WIRE_NP):
        if i == tt.W_KIND:
            w = np.where(rng.random(shape) < live,
                         rng.integers(10, 35, shape), 0)
        elif i == tt.W_SRC:
            w = np.broadcast_to(np.arange(shape[0])[:, None] % n, shape)
        elif i == tt.W_DST:
            w = rng.integers(-1, n, shape)
        elif i == tt.W_CHANNEL:
            w = rng.integers(0, 4, shape)
        else:
            w = rng.integers(-30000, 30000, shape)
        ws.append(np.ascontiguousarray(w).astype(dt))
    return ws


def jplanes(ws):
    return jpl.Planes(tuple(jnp.asarray(w) for w in ws))


def tplanes(ws):
    return tpl.Planes(t(w) for w in ws)


def assert_planes_equal(jp, tp):
    assert len(jp.ws) == len(tp)
    for a, b in zip(jp.ws, tp):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


def jfaults(n, alive, link_drop, part):
    return jf.FaultState(alive=jnp.asarray(alive),
                         link_drop=jnp.float32(link_drop),
                         partition=jnp.asarray(part, jnp.int32))


def tfaults(n, alive, link_drop, part):
    return tf.FaultState(alive=t(alive),
                         link_drop=torch.tensor(link_drop, dtype=torch.float32),
                         partition=t(np.asarray(part, np.int32)))


# ---- hashes ---------------------------------------------------------------

def test_mix32_parity():
    x = np.random.default_rng(0).integers(-2**31, 2**31, 20000) \
        .astype(np.int32)
    np.testing.assert_array_equal(u64(jf._mix32(jnp.asarray(x))),
                                  tf._mix32(t(x)).numpy())


@pytest.mark.parametrize("seed,salt", [(0, 11), (1, 402), (977, 31)])
def test_edge_hash_parity(seed, salt):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 1 << 20, (64, 1)).astype(np.int32)
    dst = rng.integers(0, 1 << 20, (64, 40)).astype(np.int32)
    for rnd in (0, 7, 123456):
        ref = jf.edge_hash(seed, jnp.int32(rnd), salt, jnp.asarray(src),
                           jnp.asarray(dst))
        got = tf.edge_hash(seed, torch.tensor(rnd, dtype=torch.int32), salt,
                           t(src), t(dst))
        np.testing.assert_array_equal(u64(ref), got.numpy())


def test_hash_bernoulli_parity():
    rng = np.random.default_rng(1)
    h = np.concatenate([rng.integers(0, 2**32, 50000, dtype=np.uint64),
                        [0, 255, 256, 2**32 - 1, 0xFFFFFF80]]).astype(np.uint32)
    for p in (0.0, 1.0, 0.05, 0.5, 1 / 3, 0.999999):
        ref = jf.hash_bernoulli(jnp.asarray(h), jnp.float32(p))
        got = tf.hash_bernoulli(t(h.astype(np.int64)),
                                torch.tensor(p, dtype=torch.float32))
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("seed", [0, 1, 31337])
def test_rank32_parity(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 17, (300, 1)).astype(np.int32)
    b = np.arange(23, dtype=np.int32)[None, :]
    c = rng.integers(0, 100, (300, 23)).astype(np.int32)
    for rnd, tag in ((0, 303), (55, 330), (99999, 340)):
        ref = jr.rank32(seed, jnp.int32(rnd), tag, jnp.asarray(a),
                        jnp.asarray(b), jnp.asarray(c))
        got = tr.rank32(seed, torch.tensor(rnd, dtype=torch.int32), tag,
                        t(a), t(b), t(c))
        np.testing.assert_array_equal(u64(ref), got.numpy())
        ref2 = jr.rank32(seed, jnp.int32(rnd), tag, jnp.asarray(a[:, 0]))
        got2 = tr.rank32(seed, torch.tensor(rnd, dtype=torch.int32), tag,
                         t(a[:, 0]))
        np.testing.assert_array_equal(u64(ref2), got2.numpy())


# ---- threefry -------------------------------------------------------------

@pytest.mark.parametrize("seed,rnd", [(0, 0), (1, 17), (4242, 100003)])
def test_threefry_node_keys_and_subkey(seed, rnd):
    gids = np.arange(4096, dtype=np.int32)
    jk = jr.node_keys(seed, jnp.int32(rnd), jnp.asarray(gids))
    tk = tr.node_keys(seed, torch.tensor(rnd, dtype=torch.int32), t(gids))
    np.testing.assert_array_equal(u64(jax.random.key_data(jk)), tk.numpy())
    js = jax.vmap(lambda k: jr.subkey(k, 401))(jk)
    ts = tr.subkey(tk, 401)
    np.testing.assert_array_equal(u64(jax.random.key_data(js)), ts.numpy())


@pytest.mark.parametrize("v,k", [(6, 1), (6, 2), (30, 4), (8, 8)])
def test_choice_slots_parity(v, k):
    rng = np.random.default_rng(v * 10 + k)
    jk = jax.vmap(lambda kk: jr.subkey(kk, 401))(
        jr.node_keys(3, jnp.int32(v), jnp.arange(4096, dtype=jnp.int32)))
    tk = t(u64(jax.random.key_data(jk)))
    valid = rng.random((4096, v)) < 0.6
    ref = jax.vmap(lambda kk, vv: jr.choice_slots(kk, vv, k))(
        jk, jnp.asarray(valid))
    got = tr.choice_slots(tk, t(valid), k)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_gumbel_transform_strictly_increasing():
    """The reference's gumbel of u = mantissa/2**23 is strictly increasing
    over every float32 mantissa, so the port's integer-mantissa ranking
    orders exactly as the reference's float scores (ties included)."""
    m = jnp.arange(2 ** 23, dtype=jnp.uint32)
    f = jax.lax.bitcast_convert_type(m | jnp.uint32(0x3F800000),
                                     jnp.float32) - 1.0
    tiny = jnp.finfo(jnp.float32).tiny
    u = jnp.maximum(tiny, f * (1.0 - tiny) + tiny)
    g = np.asarray(-jnp.log(-jnp.log(u)))
    assert np.all(np.diff(g) > 0)


def test_topk_ties_lowest_index_first():
    x = np.array([3, 1, 3, 2, 3], np.int32)
    vals, idx = tr.topk(t(x), 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
    np.testing.assert_array_equal(idx.numpy(), [0, 2, 4])
    rng = np.random.default_rng(5)
    y = rng.integers(0, 4, (200, 37)).astype(np.int32)
    for k in (1, 5, 37):
        jvals, jidx = jax.lax.top_k(jnp.asarray(y), k)
        vals, idx = tr.topk(t(y), k)
        np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
        np.testing.assert_array_equal(np.asarray(jvals), vals.numpy())


# ---- wire faults ----------------------------------------------------------

def _fault_inputs(seed, n):
    rng = np.random.default_rng(seed)
    alive = rng.random(n) < 0.8
    part = rng.integers(0, 3, n).astype(np.int32)
    return rng, alive, part


@pytest.mark.parametrize("link_drop", [0.0, 0.05, 0.5])
def test_filter_msgs_parity(link_drop):
    n = 48
    rng, alive, part = _fault_inputs(7, n)
    ws = records(rng, (n, 30), n)
    ref = jf.filter_msgs(jfaults(n, alive, link_drop, part), jplanes(ws),
                         1, jnp.int32(13), 11)
    got = tf.filter_msgs(tfaults(n, alive, link_drop, part), tplanes(ws),
                         1, torch.tensor(13, dtype=torch.int32), 11)
    assert_planes_equal(ref, got)


@pytest.mark.parametrize("link_drop", [0.0, 0.05])
def test_pack_wire_info_and_cut_parity(link_drop):
    n = 64
    rng, alive, part = _fault_inputs(8, n)
    backed = rng.random(n) < 0.3
    jfs, tfs = jfaults(n, alive, link_drop, part), \
        tfaults(n, alive, link_drop, part)
    jinfo = jf.pack_wire_info(jfs, jnp.asarray(backed))
    tinfo = tf.pack_wire_info(tfs, t(backed))
    np.testing.assert_array_equal(np.asarray(jinfo), tinfo.numpy())
    dst = rng.integers(0, n, (n, 32)).astype(np.int32)
    valid = rng.random((n, 32)) < 0.7
    gids = np.arange(n, dtype=np.int32)
    ref = jf.wire_cut_from_info(jfs, jinfo[jnp.asarray(dst)],
                                jnp.asarray(valid), jnp.asarray(gids),
                                jnp.asarray(dst), jnp.asarray(alive),
                                jnp.asarray(part), 1, jnp.int32(9), 11)
    got = tf.wire_cut_from_info(tfs, tinfo[t(dst).long()], t(valid), t(gids),
                                t(dst), t(alive), t(part), 1,
                                torch.tensor(9, dtype=torch.int32), 11)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    # filter_edges (the AAE edge filter) rides the same facts
    tgt = np.where(valid[:, :6], dst[:, :6], -1).astype(np.int32)
    ref_e = jf.filter_edges(jfs, jnp.asarray(gids), jnp.asarray(tgt), 1,
                            jnp.int32(9), 402)
    got_e = tf.filter_edges(tfs, t(gids), t(tgt), 1,
                            torch.tensor(9, dtype=torch.int32), 402)
    np.testing.assert_array_equal(np.asarray(ref_e), got_e.numpy())


def test_host_fault_ops_parity():
    n = 40
    jfs = jf.none(n, "groups")
    tfs = tf.none(n, "groups", device="cpu")
    jfs, tfs = jf.crash_many(jfs, [3, 9, 31]), tf.crash_many(tfs, [3, 9, 31])
    a, b = np.arange(0, 25), np.arange(25, n)
    jfs = jf.inject_partition(jfs, a, b)
    tfs = tf.inject_partition(tfs, a, b)
    a2, b2 = np.arange(0, n, 2), np.arange(1, n, 2)
    jfs = jf.inject_partition(jfs, a2, b2)
    tfs = tf.inject_partition(tfs, a2, b2)
    for x, y in zip(jfs, tfs):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    jfs, tfs = jf.resolve_partition(jfs), tf.resolve_partition(tfs)
    np.testing.assert_array_equal(np.asarray(jfs.partition),
                                  tfs.partition.numpy())
    with pytest.raises(ValueError):
        tf.inject_partition(tfs, a[:5], b)


# ---- exchange -------------------------------------------------------------

@pytest.mark.parametrize("n,E,cap,live", [(32, 20, 4, 0.6), (50, 77, 16, 0.3),
                                          (8, 40, 2, 0.9)])
def test_route_parity(n, E, cap, live):
    rng = np.random.default_rng(n + E)
    ws = records(rng, (n, E), n, live)
    # skew destinations onto a few hot nodes so inboxes overflow
    ws[tt.W_DST] = np.where(rng.random((n, E)) < 0.5, ws[tt.W_DST] % 3,
                            ws[tt.W_DST]).astype(np.int32)
    ref = jx.route(jplanes(ws), n, cap)
    got = tx.route(tplanes(ws), n, cap)
    assert_planes_equal(ref.data, got.data)
    np.testing.assert_array_equal(np.asarray(ref.count), got.count.numpy())
    np.testing.assert_array_equal(np.asarray(ref.drops), got.drops.numpy())
    assert int(got.drops.sum()) > 0


@pytest.mark.parametrize("E,cap,live", [(77, 32, 0.5), (20, 4, 0.7),
                                        (10, 16, 0.5)])
def test_compact_emissions_parity(E, cap, live):
    rng = np.random.default_rng(E * cap)
    ws = records(rng, (40, E), 40, live)
    ref = jx.compact_emissions(jplanes(ws), cap)
    got = tx.compact_emissions(tplanes(ws), cap)
    assert_planes_equal(ref, got)


# ---- views ----------------------------------------------------------------

def _views(rng, N, K, n_ids, fill=0.7):
    v = np.where(rng.random((N, K)) < fill,
                 rng.integers(0, n_ids, (N, K)), -1).astype(np.int32)
    return v


@pytest.mark.parametrize("A,C", [(6, 6), (6, 3), (4, 8)])
def test_admit_parity(A, C):
    rng = np.random.default_rng(A * 100 + C)
    N = 500
    view = _views(rng, N, A, 40)
    cands = _views(rng, N, C, 40, fill=0.6)
    prio = rng.integers(0, 3, (N, C)).astype(np.int32)
    scores = rng.integers(0, 2**32, (N, A + C), dtype=np.uint64) \
        .astype(np.uint32)
    cap = (A - rng.integers(0, 3, N)).astype(np.int32)
    cap[:7] = 0
    ref = jax.vmap(jv.admit)(jnp.asarray(view), jnp.asarray(cands),
                             jnp.asarray(prio), jnp.asarray(scores),
                             jnp.asarray(cap))
    got = tv.admit(t(view), t(cands), t(prio), t(scores.astype(np.int64)),
                   t(cap))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("P,C", [(30, 20), (8, 30)])
def test_bucket_merge_parity(P, C):
    rng = np.random.default_rng(P + C)
    N = 400
    view = _views(rng, N, P, 500, fill=0.4)
    cands = _views(rng, N, C, 500, fill=0.7)
    cands[:, 0] = np.arange(N)                    # some self ids
    ranks = rng.integers(0, 2**32, (N, C), dtype=np.uint64).astype(np.uint32)
    ranks[:, 1] = ranks[:, 2]                     # rank ties
    self_id = np.arange(N, dtype=np.int32)
    excl = _views(rng, N, 6, 500)
    ref = jax.vmap(jv.bucket_merge)(jnp.asarray(view), jnp.asarray(cands),
                                    jnp.asarray(ranks), jnp.asarray(self_id),
                                    jnp.asarray(excl))
    got = tv.bucket_merge(t(view), t(cands), t(ranks.astype(np.int64)),
                          t(self_id), t(excl))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


# ---- gossip ---------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 9])
def test_push_max_parity(D):
    rng = np.random.default_rng(D)
    n, K = 300, 6
    rows = rng.integers(-5, 1000, (n, D)).astype(np.int32)
    dst = _views(rng, n, K, n + 5, fill=0.8)      # some out of range
    ref = jg.push_max(jnp.asarray(rows), jnp.asarray(dst), n_out=n)
    got = tg.push_max(t(rows), t(dst), n_out=n)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    flags = rng.random((n, D)) < 0.2
    np.testing.assert_array_equal(
        np.asarray(jg.push_or(jnp.asarray(flags), jnp.asarray(dst),
                              n_out=n)),
        tg.push_or(t(flags), t(dst), n_out=n).numpy())


# --- jax.random draws and the views ops SCAMP uses ------------------------

def _keys(seed, n, tag):
    """n reference keys and the port's int64 copies of them."""
    jk = jax.vmap(lambda kk: jr.subkey(kk, tag))(
        jr.node_keys(seed, jnp.int32(7), jnp.arange(n, dtype=jnp.int32)))
    return jk, t(u64(jax.random.key_data(jk)))


@pytest.mark.parametrize("span", [1, 3, 7, 16, 64, 65, 96, 65536, 65537,
                                  (1 << 20) + 3])
def test_randint_uniform_split_parity(span):
    """``jax.random.randint(key, (), 0, span)`` (split + two draws +
    the wrapping multiplier), scalar ``uniform`` and ``split`` over 1024
    keys per span."""
    jk, tk = _keys(span, 1024, 505)
    want = jax.vmap(lambda kk: jax.random.randint(kk, (), 0, span))(jk)
    np.testing.assert_array_equal(np.asarray(want),
                                  tr.randint(tk, 0, span).numpy())
    want = jax.vmap(lambda kk: jax.random.randint(kk, (), 3, 3 + span))(jk)
    np.testing.assert_array_equal(np.asarray(want),
                                  tr.randint(tk, 3, 3 + span).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jax.random.uniform)(jk)), tr.uniform(tk).numpy())
    np.testing.assert_array_equal(
        u64(jax.random.key_data(jax.vmap(jax.random.split)(jk))),
        tr.split2(tk).numpy())


def _random_views(rng, n, k, ids, fill):
    """int32[n, k] views of distinct ids in [0, ids), -1 holes, some rows
    full and some empty."""
    out = np.full((n, k), -1, np.int32)
    for i in range(n):
        occ = rng.random(k) < fill[i % len(fill)]
        vals = rng.choice(ids, size=k, replace=False)
        out[i] = np.where(occ, vals, -1)
    return out


@pytest.mark.parametrize("k", [6, 16, 64])
def test_views_add_remove_keep_only_parity(k):
    rng = np.random.default_rng(k)
    n = 256
    view = _random_views(rng, n, k, 4 * k, fill=(1.0, 0.0, 0.5, 0.9))
    nid = rng.integers(-1, 4 * k, n).astype(np.int32)
    nid[::7] = view[::7, 0]                          # already present
    jk, tk = _keys(k, n, 421)
    jw, jev = jax.vmap(jv.add)(jnp.asarray(view), jnp.asarray(nid), jk)
    tw, tev = tv.add(t(view), t(nid), tk)
    np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_array_equal(np.asarray(jev), tev.numpy())
    for cap in (0, k // 2, k):
        jv2, je2 = jax.vmap(lambda v, x, kk: jv.add_cap(v, x, kk, cap))(
            jnp.asarray(view), jnp.asarray(nid), jk)
        tw2, te2 = tv.add_cap(t(view), t(nid), tk, cap)
        np.testing.assert_array_equal(np.asarray(jv2), tw2.numpy())
        np.testing.assert_array_equal(np.asarray(je2), te2.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jv.remove)(jnp.asarray(view), jnp.asarray(nid))),
        tv.remove(t(view), t(nid)).numpy())
    keep = rng.random(4 * k) < 0.5
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda v: jv.keep_only(v, jnp.asarray(keep)))(
            jnp.asarray(view))),
        tv.keep_only(t(view), t(keep)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jv.size)(jnp.asarray(view))),
        tv.size(t(view)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jv.is_full)(jnp.asarray(view))),
        tv.is_full(t(view)).numpy())
    assert tv.empty(k).tolist() == np.asarray(jv.empty(k)).tolist()


@pytest.mark.parametrize("k,m", [(6, 1), (16, 3), (64, 1), (64, 5)])
def test_views_sample_pick_one_parity(k, m):
    rng = np.random.default_rng(100 + k + m)
    n = 256
    view = _random_views(rng, n, k, 3 * k, fill=(1.0, 0.0, 0.3, 0.8))
    exclude = np.where(rng.random((n, 2)) < 0.7, view[:, :2],
                       rng.integers(-1, 3 * k, (n, 2))).astype(np.int32)
    jk, tk = _keys(m, n, 423)
    for ex_j, ex_t in ((None, None), (jnp.asarray(exclude), t(exclude))):
        want = jax.vmap(lambda v, kk, *e: jv.sample(v, kk, m, *e))(
            jnp.asarray(view), jk, *(() if ex_j is None else (ex_j,)))
        got = tv.sample(t(view), tk, m, ex_t)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        want1 = jax.vmap(lambda v, kk, *e: jv.pick_one(v, kk, *e))(
            jnp.asarray(view), jk, *(() if ex_j is None else (ex_j,)))
        np.testing.assert_array_equal(
            np.asarray(want1), tv.pick_one(t(view), tk, ex_t).numpy())


def test_stack_records_parity():
    rng = np.random.default_rng(3)
    a, b = records(rng, (9, 3), 9), records(rng, (9, 3), 9)
    want = jpl.stack_records([jplanes(a), jplanes(b)], axis=1)
    got = tpl.stack_records([tplanes(a), tplanes(b)], dim=1)
    assert_planes_equal(want, got)


# ---- vector clocks and inbox merge ----------------------------------------

def _clocks(rng, shape):
    """uint32 clocks with values at and above 2**31 (and at the top of the
    range, where an increment wraps)."""
    big = rng.integers(2 ** 31 - 3, 2 ** 32, shape, dtype=np.int64)
    small = rng.integers(0, 6, shape, dtype=np.int64)
    return np.where(rng.random(shape) < 0.4, big, small).astype(np.uint32)


@pytest.mark.parametrize("A", [1, 5, 64])
def test_vclock_parity(A):
    from partisan_tpu.ops import vclock as jvc
    from partisan_tpu_torch.ops import vclock as tvc

    rng = np.random.default_rng(A)
    a, b = _clocks(rng, (40, A)), _clocks(rng, (40, A))
    b[::3] = a[::3]                         # equal rows
    b[1::3] = np.maximum(a[1::3], b[1::3])  # descending rows
    actor = rng.integers(0, A, 40).astype(np.int32)
    a[::4, actor[::4]] = 0xFFFFFFFF         # increments that wrap
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), t(u64(a)), t(u64(b))
    jact, tact = jnp.asarray(actor), t(actor)
    pairs = [
        (jvc.fresh(A), tvc.fresh(A)),
        (jvc.fresh_matrix(7, A), tvc.fresh_matrix(7, A)),
        (jvc.increment(ja, jact[:, None]), tvc.increment(ta, tact[:, None])),
        (jvc.increment(ja[0], jact[0]), tvc.increment(ta[0], int(actor[0]))),
        (jvc.merge(ja, jb), tvc.merge(ta, tb)),
        (jvc.descends(ja, jb), tvc.descends(ta, tb)),
        (jvc.dominates(jb, ja), tvc.dominates(tb, ta)),
        (jvc.concurrent(ja, jb), tvc.concurrent(ta, tb)),
        (jvc.glb(ja, jb), tvc.glb(ta, tb)),
        (jvc.get_counter(ja, jact), tvc.get_counter(ta, tact)),
        (jvc.deliverable(ja, jb, jact), tvc.deliverable(ta, tb, tact)),
        (jvc.deliverable(jvc.increment(jb, jact[:, None]), jb, jact),
         tvc.deliverable(tvc.increment(tb, tact[:, None]), tb, tact)),
    ]
    for i, (want, got) in enumerate(pairs):
        want = np.asarray(want)
        if want.dtype == np.uint32:
            want = want.astype(np.int64)
        assert got.dtype == (torch.bool if want.dtype == np.bool_
                             else torch.int64), i
        np.testing.assert_array_equal(want, got.numpy(), err_msg=str(i))
    assert bool(tvc.deliverable(tvc.increment(tb, tact[:, None]), tb,
                                tact).all())


@pytest.mark.parametrize("cap,bcap,live", [(16, 6, 0.5), (8, 20, 0.8),
                                           (4, 4, 0.1)])
def test_merge_inboxes_parity(cap, bcap, live):
    rng = np.random.default_rng(cap * bcap)
    n = 24
    a = tx.route(tplanes(records(rng, (n, 12), n, live)), n, cap)
    wb = records(rng, (n, bcap), n, live)
    b_count = (wb[tt.W_KIND] != 0).sum(axis=1).astype(np.int32)
    b_drops = rng.integers(0, 3, n).astype(np.int32)
    ja = jx.Inbox(data=jplanes([w.numpy() for w in a.data]),
                  count=jnp.asarray(a.count.numpy()),
                  drops=jnp.asarray(a.drops.numpy()))
    ref = jx.merge_inboxes(ja, jx.Inbox(data=jplanes(wb),
                                        count=jnp.asarray(b_count),
                                        drops=jnp.asarray(b_drops)))
    got = tx.merge_inboxes(a, tx.Inbox(data=tplanes(wb), count=t(b_count),
                                       drops=t(b_drops)))
    assert_planes_equal(ref.data, got.data)
    np.testing.assert_array_equal(np.asarray(ref.count), got.count.numpy())
    np.testing.assert_array_equal(np.asarray(ref.drops), got.drops.numpy())
