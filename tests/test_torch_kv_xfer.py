"""PyTorch port: page export / import — `PagedKVCache.export_pages` /
`import_pages` (serving/paged_kv.py) and `ServingEngine.export_prefix` /
`import_prefix` (serving/engine.py) — against the JAX package on the CPU,
exactly (the cases of tests/test_kv_xfer.py).

The wire format is the reference's: `meta` equal field for field (the
dtype is the string "bfloat16" for bf16 pools), the payload over layers
in sorted name order, each layer's k block then its v block,
[n, page_size, h_kv, dh] row-major — byte for byte equal to JAX's on the
same page contents.  A payload exported by JAX and imported by the port
gives the JAX importer's tokens, and a payload going the other way does
too; a malformed blob or a dry pool rolls the allocator back exactly.

Toy widths: vocab 23, dim 16, 2 layers, 2 heads; pages of 4 tokens."""

import types

import numpy as np
import pytest
import torch

from paddle_tpu.serving import PagedKVCache as JPagedKVCache
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.serving import PagedKVCache, ServingEngine
from test_torch_prefix_cache import alloc_state, lm, pairs  # noqa: F401

M23 = (23, 16, 2, 2)
ENGINE = dict(num_slots=2, page_size=4, max_context=16)


def caches(dtype: str = "float32"):
    """A source and a destination allocator on each package, pools of
    `dtype`: (JAX src, JAX dst, port src, port dst)."""
    tr, ex, _ = lm(*M23)
    jex = types.SimpleNamespace(model=tr.executor.model, compute_dtype=dtype)
    pex = types.SimpleNamespace(model=ex.model, compute_dtype=dtype)
    kw = dict(num_slots=2, page_size=4, pages_per_slot=3, num_pages=8)
    return (JPagedKVCache(jex, **kw), JPagedKVCache(jex, **kw),
            PagedKVCache(pex, 2, 4, 3, torch.device("cpu"), num_pages=8),
            PagedKVCache(pex, 2, 4, 3, torch.device("cpu"), num_pages=8))


def committed(kv, n_tokens: int = 12) -> list:
    """Grow slot 0, mark its pages cached, release it: the refcount-zero
    cached pages a donation leaves."""
    assert kv.try_grow(0, n_tokens)
    pages = [int(kv.table[0, j]) for j in range(kv.pages_for(n_tokens))]
    for p in pages:
        kv.cache_page(p)
    kv.release(0)
    return pages


MARKS = [("k", 0, (1, 0, 2), 7.5), ("v", 2, (3, 1, 1), -2.25),
         ("k", 1, (0, 1, 0), 0.375)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_import_roundtrip_units_match_jax(dtype):
    """Markers planted alike in both packages' pools: the two exports'
    meta are equal (dtype "bfloat16" for bf16) and their payloads equal
    byte for byte; JAX's payload imported by the port and the port's by
    JAX land the markers; the allocators equal and reclaim whole."""
    jsrc, jdst, src, dst = caches(dtype)
    pages = committed(src)
    assert committed(jsrc) == pages
    name = sorted(src.pools)[-1]
    for part, i, at, val in MARKS:
        jsrc.pools[name][part] = jsrc.pools[name][part].at[
            (pages[i],) + at].set(val)
        src.pools[name][part][(pages[i],) + at] = val
    jmeta, jpay = jsrc.export_pages(pages)
    meta, pay = src.export_pages(pages)
    assert meta == jmeta
    assert meta["layers"][0]["dtype"] == dtype
    assert pay == jpay and len(pay) == 3 * src.page_nbytes
    assert src.n_exported == jsrc.n_exported == 3
    src.check()
    for imp, exp_meta, exp_pay in ((dst, jmeta, jpay), (jdst, meta, pay)):
        taken = imp.take_pages(3)
        imp.import_pages(exp_meta, exp_pay, taken)
        imp.adopt_restored(taken)
        assert imp.n_imported == 3 and imp.cached_page_count == 3
        for part, i, at, val in MARKS:
            assert float(imp.pools[name][part][(taken[i],) + at]) == val
        imp.check()
    assert alloc_state(dst) == alloc_state(jdst)
    for kv, ps in ((src, pages), (jsrc, pages), (dst, taken),
                   (jdst, taken)):
        for p in ps:
            kv.uncache_page(p)
        kv.check_reclaimed()


def test_import_validates_before_touching_device_like_jax():
    """Every malformed blob raises ValueError on both packages before any
    device write, and untake_pages restores the free list exactly."""
    _, jdst, src, dst = caches()
    meta, payload = src.export_pages(committed(src))
    free0 = list(dst._free)
    cases = [
        (dict(meta, n_pages=2), payload),
        (dict(meta, page_size=8), payload),
        (dict(meta, layers=meta["layers"][:1]), payload),
        (dict(meta, layers=[dict(meta["layers"][0], h_kv=99)]
              + [dict(l) for l in meta["layers"][1:]]), payload),
        (dict(meta, layers=[dict(l, dtype="bfloat16")
                            for l in meta["layers"]]), payload),
        (meta, payload[:-1]),
        (meta, payload + b"\x00"),
    ]
    for bad_meta, bad_payload in cases:
        for kv in (jdst, dst):
            taken = kv.take_pages(3)
            with pytest.raises(ValueError):
                kv.import_pages(bad_meta, bad_payload, taken)
            kv.untake_pages(taken)
            assert kv._free == free0 and kv.n_imported == 0
            kv.check()
    dst.check_reclaimed()


def test_export_rejects_free_pages():
    """A page nobody holds would ship garbage: refused on both."""
    jsrc, _, src, _ = caches()
    for kv in (jsrc, src):
        with pytest.raises(AssertionError):
            kv.export_pages([int(kv._free[-1])])


def xfer_pairs(pairs):
    """Two Pairs of one configuration (the second keyed apart by its
    explicit default pool), both cold."""
    a = pairs(model=M23, **ENGINE)
    b = pairs(model=M23, num_pages=9, **ENGINE)
    return a, b


def test_import_prefix_mounts_and_the_next_admission_hits_across_packages(
        pairs):
    """A's engines retire the same request; both export its committed
    prefix (meta equal, the K/V within float tolerance of each other).
    B's engines import JAX's payload: the next admission of the prompt is
    a prefix hit on both, with equal tokens, counters and state.  Then B
    again, from a cold cache, imports the port's payload: again equal, and
    equal to A's tokens."""
    a, b = xfer_pairs(pairs)
    prompt = np.random.default_rng(3).integers(2, 23, 9).astype(np.int32)
    out_a = a.run([("a", prompt.copy(), dict(max_new=4))])["a"]
    jtoks, jmeta, jpay = a.jeng.export_prefix(prompt)
    toks, meta, pay = a.eng.export_prefix(prompt)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert meta == jmeta and len(pay) == len(jpay)
    assert toks.size == 8 and meta["n_pages"] == 2
    np.testing.assert_allclose(np.frombuffer(pay, np.float32),
                               np.frombuffer(jpay, np.float32),
                               rtol=1e-5, atol=1e-5)
    for src_meta, src_pay in ((jmeta, jpay), (meta, pay)):
        b.reset()
        hits0 = b.eng.n_prefix_hits
        added = [e.import_prefix(toks, src_meta, src_pay)
                 for e in (b.jeng, b.eng)]
        assert added == [2, 2]
        b.check()
        assert [(e.n_kv_mounts, e.kv_pages_mounted, e.kv.n_imported)
                for e in (b.eng, b.jeng)][0] == \
            (b.jeng.n_kv_mounts, b.jeng.kv_pages_mounted,
             b.jeng.kv.n_imported)
        out_b = b.run([("b", prompt.copy(), dict(max_new=4))])["b"]
        assert b.eng.n_prefix_hits - hits0 == 1
        np.testing.assert_array_equal(out_b, out_a)


def test_import_prefix_dedups_already_mounted_runs_like_jax(pairs):
    """A second import of runs already on the device adds no node and
    frees the duplicate pages at once, on both."""
    a, b = xfer_pairs(pairs)
    prompt = np.random.default_rng(4).integers(2, 23, 9).astype(np.int32)
    a.run([("a", prompt.copy(), dict(max_new=4))])
    toks, meta, pay = a.jeng.export_prefix(prompt)
    assert [e.import_prefix(toks, meta, pay) for e in (b.jeng, b.eng)] == \
        [2, 2]
    nodes0, cached0, free0 = (b.eng.prefix.n_nodes,
                              b.eng.kv.cached_page_count,
                              b.eng.kv.free_page_count)
    assert [e.import_prefix(toks, meta, pay) for e in (b.jeng, b.eng)] == \
        [0, 0]
    assert (b.eng.prefix.n_nodes, b.eng.kv.cached_page_count,
            b.eng.kv.free_page_count) == (nodes0, cached0, free0)
    b.check()


def test_import_prefix_rolls_back_on_a_dry_pool_or_a_bad_blob(pairs):
    """Page starvation raises with the allocator as it was, on both; a
    malformed blob after a successful take rolls back through
    import_prefix's untake."""
    a, _ = xfer_pairs(pairs)
    prompt = np.random.default_rng(5).integers(2, 23, 13).astype(np.int32)
    a.run([("a", prompt[:9].copy(), dict(max_new=4))])
    toks, meta, pay = a.jeng.export_prefix(prompt[:9])
    tr, ex, params = lm(*M23)
    small = dict(num_slots=1, page_size=4, max_context=12, num_pages=4)
    dry = (JServingEngine(tr.executor, tr.params, **small),
           ServingEngine(ex, params, device="cpu", **small))
    for e in dry:
        assert e.kv.try_grow(0, 12)
        with pytest.raises(ValueError, match="cannot cover"):
            e.import_prefix(toks, meta, pay)
        e.kv.check()
        e.kv.release(0)
        e.kv.check_reclaimed()
    assert alloc_state(dry[1].kv) == alloc_state(dry[0].kv)
    fresh = (JServingEngine(tr.executor, tr.params, **ENGINE),
             ServingEngine(ex, params, device="cpu", **ENGINE))
    for e in fresh:
        free0 = list(e.kv._free)
        with pytest.raises(ValueError):
            e.import_prefix(toks, meta, pay[:-1])
        assert e.kv._free == free0
        e.kv.check_reclaimed()


def test_import_prefix_requires_the_prefix_cache(pairs):
    a, _ = xfer_pairs(pairs)
    prompt = np.random.default_rng(6).integers(2, 23, 9).astype(np.int32)
    a.run([("a", prompt.copy(), dict(max_new=4))])
    toks, meta, pay = a.eng.export_prefix(prompt)
    tr, ex, params = lm(*M23)
    for e in (JServingEngine(tr.executor, tr.params, prefix_cache=False,
                             **ENGINE),
              ServingEngine(ex, params, device="cpu", prefix_cache=False,
                            **ENGINE)):
        with pytest.raises(ValueError, match="prefix cache"):
            e.import_prefix(toks, meta, pay)
        assert e.export_prefix(prompt) is None
