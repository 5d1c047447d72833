"""Hamming 2-NN matcher tests: exact popcount oracle vs the plain int8 path
vs the Pallas kernel (interpreter mode on CPU, compiled on a GPU), plus
margin/ratio accept semantics (SURVEY.md §4: 'Hamming 2-NN margin
semantics' unit tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from coloc_tpu.config import MatcherOptions
from coloc_tpu.matching import match_pair, match_with_map
from coloc_tpu.ops import hamming
from coloc_tpu.types import Features, MapDB, empty_features


def random_desc(rng, n):
    return jnp.asarray(rng.integers(0, 2**32, size=(n, 16), dtype=np.uint64).astype(np.uint32))


def brute_force_2nn(qd, td, t_valid):
    """Numpy oracle: exact popcount distances; an invalid train row counts
    as _INVALID_DIST, ties go to the lowest index (stable sort), idx = -1
    without a valid row."""
    q = np.asarray(qd)
    t = np.asarray(td)
    Q, T = q.shape[0], t.shape[0]
    dist = np.zeros((Q, T), np.int32)
    for j in range(T):
        x = q ^ t[j][None, :]
        dist[:, j] = np.unpackbits(x.view(np.uint8), axis=1).sum(1)
    dist = np.where(np.asarray(t_valid)[None, :], dist, 2048)
    order = np.argsort(dist, axis=1, kind="stable")
    best_idx = order[:, 0]
    best = dist[np.arange(Q), best_idx]
    second = (dist[np.arange(Q), order[:, 1]] if T > 1
              else np.full(Q, 2048))
    return np.where(best < 2048, best_idx, -1), best, second


def planted_problem(rng, Q, T):
    """Random descriptors with planted duplicates, ties and invalid rows on
    both sides."""
    td = np.array(random_desc(rng, T))
    qd = np.array(random_desc(rng, Q))
    n = max(min(Q // 4, T // 4), 1) if T >= 4 else 0
    if n:
        rows = rng.choice(T, size=3 * n, replace=False)
        src, dup, tie = rows[:n], rows[n:2 * n], rows[2 * n:]
        td[dup] = td[src]                  # duplicated best
        qd[:n] = td[src]
        qd[n:2 * n] = td[tie]              # two rows 10 bits away
        td[tie, 0] ^= np.uint32(0x3FF)
        twin = (tie + T // 2) % T
        td[twin] = qd[n:2 * n]
        td[twin, 0] ^= np.uint32(0xFFC00)
        tv = rng.random(T) > 0.1
        tv[src[: max(n // 4, 1)]] = False
    else:
        tv = np.ones(T, bool)
    qv = rng.random(Q) > 0.1
    return (jnp.asarray(qd), jnp.asarray(td), jnp.asarray(qv),
            jnp.asarray(tv))


def assert_same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestUnpack:
    def test_pack_unpack_roundtrip(self, rng):
        d = random_desc(rng, 8)
        s = hamming.unpack_bipolar(d, dtype=jnp.float32)
        bits = (np.asarray(s) > 0).astype(np.uint32)
        d2 = hamming.pack_bits(jnp.asarray(bits))
        np.testing.assert_array_equal(np.asarray(d2), np.asarray(d))

    def test_bipolar_identity(self, rng):
        """HD = (512 - dot)/2 must equal exact popcount."""
        a, b = random_desc(rng, 4), random_desc(rng, 4)
        sa = hamming.unpack_bipolar(a, jnp.float32)
        sb = hamming.unpack_bipolar(b, jnp.float32)
        dot = np.asarray(sa @ sb.T)
        hd_matmul = (512 - dot) / 2
        hd_pop = np.zeros((4, 4))
        for i in range(4):
            for j in range(4):
                hd_pop[i, j] = int(hamming.hamming_distance(a[i], b[j]))
        np.testing.assert_array_equal(hd_matmul, hd_pop)


class TestXLAPath:
    def test_vs_oracle(self, rng):
        qd, td = random_desc(rng, 33), random_desc(rng, 47)
        qv = jnp.ones(33, bool)
        tv = jnp.asarray(rng.random(47) > 0.2)
        idx, best, second = hamming.hamming_2nn_plain(qd, td, qv, tv)
        oidx, obest, osecond = brute_force_2nn(qd, td, tv)
        np.testing.assert_array_equal(np.asarray(best), obest)
        np.testing.assert_array_equal(np.asarray(second), osecond)
        np.testing.assert_array_equal(np.asarray(idx), oidx)
        # best index must achieve the best distance
        d = np.array([
            int(hamming.hamming_distance(qd[i], td[int(np.asarray(idx)[i])]))
            for i in range(33)
        ])
        np.testing.assert_array_equal(d, obest)


class TestPallasKernel:
    def test_vs_xla_path(self, rng):
        """Pallas kernel (interpret mode) must agree bit for bit with the
        plain path, including padding/masking behavior at non-tile-multiple
        sizes."""
        qd, td = random_desc(rng, 100), random_desc(rng, 300)
        qv = jnp.asarray(rng.random(100) > 0.1)
        tv = jnp.asarray(rng.random(300) > 0.1)
        assert_same(hamming.hamming_2nn(qd, td, qv, tv, interpret=True),
                    hamming.hamming_2nn_plain(qd, td, qv, tv))

    def test_exact_match_found(self, rng):
        """Planted identical descriptors must match with distance 0."""
        td = random_desc(rng, 600)
        sel = rng.choice(600, size=40, replace=False)
        qd = td[jnp.asarray(sel)]
        qv = jnp.ones(40, bool)
        tv = jnp.ones(600, bool)
        pi, pb, ps = hamming.hamming_2nn(qd, td, qv, tv, interpret=True)
        np.testing.assert_array_equal(np.asarray(pb), np.zeros(40))
        np.testing.assert_array_equal(np.asarray(pi), sel)

    def test_duplicate_and_tie_semantics(self, rng):
        """Regression for the packed-key epilogue: a duplicated best
        descriptor must leave its twin as second-best (CUDAK2NN semantics),
        ties must resolve to the LOWEST train index (incl. across bank tiles
        and splits), and invalid rows must never match."""
        T = 4200  # many bank tiles and several splits
        td = random_desc(rng, T)
        # plant: query 0's best appears at train rows 7, 2100 and 4100
        td = td.at[2100].set(td[7])
        td = td.at[4100].set(td[7])
        qd = td[jnp.asarray([7, 50])]
        qv = jnp.ones(2, bool)
        tv = np.ones(T, bool)
        tv[30:60] = False  # invalidates query 1's own row (50)
        tv = jnp.asarray(tv)

        pi, pb, ps = hamming.hamming_2nn(qd, td, qv, tv, interpret=True)
        # duplicate best: dist 0 at the lowest copy, second ALSO 0
        assert int(pi[0]) == 7
        assert int(pb[0]) == 0 and int(ps[0]) == 0
        # query 1's exact row is invalid; the true best is whatever valid
        # row is nearest
        assert int(pi[1]) != 50 and int(pb[1]) > 0
        assert_same((pi, pb, ps), brute_force_2nn(qd, td, tv))

    def test_all_invalid_targets(self, rng):
        """With every train row invalid the kernel must report idx=-1 and
        best=second=_INVALID_DIST (the session layer treats that as 'no
        match', never a spurious index)."""
        qd, td = random_desc(rng, 8), random_desc(rng, 100)
        qv = jnp.ones(8, bool)
        tv = jnp.zeros(100, bool)
        want = (-np.ones(8), np.full(8, hamming._INVALID_DIST),
                np.full(8, hamming._INVALID_DIST))
        assert_same(hamming.hamming_2nn(qd, td, qv, tv, interpret=True), want)
        assert_same(hamming.hamming_2nn_plain(qd, td, qv, tv), want)

    @pytest.mark.parametrize("Q,T,tiles", [
        (1, 1, hamming.Tiles()),
        (3, 5, hamming.Tiles(programs=1)),
        (65, 1000, hamming.Tiles(programs=1)),          # one split
        (100, 3000, hamming.Tiles(programs=8)),         # a few splits
        (130, 2100, hamming.Tiles()),                   # default grid
        (33, 700, hamming.Tiles(bq=32, bt=128, programs=1024)),  # max splits
    ])
    def test_planted_cases_match_oracle(self, rng, Q, T, tiles):
        """Q and T off tile multiples, one to many bank splits, planted
        duplicates, ties and invalid rows on both sides: the kernel, the
        plain path and the popcount oracle agree bit for bit."""
        qd, td, qv, tv = planted_problem(rng, Q, T)
        Tp = hamming._round_up(T, hamming._BANK_ALIGN)
        st = jnp.pad(hamming.unpack_bipolar(td), ((0, Tp - T), (0, 0)))
        pen = hamming._penrcol_row(tv, Tp, tiles.bt)
        Qp = hamming._round_up(Q, tiles.bq)
        sq = jnp.pad(hamming.unpack_bipolar(qd), ((0, Qp - Q), (0, 0)))
        idx, best, second = hamming._k2nn(sq, st, pen, interpret=True,
                                          tiles=tiles)
        got = hamming._mask_queries(qv, idx[:Q], best[:Q], second[:Q])
        oi, ob, os_ = brute_force_2nn(qd, td, tv)
        inv = hamming._INVALID_DIST
        want = (oi, np.where(qv, ob, inv), np.where(qv, os_, inv))
        assert_same(got, want)
        assert_same(hamming.hamming_2nn_plain(qd, td, qv, tv), want)

    def test_vmap_matches_plain(self, rng):
        """Under jax.vmap (the batched drone step and serving) the kernel
        keeps its contract per batch member."""
        qb = jnp.stack([random_desc(rng, 50), random_desc(rng, 50)])
        qv = jnp.asarray(rng.random((2, 50)) > 0.1)
        td = random_desc(rng, 500)
        bank = hamming.pack_bank(td, jnp.asarray(rng.random(500) > 0.1))
        got = jax.vmap(lambda q, v: hamming.hamming_2nn_bank(
            q, v, bank, interpret=True))(qb, qv)
        want = jax.vmap(lambda q, v: hamming.hamming_2nn_bank_plain(
            q, v, bank))(qb, qv)
        assert_same(got, want)

    def test_backend_alone_chooses_path(self, rng, monkeypatch):
        """The kernel runs when the backend is the GPU (or a test asks for
        the interpreter); every other backend runs the plain path."""
        calls = []
        real = hamming._k2nn

        def spy(*a, **kw):
            calls.append(kw.get("interpret"))
            return real(*a, **{**kw, "interpret": True})

        monkeypatch.setattr(hamming, "_k2nn", spy)
        qd, td = random_desc(rng, 20), random_desc(rng, 90)
        qv, tv = jnp.ones(20, bool), jnp.ones(90, bool)
        want = hamming.hamming_2nn_plain(qd, td, qv, tv)
        assert_same(hamming.hamming_2nn(qd, td, qv, tv), want)
        assert calls == []                      # CPU: plain path
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert_same(hamming.hamming_2nn(qd, td, qv, tv), want)
        assert calls == [False]                 # GPU: compiled kernel

    @pytest.mark.gpu
    def test_compiled_kernel_matches_plain(self, gpu, rng):
        """On the card: the Triton-compiled kernel against the plain path at
        a real width."""
        qd, td, qv, tv = planted_problem(rng, 1024, 4096)
        bank = hamming.pack_bank(td, tv)
        assert_same(hamming.hamming_2nn_bank_kernel(qd, qv, bank),
                    hamming.hamming_2nn_bank_plain(qd, qv, bank))


class TestAcceptSemantics:
    def _features(self, desc, n_valid=None):
        n = desc.shape[0]
        f = empty_features(n)
        valid = jnp.arange(n) < (n_valid if n_valid is not None else n)
        return f._replace(desc=desc, valid=valid)

    def test_margin_mode(self, rng):
        """second - best > threshold accepts; close seconds reject."""
        td = random_desc(rng, 256)
        qd = td[:32]  # exact matches: best=0; second is random ~256
        opts = MatcherOptions(mode="margin", pair_margin_threshold=40)
        m = match_pair(self._features(qd), self._features(td), opts)
        assert np.asarray(m.mask).all()
        np.testing.assert_array_equal(np.asarray(m.idx), np.arange(32))

    def test_margin_rejects_ambiguous(self, rng):
        """Duplicate train descriptors -> second == best -> margin 0 -> reject."""
        base = random_desc(rng, 64)
        td = jnp.concatenate([base, base], axis=0)  # every descriptor twice
        qd = base[:16]
        opts = MatcherOptions(mode="margin", pair_margin_threshold=40)
        m = match_pair(self._features(qd), self._features(td), opts)
        assert not np.asarray(m.mask).any()

    def test_ratio_mode(self, rng):
        td = random_desc(rng, 256)
        qd = td[:16]
        opts = MatcherOptions(mode="ratio", dist_ratio=0.8)
        m = match_pair(self._features(qd), self._features(td), opts)
        assert np.asarray(m.mask).all()

    def test_invalid_query_rejected(self, rng):
        td = random_desc(rng, 128)
        qd = td[:16]
        opts = MatcherOptions()
        m = match_pair(self._features(qd, n_valid=8), self._features(td), opts)
        assert np.asarray(m.mask)[:8].all()
        assert not np.asarray(m.mask)[8:].any()

    def test_all_invalid_bank_rejects(self, rng):
        """Regression: the invalid-train penalty shifts best and second
        equally, so margin alone would still accept against an empty bank."""
        desc = random_desc(rng, 128)
        mapdb = MapDB(X=jnp.zeros((128, 3)), desc=desc, valid=jnp.zeros(128, bool))
        m = match_with_map(self._features(desc[:16]), mapdb, MatcherOptions())
        assert not np.asarray(m.mask).any()

    def test_map_match(self, rng):
        desc = random_desc(rng, 512)
        mapdb = MapDB(X=jnp.zeros((512, 3)), desc=desc, valid=jnp.ones(512, bool))
        qd = desc[100:140]
        opts = MatcherOptions(mode="margin", margin_threshold=60)
        m = match_with_map(self._features(qd), mapdb, opts)
        np.testing.assert_array_equal(np.asarray(m.idx), np.arange(100, 140))


class TestResidentBank:
    def test_bank_path_matches_direct(self, rng):
        """pack_bank + hamming_2nn_bank (kernel, interpreted) must reproduce
        the plain 2-NN on the raw descriptors."""
        qd = random_desc(rng, 80)
        td = random_desc(rng, 300)
        qv = jnp.asarray(rng.random(80) > 0.1)
        tv = jnp.asarray(rng.random(300) > 0.1)
        bank = hamming.pack_bank(td, tv)
        assert_same(hamming.hamming_2nn_bank(qd, qv, bank, interpret=True),
                    hamming.hamming_2nn_plain(qd, td, qv, tv))


class TestTwoStage:
    """Two-stage large-bank matcher: 128-bit group
    prefilter + EXACT 512-bit re-rank of the survivors. The contract under
    test: on matching-shaped banks (true matches sit well below the
    background pool) the ACCEPTED matches — and the best index/distance of
    every accepted match — equal the brute-force kernel's."""

    def _matching_shaped(self, rng, Q, T, n_true=None):
        """Bank of random descriptors where each query has one true match
        (a few flipped bits from the query) planted at a random slot."""
        qd = np.array(random_desc(rng, Q))
        td = np.array(random_desc(rng, T))
        n_true = Q if n_true is None else n_true
        slots = rng.choice(T, size=n_true, replace=False)
        for qi in range(n_true):
            d = qd[qi].copy()
            # flip ~40 random bits -> distance ~40 vs background ~256
            for b in rng.integers(0, 512, 40):
                d[b // 32] ^= np.uint32(1 << (b % 32))
            td[slots[qi]] = d
        return jnp.asarray(qd), jnp.asarray(td), slots

    def test_accepted_set_equals_bruteforce_large_bank(self, rng):
        """Exactness test at a 256k-slot bank (the BANK is full 256k)."""
        from coloc_tpu.matching import (
            MapDB, match_with_map, pack_map_bank_twostage,
        )
        from coloc_tpu.types import Features

        Q, T = 512, 262_144
        qd, td, slots = self._matching_shaped(rng, Q, T)
        qv = jnp.ones(Q, bool)
        tv = jnp.asarray(rng.random(T) > 0.05)
        mapdb = MapDB(X=jnp.zeros((T, 3)), desc=td, valid=tv)

        # brute-force reference (plain path — exact)
        xi, xb, xs = hamming.hamming_2nn_plain(qd, td, qv, tv)
        # two-stage
        bank2 = hamming.pack_bank_twostage(td, tv)
        ti_, tb, ts = hamming.hamming_2nn_twostage(qd, qv, bank2)

        # best retrieval: exact wherever the brute-force best is a genuine
        # match (the planted low-distance hit)
        xb_np, tb_np = np.asarray(xb), np.asarray(tb)
        xi_np, ti_np = np.asarray(xi), np.asarray(ti_)
        planted = xb_np < 128
        assert planted.sum() >= Q * 0.9
        np.testing.assert_array_equal(ti_np[planted], xi_np[planted])
        np.testing.assert_array_equal(tb_np[planted], xb_np[planted])

        # accept-set parity at the reference margin threshold (60): the
        # margin denominator may be biased up by a few bits when the true
        # global second hides outside the survivors, but decisions at the
        # reference threshold must agree
        opts = MatcherOptions()
        acc_bf = (np.asarray(xs) - xb_np) > opts.margin_threshold
        acc_ts = (np.asarray(ts) - tb_np) > opts.margin_threshold
        np.testing.assert_array_equal(acc_ts, acc_bf)
        # and through the public matching API
        feats = Features(
            xy=jnp.zeros((Q, 2)), score=jnp.ones(Q),
            scale=jnp.zeros(Q, jnp.int32), angle=jnp.zeros(Q),
            desc=qd, valid=qv,
        )
        m2 = match_with_map(feats, mapdb, opts,
                            twostage_bank=pack_map_bank_twostage(mapdb))
        np.testing.assert_array_equal(
            np.asarray(m2.idx)[acc_bf], xi_np[acc_bf])

    def test_duplicate_semantics_and_planted_retrieval(self, rng):
        """Contract checks on a one-group bank: planted (true-match-shaped)
        queries retrieve exactly the brute-force best with the exact
        distance; a duplicated best descriptor leaves its twin as
        second-best with the lowest-index tiebreak (CUDAK2NN semantics —
        both twins share the 128-bit sub-distance, so both survive the
        prefilter by construction). Queries with no planted match have a
        best that is a random background row; its 128-bit rank is
        uncorrelated with its 512-bit rank, so NO exactness is claimed
        there — that is the documented contract boundary."""
        Q, T = 64, 1024
        qd, td, planted_slots = self._matching_shaped(rng, Q, T, n_true=32)
        # plant a DUPLICATE of query 0's best so second-best = twin
        td = np.array(td)
        td[7] = td[100] = np.asarray(qd)[0]
        td = jnp.asarray(td)
        qv = jnp.ones(Q, bool)
        tv = jnp.ones(T, bool)
        xi, xb, xs = hamming.hamming_2nn_plain(qd, td, qv, tv)
        bank2 = hamming.pack_bank_twostage(td, tv)
        ti_, tb, ts = hamming.hamming_2nn_twostage(qd, qv, bank2)
        has_match = np.asarray(xb) < 128    # query 0 (dup) + planted ones
        assert has_match.sum() >= 32
        np.testing.assert_array_equal(
            np.asarray(ti_)[has_match], np.asarray(xi)[has_match])
        np.testing.assert_array_equal(
            np.asarray(tb)[has_match], np.asarray(xb)[has_match])
        # duplicate: best = lowest-index twin, twin survives as second
        assert int(ti_[0]) == 7 and int(tb[0]) == 0 and int(ts[0]) == 0


class TestNFAOracle:
    def test_nfa_matches_bruteforce(self, rng):
        """nfa_scores must agree with a direct numpy evaluation of the
        a-contrario formula for every model."""
        from coloc_tpu.ransac import nfa_scores

        Hm, M, S = 5, 40, 5
        res_sq = rng.uniform(0.0001, 4.0, (Hm, M)).astype(np.float32)
        valid = rng.random(M) > 0.15
        log_a0 = -2.0

        score, thr = nfa_scores(
            jnp.asarray(res_sq), jnp.asarray(valid), S, log_a0, 1.0,
        )
        # numpy oracle
        n = valid.sum()
        import math

        def logC(a, b):
            return (math.lgamma(a + 1) - math.lgamma(b + 1)
                    - math.lgamma(a - b + 1)) / math.log(10)

        for h in range(Hm):
            r = np.sort(np.where(valid, res_sq[h], np.inf))
            best = np.inf
            bthr = None
            for k in range(S + 1, n + 1):
                e = math.sqrt(r[k - 1])
                v = (math.log10(n - S) + logC(n, k) + logC(k, S)
                     + (k - S) * (log_a0 + math.log10(e)))
                if v < best:
                    best = v
                    bthr = r[k - 1]
            assert float(score[h]) == pytest.approx(best, rel=1e-3, abs=1e-2)
            assert float(thr[h]) == pytest.approx(bthr, rel=1e-4)
