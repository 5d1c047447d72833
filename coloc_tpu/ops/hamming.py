"""Brute-force 512-bit Hamming 2-NN matching.

Reference parity: CUDAK2NN (src/CUDAK2NN.cu) — each query streams the whole
training bank, XOR + popcount per 64-bit word, keeps best + second-best, and
accepts iff `second_best - best > threshold` (popcount MARGIN, not a ratio —
CUDAK2NN.cu:16-21,75, the stated correct criterion for binary descriptors).
The CPU path instead uses OpenMVG DistanceRatioMatch with Lowe ratio 0.8
(CPUMatcher.hpp:58-59); both accept modes are provided here.

Hamming distance as a matrix product (SURVEY.md §7.1.3): for bit vectors
q,t ∈ {0,1}^512 mapped to s = 2b-1 ∈ {-1,+1}^512, HD(q,t) = (512 - <s_q, s_t>)
/ 2. So the whole Q×T distance matrix is one product over ±1 int8 operands
with exact int32 accumulation, which runs on the int8 tensor cores.

Two implementations of one contract, chosen by the backend alone:
  plain  — int8 dot_general to int32 + a top-2 in jnp. It runs on the CPU and
           is the reference the kernel is checked against.
  kernel — Pallas through Triton, on the GPU. Each program keeps one query
           tile and loops over its split of the bank, carrying the running
           (best, second, argbest) in registers, so the Q×T matrix never
           reaches device memory. The bank is split over a second grid axis
           so that a small query set still fills the card; a small jnp pass
           merges the splits. `interpret=True` runs it in the Pallas
           interpreter (tests).

Contract, bit for bit on both paths: an invalid bank row counts as
_INVALID_DIST; ties in best go to the lowest bank index; a duplicate of the
best row is the second-best at the same distance (CUDAK2NN duplicate
semantics); idx = -1 when no valid bank row exists; invalid queries report
best = second = _INVALID_DIST.

pack_bank / hamming_2nn_bank keep the training bank device-resident
(setMapData parity): it is unpacked once and reused across frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

DESC_BITS = 512
DESC_WORDS = 16
_INVALID_DIST = 2048  # > any possible Hamming distance


def unpack_bipolar(desc: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """(N, 16) uint32 packed bits -> (N, 512) ±1 of `dtype` (bit 0 of word 0 first).

    int8 by default: ±1 dot products run on the int8 tensor cores with exact
    int32 accumulation (|dot| <= 512)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(desc.shape[0], DESC_BITS)
    return (2 * bits.astype(jnp.int32) - 1).astype(dtype)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(N, 512) {0,1} -> (N, 16) uint32, inverse of unpack layout."""
    b = bits.reshape(bits.shape[0], DESC_WORDS, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bipolar_dot(sq, st):
    """(Q, 512) x (T, 512) ±1 int8 -> (Q, T) int32, exact. The explicit
    precision keeps the library-wide "highest" f32 setting away from an
    integer product."""
    return jax.lax.dot_general(
        sq, st, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
        precision=jax.lax.Precision.DEFAULT,
    )


# ---------------------------------------------------------------------------
# Plain path (CPU, and the reference)
# ---------------------------------------------------------------------------


def _plain_2nn(sq, st, t_valid):
    dist = (DESC_BITS - _bipolar_dot(sq, st)) >> 1
    dist = jnp.where(t_valid[None, :], dist, _INVALID_DIST)
    best = jnp.min(dist, axis=1)
    idx = jnp.argmin(dist, axis=1).astype(jnp.int32)   # first = lowest index
    col = jnp.arange(dist.shape[1], dtype=jnp.int32)
    second = jnp.min(
        jnp.where(col[None, :] == idx[:, None], _INVALID_DIST, dist), axis=1)
    idx = jnp.where(best < _INVALID_DIST, idx, -1)
    return idx, best, second


# ---------------------------------------------------------------------------
# Pallas kernel (Triton route)
# ---------------------------------------------------------------------------

class Tiles(NamedTuple):
    """Kernel tiling, chosen on an H100 (see PERF.md)."""

    bq: int = 128           # query rows per program
    bt: int = 64            # bank rows per loop step
    num_warps: int = 4
    num_stages: int = 3
    programs: int = 264     # grid size to aim for: two per SM (132 SMs)


_TILES = Tiles()
_BANK_ALIGN = 1024  # bank padding quantum: a multiple of every tile's bt
_MIN_KEY = -(1 << 30)
# dot-space encoding of an INVALID-distance result: dist = (512 - dot) / 2,
# so dot = 512 - 2*dist hits _INVALID_DIST at 512 - 2*2048
_DOT_INVALID = DESC_BITS - 2 * _INVALID_DIST


def _penrcol_row(t_valid: jnp.ndarray, Tp: int, period: int) -> jnp.ndarray:
    """(Tp,) int32 epilogue row: pen*65536 + (period-1 - col%period), where
    pen is 0 for valid entries and -2*_INVALID_DIST (dist-space
    +_INVALID_DIST) for invalid/padded ones. Entry >= 0 iff the row is
    valid."""
    T = t_valid.shape[0]
    pen = jnp.where(t_valid, 0, jnp.int32(-2 * _INVALID_DIST * 65536))
    pen = jnp.pad(pen.astype(jnp.int32), (0, Tp - T),
                  constant_values=-2 * _INVALID_DIST * 65536)
    rcol = (period - 1) - (jnp.arange(Tp, dtype=jnp.int32) % period)
    return pen + rcol


def _merge_top2(a, b):
    """Merge two running (best_dot, second_dot, argbest) triples, `a` over
    the lower bank indices. Strict > keeps `a` on ties -> lowest index; a
    tie also makes the twin the second (duplicate semantics)."""
    best, second, arg = a
    tbest, tsecond, targ = b
    take = tbest > best
    return (
        jnp.where(take, tbest, best),
        jnp.where(take, jnp.maximum(best, tsecond), jnp.maximum(second, tbest)),
        jnp.where(take, targ, arg),
    )


def _k2nn_kernel(q_ref, t_ref, penrcol_ref, bdot_ref, sdot_ref, idx_ref, *,
                 rows_per_split: int, bt: int):
    """One program: a (bq, 512) query tile against one split of the bank.

    The epilogue works in DOT space (maximize <s_q, s_t>) with one packed
    int32 key per element:

        key = (dot << 16) + penrcol,   penrcol = pen*65536 + (bt-1-col)

    so one max-reduce yields both the best penalized dot (high 16 bits;
    arithmetic >>16 is exact since the low half is in [0, 2^16)) and the
    LOWEST column attaining it; keys are unique, so masking exactly the
    argmax element and reducing again yields the second-best with
    duplicate semantics. Penalized keys stay above _MIN_KEY:
    dot + pen >= -512 - 4096. The carry starts at _DOT_INVALID, which an
    invalid row never exceeds, so invalid rows are never the best."""
    base = pl.program_id(1) * rows_per_split
    q = q_ref[...]
    bq = q.shape[0]

    def body(i, carry):
        start = pl.multiple_of(base + i * bt, bt)
        dot = _bipolar_dot(q, t_ref[pl.ds(start, bt), :])       # (bq, bt)
        key = (dot << 16) + penrcol_ref[pl.ds(start, bt)][None, :]
        kmax = jnp.max(key, axis=1)
        kmax2 = jnp.max(jnp.where(key == kmax[:, None], _MIN_KEY, key), axis=1)
        tile = (
            jax.lax.shift_right_arithmetic(kmax, 16),
            jax.lax.shift_right_arithmetic(kmax2, 16),
            start + (bt - 1) - (kmax & 65535),
        )
        return _merge_top2(carry, tile)

    init = (
        jnp.full((bq,), _DOT_INVALID, jnp.int32),
        jnp.full((bq,), _DOT_INVALID, jnp.int32),
        jnp.full((bq,), -1, jnp.int32),
    )
    best, second, arg = jax.lax.fori_loop(
        0, rows_per_split // bt, body, init)
    bdot_ref[...] = best
    sdot_ref[...] = second
    idx_ref[...] = arg


def _num_splits(n_qtiles: int, n_btiles: int, programs: int) -> int:
    """Largest power-of-two split of the bank's tiles that keeps the grid
    at or under about `programs` programs."""
    s = 1
    while n_btiles % (2 * s) == 0 and n_qtiles * s < programs:
        s *= 2
    return s


@functools.partial(jax.jit, static_argnames=("interpret", "tiles"))
def _k2nn(sq, st, penrcol, interpret=False, tiles: Tiles = _TILES):
    """(Qp, 512) x (Tp, 512) padded ±1 operands -> (idx, best, second)
    distances, each (Qp,) i32. Qp is a multiple of tiles.bq, Tp of
    tiles.bt, and penrcol's tiebreak period is tiles.bt."""
    Qp, Tp = sq.shape[0], st.shape[0]
    nq = Qp // tiles.bq
    S = _num_splits(nq, Tp // tiles.bt, tiles.programs)
    flat = jax.ShapeDtypeStruct((S * Qp,), jnp.int32)
    out_spec = pl.BlockSpec((tiles.bq,), lambda qi, s: (s * nq + qi,))
    bdot, sdot, idx = pl.pallas_call(
        functools.partial(_k2nn_kernel, rows_per_split=Tp // S, bt=tiles.bt),
        grid=(nq, S),
        in_specs=[
            pl.BlockSpec((tiles.bq, DESC_BITS), lambda qi, s: (qi, 0)),
            pl.BlockSpec((Tp, DESC_BITS), lambda qi, s: (0, 0)),
            pl.BlockSpec((Tp,), lambda qi, s: (0,)),
        ],
        out_specs=(out_spec, out_spec, out_spec),
        out_shape=(flat, flat, flat),
        compiler_params=pltriton.CompilerParams(
            num_warps=tiles.num_warps, num_stages=tiles.num_stages),
        backend="triton",
        interpret=interpret,
        name="hamming_k2nn",
    )(sq, st, penrcol)
    bdot, sdot, idx = (x.reshape(S, Qp) for x in (bdot, sdot, idx))
    best, second, arg = bdot[0], sdot[0], idx[0]
    for s in range(1, S):
        best, second, arg = _merge_top2(
            (best, second, arg), (bdot[s], sdot[s], idx[s]))
    # dot -> dist: dots are even (512 ±1 terms), penalties are even, so the
    # shift is exact
    return arg, (DESC_BITS - best) >> 1, (DESC_BITS - second) >> 1


def pack_bank(t_desc: jnp.ndarray, t_valid: jnp.ndarray):
    """Precompute the device-resident training bank (setMapData parity,
    GPUMatcher.hpp:110-117): unpacked ±1 int8 descriptors padded to the
    kernel's bank quantum, the kernel's packed penalty/tiebreak row, and the
    true bank size (a Python int)."""
    T = t_desc.shape[0]
    Tp = _round_up(T, _BANK_ALIGN)
    st = jnp.pad(unpack_bipolar(t_desc), ((0, Tp - T), (0, 0)))
    return st, _penrcol_row(t_valid, Tp, _TILES.bt), T


def _mask_queries(q_valid, idx, best, second):
    best = jnp.where(q_valid, best, jnp.int32(_INVALID_DIST))
    second = jnp.where(q_valid, second, jnp.int32(_INVALID_DIST))
    return idx, best, second


def hamming_2nn_bank_plain(q_desc, q_valid, bank):
    """The plain 2-NN against a resident bank, on any backend."""
    st, penrcol, T = bank
    # valid entries carry only the non-negative column tiebreak bits
    return _mask_queries(q_valid, *_plain_2nn(
        unpack_bipolar(q_desc), st[:T], penrcol[:T] >= 0))


def hamming_2nn_bank_kernel(q_desc, q_valid, bank, interpret: bool = False):
    """The Pallas 2-NN against a resident bank (GPU, or the interpreter)."""
    st, penrcol, _ = bank
    Q = q_desc.shape[0]
    sq = jnp.pad(unpack_bipolar(q_desc),
                 ((0, _round_up(Q, _TILES.bq) - Q), (0, 0)))
    idx, best, second = _k2nn(sq, st, penrcol, interpret=interpret)
    return _mask_queries(q_valid, idx[:Q], best[:Q], second[:Q])


def hamming_2nn_bank(q_desc, q_valid, bank, interpret: bool = False):
    """2-NN against a precomputed resident bank: (best_idx, best, second),
    each (Q,) i32. The kernel runs on the GPU (or interpreted when
    `interpret`), the plain path elsewhere."""
    if interpret or jax.default_backend() == "gpu":
        return hamming_2nn_bank_kernel(q_desc, q_valid, bank, interpret)
    return hamming_2nn_bank_plain(q_desc, q_valid, bank)


def hamming_2nn(q_desc, t_desc, q_valid, t_valid, interpret: bool = False):
    """2-NN of each query against the train descriptors; same contract and
    path choice as hamming_2nn_bank."""
    return hamming_2nn_bank(q_desc, q_valid, pack_bank(t_desc, t_valid),
                            interpret=interpret)


def hamming_2nn_plain(q_desc, t_desc, q_valid, t_valid):
    """The plain 2-NN on any backend (the reference the kernel is held to)."""
    return hamming_2nn_bank_plain(q_desc, q_valid, pack_bank(t_desc, t_valid))


def hamming_distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact popcount Hamming distance between packed descriptor rows (test oracle)."""
    x = jnp.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Two-stage matcher for very large banks (SURVEY §5 long-axis analog)
# ---------------------------------------------------------------------------
#
# Brute-force 2-NN costs Q*T*512 MACs; past ~10^5 landmarks the
# bank, not the frame, dominates per-frame cost. The two-stage matcher
# prunes with a 128-bit stride-sampled prefilter (1/4 the MACs) that keeps
# the top-2 candidates of every GROUP of _GROUP train rows, then re-ranks
# the surviving 2*T/_GROUP candidates with EXACT 512-bit popcount
# distances (CUDAK2NN margin semantics intact on the survivors:
# lowest-index best, duplicate descriptors leave their twin as second).
#
# Off by default: it is a prototype whose speed against brute force on
# the GPU is not measured yet (brute force and
# parallel.mesh.sharded_map_match are the supported paths).
#
# Contract (documented approximation): the best match is retrieved exactly
# whenever its group-local 128-bit rank is <= 2 — for matching-shaped data
# (a true match sits tens of bits below the background pool) this is
# overwhelmingly the case, and tests/test_hamming.py pins accepted-set
# equality against the brute-force kernel at 256k. The SECOND-best (margin
# denominator) is the minimum over the candidate pool, not the global
# pool, so margins are biased up by a few bits when the true second-best
# hides outside the survivors — accept decisions at the reference
# threshold (60) are unaffected for true matches, which is what the test
# asserts. For exact-margin semantics at any size, use the brute-force
# kernel or shard it (parallel.mesh.sharded_map_match).

_GROUP = 2048          # train rows per prefilter group
_PF_BITS = 128         # stride-sampled prefilter bits (512 / 4)
_PF_STRIDE = DESC_BITS // _PF_BITS
_CAND_IDX_MASK = (1 << 20) - 1   # candidate index field in the rerank key
_RERANK_INVALID = 600            # > any real distance, keeps keys in int32


def pack_bank_twostage(t_desc: jnp.ndarray, t_valid: jnp.ndarray):
    """Resident two-stage bank: stride-sampled ±1 prefilter operand +
    penalty row + the PACKED full descriptors (stage 2 gathers these) +
    validity. Groups pad to _GROUP multiples with invalid rows."""
    T = t_desc.shape[0]
    if T > _CAND_IDX_MASK + 1:
        # the re-rank key packs the candidate index into 20 bits; a larger
        # bank would silently bleed indices into the distance field
        raise ValueError(
            f"two-stage bank capped at {_CAND_IDX_MASK + 1} rows (got {T});"
            " shard the bank (parallel.mesh.sharded_map_match) instead"
        )
    Tp = _round_up(T, _GROUP)
    st = unpack_bipolar(t_desc)                     # (T, 512) int8
    st_sub = jnp.pad(st[:, ::_PF_STRIDE], ((0, Tp - T), (0, 0)))
    # tiebreak period = _GROUP: _group_top2 decodes group-local columns
    penrcol = _penrcol_row(t_valid, Tp, _GROUP)
    return st_sub, penrcol, t_desc, t_valid, T


def _group_top2(sq_sub, st_sub, penrcol):
    """Group prefilter: per (query, group of _GROUP train rows) the
    group-local best and second-best candidate GLOBAL indices at the
    prefilter bits, by the packed-key argmax of the 2-NN kernel (one
    (Q, G, _GROUP) reshape + top-2)."""
    Q, Tp = sq_sub.shape[0], st_sub.shape[0]
    # penrcol's column tiebreak must run with period _GROUP for the
    # group-local decode below (pack_bank_twostage builds it so)
    assert Tp % _GROUP == 0 and penrcol.shape == (Tp,)
    G = Tp // _GROUP
    key = (_bipolar_dot(sq_sub, st_sub) << 16) + penrcol[None, :]
    top2, _ = jax.lax.top_k(key.reshape(Q, G, _GROUP), 2)   # (Q, G, 2)
    base = jnp.arange(G, dtype=jnp.int32)[None, :] * _GROUP
    idx1 = (_GROUP - 1) - (top2[:, :, 0] & 65535) + base
    idx2 = (_GROUP - 1) - (top2[:, :, 1] & 65535) + base
    return idx1, idx2


def hamming_2nn_twostage(
    q_desc: jnp.ndarray,   # (Q, 16) uint32
    q_valid: jnp.ndarray,  # (Q,) bool
    bank,                  # pack_bank_twostage output
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-stage 2-NN against a resident large bank; same output contract
    as hamming_2nn (idx, best, second)."""
    st_sub, penrcol, t_desc, t_valid, T = bank

    # ---- stage 1: group-local top-2 at 128 prefilter bits -----------------
    sq_sub = unpack_bipolar(q_desc)[:, ::_PF_STRIDE]
    idx1, idx2 = _group_top2(sq_sub, st_sub, penrcol)
    cand = jnp.concatenate([idx1, idx2], axis=1)             # (Q, 2G)

    # ---- stage 2: exact 512-bit popcount re-rank of the survivors --------
    safe = jnp.clip(cand, 0, T - 1)
    cd = t_desc[safe]                                        # (Q, 2G, 16)
    dist = jnp.sum(
        jax.lax.population_count(jnp.bitwise_xor(cd, q_desc[:, None, :])),
        axis=-1,
    ).astype(jnp.int32)                                      # (Q, 2G)
    ok = (cand >= 0) & (cand < T) & t_valid[safe]
    dist = jnp.where(ok, dist, _RERANK_INVALID)
    # packed re-rank key: distance-major, global-index tiebreak (lowest
    # index wins — matches the brute-force kernel); keys are unique because
    # candidate indices are unique (groups are disjoint, idx2 != idx1), so
    # masking exactly the min and re-reducing yields CUDAK2NN duplicate
    # semantics (a twin descriptor survives as second-best)
    skey = dist * (_CAND_IDX_MASK + 1) + safe
    k1 = jnp.min(skey, axis=1, keepdims=True)
    k2 = jnp.min(jnp.where(skey == k1, jnp.int32(2 ** 30), skey), axis=1)
    k1 = k1[:, 0]
    best_idx = (k1 & _CAND_IDX_MASK).astype(jnp.int32)
    best = k1 >> 20
    second = k2 >> 20
    best = jnp.where(best >= _RERANK_INVALID, _INVALID_DIST, best)
    second = jnp.where(second >= _RERANK_INVALID, _INVALID_DIST, second)
    best = jnp.where(q_valid, best, jnp.int32(_INVALID_DIST))
    second = jnp.where(q_valid, second, jnp.int32(_INVALID_DIST))
    return best_idx, best.astype(jnp.int32), second.astype(jnp.int32)
