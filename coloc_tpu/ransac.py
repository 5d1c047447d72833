"""Batched fixed-shape RANSAC harness.

Reference parity: OpenMVG ACRANSAC as driven by RobustMatcher.hpp (256
iterations, RobustMatcher.hpp:34) and Localizer.hpp (:84). The host loop
"sample -> solve -> score -> keep best" becomes: sample ALL B minimal sets at
once, vmap the minimal solver (which may emit several candidate models per
sample), score every model against every correspondence in one (B, M)
computation, argmax inlier count (SURVEY.md §7.1.4).

Scoring modes: "nfa" (the DEFAULT) is a-contrario ACRANSAC with a fully
adaptive inlier threshold (infinite max admissible error, matching the
reference's initial_residual_tolerance defaults); "count" is the fixed-
threshold fallback. Both apply the same `inliers >= inlier_multiple x
minimal sample` acceptance gate the reference layers on top of ACRANSAC
(RobustMatcher.hpp:147,175,210).

Degenerate-sample hygiene: minimal samples are drawn WITHOUT replacement
(Floyd's algorithm, fixed-shape) so no hypothesis budget is burned on
duplicate-index degenerate models — matching the reference's UniformSample
semantics (OpenMVG robust_estimation).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


# exact-NFA evaluations per call (pre-ranked by two-threshold inlier counts;
# see the scoring="nfa" branch in ransac())
_NFA_CANDIDATES = 32
# Pre-rank ladder shape: rungs threshold * 4^j for j in [LADDER_JMAX -
# (LADDER_RUNGS - 1) ... LADDER_JMAX].
LADDER_JMAX = 2
LADDER_RUNGS = 5


class RansacResult(NamedTuple):
    model: jnp.ndarray      # best model parameters (pytree leaf stack)
    inliers: jnp.ndarray    # (M,) bool
    n_inliers: jnp.ndarray  # () int32
    success: jnp.ndarray    # () bool
    threshold_sq: jnp.ndarray  # () f32 squared inlier threshold actually used
    # (count: the fixed threshold; nfa: the ADAPTIVE per-model threshold of
    # the winning model — ACRansacOut.first parity, RobustMatcher.hpp:173)


def nfa_scores(
    res_sq: jnp.ndarray,     # (Hm, M) squared residuals per model
    valid: jnp.ndarray,      # (M,) bool correspondence validity
    sample_size: int,
    log_alpha0: float,       # log10 of the background-probability constant
    error_dim: float = 1.0,  # 1 = point-to-line (epipolar), 2 = point error
    max_threshold_sq: float = jnp.inf,
):
    """Batched a-contrario NFA scoring (OpenMVG ACRANSAC semantics).

    For each model: sort residuals ascending; over every candidate inlier
    count k in (S, n]:
      log10 NFA(k) = log10(n-S) + logC(n,k) + logC(k,S)
                     + (k-S) * (log_alpha0 + dim * log10(e_k))
    where e_k is the k-th smallest residual (not squared). The model's score
    is min_k logNFA; the adaptive inlier threshold is e_{k*} at the argmin.
    A model is meaningful iff its score < 0 (epsilon = 1).

    Returns (score (Hm,), threshold_sq (Hm,)) — per-model adaptive thresholds.
    """
    Hm, M = res_sq.shape
    S = sample_size
    n = jnp.sum(valid.astype(jnp.int32))

    masked = jnp.where(valid[None, :], res_sq, jnp.inf)
    masked = jnp.where(masked <= max_threshold_sq, masked, jnp.inf)
    sorted_sq = jnp.sort(masked, axis=1)                     # (Hm, M)

    ks = jnp.arange(1, M + 1, dtype=jnp.float32)             # k = rank
    # log10 binomials via lgamma (natural log -> log10)
    ln10 = jnp.log(10.0)
    lgam = jax.scipy.special.gammaln
    nf = n.astype(jnp.float32)
    logC_n_k = (lgam(nf + 1) - lgam(ks + 1) - lgam(jnp.maximum(nf - ks + 1, 1.0))) / ln10
    logC_k_S = (lgam(ks + 1) - lgam(float(S) + 1) - lgam(jnp.maximum(ks - S + 1, 1.0))) / ln10

    log_e = 0.5 * jnp.log10(jnp.maximum(sorted_sq, 1e-20))   # log10 e_k
    log_nfa = (
        jnp.log10(jnp.maximum(nf - S, 1.0))
        + logC_n_k[None, :]
        + logC_k_S[None, :]
        + (ks[None, :] - S) * (log_alpha0 + error_dim * log_e)
    )
    k_ok = (ks[None, :] > S) & (ks[None, :] <= nf) & jnp.isfinite(sorted_sq)
    log_nfa = jnp.where(k_ok, log_nfa, jnp.inf)

    best_k = jnp.argmin(log_nfa, axis=1)                     # (Hm,)
    score = jnp.take_along_axis(log_nfa, best_k[:, None], axis=1)[:, 0]
    thr_sq = jnp.take_along_axis(sorted_sq, best_k[:, None], axis=1)[:, 0]
    return score, thr_sq


def ladder_rank(res_sq: jnp.ndarray, valid: jnp.ndarray,
                threshold_sq: float) -> jnp.ndarray:
    """Pre-rank of each model: the integral of its inlier-count curve over
    the geometric threshold ladder threshold_sq * 4^j,
    j in [LADDER_JMAX - LADDER_RUNGS + 1, LADDER_JMAX]. res_sq (Hm, M),
    valid (M,) -> (Hm,) f32 rung counts summed over valid residuals.

    A model must fit tightly AND broadly to rank high — counting at a
    single loose gate lets sloppy models that grab accidental outliers
    outrank the exact model, and a single tight gate is blind when the
    data's noise exceeds it (the adaptive-up case NFA exists for).
    Ladder counting in ONE elementwise pass: for geometric rungs t*4^j,
    j in [jmin, jmax], the number of rungs a residual clears is
      #{j : res < t*4^j} = clip(jmax - floor(log4(res / t)), 0, n)
    — replacing per-rung (Hm, M) compare+reduce passes (each pass is
    memory-bound). One log2 + clip costs less than two passes.
    Rung range [-2, 2] around the nominal gate (top rung 4^2 x the seed
    threshold, e.g. a 16 px epipolar band for a 4 px gate): wide enough
    that models separate on the loose rungs when the data's noise exceeds
    the gate (the adaptive-up regime NFA exists for — pinned by the
    50-scene exhaustive-winner property test up to 3x-gate noise), tight
    enough that the rank prefers exact models. Wider ladders (jmax 3-6)
    and a data-derived rung were tried: both shuffle NFA tie-breaks toward
    broader models whose LM refinement converges more slowly, with no
    winner-quality gain on the property test.
    """
    v = jnp.log2(jnp.maximum(res_sq, 1e-30)) - jnp.log2(
        jnp.float32(threshold_sq))
    cnt = jnp.clip(jnp.float32(LADDER_JMAX) - jnp.floor(v * 0.5), 0.0,
                   jnp.float32(LADDER_RUNGS))
    return jnp.sum(jnp.where(valid[None, :], cnt, 0.0), axis=1)


def _distinct_positions(u: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Floyd's algorithm: S distinct uniform positions in [0, n) from S
    uniforms. Fixed shape, O(S^2) compares (S <= 8 in practice)."""
    S = u.shape[0]
    nf = jnp.maximum(n, S).astype(jnp.int32)  # n < S: distinct impossible
    picks = jnp.zeros((S,), jnp.int32)
    for j in range(S):
        m = nf - S + j + 1  # draw t in [0, m)
        t = jnp.floor(u[j] * m.astype(jnp.float32)).astype(jnp.int32)
        t = jnp.clip(t, 0, m - 1)
        if j > 0:
            collide = jnp.any(picks[:j] == t)
            t = jnp.where(collide, nf - S + j, t)
        picks = picks.at[j].set(t)
    # if n < S, clamp into the valid range (duplicates unavoidable; such a
    # bank can never pass the >= 2.5*S inlier gate anyway)
    return jnp.clip(picks, 0, jnp.maximum(n - 1, 0))


def _pack_valid_first(valid: jnp.ndarray) -> jnp.ndarray:
    """Stable index order with valid entries first — equivalent to
    argsort(~valid, stable) but built from two cumsums + one scatter
    instead of a sort."""
    n = valid.shape[0]
    pos_valid = jnp.cumsum(valid.astype(jnp.int32)) - 1
    n_valid = pos_valid[-1] + 1
    pos_invalid = n_valid + jnp.cumsum((~valid).astype(jnp.int32)) - 1
    tgt = jnp.where(valid, pos_valid, pos_invalid)
    return jnp.zeros((n,), jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32)
    )


def sample_indices(
    key: jax.Array, valid: jnp.ndarray, num_samples: int, sample_size: int
) -> jnp.ndarray:
    """(B, S) indices drawn WITHOUT replacement from the valid entries of a
    fixed-size bank.

    Permutation-free trick: pack valid indices first (stable); draw
    distinct uniform [0, n_valid) positions (Floyd) into that packed list so
    no sample wastes its hypothesis on a duplicate-index degenerate model.
    """
    order = _pack_valid_first(valid)  # valid entries first, stable
    n_valid = jnp.sum(valid.astype(jnp.int32))
    u = jax.random.uniform(key, (num_samples, sample_size))
    pos = jax.vmap(lambda uu: _distinct_positions(uu, n_valid))(u)
    return order[pos]


def ransac(
    key: jax.Array,
    data: Tuple[jnp.ndarray, ...],
    valid: jnp.ndarray,
    solver: Callable,         # (sampled data...) -> (models, model_valid)
    scorer: Callable,         # (model, data...) -> (M,) squared residuals
    sample_size: int,
    num_hypotheses: int,
    threshold_sq: float,
    inlier_multiple: float = 2.5,
    scoring: str = "count",   # "count" (fixed threshold) | "nfa" (ACRANSAC)
    log_alpha0: float = 0.0,  # only for scoring="nfa"
    error_dim: float = 1.0,   # only for scoring="nfa"
    batch_scorer: Callable = None,  # optional (models (Hm,...), data...) ->
                                    # (Hm, M) residuals in one shot
    rank_scorer: Callable = None,   # optional CHEAP residuals used only for
                                    # the NFA candidate pre-rank ladder
) -> RansacResult:
    """Generic batched RANSAC.

    solver: takes per-sample gathered data (each (S, ...)) and returns
      (models, valid) where models is a pytree with leading axis H (candidate
      models per sample, H>=1) and valid is (H,) bool.
    scorer: takes one model pytree + full data, returns squared residuals (M,).
    batch_scorer: optional all-models scorer. vmap(scorer) evaluates each
      model's (M,) residuals independently — for projective/epipolar models
      that shape lowers to thousands of tiny K=3 contractions; a hand-
      batched formulation (one (M, 3) x (3, 3*Hm) matmul + elementwise
      epilogue) scores the full (Hm, M) matrix at once. Must agree with
      `scorer` closely enough that candidate RANKING is preserved — the
      quadratic-form scorers deviate up to ~2e-3 relative on LARGE
      (far-outlier) residuals (denominator cancellation; see their
      docstrings). All exact quantities (final inlier classification,
      adaptive thresholds via the winning model) always use `scorer`.
    rank_scorer: optional cheap (DEFAULT-precision matmul) all-models scorer used
      ONLY for the NFA pre-rank ladder. With it, the full-precision
      residual matrix is computed for just the top-`_NFA_CANDIDATES`
      models, so exact quantities (NFA scores, adaptive thresholds, inlier
      sets) never see the cheap arithmetic — it can only perturb WHICH
      models enter the top-32 (same approximation class as the ladder
      itself; the pre-rank property test pins winner stability).

    scoring="count" ranks models by inliers under the fixed threshold;
    scoring="nfa" ranks by a-contrario NFA with a per-model ADAPTIVE
    threshold and NO maximum admissible error (OpenMVG ACRANSAC parity —
    the reference passes infinite initial tolerances); under "nfa",
    `threshold_sq` only seeds the candidate pre-rank ladder.
    """
    M = valid.shape[0]
    idx = sample_indices(key, valid, num_hypotheses, sample_size)  # (B, S)

    gathered = tuple(jax.tree_util.tree_map(lambda a: a[idx], d) for d in data)
    models, model_valid = jax.vmap(solver)(*gathered)  # (B, H, ...), (B, H)

    flat_models = jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), models
    )
    flat_valid = model_valid.reshape(-1)  # (B*H,)

    def score_all(ms):
        if batch_scorer is not None:
            return batch_scorer(ms, *data)
        return jax.vmap(lambda m: scorer(m, *data))(ms)

    if scoring == "nfa":
        # max admissible threshold is INFINITE, matching the reference's
        # ACRANSAC calls (RelativePose_Info.initial_residual_tolerance and
        # Image_Localizer_Match_Data.error_max both default to infinity;
        # RobustMatcher.hpp:142,170,206) — the threshold is FULLY adaptive.
        #
        # Cost shape: the exact NFA curve needs each model's residuals fully
        # SORTED — (Hm, M) sorts dominate everything else at reference
        # capacity (Hm=1024, M=5000). Mirroring sequential
        # ACRANSAC's early rejection (it only evaluates the full NFA for
        # models that beat the incumbent), models are pre-ranked by cheap
        # threshold-ladder inlier counts and the exact NFA runs on the TOP
        # `_NFA_CANDIDATES` only. The winner among those is NFA-exact, but
        # the PRE-RANK is an approximation: a model excluded from the top-32
        # is never NFA-scored, so this deviates from sequential ACRANSAC iff
        # the true NFA winner ranks below 32 on the ladder counts
        # (tests/test_robust.py pins winner equality against exhaustive NFA
        # across seeds at reference capacity).
        rank_res = (
            rank_scorer(flat_models, *data) if rank_scorer is not None
            else score_all(flat_models)
        )                                                           # (Hm, M)
        rank = ladder_rank(rank_res, valid, threshold_sq)
        rank = jnp.where(flat_valid, rank, -1)
        k_nfa = min(_NFA_CANDIDATES, rank.shape[0])
        _, cand = jax.lax.top_k(rank, k_nfa)
        # exact (full-precision) residuals for the candidates only
        cand_models = jax.tree_util.tree_map(
            lambda a: a[cand], flat_models
        )
        cand_res = (
            score_all(cand_models) if rank_scorer is not None
            else rank_res[cand]
        )
        score, thr = nfa_scores(
            cand_res, valid, sample_size, log_alpha0, error_dim,
        )
        score = jnp.where(flat_valid[cand], score, jnp.inf)
        best_sub = jnp.argmin(score)
        best = cand[best_sub]
        best_model = jax.tree_util.tree_map(lambda a: a[best], flat_models)
        res = scorer(best_model, *data)
        inliers = (res <= thr[best_sub]) & valid
        n_inl = jnp.sum(inliers.astype(jnp.int32))
        meaningful = score[best_sub] < 0.0  # NFA < 1
        success = meaningful & (n_inl >= jnp.int32(inlier_multiple * sample_size))
        return RansacResult(
            model=best_model, inliers=inliers, n_inliers=n_inl,
            success=success, threshold_sq=thr[best_sub].astype(jnp.float32),
        )

    all_res = score_all(flat_models)  # (Hm, M)
    counts = jnp.sum(
        ((all_res < threshold_sq) & valid[None, :]).astype(jnp.int32), axis=1
    )
    counts = jnp.where(flat_valid, counts, -1)
    best = jnp.argmax(counts)

    best_model = jax.tree_util.tree_map(lambda a: a[best], flat_models)
    res = scorer(best_model, *data)
    inliers = (res < threshold_sq) & valid
    n_inl = jnp.sum(inliers.astype(jnp.int32))
    success = n_inl >= jnp.int32(inlier_multiple * sample_size)
    return RansacResult(
        model=best_model, inliers=inliers, n_inliers=n_inl, success=success,
        threshold_sq=jnp.float32(threshold_sq),
    )
