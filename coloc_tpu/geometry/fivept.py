"""Batched Nistér 5-point essential-matrix solver.

Reference parity: OpenMVG's FivePointSolver inside the ACRANSAC essential
kernel (RobustMatcher.hpp:161-171). The 5-point solver matters beyond parity:
the 8-point linear solver degenerates when the scene is plane-dominant (all
points coplanar satisfy a 2-parameter family of E), which is the common case
for downward/forward-facing MAV cameras — exactly this framework's workload.

Batched formulation (no data-dependent branching, no nonsymmetric eig):
  1. Null space of the 5x9 epipolar design matrix via SVD -> basis X,Y,Z,W;
     E = x X + y Y + z Z + W.
  2. The 10 cubic constraints (det E = 0 and 2 E E^T E - tr(E E^T) E = 0)
     are expanded at TRACE TIME with exact polynomial bookkeeping (the
    `_Poly` helper below) into the 10x20 coefficient matrix over Nistér's
     monomial order — no hand-derived coefficient tables.
  3. Gauss-Jordan reduction = one 10x10 linear solve.
  4. Nistér's <k>,<l>,<m> row combinations give a 3x3 matrix in z whose
     determinant is the degree-10 polynomial; roots via fixed-iteration
     Durand-Kerner (complex64) + Newton polish, as in geometry/p3p.py.
  5. Each real root -> (x, y) by a 2x2 solve -> Gauss-Newton polish on the
     10 constraints, seeded from the root and two 1%-split copies (near-
     double roots hold two genuine solutions DK merges). Up to 30 candidates
     per sample, masked by a validity flag for the RANSAC harness.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


class _Poly:
    """Trace-time polynomial in (x, y, z): dict[(i,j,k)] -> jnp scalar."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})

    @staticmethod
    def const(c):
        return _Poly({(0, 0, 0): c})

    def __add__(self, other):
        out = dict(self.terms)
        for m, c in other.terms.items():
            out[m] = out[m] + c if m in out else c
        return _Poly(out)

    def __sub__(self, other):
        out = dict(self.terms)
        for m, c in other.terms.items():
            out[m] = out[m] - c if m in out else -c
        return _Poly(out)

    def __mul__(self, other):
        out = {}
        for m1, c1 in self.terms.items():
            for m2, c2 in other.terms.items():
                m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
                prod = c1 * c2
                out[m] = out[m] + prod if m in out else prod
        return _Poly(out)

    def coeff(self, m):
        return self.terms.get(m, jnp.float32(0.0))


# Nistér's monomial order for the 10x20 constraint matrix
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1), (2, 0, 0),
    (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]

_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}


def _diff_mats():
    """Constant (3, 20, 20) differentiation matrices over the monomial
    basis: (D[a] @ mono)[k] = d mono_k / d var_a.

    The 20 Nistér monomials are exactly ALL monomials of total degree <= 3
    in (x, y, z) (C(6,3) = 20), so the basis is closed under d/dx, d/dy,
    d/dz — each partial of a basis monomial is an integer multiple of
    another basis monomial. This turns the GN polish Jacobian into a
    PRECOMPUTABLE matrix product: J_a = (M @ D[a]) @ mono, removing all
    per-seed gradient arithmetic from the polish loop."""
    import numpy as np

    D = np.zeros((3, 20, 20), np.float32)
    for k, exps in enumerate(_MONOMIALS):
        for a in range(3):
            if exps[a] > 0:
                red = list(exps)
                red[a] -= 1
                D[a, k, _MONO_INDEX[tuple(red)]] = float(exps[a])
    return jnp.asarray(D)


_DIFF_MATS = _diff_mats()


def _null_basis(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """(5,2),(5,2) normalized coords -> (4, 3, 3) null-space basis of A."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    one = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], axis=-1
    )  # (5, 9)
    # null space via complete QR of A^T: the trailing 4 columns of Q are
    # orthogonal to range(A^T) = row space of A. Cheaper than batched tiny
    # SVDs, same f32 accuracy
    # under the library-wide HIGHEST matmul precision. Near-double roots of
    # the reduced polynomial cluster differently in this parametrization;
    # the split-seed polish below recovers both members of such pairs.
    q, _ = jnp.linalg.qr(A.T, mode="complete")  # (9, 9)
    return q[:, 5:9].T.reshape(4, 3, 3)


def _constraint_rows(X, Y, Z, W):
    """Trace-time cubic-constraint expansion over ANY scalar-like values.

    X/Y/Z/W: indexable [r][c] (or array (3,3)) null-basis matrices whose
    entries are jnp scalars or equally shaped arrays. Returns a 10 x 20
    nested list of coefficient values over `_MONOMIALS`."""
    # E entries as degree-1 polynomials
    E = [[None] * 3 for _ in range(3)]
    for r in range(3):
        for c in range(3):
            E[r][c] = _Poly({
                (1, 0, 0): X[r][c],
                (0, 1, 0): Y[r][c],
                (0, 0, 1): Z[r][c],
                (0, 0, 0): W[r][c],
            })

    def matmul(A, B):
        return [
            [sum((A[r][k] * B[k][c] for k in range(3)), _Poly())
             for c in range(3)]
            for r in range(3)
        ]

    Et = [[E[c][r] for c in range(3)] for r in range(3)]
    EEt = matmul(E, Et)
    EEtE = matmul(EEt, E)
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]

    eqs = []
    # det(E) = 0
    det = (
        E[0][0] * (E[1][1] * E[2][2] - E[1][2] * E[2][1])
        - E[0][1] * (E[1][0] * E[2][2] - E[1][2] * E[2][0])
        + E[0][2] * (E[1][0] * E[2][1] - E[1][1] * E[2][0])
    )
    eqs.append(det)
    # 2 E E^T E - tr(E E^T) E = 0, nine entries
    two = _Poly.const(jnp.float32(2.0))
    for r in range(3):
        for c in range(3):
            eqs.append(two * EEtE[r][c] - trace * E[r][c])

    return [[eq.coeff(m) for m in _MONOMIALS] for eq in eqs]


def _constraint_matrix(basis: jnp.ndarray) -> jnp.ndarray:
    """(4,3,3) basis -> (10, 20) cubic-constraint coefficient matrix."""
    rows = _constraint_rows(basis[0], basis[1], basis[2], basis[3])
    return jnp.stack([jnp.stack(r) for r in rows])  # (10, 20)


def _det3_polys(P, Q, R):
    """det of [[P0,Q0,R0],[P1,Q1,R1],[P2,Q2,R2]] where P,Q are (3, dP) and R
    (3, dR) ascending z-polynomials -> (11,) degree-10 polynomial."""

    def pmul(a, b):
        n = a.shape[0] + b.shape[0] - 1
        out = jnp.zeros(n)
        for i in range(a.shape[0]):
            out = out.at[i : i + b.shape[0]].add(a[i] * b)
        return out

    def psub(a, b):
        n = max(a.shape[0], b.shape[0])
        return (
            jnp.pad(a, (0, n - a.shape[0])) - jnp.pad(b, (0, n - b.shape[0]))
        )

    m01 = psub(pmul(Q[1], R[2]), pmul(Q[2], R[1]))
    m11 = psub(pmul(P[1], R[2]), pmul(P[2], R[1]))
    m21 = psub(pmul(P[1], Q[2]), pmul(P[2], Q[1]))
    det = psub(psub(pmul(P[0], m01), pmul(Q[0], m11)), pmul(R[0], m21) * -1.0)
    # det = P0*(Q1R2-Q2R1) - Q0*(P1R2-P2R1) + R0*(P1Q2-P2Q1)
    return jnp.pad(det, (0, 11 - det.shape[0]))


def _durand_kerner(coeffs: jnp.ndarray, degree: int = 10, iters: int = 24):
    """Roots of ascending-coefficient polynomial; returns (roots, is_real).

    Iteration budget: each DK step is ~150 tiny vector ops inside a
    sequential fori_loop, so the budget is a direct latency knob. A 200-problem sweep (16/24/32/40/60 iters) showed BIT-
    IDENTICAL downstream E-recovery at every setting: the split-seed GN
    polish, not DK precision, determines which solutions are captured. 24
    keeps a 1.5x margin over the lowest tested setting."""
    lead = coeffs[degree]
    lead = jnp.where(jnp.abs(lead) < 1e-12, 1e-12, lead)
    c = coeffs / lead  # monic, ascending

    # Variable rescaling z = s*w so roots sit at O(1): without it, samples
    # with |c_k| >> 1 put the Cauchy bound (and hence the DK start circle)
    # thousands of units out and 120 iterations never converge.
    k = jnp.arange(degree)
    mag = jnp.maximum(jnp.abs(c[:degree]), 1e-30)
    s = jnp.max(mag ** (1.0 / (degree - k)))
    s = jnp.clip(s, 1e-3, 1e6)
    c = c * jnp.exp(
        (jnp.arange(degree + 1).astype(jnp.float32) - degree) * jnp.log(s)
    )

    def poly(z):
        acc = jnp.full_like(z, c[degree])
        for i in range(degree - 1, -1, -1):
            acc = acc * z + c[i]
        return acc

    seed = jnp.asarray(0.4 + 0.9j, jnp.result_type(jnp.complex64, coeffs.dtype))
    z0 = seed ** jnp.arange(1, degree + 1)

    def body(_, z):
        pz = poly(z)
        diff = z[:, None] - z[None, :]
        diff = jnp.where(jnp.eye(degree, dtype=bool), 1.0 + 0.0j, diff)
        denom = jnp.prod(diff, axis=1)
        return z - pz / (denom + 1e-20)

    z = jax.lax.fori_loop(0, iters, body, z0)

    def dpoly_real(x):
        acc = jnp.full_like(x, degree * jnp.real(c[degree]))
        for i in range(degree - 1, 0, -1):
            acc = acc * x + i * jnp.real(c[i])
        return acc

    x = jnp.real(z)
    for _ in range(3):
        x = x - jnp.real(poly(x.astype(jnp.result_type(jnp.complex64, x.dtype)))) / (
            dpoly_real(x) + 1e-12
        )
    # Very loose realness gate: in f32, Durand-Kerner may leave sizeable
    # imaginary parts even on genuine real roots (clustered-root stalls); the
    # per-root Gauss-Newton polish downstream recovers true solutions from
    # the real part, and spurious candidates are cheap — the RANSAC scorer
    # votes them out. Gate only filters clearly-complex roots and NaNs.
    is_real = jnp.abs(jnp.imag(z)) < 0.5 * (jnp.abs(jnp.real(z)) + 1.0)
    is_real = is_real & jnp.isfinite(x)
    return x * s, is_real  # undo the variable rescaling


def _gj_tail(M: jnp.ndarray) -> jnp.ndarray:
    """(10, 20) constraint matrix -> (10, 10) tail of the Gauss-Jordan
    reduction, i.e. A10^{-1} B10.

    Hand-rolled GJ with partial pivoting instead of jnp.linalg.solve: ten
    elimination steps of elementwise ops vmap cleanly, where a batched
    10x10 LU is a sequence of small dispatches. Row swaps are
    expressed as one-hot blends (no dynamic row gathers under vmap)."""
    Mw = M.at[:, :10].add(1e-10 * jnp.eye(10))  # same mild regularization
    iota = jnp.arange(10)
    for k in range(10):
        # partial pivot among rows k..9 on column k
        cand = jnp.where(iota >= k, jnp.abs(Mw[:, k]), -1.0)
        onep = (iota == jnp.argmax(cand)).astype(Mw.dtype)      # (10,)
        onek = (iota == k).astype(Mw.dtype)
        rp = onep @ Mw                                          # (20,)
        rk = Mw[k]
        # swap rows k <-> p (cancels when p == k)
        Mw = Mw + onek[:, None] * (rp - rk) + onep[:, None] * (rk - rp)
        piv = rp[k] + onep[k] * (rk[k] - rp[k])
        piv = jnp.where(jnp.abs(piv) < 1e-20, 1e-20, piv)
        rowk = Mw[k] / piv
        # eliminate column k from every other row, set row k to the pivot row
        Mw = Mw - Mw[:, k : k + 1] * rowk[None, :]
        Mw = Mw + onek[:, None] * rowk[None, :]
    return Mw[:, 10:]


def _reduced_front(x1: jnp.ndarray, x2: jnp.ndarray):
    """Shared trace: minimal sample -> everything the polish needs.

    Returns (basis (4,3,3), M (10,20), MD (40,20), polys, n_poly (11,))
    where polys = (Pk, Qk, Pl, Ql, Pm, Qm, Rk, Rl, Rm) are
    the ascending z-polynomials of Nistér's <k>,<l>,<m> reduced equations
    (P, Q deg-3 -> 4 coeffs; R deg-4 -> 5 coeffs) and MD stacks the
    constraint matrix with its three differentiation products
    (rows 0:10 = M, rows 10+10a:20+10a = M @ D_a)."""
    basis = _null_basis(x1, x2)
    M = _constraint_matrix(basis)  # (10, 20)

    # Gauss-Jordan tail over monomials [xz2,xz,x,yz2,yz,y,z3,z2,z,1]
    tail = _gj_tail(M)  # (10, 10)

    def row_polys(r):
        # ascending z-polynomials for x, y, const parts of `x P + y Q + R`
        P = jnp.stack([r[2], r[1], r[0]])          # x: [x, xz, xz^2]
        Q = jnp.stack([r[5], r[4], r[3]])          # y
        R = jnp.stack([r[9], r[8], r[7], r[6]])    # 1: [1, z, z^2, z^3]
        return P, Q, R

    def combine(ra, rb):
        """<k> = eq(ra) - z * eq(rb): returns deg-3 P,Q and deg-4 R."""
        Pa, Qa, Ra = row_polys(ra)
        Pb, Qb, Rb = row_polys(rb)
        P = jnp.pad(Pa, (0, 1)) - jnp.concatenate([jnp.zeros(1), Pb])
        Q = jnp.pad(Qa, (0, 1)) - jnp.concatenate([jnp.zeros(1), Qb])
        R = jnp.pad(Ra, (0, 1)) - jnp.concatenate([jnp.zeros(1), Rb])
        return P, Q, R

    Pk, Qk, Rk = combine(tail[4], tail[5])
    Pl, Ql, Rl = combine(tail[6], tail[7])
    Pm, Qm, Rm = combine(tail[8], tail[9])

    n_poly = _det3_polys(
        (Pk, Pl, Pm), (Qk, Ql, Qm), (Rk, Rl, Rm)
    )  # (11,) ascending

    # residual + Jacobian of the 10 constraints from ONE (40, 20) @ (20,)
    # product per GN step: rows 0:10 = r, rows 10+10a:20+10a = dr/dvar_a
    MD = jnp.concatenate(
        [M] + [M @ _DIFF_MATS[a] for a in range(3)], axis=0
    )  # (40, 20), computed once per minimal sample
    polys = (Pk, Qk, Pl, Ql, Pm, Qm, Rk, Rl, Rm)
    return basis, M, MD, polys, n_poly


def _reduced_system(x1: jnp.ndarray, x2: jnp.ndarray):
    """_reduced_front + Durand-Kerner roots (XLA root-finding; the Pallas
    batch path swaps in the _dk_kernel instead)."""
    basis, M, MD, polys, n_poly = _reduced_front(x1, x2)
    roots, is_real = _durand_kerner(n_poly)  # (10,), (10,)
    return basis, M, MD, polys, roots, is_real


def five_point(
    x1: jnp.ndarray, x2: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """5 correspondences (5,2)+(5,2) -> (30, 3, 3) E candidates + (30,)
    valid (10 polynomial roots x 3 split seeds; see the split-seed note
    below)."""
    basis, M, MD, polys, roots, is_real = _reduced_system(x1, x2)
    Pk, Qk, Pl, Ql, Pm, Qm, Rk, Rl, Rm = polys

    def monomials(xyz):
        """All 20 monomials from cached power chains — no pow ops.
        Gradients come from the constant differentiation matrices
        (`_DIFF_MATS`), so the polish loop needs no per-seed gradient
        arithmetic at all."""
        x, y, z = xyz[0], xyz[1], xyz[2]
        one = jnp.ones_like(x)
        px = [one, x, x * x, x * x * x]
        py = [one, y, y * y, y * y * y]
        pz = [one, z, z * z, z * z * z]
        return jnp.stack(
            [px[i] * py[j] * pz[k] for (i, j, k) in _MONOMIALS]
        )  # (20,)

    def solve3(A, b):
        """Closed-form 3x3 solve (adjugate) — avoids batched LU dispatch."""
        c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
        c01 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
        c02 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
        det = A[0, 0] * c00 + A[0, 1] * c01 + A[0, 2] * c02
        det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
        adj = jnp.array([
            [c00,
             A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2],
             A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]],
            [c01,
             A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0],
             A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]],
            [c02,
             A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1],
             A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]],
        ])
        return adj @ b / det

    def e_from_root(z):
        def ev(p):
            acc = p[-1]
            for i in range(p.shape[0] - 2, -1, -1):
                acc = acc * z + p[i]
            return acc

        # solve for (x, y) via least squares over all three reduced
        # equations (closed-form 2x2 normal solve)
        Amat = jnp.array(
            [[ev(Pk), ev(Qk)], [ev(Pl), ev(Ql)], [ev(Pm), ev(Qm)]]
        )
        bvec = -jnp.array([ev(Rk), ev(Rl), ev(Rm)])
        AtA = Amat.T @ Amat + 1e-12 * jnp.eye(2)
        Atb = Amat.T @ bvec
        det2 = AtA[0, 0] * AtA[1, 1] - AtA[0, 1] * AtA[1, 0]
        det2 = jnp.where(jnp.abs(det2) < 1e-20, 1e-20, det2)
        xy = jnp.array([
            (AtA[1, 1] * Atb[0] - AtA[0, 1] * Atb[1]) / det2,
            (AtA[0, 0] * Atb[1] - AtA[1, 0] * Atb[0]) / det2,
        ])
        xyz = jnp.array([xy[0], xy[1], z])

        # Gauss-Newton polish of (x, y, z) on the original 10 constraints —
        # recovers the accuracy the f32 GJ reduction + root-finding lost.
        # Iteration budget: the polish is the solver's latency long pole
        # (sequential fusions over (H*30,) elements), so iterations are a
        # direct knob. Measured over 400 mixed general/planar minimal sets:
        # best held-out residual > 1e-4 on 10/400 samples at 3 iters vs
        # 8/400 at 4 iters (median 2e-13 both) — the 256-hypothesis RANSAC
        # consensus absorbs the delta, and the convergence certificate
        # below masks (never mis-scores) the unconverged candidates.
        for _ in range(3):
            rj = jnp.sum(MD * monomials(xyz)[None, :], axis=-1)  # (40,)
            r = rj[:10]                   # (10,)
            J = rj[10:].reshape(3, 10).T  # (10, 3)
            JtJ = J.T @ J + 1e-9 * jnp.eye(3)
            # closed-form adjugate solve instead of a batched 3x3 LU
            # (near-double-root robustness comes from the split seeds, not
            # solver precision)
            xyz = xyz - solve3(JtJ, J.T @ r)

        E = (
            xyz[0] * basis[0] + xyz[1] * basis[1] + xyz[2] * basis[2] + basis[3]
        )
        norm = jnp.linalg.norm(E)
        # convergence certificate: the closed-form 3x3 solve can blow up on a
        # (near-)singular JtJ (f32 adjugate/det), leaving an unconverged xyz
        # whose E is arbitrary — such a candidate can score as a universal
        # 'inlier magnet'. Scale-normalized constraint residual
        # must be tiny for a genuinely solved candidate.
        r_fin = jnp.sum(M * monomials(xyz)[None, :], axis=-1)
        scale = 1.0 + jnp.sum(xyz * xyz) ** 1.5
        converged = (
            jnp.all(jnp.isfinite(xyz))
            & (jnp.max(jnp.abs(r_fin)) < 1e-3 * scale)
        )
        return E / jnp.where(norm < 1e-12, 1e-12, norm), converged

    # SPLIT SEEDS: when two roots of the degree-10 polynomial nearly
    # coincide (two genuine E solutions close in this basis's z-coordinate),
    # Durand-Kerner returns a merged cluster point and a single polish basin
    # would LOSE one of the twin solutions (held-out residual ~3e-4 instead
    # of ~1e-12). Polishing from z and z +- 1% splits the basins; spurious
    # extra candidates are cheap — the RANSAC scorer votes them out.
    delta = 0.01 * (jnp.abs(roots) + 1.0)
    seeds = jnp.concatenate([roots, roots + delta, roots - delta])
    Es, converged = jax.vmap(e_from_root)(seeds)  # (30, 3, 3), (30,)
    return Es, jnp.tile(is_real, 3) & converged
