"""The Rančić conformal map of the cubed sphere, computed from first
principles (numpy only).

Counterpart of ``oceananigans_tpu/grids/conformal_map.py``: the conformal
map of Rančić, Purser & Mesinger (1996, QJRMS 122, "A global shallow-water
model using an expanded spherical cube"). A cube vertex V is put at the
north pole; with the stereographic coordinate ẑ from V and the planar
coordinate w of the face's development,

    Z := ẑ³        (one turn around V covers the 3 faces)
    W := (w/2)⁴    (each square corner π/2 opens to 2π)

the map is an analytic W ↦ Z(W) = Σₖ Cₖ Wᵏ with real Cₖ. The coefficients
are fitted (damped Gauss-Newton on a collocation) to the two symmetry
involutions of the face, the 180° rotations about an edge midpoint
(w ↦ 2 − w) and about the face centre (w ↦ (2 + 2i) − w), with the anchors
ẑ(1 + i) = the face centre and ẑ(1) = 1. Every face point is folded to the
quadrant nearest its reference corner, so the series is evaluated at
|W| ≤ 1/4, where 30 terms leave about 1e-18. ``rancic_published_A`` turns
the fit into the normalisation of the paper's Table B1 (A₁ =
1.47713062600964, A₂ = −0.38183510510174, A₃ = −0.05573058001191, ...),
which the tests hold.
"""

from __future__ import annotations

import numpy as np

_SQ3 = 1.0 / np.sqrt(3.0)

# canonical (+x) face, matching panel_corner_coordinates: in-face x → sphere
# Y, in-face y → sphere Z; corner (1,1) at the vertex (1,1,1)/√3
_V0 = np.array([1.0, 1.0, 1.0]) * _SQ3      # vertex (corner (1,1))
_V1 = np.array([1.0, 1.0, -1.0]) * _SQ3     # along the x=1 edge (w real)
_V2 = np.array([1.0, -1.0, 1.0]) * _SQ3     # along the y=1 edge (w = i side)


def _vertex_frame():
    """Rotation R with R·V0 = ẑ-pole and the V0→V1 edge midpoint at
    positive-real stereographic azimuth."""
    m = _V0 + _V1
    m = m / np.linalg.norm(m)
    e3 = _V0
    e1 = m - (m @ e3) * e3
    e1 = e1 / np.linalg.norm(e1)
    # e2 = e1 × e3 (NOT e3 × e1): the planar development w = (1−y)+i(1−x)
    # walks the two face edges counterclockwise (v1-edge at azimuth 0,
    # v2-edge at +2π/3), so the stereographic frame must match that
    # handedness for w ↦ z to be analytic rather than anti-analytic
    e2 = np.cross(e1, e3)
    R = np.stack([e1, e2, e3])
    return R, m


def _stereo(p):
    """South-pole stereographic projection of rotated-frame points
    (..., 3) → complex; the north pole (the vertex) maps to 0."""
    return (p[..., 0] + 1j * p[..., 1]) / (1.0 + p[..., 2])


def _unstereo(z):
    """Inverse stereographic projection → rotated-frame unit vectors."""
    x, y = np.real(z), np.imag(z)
    r2 = x * x + y * y
    d = 1.0 + r2
    return np.stack([2 * x / d, 2 * y / d, (1.0 - r2) / d], axis=-1)


def _z_edge_mid(R):
    m = _V0 + _V1
    m = m / np.linalg.norm(m)
    return np.real(_stereo(R @ m))


def _eval_zhat(C, w):
    """ẑ(w) = (w/2)^{4/3} · (Σₖ Cₖ W^{k−1})^{1/3},  W = (w/2)⁴ — branch-safe
    for arg w ∈ [0, π/2] (the C-polynomial part stays in the right
    half-plane over the face)."""
    wh = np.asarray(w) / 2.0
    W = wh ** 4
    q = np.zeros_like(W)
    for ck in C[::-1]:
        q = q * W + ck
    r = np.abs(wh)
    th = np.angle(wh)
    w43 = np.where(r == 0, 0.0, r ** (4.0 / 3.0) * np.exp(1j * 4.0 * th / 3.0))
    return w43 * q ** (1.0 / 3.0)


def fit_rancic_coefficients(K=30, n_col=48):
    """Least-squares collocation fit of C₁..C_K (float64, ~seconds) by
    damped Gauss-Newton (the module docstring lists the conditions).
    Multiple collocation radii reach |W| ≈ 0.8 so the series tail is
    genuinely constrained; a mild ridge removes the remaining null space."""
    R, m = _vertex_frame()
    ze = _z_edge_mid(R)
    M_edge = R @ (2.0 * np.outer(m, m) - np.eye(3)) @ R.T
    c = np.array([1.0, 0.0, 0.0])              # +x face centre
    M_cent = R @ (2.0 * np.outer(c, c) - np.eye(3)) @ R.T
    p_cent = R @ c

    phis = np.linspace(0.0, 2 * np.pi, n_col, endpoint=False) + 0.03
    wes = []
    for rho_e in (0.3, 0.6, 0.9):
        we = 1.0 + rho_e * np.exp(1j * phis)
        wes.append(np.where(np.angle(we) < 0, np.conj(we), we))
    we = np.concatenate(wes)
    wcs = []
    for rho_c in (0.2, 0.35, 0.5):
        wcs.append((1.0 + 1j) + rho_c * np.exp(1j * phis))
    wc = np.concatenate(wcs)

    ridge = 1e-7 * (np.arange(1, K + 1) / K) ** 4

    def resid(C):
        out = []
        p1 = _unstereo(_eval_zhat(C, 2.0 - we) * ze)
        p2 = _unstereo(_eval_zhat(C, we) * ze) @ M_edge.T
        out.append((p1 - p2).ravel())
        q1 = _unstereo(_eval_zhat(C, (2.0 + 2j) - wc) * ze)
        q2 = _unstereo(_eval_zhat(C, wc) * ze) @ M_cent.T
        out.append((q1 - q2).ravel())
        pc = _unstereo(np.asarray(_eval_zhat(C, np.array(1.0 + 1j)) * ze))
        out.append(10.0 * (pc - p_cent).ravel())
        zm = _eval_zhat(C, np.array(1.0 + 0j))
        out.append(10.0 * np.array([np.real(zm) - 1.0, np.imag(zm)]))
        out.append(ridge * C)
        return np.concatenate(out)

    C = np.zeros(K)
    C[0] = 11.0        # ≈ Z(vertex): ẑ(2) ~ 2.22, Z ~ 11
    r = resid(C)
    cost = r @ r
    lam = 1e-3
    for _ in range(400):
        J = np.empty((r.size, K))
        h = 1e-7
        for j in range(K):
            Cp = C.copy(); Cp[j] += h
            Cm = C.copy(); Cm[j] -= h
            J[:, j] = (resid(Cp) - resid(Cm)) / (2 * h)
        JTJ = J.T @ J
        g = J.T @ r
        improved = False
        for _ in range(60):
            dC = np.linalg.solve(JTJ + lam * np.diag(np.diag(JTJ) + 1e-12),
                                 -g)
            r2 = resid(C + dC)
            c2 = r2 @ r2
            if c2 < cost:
                C, r, cost = C + dC, r2, c2
                lam = max(lam * 0.3, 1e-14)
                improved = True
                break
            lam *= 10.0
        if not improved or cost < 1e-26:
            break
    return C


def _zeta_vertex():
    """Z at the adjacent vertex, from exact geometry: ζ = (z_v1/z_e)³ with
    z_v1 = tan(θ/2), cos θ = V0·V1 = 1/3."""
    z_v1 = np.tan(0.5 * np.arccos(1.0 / 3.0))
    R, _ = _vertex_frame()
    return float((z_v1 / _z_edge_mid(R)) ** 3)


def rancic_published_A(C):
    """Rancic's Table-B1 A-series from the fitted Cₖ.  Their expansion
    writes the PLANE variable as a series in the normalised SPHERE variable
    Z_t = Z/ζ (ζ = Z at the adjacent vertex, so Z_t = 1 there): comparing
    normalisations termwise gives simply Aₖ = Cₖ/ζ (A₁ ≈ 1.47713,
    Σ Aₖ = 1).  The Bₖ of their inverse series follow by reversion."""
    zeta = _zeta_vertex()
    A = np.asarray(C) / zeta
    return A, _invert_series(A)


def _invert_series(B):
    """Aₖ of the inverse series W(Z) = Σ Aₖ Zᵏ from Z(W) = Σ Bₖ Wᵏ, by
    truncated Newton iteration on series composition."""
    K = len(B)
    A = np.zeros(K)
    A[0] = 1.0 / B[0]

    def compose(Cs, Ds):
        # coefficients of Cs(Ds(W)) truncated to K terms; index a ↔ W^{a+1}
        out = np.zeros(K)
        P = Ds.copy()
        for j in range(1, K + 1):
            out += Cs[j - 1] * P
            if j < K:
                newP = np.zeros(K)
                for a in range(K):
                    if P[a] == 0.0:
                        continue
                    hi = K - (a + 1)
                    if hi > 0:
                        newP[a + 1:a + 1 + hi] += P[a] * Ds[:hi]
                P = newP
        return out

    for _ in range(80):
        comp = compose(A, B)
        err = -comp
        err[0] += 1.0
        if np.max(np.abs(err)) < 1e-15:
            break
        A = A + compose(err, A)
    return A


_C_CACHE = {}
_NODE_CACHE = {}


def rancic_C(K=30):
    if K not in _C_CACHE:
        _C_CACHE[K] = fit_rancic_coefficients(K)
    return _C_CACHE[K]


def conformal_face_nodes(N, K=30):
    """(N+1, N+1, 3) unit-vector nodes of the canonical (+x) conformal
    face at uniform square coordinates.  Every node is folded (by the face's
    reflection symmetries) to the quadrant nearest the reference corner, so
    the series is only ever evaluated at |W| ≤ 1/4."""
    C = rancic_C(K)
    R, _ = _vertex_frame()
    ze = _z_edge_mid(R)
    xs = np.linspace(-1.0, 1.0, N + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    sx = np.where(X < 0, -1.0, 1.0)
    sy = np.where(Y < 0, -1.0, 1.0)
    Xa, Ya = np.abs(X), np.abs(Y)
    w = (1.0 - Ya) + 1j * (1.0 - Xa)
    p = _unstereo(_eval_zhat(C, w) * ze)       # rotated frame
    q = p @ R                                  # = Rᵀ rows: world frame
    # undo the sign folds: face-x ↔ sphere Y, face-y ↔ sphere Z
    out = np.stack([q[..., 0], sx * q[..., 1], sy * q[..., 2]], axis=-1)
    out = out / np.linalg.norm(out, axis=-1, keepdims=True)
    return out


def conformal_cubed_sphere_nodes(N, K=30):
    """Per-panel (N+1, N+1, 3) node arrays of the Rancic conformal cubed
    sphere (panel order/rotations as PANEL_ROTATIONS)."""
    if N in _NODE_CACHE:
        return _NODE_CACHE[N]
    from .cubed_sphere import PANEL_ROTATIONS
    face = conformal_face_nodes(N, K)
    nodes = [np.ascontiguousarray(face @ Rp.T) for Rp in PANEL_ROTATIONS]
    _NODE_CACHE[N] = nodes
    return nodes
