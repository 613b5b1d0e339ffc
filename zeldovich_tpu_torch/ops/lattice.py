"""PLT eigenmode tables: the dynamical matrix of the gravitating lattice, in torch.

Port of ``zeldovich_tpu/ops/lattice.py`` (numpy + scipy on the host): the
same tables, computed in float64 with torch ops on the device of the k
vectors, the card by default.  ``generate_eigmodes_table`` works through a
group of kx planes at a time and copies each into a host float64 array, so
the whole table is never on the device.

Physics (Marcos et al. 2006; Garrison et al. 2016): particles on a simple
cubic lattice (spacing 1, unit mass, uniform neutralizing background)
perturbed by a plane wave ``u(R) = eps exp(ik.R)`` feel a linearized force
``F = D(k) eps`` with the dynamical matrix

    D_ab(k) = G sum_{R != 0} t_ab(R) (exp(ik.R) - 1),
    t_ab(R) = -d_a d_b (1/R)  (the tidal tensor of a unit point mass)

The conditionally-convergent sum is evaluated with an Ewald split
``1/r = erfc(ar)/r + erf(ar)/r``:

    D(k)/G = sum_{0<|R|<=rc} s(R) (exp(ik.R) - 1)                (real space)
           + sum_K  g(k+K)  -  sum_{K != 0} g(K)                 (reciprocal)

    s_ab(R) = -d_a d_b erfc(aR)/R
    g_ab(q) = 4 pi (q_a q_b / q^2) exp(-q^2 / 4 a^2)

with the divergent K=0 term of the second reciprocal sum dropped (the
uniform-background subtraction).  Eigenvalues are normalized by
``4 pi G rho_bar`` so the continuum longitudinal limit is eps = 1; the
Kohn sum rule ``tr eps(k) = 1`` holds for every k != 0.

For each k the table stores the growing mode: the eigenvector most aligned
with k_hat (sign-fixed so e.k_hat >= 0) and its eigenvalue, in the
reference loader's layout (ops/plt.py): [ix, iy, iz in 0..N/2] with x/y
indices in FFT wrap order and the +kz half-space.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
#: float64 elements of one (k-points, K vectors) temporary of the Ewald sum:
#: the JAX module's chunk on the host, 1 GiB on the card
_CHUNK_ELEMS_CPU, _CHUNK_ELEMS_CARD = 2**22, 2**27
#: k-points of the kx planes the generator hands the device at once
_GROUP_KPOINTS = 2**20
#: 3x3 matrices a torch.linalg.eigh call takes: the batched cuSOLVER solver
#: behind it on the card refuses 32768 and more (CUSOLVER_STATUS_INVALID_VALUE;
#: torch 2.11, CUDA 12.8)
_EIGH_BATCH = 2**14


def _real_space_tensor(alpha: float, rcut: float, device):
    """Lattice vectors R (0 < |R| <= rcut) and s_ab(R), the erfc-damped
    tidal tensor: s_ab = -d_a d_b [erfc(a r)/r].

    d_a d_b f(r) = (f''/r^2 - f'/r^3) r_a r_b + (f'/r) delta_ab  for radial f.
    With f = erfc(ar)/r:
        f'  = -erfc(ar)/r^2 - (2a/sqrt(pi)) exp(-a^2 r^2)/r
        f'' = 2 erfc(ar)/r^3 + (2a/sqrt(pi)) exp(-a^2 r^2) (2/r^2 + 2 a^2)
    """
    n = int(math.floor(rcut))
    g = torch.arange(-n, n + 1, device=device)
    R = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)
    r2 = (R**2).sum(1)
    keep = (r2 > 0) & (r2 <= rcut**2)
    R = R[keep].to(F64)
    r = torch.sqrt(r2[keep].to(F64))

    pref = 2 * alpha / math.sqrt(math.pi) * torch.exp(-(alpha**2) * r * r)
    erfc = torch.special.erfc(alpha * r)
    f1 = -erfc / r**2 - pref / r
    f2 = 2 * erfc / r**3 + pref * (2 / r**2 + 2 * alpha**2)

    rr = R[:, :, None] * R[:, None, :] / (r**2)[:, None, None]
    eye = torch.eye(3, dtype=F64, device=device)[None]
    # s_ab = -[ (f2 - f1/r) rhat_a rhat_b + (f1/r) delta_ab ]
    s = -((f2 - f1 / r)[:, None, None] * rr + (f1 / r)[:, None, None] * eye)
    return R, s


def _recip_space_tensor(alpha: float, mcut: int, device):
    """Reciprocal vectors K = 2 pi m (|m| <= mcut)."""
    g = torch.arange(-mcut, mcut + 1, device=device)
    M = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), dim=-1).reshape(-1, 3)
    return 2 * math.pi * M.to(F64)


def _g_tensor(q):
    """q_a q_b / q^2 (0 at q = 0); the caller applies 4 pi and the
    Gaussian factor (it needs alpha)."""
    q2 = (q**2).sum(-1)
    q2s = torch.where(q2 == 0, 1.0, q2)
    return q[..., :, None] * q[..., None, :] / q2s[..., None, None]


def dynamical_matrix(kvecs, alpha: float = 2.0, rcut: float = 3.6,
                     mcut: int = 4) -> torch.Tensor:
    """eps(k) = D(k) / (4 pi G rho_bar) for k vectors (..., 3), on their device.

    k in lattice units (the first Brillouin zone is [-pi, pi]^3, but any k
    is valid: D is periodic in the reciprocal lattice).  ``kvecs`` is a
    tensor (a numpy array lands on the CPU).  Returns (..., 3, 3)
    symmetric float64 matrices.
    """
    kvecs = torch.as_tensor(kvecs, dtype=F64)
    device = kvecs.device
    flat = kvecs.reshape(-1, 3)
    nk = flat.shape[0]
    out = torch.empty((nk, 3, 3), dtype=F64, device=device)

    R, s = _real_space_tensor(alpha, rcut, device)
    K = _recip_space_tensor(alpha, mcut, device)

    # static reciprocal background sum: sum_{K != 0} g(K)
    Knz = K[(K**2).sum(1) > 0]
    gK = _g_tensor(Knz) * torch.exp(-(Knz**2).sum(1) / (4 * alpha**2))[:, None, None]
    bg = 4 * math.pi * gK.sum(0)

    # sum_K w q_a q_b with q = k + K, as k_a k_b sum w + k_a sum w K_b
    # + sum w K_a k_b + sum w K_a K_b: one product of the (c, nK) weights
    # with the K moments [1, K_a, K_a K_b] in place of (c, nK, 3)
    # temporaries.  Exact to rounding in the first Brillouin zone (the
    # small-q term is K = 0's); far outside it the parts cancel, ~2e-13
    # of the largest entry at |k| ~ 5 pi
    moments = torch.cat([torch.ones_like(K[:, :1]), K,
                         (K[:, :, None] * K[:, None, :]).reshape(-1, 9)], dim=1)
    s9 = s.reshape(-1, 9)
    elems = _CHUNK_ELEMS_CPU if device.type == "cpu" else _CHUNK_ELEMS_CARD
    chunk = max(1, elems // max(len(R), len(K)))
    for i in range(0, nk, chunk):
        k = flat[i : i + chunk]  # (c, 3)
        # real-space: sum s(R) (cos(k.R) - 1)   (sin part cancels by R->-R)
        phase = torch.cos(k @ R.T) - 1.0  # (c, nR)
        real = (phase @ s9).view(-1, 3, 3)
        # reciprocal: sum_K g(k+K), |q|^2 summed from q's components
        q2 = sum((k[:, a, None] + K[None, :, a]) ** 2 for a in range(3))
        damp = 4 * math.pi * torch.exp(-q2 / (4 * alpha**2))
        q2s = torch.where(q2 == 0, 1.0, q2)
        m = (damp / q2s) @ moments  # (c, 13): sum w, sum w K_a, sum w K_a K_b
        kk = k[:, :, None] * k[:, None, :]
        kK = k[:, :, None] * m[:, None, 1:4]
        recip = kk * m[:, :1, None] + kK + kK.transpose(1, 2) + m[:, 4:].view(-1, 3, 3)
        out[i : i + chunk] = real + recip - bg
    return (out / (4 * math.pi)).reshape(*kvecs.shape[:-1], 3, 3)


def growing_mode(eps: torch.Tensor, khat: torch.Tensor):
    """Pick the growing mode: the eigenvector most aligned with k_hat (the
    first on a tie).

    Returns (evec (..., 3) sign-fixed so evec . k_hat >= 0, eval (...,)).
    """
    # ascending eigenvalues; v[..., :, j] the j-th vector
    flat = eps.reshape(-1, 3, 3)
    parts = [torch.linalg.eigh(flat[i : i + _EIGH_BATCH])
             for i in range(0, flat.shape[0], _EIGH_BATCH)]
    w = torch.cat([p[0] for p in parts]).reshape(eps.shape[:-1])
    v = torch.cat([p[1] for p in parts]).reshape(eps.shape)
    align = (v * khat[..., :, None]).sum(-2).abs()
    j = align.argmax(-1, keepdim=True)
    evec = torch.take_along_dim(v, j[..., None, :], dim=-1)[..., 0]
    eval_ = torch.take_along_dim(w, j, dim=-1)[..., 0]
    sign = torch.sign((evec * khat).sum(-1))
    sign = torch.where(sign == 0, 1.0, sign)
    return evec * sign[..., None], eval_


def wrapped_index(N: int, device="cuda") -> torch.Tensor:
    """The table's wavenumber of each index: wrap(i) = i - N for i > N/2,
    and index N/2 meaning -N/2 (numpy fft convention; immaterial for D
    since D(-k) = D(k))."""
    half = N // 2
    ix = torch.arange(N, device=device)
    wrap = torch.where(ix > half, ix - N, ix)
    return torch.where(ix == half, -half, wrap)


def plane_groups(N: int, device="cuda"):
    """The table's kx planes, a group at a time: yields the first plane's
    index, the group's k vectors (planes, N, N/2+1, 3) on ``device`` and
    their unit vectors (0 at k = 0)."""
    wrap = wrapped_index(N, device)
    kz = torch.arange(N // 2 + 1, device=device)
    group = max(1, _GROUP_KPOINTS // (N * (N // 2 + 1)))
    for a in range(0, N, group):
        KX, KY, KZ = torch.meshgrid(wrap[a : a + group], wrap, kz, indexing="ij")
        k = 2 * math.pi / N * torch.stack([KX, KY, KZ], dim=-1).to(F64)
        kmag = torch.linalg.vector_norm(k, dim=-1)
        yield a, k, k / torch.where(kmag == 0, 1.0, kmag)[..., None]


def generate_eigmodes_table(N: int, alpha: float = 2.0, rcut: float = 3.6,
                            mcut: int = 4, device="cuda", out=None,
                            verbose: bool = False) -> np.ndarray:
    """Full eigenmode table (N, N, N/2+1, 4) float64 in the reference layout,
    computed on ``device``.

    Index (ix, iy, iz): kx = wrap(ix), ky = wrap(iy), kz = iz, in units of
    the grid fundamental 2 pi / N (``wrapped_index``).  A group of kx
    planes at a time goes through the device and is copied into ``out``
    (a host float64 array of that shape, an ``np.memmap`` for one; a new
    array when None), which is returned.
    """
    shape = (N, N, N // 2 + 1, 4)
    table = np.empty(shape) if out is None else out
    if table.shape != shape or table.dtype != np.float64:
        raise ValueError(f"out is {table.dtype}{table.shape}, want float64{shape}")
    for a, k, khat in plane_groups(N, device):
        evec, eval_ = growing_mode(dynamical_matrix(k, alpha, rcut, mcut), khat)
        # straight into the host array: one copy, no pageable staging tensor
        torch.from_numpy(table[a : a + len(k)]).copy_(torch.cat([evec, eval_[..., None]], -1))
        if verbose and (len(k) > 1 or a % 8 == 0):
            print(f"  plane {a}/{N}", flush=True)
    # k = 0: undefined; generation zeroes this mode and the lookup returns
    # norm 0, so store a benign unit entry
    table[0, 0, 0] = [0.0, 0.0, 1.0, 1.0]
    return table


def check_table(table, reference, eps, sep: float = 1e-6) -> dict:
    """Hold an eigenmode table to a reference of the same N made by another
    eigensolver (LAPACK's, say, where the table's is cuSOLVER's); raises
    ValueError naming the rule that fails.

    ``table``, ``reference``: (N, N, N/2+1, 4) arrays; ``eps``: the
    reference generator's dynamical matrices (N, N, N/2+1, 3, 3) at the
    table's k vectors.  The rules:

    1. eigenvalues within 1e-12 everywhere;
    2. eigenvectors within 1e-10 wherever the chosen eigenvalue lies at
       least ``sep`` from the other two;
    3. elsewhere (a degenerate eigenspace, where the two solvers may pick
       different bases) a unit vector to 1e-12 with e.k_hat >= -1e-12 in
       the reference's eigenspace: |(eps - lambda I) e| <= 1e-10.

    The k = 0 entry, the stored convention of both, must be equal.
    Returns the number of entries under rules 2 and 3 and the worst
    deviation of each rule.
    """
    table, reference, eps = (np.asarray(a, np.float64) for a in (table, reference, eps))
    N = table.shape[0]
    if reference.shape != table.shape or eps.shape != table.shape[:3] + (3, 3):
        raise ValueError(f"shapes {table.shape}, {reference.shape}, {eps.shape}")
    if not np.array_equal(table[0, 0, 0], reference[0, 0, 0]):
        raise ValueError(f"k = 0 entries {table[0, 0, 0]} != {reference[0, 0, 0]}")
    live = np.ones(table.shape[:3], bool)
    live[0, 0, 0] = False
    e, lam = table[..., :3][live], table[..., 3][live]
    e_ref, lam_ref, eps = reference[..., :3][live], reference[..., 3][live], eps[live]
    wrap = wrapped_index(N, "cpu").numpy()
    k = np.stack(np.meshgrid(wrap, wrap, np.arange(N // 2 + 1), indexing="ij"), -1)[live]

    # the distance of the chosen eigenvalue to the other two: the second
    # smallest of its distances to all three
    gap = np.sort(np.abs(np.linalg.eigvalsh(eps) - lam_ref[:, None]), axis=1)[:, 1]
    apart = gap >= sep
    worst = {
        "eigenvalue": float(np.abs(lam - lam_ref).max()),
        "vector": float(np.abs(e - e_ref)[apart].max(initial=0.0)),
        "norm": float(np.abs(np.linalg.norm(e[~apart], axis=1) - 1).max(initial=0.0)),
        "dot": float(((e * k).sum(1) / np.linalg.norm(k, axis=1))[~apart].min(initial=0.0)),
        "residual": float(np.linalg.norm(
            (eps[~apart] @ e[~apart, :, None])[..., 0] - lam_ref[~apart, None] * e[~apart],
            axis=1).max(initial=0.0)),
    }
    for rule, bad in (("eigenvalue", worst["eigenvalue"] > 1e-12),
                      ("vector", worst["vector"] > 1e-10),
                      ("norm", worst["norm"] > 1e-12),
                      ("dot", worst["dot"] < -1e-12),
                      ("residual", worst["residual"] > 1e-10)):
        if bad:
            raise ValueError(f"table breaks rule '{rule}' against the reference: {worst}")
    return {"separated": int(apart.sum()), "degenerate": int((~apart).sum()), **worst}
