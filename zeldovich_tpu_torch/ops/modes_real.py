"""Setup fields and the plain half-spectrum synthesis, as torch tensor ops.

Port of the main-path parts of ``zeldovich_tpu/ops/modes_real.py``:

* ``pk_effective``: P(k) with the zero rules folded in (pk = 0 zeroes a
  mode exactly, since sqrt(-0 * log R) == 0);
* ``plt_coef_fields``: the PLT eigenmode coefficient planes (on a CUDA
  device the kernel of csrc/plt.cu, else ``plt_coef_fields_plain``);
* ``synthesize_half_pair``: the packed half-SPECTRUM
  ``(narray, 2, 2, half+1, Z, X)`` = (array, +/- packing, re/im, ky, Z, X),
  with the ky=0 self-conjugate fixup and the zero y-Nyquist row;
* ``synthesize_full_fast_pair``: the full k-grid ``(narray, 2, Y, Z, X)``
  of the configurations the half spectrum cannot represent (f_NL, v1,
  CornerModes with k_cutoff != 1), from the generated half space by
  reflection (``assemble_pair``), with ``phi_of_D`` and ``finish_fields``;
* ``synthesize_pair``: any rows of that full grid, each entry computed at
  its source mode (the out-of-core slab synthesis).

``synthesize_half_pair``, ``pack_rows`` (any of the generated planes),
``pack_half_raw`` and ``gaussian`` are the plain versions the CUDA kernels of ops/synth.py (B1, B3) and
ops/boxmuller.py (B4, B5) are held against.  Work is chunked over y so
the int64 limb temporaries of the draw chain, and the field temporaries
of the full grid, stay bounded at 512^3 and above.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..utils.timers import span, tracing
from . import pcg_device
from .modes import SynthConfig, SynthTables, hermitian_source, zero_rules


def _np_dtype(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


def y_chunk(half: int, ppd: int, max_elems: int) -> int:
    """Largest divisor of half with chunk * ppd^2 <= max_elems (>= 1)."""
    cy = max(1, min(half, max_elems // (ppd * ppd)))
    while half % cy:
        cy -= 1
    return cy


def _wavenumbers(y0: int, y1: int, ppd: int, device):
    """ky (ny,1,1), kz (1,Z,1), kx (1,1,X) int64 and their integer n2."""
    half = ppd // 2
    ky = torch.arange(y0, y1, device=device)[:, None, None]
    z = torch.arange(ppd, device=device)[None, :, None]
    x = torch.arange(ppd, device=device)[None, None, :]
    kz = torch.where(z > half, z - ppd, z)
    kx = torch.where(x > half, x - ppd, x)
    n2 = kx * kx + ky * ky + kz * kz
    return ky, kz, kx, n2


def _planes(cfg: SynthConfig, rows):
    """The generated planes [y0, y1) that ``rows`` names (all by default)."""
    y0, y1 = rows if rows is not None else (0, cfg.ppd // 2)
    if not 0 <= y0 < y1 <= cfg.ppd // 2:
        raise ValueError(f"planes {rows}: want 0 <= y0 < y1 <= {cfg.ppd // 2}")
    return y0, y1


def pk_effective(cfg: SynthConfig, tables: SynthTables, dtype, rows=None):
    """Static per-run amplitude field (half, Z, X): the zero-rule mask
    folded into P(k).  Bit-equal to the JAX package's (a gather + cast).
    ``rows = (y0, y1)``: the planes [y0, y1) alone."""
    ppd = cfg.ppd
    y0, y1 = _planes(cfg, rows)
    dev = tables.device
    out = torch.empty((y1 - y0, ppd, ppd), dtype=dtype, device=dev)
    cy = y_chunk(y1 - y0, ppd, 1 << 23)
    for r0 in range(0, y1 - y0, cy):
        ky, kz, kx, n2 = _wavenumbers(y0 + r0, y0 + r0 + cy, ppd, dev)
        zero = zero_rules(kx, ky, kz, n2, cfg)
        pk = tables.pk_n2[n2].to(dtype)
        out[r0:r0 + cy] = torch.where(zero, 0.0, pk)
    return out


def _inv_k2(n2, cfg: SynthConfig, dtype):
    """1/k^2 (0 at the origin), in the JAX package's rounding order."""
    npf = _np_dtype(dtype)
    k2 = n2.to(dtype) * float(npf(cfg.fundamental) ** 2)
    return torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, k2))


def plt_coefs_at(kx, ky, kz, n2, cfg: SynthConfig, tables: SynthTables, dtype):
    """PLT coefficients (cx, cy, cz, f) at wavevectors (kx, ky, kz).

    cx, cy, cz = evec_j * rescale * fundamental / k^2 (the per-mode
    displacement coefficients) and f, the PLT growth factor of the
    velocity arrays; the JAX package's _finish_fields expressions.
    """
    from .plt import eigenmode_lookup

    npf = _np_dtype(dtype)
    ik2 = _inv_k2(n2, cfg, dtype)
    evec, eval_ = eigenmode_lookup(kx, ky, kz, cfg.ppd, tables.eig, dtype=dtype)
    f = (torch.sqrt(1.0 + 24.0 * eval_ * float(npf(cfg.f_cluster))) - 1.0) * 0.25
    fund = float(npf(cfg.fundamental))
    if cfg.qPLTrescale:
        rescale = torch.pow(float(npf(cfg.plt_rescale_base)),
                            float(npf(cfg.plt_target_f)) - f)
        scale = rescale * fund * ik2
    else:
        scale = fund * ik2
    return evec[0] * scale, evec[1] * scale, evec[2] * scale, f


def plt_coef_fields(cfg: SynthConfig, tables: SynthTables, dtype, rows=None):
    """Setup-time PLT coefficient planes, stacked (4, half, Z, X).

    ``plt_coefs_at`` over the generated half space (``rows = (y0, y1)``:
    the planes [y0, y1) alone): one stacked tensor, so the synthesis
    kernels take one pointer.  On a CUDA device one launch of the
    hand-written kernel (csrc/plt.cu) writes it; on the CPU the plain
    version, ``plt_coef_fields_plain``, computes it.
    """
    dev = tables.device
    if dev.type == "cpu":
        return plt_coef_fields_plain(cfg, tables, dtype, rows)
    if tables.eig is None:
        raise ValueError("PLT needs the eigenmode table (SynthTables.eig)")
    y0, y1 = _planes(cfg, rows)
    out = torch.empty((4, y1 - y0, cfg.ppd, cfg.ppd), dtype=dtype, device=dev)
    npf = _np_dtype(dtype)
    kernels.launch_plt_coefs(
        tables.eig, out, y0, float(npf(cfg.fundamental)),
        float(npf(cfg.fundamental) ** 2), float(npf(cfg.f_cluster)),
        float(npf(cfg.plt_rescale_base)), float(npf(cfg.plt_target_f)),
        cfg.qPLTrescale,
    )
    return out


def plt_coef_fields_plain(cfg: SynthConfig, tables: SynthTables, dtype, rows=None):
    """Plain version of ``plt_coef_fields`` on any device: ``plt_coefs_at``
    in chunks over y, since the 8-point gather holds ~8 chunk-sized (.., 4)
    temporaries at once."""
    ppd = cfg.ppd
    y0, y1 = _planes(cfg, rows)
    dev = tables.device
    out = torch.empty((4, y1 - y0, ppd, ppd), dtype=dtype, device=dev)
    cy = y_chunk(y1 - y0, ppd, 32 * ppd * ppd)
    for r0 in range(0, y1 - y0, cy):
        ky, kz, kx, n2 = _wavenumbers(y0 + r0, y0 + r0 + cy, ppd, dev)
        for j, c in enumerate(plt_coefs_at(kx, ky, kz, n2, cfg, tables, dtype)):
            out[j, r0:r0 + cy] = c
    return out


def gaussian(plane, m, c, pk, fixed_power: bool, live=None):
    """D = live * cgauss(pk) from first-draw states plane * m + c.

    Two XSL-RR draws per mode (one LCG step apart) and Box-Muller against
    pk, in pk's dtype; the limb tuples broadcast against pk.
    """
    R, T = pcg_device.uniform_pair_from_affine(plane, m, c, pk.dtype)
    amp = torch.sqrt(pk) if fixed_power else torch.sqrt(-pk * torch.log(R))
    if live is not None:
        amp = live * amp
    cosv, sinv = pcg_device.sincos_2pi(T)
    return amp * cosv, amp * sinv


def draw_planes(tables: SynthTables, y0: int, y1: int, pk, fixed_power: bool,
                live=None):
    """D = live * cgauss(pk) on the generated planes [y0, y1): (D_re, D_im).

    Per mode the first-draw state plane[y] * mzx + czx (pk the y-chunk of
    a (half, Z, X) field): the plain version of kernel B4 and the front of
    B1.
    """
    plane = tuple(p[y0:y1, None, None] for p in tables.planes)
    m = tuple(a[None] for a in tables.mzx)
    c = tuple(a[None] for a in tables.czx)
    return gaussian(plane, m, c, pk, fixed_power, live)


def field_coefs(kx, ky, kz, n2, cfg: SynthConfig, dtype):
    """Displacement coefficients c_j = k_j * fundamental / k^2 (0 at the
    origin), in the JAX package's rounding order."""
    scale = float(_np_dtype(dtype)(cfg.fundamental)) * _inv_k2(n2, cfg, dtype)
    return tuple(k.to(dtype) * scale for k in (kx, ky, kz))


def finish_fields(D, coefs):
    """(F, G, H) = c_j * (i D) for the coefficients c_j = coefs[j]
    (``field_coefs``, or the PLT cx, cy, cz): the JAX package's
    _finish_fields expressions."""
    # re = -c * D_im, im = c * D_re
    return tuple((-c * D[1], c * D[0]) for c in coefs[:3])


def packed_fields(D, coefs, plt: bool, just_density: bool):
    """The packed arrays of one chunk as (array, P, Q), array = P + iQ of
    two real fields, each an (re, im) pair or None for a zero field:
    (D, F) and (G, H) with (F, G, H) = finish_fields(D, coefs); under PLT
    also (0, fF) and (fG, fH), f = coefs[3]; density only, (D, 0)."""
    if just_density:
        yield 0, D, None
        return
    F, G, H = finish_fields(D, coefs)
    yield 0, D, F
    yield 1, G, H
    if plt:
        f = coefs[3]
        yield 2, None, (F[0] * f, F[1] * f)
        yield 3, (G[0] * f, G[1] * f), (H[0] * f, H[1] * f)


def _packing(P, Q, sign: int = 1):
    """S+ = P + iQ (sign 1) or S- = P - iQ (sign -1) of two real fields as
    an (re, im) pair; None is a zero field."""
    if Q is None:
        return P
    if P is None:
        return (-Q[1], Q[0]) if sign > 0 else (Q[1], -Q[0])
    if sign > 0:
        return P[0] - Q[1], P[1] + Q[0]
    return P[0] + Q[1], P[1] - Q[0]


def _coefs_of_planes(cfg: SynthConfig, y0: int, y1: int, dtype, device,
                     plt_coefs=None):
    """The field coefficients of the generated planes [y0, y1): the chunk
    of the PLT planes, or field_coefs of the planes' wavevectors."""
    if plt_coefs is not None:
        return plt_coefs[:, y0:y1]
    ky, kz, kx, n2 = _wavenumbers(y0, y1, cfg.ppd, device)
    return field_coefs(kx, ky, kz, n2, cfg, dtype)


def _reflect_zx(p):
    """p[..., (n - z) % n, (n - x) % n]."""
    n = p.shape[-1]
    idx = (n - torch.arange(n, device=p.device)) % n
    return p[..., idx[:, None], idx[None, :]]


def _plane0_masks(n: int, device):
    """(Z, X) masks of the ky=0 plane: its in-plane mirror half (z > half,
    or z = 0 and x > half) and the origin."""
    half = n // 2
    z = torch.arange(n, device=device)[:, None]
    x = torch.arange(n, device=device)[None, :]
    return (z > half) | ((z == 0) & (x > half)), (z == 0) & (x == 0)


def fix_ky0_packed(out):
    """Self-conjugate ky=0 fixup of a packed (narray, 2, 2, ky, Z, X) array,
    in place: on the in-plane mirror half, S+ = conj(reflect(S-)) and
    S- = conj(reflect(S+)); the origin is zeroed (zeldovich.cpp:485-503)."""
    fixm, orig = _plane0_masks(out.shape[-1], out.device)
    row = out[:, :, :, 0]  # (narray, pm, reim, Z, X)
    refl = _reflect_zx(row.flip(1))  # the opposite packing, reflected
    conj = torch.tensor([1.0, -1.0], dtype=out.dtype, device=out.device)
    fixed = torch.where(fixm, refl * conj[:, None, None], row)
    out[:, :, :, 0] = torch.where(orig, 0.0, fixed)
    return out


def _pack_into(out, a, y0, y1, P, Q):
    """Both packings of two real fields: S+ = P + iQ, S- = P - iQ."""
    for s, sign in ((0, 1), (1, -1)):
        out[a, s, 0, y0:y1], out[a, s, 1, y0:y1] = _packing(P, Q, sign)


def pack_rows(cfg: SynthConfig, tables: SynthTables, dtype, pk_eff, plt_coefs=None,
              ky0: int = 0, out=None):
    """The packed planes [ky0, ky0 + rows) of the generated half spectrum,
    (narray, 2, 2, rows, Z, X), the ky=0 plane RAW; pk_eff (rows, Z, X)
    and plt_coefs (4, rows, Z, X) hold those planes.

    Per mode: the first-draw state plane[y]*mzx + czx, two XSL-RR draws,
    Box-Muller against pk_eff, the displacement fields i k_j/k^2 D (or the
    PLT coefficient planes, and f times them for the velocity arrays),
    both +/- packings.
    """
    ppd, rows = cfg.ppd, pk_eff.shape[0]
    dev = pk_eff.device
    if cfg.qPLT and plt_coefs is None:
        plt_coefs = plt_coef_fields(cfg, tables, dtype, (ky0, ky0 + rows))
    if out is None:
        out = torch.empty((cfg.narray, 2, 2, rows, ppd, ppd), dtype=dtype, device=dev)
    ny = y_chunk(rows, ppd, 1 << 22)
    for r0 in range(0, rows, ny):
        y0, y1 = ky0 + r0, ky0 + r0 + ny
        D = draw_planes(tables, y0, y1, pk_eff[r0:r0 + ny], cfg.fixed_power)
        coefs = (None if cfg.just_density else plt_coefs[:, r0:r0 + ny] if cfg.qPLT
                 else _coefs_of_planes(cfg, y0, y1, dtype, dev))
        for a, P, Q in packed_fields(D, coefs, cfg.qPLT, cfg.just_density):
            _pack_into(out, a, r0, r0 + ny, P, Q)
    return out


def pack_half_raw(cfg: SynthConfig, tables: SynthTables, dtype, pk_eff,
                  plt_coefs=None):
    """The packed half spectrum (narray, 2, 2, half+1, Z, X) with the ky=0
    plane RAW and the y-Nyquist row zero (``pack_rows`` of every generated
    plane): the plain version of kernel B3."""
    ppd, half = cfg.ppd, cfg.ppd // 2
    out = torch.zeros((cfg.narray, 2, 2, half + 1, ppd, ppd), dtype=dtype,
                      device=pk_eff.device)
    pack_rows(cfg, tables, dtype, pk_eff, plt_coefs, out=out[:, :, :, :half])
    return out


def synthesize_half_pair(cfg: SynthConfig, tables: SynthTables, dtype,
                         pk_eff, plt_coefs=None):
    """Half-SPECTRUM synthesis: (narray, 2, 2, half+1, Z, X), plain torch:
    ``pack_half_raw`` and then the ky=0 fixup."""
    return fix_ky0_packed(pack_half_raw(cfg, tables, dtype, pk_eff, plt_coefs))


def phi_of_D(D, n2, tables: SynthTables):
    """phi = D / M (the gen_phi pass); zero where M is undefined (origin)."""
    M = tables.M_n2[n2].to(D[0].dtype)
    invM = torch.where(n2 == 0, 0.0, 1.0 / torch.where(n2 == 0, 1.0, M))
    return D[0] * invM, D[1] * invM


def _mirror(p):
    """p[ny-1-y, (n-z) % n, (n-x) % n] of (ny, n, n) planes: one gather."""
    ny, n = p.shape[0], p.shape[-1]
    idx = (n - torch.arange(n, device=p.device)) % n
    yi = torch.arange(ny - 1, -1, -1, device=p.device)
    return p[yi[:, None, None], idx[None, :, None], idx[None, None, :]]


def assemble_pair(out, P, Q, y0: int):
    """Write the field P + iQ of generated planes [y0, y0+ny) into the full
    grid ``out`` (2, Y, Z, X).

    P and Q are (re, im) pairs of (ny, Z, X), or None for a zero field.
    Plane y takes S+ = P + iQ; mirror plane n - y takes conj(S-) at the
    reflected (z, x), S- = P - iQ (the conjugates of both fields packed
    the same way); on plane 0 the in-plane mirror half (z > half, or z = 0
    and x > half) takes conj(S-) of plane 0 reflected and the origin is
    zero; the y-Nyquist plane is zero (the JAX package's _assemble_pair,
    with the packing done before the reflection: the same values).
    """
    sp, sm = _packing(P, Q, 1), _packing(P, Q, -1)
    ny, n = sp[0].shape[0], sp[0].shape[-1]
    half, y1 = n // 2, y0 + ny
    out[0, y0:y1] = sp[0]
    out[1, y0:y1] = sp[1]
    ys = max(y0, 1)  # plane 0 has no mirror plane
    if ys < y1:
        out[0, n - y1 + 1:n - ys + 1] = _mirror(sm[0][ys - y0:])
        out[1, n - y1 + 1:n - ys + 1] = -_mirror(sm[1][ys - y0:])
    if y0 == 0:
        fixm, orig = _plane0_masks(n, out.device)
        for j, sgn in ((0, 1.0), (1, -1.0)):
            fixed = torch.where(fixm, sgn * _reflect_zx(sm[j][0]), out[j, 0])
            out[j, 0] = torch.where(orig, 0.0, fixed)
    if y1 == half:
        out[:, half] = 0.0


def synthesize_full_fast_pair(cfg: SynthConfig, tables: SynthTables, dtype,
                              gen_phi: bool = False, phi_pair=None, pk_eff=None,
                              D_source=None, plt_coefs=None, plain: bool = False):
    """Full k-grid as real pairs via half-space generation + reflection.

    Returns (narray, 2, Y, Z, X), or (1, 2, Y, Z, X) phi(k) with gen_phi.
    D on the generated half space comes from one of:

    * ``phi_pair`` (2, Y, Z, X), the f_NL input pass (not with gen_phi):
      D = phi(k) * M(n2), zeroed only at the origin, not by the zero rules
      (zeldovich.cpp:393-400): the f_NL mode coupling repopulates those
      modes, so the spectrum is not Hermitian and pk_eff is not used;
    * ``D_source`` (2, half, Z, X), the host-generated ZD_Version=1 field,
      with the zero rules applied;
    * kernel B4 (ops/boxmuller.py) against ``pk_eff`` (zero rules folded).

    The fields and packings are built one y-chunk at a time and written
    straight into the output, one packed array after another, so no
    full-grid field temporaries exist.  ``plain=True`` takes B4's plain
    version on any device.  The assembly (the y-chunks' torch ops) is the
    span ``full.synth`` (counts ``arrays``, the output's, and ``chunks``,
    its y-chunks); B4's draw and the PLT planes come before it opens.
    While a profiler runs the span syncs the device when it opens and at
    its close, so it holds the assembly's device work alone.
    """
    from .boxmuller import halfspace_boxmuller, halfspace_boxmuller_plain

    ppd, half = cfg.ppd, cfg.ppd // 2
    dev = tables.device
    use_phi = phi_pair is not None and not gen_phi
    if (gen_phi or use_phi) and tables.M_n2 is None:
        raise ValueError("the f_NL passes need tables.M_n2")
    Dhalf = None
    if not use_phi and D_source is None:
        if pk_eff is None:
            pk_eff = pk_effective(cfg, tables, dtype)
        draw = halfspace_boxmuller_plain if plain else halfspace_boxmuller
        Dhalf = draw(tables, pk_eff, cfg.fixed_power)
    plt = cfg.qPLT and not gen_phi
    if plt and plt_coefs is None:
        plt_coefs = plt_coef_fields(cfg, tables, dtype)
    narray = 1 if gen_phi else cfg.narray
    out = torch.empty((narray, 2, ppd, ppd, ppd), dtype=dtype, device=dev)
    cy = y_chunk(half, ppd, 1 << 22)
    sync = tracing() and dev.type == "cuda"
    if sync:
        torch.cuda.synchronize(dev)
    with span("full.synth", arrays=narray, chunks=half // cy):
        for y0 in range(0, half, cy):
            y1 = y0 + cy
            ky, kz, kx, n2 = _wavenumbers(y0, y1, ppd, dev)
            if use_phi:
                M = tables.M_n2[n2].to(dtype)
                D = (phi_pair[0, y0:y1] * M, phi_pair[1, y0:y1] * M)
                if y0 == 0:
                    D[0][0, 0, 0] = D[1][0, 0, 0] = 0.0
            elif D_source is not None:
                zero = zero_rules(kx, ky, kz, n2, cfg)
                D = tuple(torch.where(zero, 0.0, D_source[j, y0:y1]) for j in range(2))
            else:
                D = (Dhalf[0][y0:y1], Dhalf[1][y0:y1])
            if gen_phi:
                assemble_pair(out[0], phi_of_D(D, n2, tables), None, y0)
                continue
            coefs = (None if cfg.just_density else _coefs_of_planes(
                cfg, y0, y1, dtype, dev, plt_coefs if plt else None))
            for a, P, Q in packed_fields(D, coefs, plt, cfg.just_density):
                assemble_pair(out[a], P, Q, y0)
        if sync:
            torch.cuda.synchronize(dev)
    return out


def slab_chunk(ny: int, ppd: int) -> int:
    """Rows of a slab synthesized at once: ~16M modes."""
    return max(1, min(ny, (1 << 24) // (ppd * ppd)))


def slab_modes(y0: int, y1: int, ppd: int, device):
    """Rows [y0, y1) of the full grid at their source modes:
    (sy, sz, sx, mirror, hard_zero, kx, ky, kz, n2), each (ny, Z, X)
    int64 or bool, the wavevector (kx, ky, kz) the source's."""
    half = ppd // 2
    y = torch.arange(y0, y1, device=device)[:, None, None]
    z = torch.arange(ppd, device=device)[None, :, None]
    x = torch.arange(ppd, device=device)[None, None, :]
    sy, sz, sx, mirror, hard_zero = hermitian_source(y, z, x, ppd)
    kz = torch.where(sz > half, sz - ppd, sz)
    kx = torch.where(sx > half, sx - ppd, sx)
    n2 = kx * kx + sy * sy + kz * kz
    return sy, sz, sx, mirror, hard_zero, kx, sy, kz, n2


def draw_operands(modes, cfg: SynthConfig, tables: SynthTables, dtype):
    """Kernel B5's operands for ``slab_modes``: int32 source indices (sy
    clamped below half: the y-Nyquist plane is hard-zeroed anyway), P(k)
    at the source (pk_n2[n2], not pk_eff) and live = not the zero rules."""
    sy, sz, sx, _, _, kx, ky, kz, n2 = modes
    zero = zero_rules(kx, ky, kz, n2, cfg)
    idx = (torch.clamp(sy, max=cfg.ppd // 2 - 1), sz, sx)
    idx = tuple(i.to(torch.int32).contiguous() for i in idx)
    return (*idx, tables.pk_n2[n2].to(dtype), (~zero).to(dtype))


def synthesize_pair(y0: int, ny: int, cfg: SynthConfig, tables: SynthTables,
                    dtype, gen_phi: bool = False, phi_pair=None, D_source=None,
                    plain: bool = False):
    """Rows [y0, y0+ny) of the full k-grid as real pairs, any y0 and ny.

    Returns (narray, 2, ny, Z, X), or (1, 2, ny, Z, X) phi(k) with
    gen_phi: the out-of-core slab synthesis (the JAX package's
    modes_real.synthesize_pair).  Every entry is computed at its source
    mode (``hermitian_source``) in the generated half space and then
    conjugated per field (negate im) where ``mirror`` and zeroed where
    ``hard_zero``: slabs in the generated half, across ppd/2 and in the
    mirror half all take this one path.  D at the source comes from:

    * ``phi_pair`` = ((same_re, same_im), (refl_re, refl_im)), the f_NL
      input pass (not with gen_phi): phi(k) at (y, z, x) and at the
      reflected index, each (ny, Z, X); D = phi(source) * M(n2), zeroed
      only at the origin;
    * ``D_source`` (2, half, Z, X), the host-generated ZD_Version=1 field,
      with the zero rules;
    * kernel B5 (ops/boxmuller.py) at the source indices, against
      pk_n2[n2(source)] with the zero rules as ``live``.

    The fields follow at the source wavevector (the PLT coefficients
    through ``plt_coefs_at``).  Rows are built in chunks of ~16M modes.
    ``plain=True`` takes B5's plain version on any device.
    """
    from .boxmuller import boxmuller, boxmuller_plain

    ppd, half = cfg.ppd, cfg.ppd // 2
    dev = tables.device
    if not 0 <= y0 < y0 + ny <= ppd:
        raise ValueError(f"rows [{y0}, {y0 + ny}) are not rows of a {ppd}^3 grid")
    use_phi = phi_pair is not None and not gen_phi
    if (gen_phi or use_phi) and tables.M_n2 is None:
        raise ValueError("the f_NL passes need tables.M_n2")
    plt = cfg.qPLT and not gen_phi
    narray = 1 if gen_phi else cfg.narray
    draw = boxmuller_plain if plain else boxmuller
    out = torch.empty((narray, 2, ny, ppd, ppd), dtype=dtype, device=dev)
    cy = slab_chunk(ny, ppd)
    for r0 in range(0, ny, cy):
        r1 = min(ny, r0 + cy)
        sm = slab_modes(y0 + r0, y0 + r1, ppd, dev)
        sy, sz, sx, mirror, hard_zero, kx, ky, kz, n2 = sm
        if use_phi:
            (s_re, s_im), (f_re, f_im) = phi_pair
            M = torch.where(n2 == 0, 0.0, tables.M_n2[n2].to(dtype))
            D = (torch.where(mirror, f_re[r0:r1], s_re[r0:r1]) * M,
                 torch.where(mirror, f_im[r0:r1], s_im[r0:r1]) * M)
        elif D_source is not None:
            zero = zero_rules(kx, ky, kz, n2, cfg)
            src = (torch.clamp(sy, max=half - 1), sz, sx)  # y-Nyquist: zeroed
            D = tuple(torch.where(zero, 0.0, D_source[j][src]) for j in range(2))
        else:
            D = draw(tables, *draw_operands(sm, cfg, tables, dtype), cfg.fixed_power)
        live = (~hard_zero).to(dtype)
        conj_live = torch.where(mirror, -live, live)

        def C(w):
            return None if w is None else (w[0] * live, w[1] * conj_live)

        if gen_phi:
            out[0, 0, r0:r1], out[0, 1, r0:r1] = C(phi_of_D(D, n2, tables))
            continue
        coefs = (None if cfg.just_density
                 else plt_coefs_at(kx, ky, kz, n2, cfg, tables, dtype) if plt
                 else field_coefs(kx, ky, kz, n2, cfg, dtype))
        for a, P, Q in packed_fields(D, coefs, plt, cfg.just_density):
            out[a, 0, r0:r1], out[a, 1, r0:r1] = _packing(C(P), C(Q))
    return out
