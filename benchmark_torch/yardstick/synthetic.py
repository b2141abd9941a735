"""The traffic generator of the benchmark: synthetic ZA / FastPM cubes in
the reference's 19-column schema.

Copied from nbody_tpu_torch/data/synthetic.py (``_lpt_displacement_fields``
and ``synthetic_raw_cubes``), without its disk cache: the benchmark makes
its cubes anew in every run from ``--seed``, so that a later change to the
program's generator cannot change the benchmark's inputs.  Pure numpy; the
same seed gives bit-identical cubes (benchmark_torch/selfcheck.py holds the
copy equal to the original).
"""

from __future__ import annotations

import numpy as np


def _lpt_displacement_fields(rng: np.random.Generator, cells: int,
                             amplitude: float, slope: float = -2.5,
                             d2_ratio: float = 0.35):
    """First- and second-order LPT displacement fields, both (C, C, C, 3).

    psi1 = -grad(phi1) for a periodic Gaussian random potential phi1 with
    |phi1_k| ~ k^slope, rescaled so rms(|psi1|) = amplitude (grid units).

    psi2 = (3/7) grad(phi2) with the standard 2LPT Poisson source
    (Scoccimarro 1998, eq. 2.9):
        del^2 phi2 = sum_{i<j} [phi1,ii phi1,jj - (phi1,ij)^2]
    computed spectrally from the SAME phi1 realization, then rescaled to
    rms(|psi2|) = d2_ratio * amplitude — the epoch choice: the psi2/psi1
    ratio grows like the linear growth factor D(t), and the late-time
    regime (where the reference's FastPM targets live) is the interesting
    one for learning.
    """
    k1 = np.fft.fftfreq(cells) * cells
    kx, ky, kz = np.meshgrid(k1, k1, k1, indexing="ij")
    kvec = (kx, ky, kz)
    k2 = kx ** 2 + ky ** 2 + kz ** 2
    k2[0, 0, 0] = 1.0
    power = k2 ** (slope / 2.0)
    power[0, 0, 0] = 0.0
    # Zero the Nyquist planes: the spectral derivative -1j*k of a real
    # field is ill-defined at the unpaired Nyquist mode (its real
    # projection halves it), which would leave psi1 slightly curl-ful and
    # break the exact psi1 -> Hessian -> phi2 chain the premise tests pin.
    if cells % 2 == 0:
        nyq = cells // 2
        power[np.abs(kx) == nyq] = 0.0
        power[np.abs(ky) == nyq] = 0.0
        power[np.abs(kz) == nyq] = 0.0
    phi_k = np.fft.fftn(rng.normal(size=(cells,) * 3)) * power

    psi1 = np.empty((cells, cells, cells, 3))
    for d in range(3):
        psi1[..., d] = np.real(np.fft.ifftn(-1j * kvec[d] * phi_k))
    s1 = amplitude / (np.sqrt(np.mean(np.sum(psi1 ** 2, axis=-1))) + 1e-12)
    psi1 *= s1
    phi_k = phi_k * s1      # keep phi1 consistent with the rescaled psi1

    # Hessian phi1,ij in k-space: -(k_i k_j) phi1_k
    hess = {}
    for i in range(3):
        for j in range(i, 3):
            hess[(i, j)] = np.real(np.fft.ifftn(-(kvec[i] * kvec[j]) * phi_k))
    src = (hess[(0, 0)] * hess[(1, 1)] - hess[(0, 1)] ** 2
           + hess[(0, 0)] * hess[(2, 2)] - hess[(0, 2)] ** 2
           + hess[(1, 1)] * hess[(2, 2)] - hess[(1, 2)] ** 2)
    src_k = np.fft.fftn(src)
    phi2_k = -src_k / k2                 # del^2 phi2 = src
    phi2_k[0, 0, 0] = 0.0
    psi2 = np.empty((cells, cells, cells, 3))
    for d in range(3):
        psi2[..., d] = (3.0 / 7.0) * np.real(np.fft.ifftn(1j * kvec[d]
                                                          * phi2_k))
    rms2 = np.sqrt(np.mean(np.sum(psi2 ** 2, axis=-1))) + 1e-12
    psi2 *= (d2_ratio * amplitude) / rms2
    # Linear density contrast delta = -div(psi1) = del^2 phi1 (continuity
    # equation at first order), normalized to unit rms — the locally
    # observable field that modulates nonlinear growth.
    delta = np.real(np.fft.ifftn(-k2 * np.where(power > 0, 1.0, 0.0) * phi_k))
    delta /= (np.std(delta) + 1e-12)
    return psi1, psi2, delta


def synthetic_raw_cubes(num_samples: int = 16, cells: int = 32,
                        seed: int = 0, za_rms: float = 1.0) -> np.ndarray:
    """Generate (S, C, C, C, 19) raw cubes matching the reference schema.

    Column layout (reference utils.py:538-544):
      [...,  1: 4] ZA displacements     [..., 10:13] ZA velocity
      [...,  4: 7] 2LPT displacements   [..., 13:16] 2LPT velocity
      [...,  7:10] FastPM displacements [..., 16:19] FastPM velocity
    Displacements are in grid units (box = 4*C like the real 128-box data).
    """
    rng = np.random.default_rng(seed)
    out = np.zeros((num_samples, cells, cells, cells, 19), dtype=np.float32)
    for s in range(num_samples):
        za, psi2, delta = _lpt_displacement_fields(rng, cells,
                                                   amplitude=za_rms)
        lpt2 = za + psi2
        # "FastPM" truth: 2LPT plus the leading nonlinear mode-coupling
        # response — collapse accelerates in overdense regions, so the
        # displacement picks up a psi1*delta coupling (delta = -div psi1,
        # the linear density contrast) plus a local amplitude modulation.
        # Both are quadratic in the Gaussian field (third moments against
        # psi1 vanish), so neither is absorbable by a fitted linear-
        # velocity timestep; delta is a FIRST-derivative field, directly
        # visible in one hop of neighbor relative positions, so the
        # coupling term is learnable at realistic training budgets.
        za_mag2 = np.sum(za ** 2, axis=-1, keepdims=True)
        coupling = 0.30 * za * delta[..., None]
        fpm = (lpt2 + coupling
               + 0.15 * za * np.tanh(za_mag2 / max(za_rms, 1e-12) ** 2))
        f_growth = 0.5  # velocity ~ f * H * displacement, arbitrary units
        out[s, ..., 1:4] = za
        out[s, ..., 4:7] = lpt2
        out[s, ..., 7:10] = fpm
        out[s, ..., 10:13] = f_growth * za
        # D2 ~ D^2: the second-order displacement's velocity weight doubles
        out[s, ..., 13:16] = f_growth * (za + 2.0 * psi2)
        out[s, ..., 16:19] = f_growth * (fpm + psi2)
    return out
