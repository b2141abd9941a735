"""Synthetic ZA/FastPM-like cube generator (port of
nbody_tpu/data/synthetic.py, pure numpy: the same seed gives bit-identical
cubes in both packages; tests/test_torch_data.py holds them equal).

The real datasets (ZA_001.npy ... ZA_010.npy, shape (1000, 32, 32, 32, 19),
reference utils.py:530-545) are not present in this environment, so the
framework ships a physically-grounded generator producing the same schema:

  * ZA displacements: psi1 = -grad(phi1) for a Gaussian random potential
    phi1 with a power-law spectrum (smooth, curl-free — like real
    Zel'dovich fields).
  * 2LPT displacements: psi1 + psi2 with the GENUINE second-order term
    psi2 = (3/7) grad(phi2),  del^2 phi2 = sum_{i<j}[phi1,ii phi1,jj
    - phi1,ij^2]  (the standard 2LPT source, solved spectrally).  psi2 is
    deterministic given psi1 but quadratic mode coupling — NOT proportional
    to the particle's own velocity — so, as with real simulation data, a
    least-squares linear-velocity baseline cannot absorb it while a model
    that sees the local field structure can.
  * FastPM displacements: 2LPT plus the leading nonlinear mode-coupling
    response psi1 * delta (delta = -div psi1, the linear density contrast
    — collapse accelerates in overdense regions) and a local amplitude
    modulation, standing in for beyond-2LPT collapse.  The coupling term
    is quadratic in the Gaussian field, hence invisible to a fitted
    linear-velocity timestep, yet one-hop learnable: delta is a first
    derivative of the displacement field, read directly off neighbor
    relative positions.
  * Velocities from linear-theory growth: v ~ f*(psi1 + 2*psi2*...) — the
    second-order displacement grows ~D^2 so its velocity weight is doubled.

Used for tests and for benchmarking when no real data is on disk.  An
earlier revision modeled the FastPM correction as ``za * (1 + tanh)`` plus
a grid-roll term; that truth was nearly affine in the input velocity, so
the reference's own headline comparison (model vs linear-velocity
baseline, visualization/plot_eval.py:85-93) was unbeatable by construction
— the 2LPT term restores the structure-dependent signal real models
exploit.
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

    The result is disk-cached per (num_samples, cells, seed, za_rms): the
    2LPT spectral solve for 1000 32^3 cubes costs ~5 min of host CPU, and
    every CLI process in a measurement queue (and every hop of the rollout
    chain) would regenerate an identical, fully-deterministic array.
    Disable or redirect via NBODY_SYNTH_CACHE_DIR ("" disables); the
    default lives under the process's temporary directory ($TMPDIR).
    """
    import os
    import tempfile
    cache_dir = os.environ.get(
        "NBODY_SYNTH_CACHE_DIR",
        os.path.join(tempfile.gettempdir(), "nbody_synth"))
    min_pts = int(os.environ.get("NBODY_SYNTH_CACHE_MIN", 2 ** 20))
    cache = None
    if cache_dir and num_samples * cells ** 3 >= min_pts:  # skip tiny test cubes
        rms_tag = f"{za_rms:g}".replace(".", "p")
        cache = os.path.join(cache_dir, f"synth_{num_samples}x{cells}"
                                        f"_s{seed}_r{rms_tag}.npy")
        try:
            if os.path.exists(cache):
                return np.load(cache)
        except Exception:
            pass  # unreadable/corrupt cache -> regenerate

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
    if cache is not None:
        try:
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            # np.save appends ".npy" unless the name already ends with it
            tmp = cache + f".{os.getpid()}.tmp.npy"
            np.save(tmp, out)
            os.replace(tmp, cache)   # atomic vs concurrent readers
        except Exception:
            pass  # cache is best-effort (read-only FS, disk full, ...)
    return out
