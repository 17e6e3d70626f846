"""Analytic physical fields used to drive AMR refinement and fill cells.

Two test cases mirror the paper's:

  * **Sedov3D** — point explosion in a cubic box (paper §3 benchmark case):
    self-similar blast-wave profile with a density/pressure shell at the
    shock radius. Smooth away from the shock, sharp at it.
  * **Orion-like** — lognormal density from multi-octave value noise, a
    proxy for the MHD-turbulence molecular-cloud data (Ntormousi &
    Hennebelle 2019) used for the paper's pruning/compression figures.

All evaluators are vectorized: points are (N, 3) float64 in [0, 1).
"""
from __future__ import annotations

import numpy as np


class Field:
    """Bundle of named scalar evaluators over unit-box points."""

    def __init__(self, evaluators):
        self._ev = dict(evaluators)

    @property
    def names(self):
        return list(self._ev)

    def __call__(self, name: str, pts: np.ndarray) -> np.ndarray:
        return self._ev[name](pts)

    def all(self, pts: np.ndarray) -> dict[str, np.ndarray]:
        return {k: f(pts) for k, f in self._ev.items()}


# ---------------------------------------------------------------- Sedov3D

def sedov(center=(0.5, 0.5, 0.5), r_shock: float = 0.28,
          shell_width: float = 0.02, rho0: float = 1.0,
          jump: float = 4.0) -> Field:
    """Sedov blast wave approximation (strong-shock gamma=5/3 profile)."""
    c = np.asarray(center)

    def radius(pts):
        return np.sqrt(((pts - c) ** 2).sum(axis=1)) + 1e-12

    def density(pts):
        r = radius(pts)
        x = r / r_shock
        inner = rho0 * np.clip(x, 1e-3, 1.0) ** 4.5  # evacuated interior
        shell = rho0 * jump * np.exp(-0.5 * ((r - r_shock) / shell_width) ** 2)
        post = rho0 * np.where(r > r_shock, 1.0, 0.0)
        return np.where(r <= r_shock, inner, post) + shell

    def pressure(pts):
        r = radius(pts)
        x = np.clip(r / r_shock, 1e-3, None)
        return np.where(x <= 1.0, 0.3 + 0.7 * x ** 1.5,
                        1e-3 + 0.3 * np.exp(-4.0 * (x - 1.0)))

    def vel(axis):
        def f(pts):
            r = radius(pts)
            u = (pts[:, axis] - c[axis]) / r
            mag = np.where(r <= r_shock, 0.75 * r / r_shock,
                           0.75 * np.exp(-6.0 * (r / r_shock - 1.0)))
            return mag * u
        return f

    return Field({"density": density, "pressure": pressure,
                  "velocity_x": vel(0), "velocity_y": vel(1),
                  "velocity_z": vel(2)})


# ------------------------------------------------------------- Orion-like

class _ValueNoise:
    """Periodic multi-octave trilinear value noise on the unit box."""

    def __init__(self, seed: int, octaves: int = 6, base_res: int = 4,
                 persistence: float = 0.62):
        rng = np.random.default_rng(seed)
        self.grids = []
        self.persistence = persistence
        res = base_res
        for _ in range(octaves):
            self.grids.append(rng.standard_normal((res, res, res)))
            res *= 2

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        out = np.zeros(pts.shape[0])
        amp = 1.0
        for g in self.grids:
            n = g.shape[0]
            x = pts * n
            i0 = np.floor(x).astype(np.int64) % n
            f = x - np.floor(x)
            i1 = (i0 + 1) % n
            # trilinear blend
            def at(ix, iy, iz):
                return g[ix, iy, iz]
            c000 = at(i0[:, 0], i0[:, 1], i0[:, 2]); c100 = at(i1[:, 0], i0[:, 1], i0[:, 2])
            c010 = at(i0[:, 0], i1[:, 1], i0[:, 2]); c110 = at(i1[:, 0], i1[:, 1], i0[:, 2])
            c001 = at(i0[:, 0], i0[:, 1], i1[:, 2]); c101 = at(i1[:, 0], i0[:, 1], i1[:, 2])
            c011 = at(i0[:, 0], i1[:, 1], i1[:, 2]); c111 = at(i1[:, 0], i1[:, 1], i1[:, 2])
            fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
            c00 = c000 * (1 - fx) + c100 * fx
            c10 = c010 * (1 - fx) + c110 * fx
            c01 = c001 * (1 - fx) + c101 * fx
            c11 = c011 * (1 - fx) + c111 * fx
            c0 = c00 * (1 - fy) + c10 * fy
            c1 = c01 * (1 - fy) + c11 * fy
            out += amp * (c0 * (1 - fz) + c1 * fz)
            amp *= self.persistence
        return out


def orion(seed: int = 7, sigma: float = 1.6) -> Field:
    """Lognormal turbulent cloud proxy with velocity components."""
    s = _ValueNoise(seed)
    vxn = _ValueNoise(seed + 1, octaves=5)
    vyn = _ValueNoise(seed + 2, octaves=5)
    vzn = _ValueNoise(seed + 3, octaves=5)

    def density(pts):
        return np.exp(sigma * s(pts))  # lognormal PDF of supersonic turbulence

    return Field({"density": density,
                  "velocity_x": lambda p: 0.8 * vxn(p),
                  "velocity_y": lambda p: 0.8 * vyn(p),
                  "velocity_z": lambda p: 0.8 * vzn(p),
                  "pressure": lambda p: density(p) ** (5.0 / 3.0)})
