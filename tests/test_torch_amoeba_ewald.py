"""The port's complete periodic AMOEBA potential against the JAX package
at f64: `make_amoeba_potential(..., valence=True, ewald=True, pme=True)`
on two flexible water03 waters in a 12 A box (cutoff 5.5 A, Ewald
tolerance 1e-4, PME order 8 on a 16^3 mesh), a seeded jitter with one
water across the box face.

Each part's energy (permanent multipole PME, Ewald-split mutual
polarization with its CG, buffered 14-7 vdW, valence) within 1e-7
relative of the JAX part; the total forces within 1e-7 of the largest
against central differences of the JAX energy (the JAX gradient of the
quadrupole tiers compiles for minutes). The CG runs to 1e-10, so the
differences do not cross a change of the iteration count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_amoeba import BOX, CUTOFF, L, WATER03_FULL, both
from test_torch_multipole_ewald import central_forces
from test_torch_multipoles import dimer

torch.set_num_threads(1)


def test_full_periodic_stack_matches_jax():
    jp, tp = both(WATER03_FULL, cutoff=CUTOFF, switch_dist=5.0, ewald=True, box=BOX,
                  ewald_tol=1e-4, pme=True, valence=True, cg_iters=60, cg_tol=1e-10)
    assert [type(p).__name__ for p in tp.parts] == ["AmoebaElectrostatics", "AmoebaVdw",
                                                    "AmoebaValence"]
    assert type(tp.parts[0].multipoles).__name__ == "MultipolePme"
    bj = jnp.asarray(BOX)
    jel = jp.parts[0]
    jparts = {"permanent": jel.multipoles, "polarization": jel.polarization,
              "vdw": jp.parts[1], "valence": jp.parts[2]}
    jfns = {k: jax.jit(lambda p, o=o: o.energy_fn(p, bj)) for k, o in jparts.items()}
    pos = dimer(11, 0.05)[0] + np.array([L / 2, L / 2, 9.5])
    pos = pos - L * np.floor(pos / L)
    x = torch.as_tensor(pos).requires_grad_(True)
    parts = tp.energy_parts(x, torch.as_tensor(BOX))
    assert parts.keys() == jparts.keys()
    (g,) = torch.autograd.grad(sum(parts.values()), x)
    for k, fn in jfns.items():
        ej, et = float(fn(jnp.asarray(pos))), float(parts[k].detach())
        assert abs(et - ej) <= 1e-7 * max(1.0, abs(ej)), (k, et, ej)
    f_ref = central_forces(lambda p: sum(fn(p) for fn in jfns.values()), pos)
    assert np.abs(-g.numpy() - f_ref).max() <= 1e-7 * np.abs(f_ref).max()
    assert int(tp.parts[0].polarization.last_cg_iters) < 60
