"""Periodic-boundary trajectory wrapping by molecule center of mass.

The port's own copy of `torchmd_tpu.wrapper`; it imports nothing of the JAX
package.

Equivalent to the reference Wrapper (torchmd/wrapper.py:4-55): molecules
(connected components of the bond graph) are translated as rigid groups so
their geometric centers fall inside [0, box); unbonded atoms wrap
individually; an optional `wrapidx` atom group re-centers the box first.

Differences:
  - connected components via a dependency-free union-find (no networkx),
  - fully vectorized (one segment-sum over a group-id array instead of a
    Python loop over molecules),
  - `wrap` also RETURNS the wrapped array (the reference's wrapidx branch
    rebinds its local and silently never mutates the caller's tensor,
    wrapper.py:14-18).
"""

from __future__ import annotations

import numpy as np


def _union_find_groups(natoms: int, bonds) -> np.ndarray:
    parent = np.arange(natoms, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    if bonds is not None:
        for a, b in np.asarray(bonds, dtype=np.int64):
            ra, rb = find(int(a)), find(int(b))
            if ra != rb:
                parent[rb] = ra
    roots = np.array([find(i) for i in range(natoms)])
    _, group_id = np.unique(roots, return_inverse=True)
    return group_id


def calculate_molecule_groups(natoms, bonds, device=None):
    """Reference-compatible helper: (list of multi-atom groups, singleton
    atom indices)."""
    group_id = _union_find_groups(natoms, bonds)
    groups, nongrouped = [], []
    for g in range(group_id.max() + 1 if natoms else 0):
        members = np.where(group_id == g)[0]
        if len(members) > 1:
            groups.append(members)
        else:
            nongrouped.append(members[0])
    return groups, np.array(nongrouped, dtype=np.int64)


class Wrapper:
    def __init__(self, natoms, bonds, device=None):
        self.natoms = natoms
        if bonds is not None and len(bonds):
            self.group_id = _union_find_groups(natoms, bonds)
        else:
            self.group_id = np.arange(natoms, dtype=np.int64)
        self.ngroups = int(self.group_id.max()) + 1 if natoms else 0
        counts = np.bincount(self.group_id, minlength=self.ngroups)
        self.group_counts = counts.astype(np.float64)
        # reference-compatible views
        self.groups = [
            np.where(self.group_id == g)[0]
            for g in range(self.ngroups)
            if counts[g] > 1
        ]
        self.nongrouped = np.where(counts[self.group_id] == 1)[0]

    def wrap(self, pos, box, wrapidx=None):
        """Wrap positions into the box. pos: (nreplicas, natoms, 3) numpy
        array (modified in place when possible) or a tensor; box:
        (nreplicas, 3, 3) or (nreplicas, 3). Returns the wrapped array."""
        inplace = isinstance(pos, np.ndarray)
        p = np.asarray(pos, dtype=np.float64).copy()
        box = np.asarray(box, dtype=np.float64)
        if box.ndim == 3:
            box = np.stack([np.diag(b) for b in box])
        if np.all(box == 0):
            return pos
        box3 = box[:, None, :]  # (R, 1, 3)

        if wrapidx is not None:
            # Recenter so the selected group's COM sits at box/2
            com = p[:, wrapidx].sum(axis=1, keepdims=True) / len(wrapidx)
            p = p - com + box3 / 2

        # Per-group geometric centers via segment sum
        nrep = p.shape[0]
        sums = np.zeros((nrep, self.ngroups, 3))
        np.add.at(sums, (slice(None), self.group_id), p)
        coms = sums / self.group_counts[None, :, None]
        offsets = np.floor(coms / box3) * box3
        p = p - offsets[:, self.group_id, :]

        if inplace:
            pos[:] = p.astype(pos.dtype)
            return pos
        return p.astype(np.asarray(pos).dtype)
