"""YAML force-field reader.

The port's own copy of `torchmd_tpu.forcefields.ff_yaml`; it imports nothing of the JAX
package.

Reads the custom YAML schema used by the reference's bundled force fields
(behavior spec: torchmd/forcefields/ff_yaml.py:7-103 and
tests/water/water_forcefield.yaml): top-level sections ``atomtypes``,
``masses``, ``bonds`` ({k0, req}), ``angles`` ({k0, theta0}), ``dihedrals``
({terms: [{phi_k, phase, per}], scnb, scee}), ``impropers`` ({phi_k, phase,
per}), ``lj`` ({sigma, epsilon, sigma14, epsilon14}), ``electrostatics``
({charge}). Multi-atom entries are keyed by "(T1, T2, ...)" strings; the
type ``X`` is a wildcard.

Lookup semantics: the most specific entry wins (fewest wildcards); ties
prefer the query's own atom order over the reversed order (bonds, angles,
dihedrals) or over center-preserving permutations (impropers, center fixed
at the third slot), and within one ordering prefer wildcards in trailing
positions. Implementation here parses each section's keys into type tuples
once and probes that table with lazily generated patterns — equivalent
semantics, table-driven rather than the reference's string-formatting probe.
"""

from __future__ import annotations

from itertools import combinations, permutations
from math import radians

import numpy as np
import yaml

from .forcefield import _ForceFieldBase

WILDCARD = "X"


def _parse_key(key) -> tuple:
    """A section key — "(T1, T2)" or a bare type name — as a type tuple."""
    text = str(key).strip()
    if text.startswith("(") and text.endswith(")"):
        return tuple(part.strip() for part in text[1:-1].split(","))
    return (text,)


def _orderings(term, types):
    """Every atom ordering under which `term` may be stored, preference
    order first."""
    yield types
    if term in ("bonds", "angles", "dihedrals"):
        yield types[::-1]
    elif term == "impropers":
        # Center atom stays third; the outer three may appear in any order.
        for idx in permutations((0, 1, 3)):
            if idx == (0, 1, 3):
                continue  # identity already yielded
            i, j, k = idx
            yield (types[i], types[j], types[2], types[k])


def _with_wildcards(order, count):
    """All patterns replacing `count` positions of `order` with the
    wildcard, trailing positions first (the reference's tie-break order)."""
    slots = range(len(order))
    for chosen in reversed(list(combinations(slots, count))):
        yield tuple(
            WILDCARD if pos in chosen else typ for pos, typ in enumerate(order)
        )


class YamlForcefield(_ForceFieldBase):
    """Force-field parameter source backed by a YAML file or parsed dict."""

    def __init__(self, mol, prm):
        self.mol = mol
        if isinstance(prm, str):
            with open(prm) as fh:
                self.prm = yaml.safe_load(fh)
        else:
            self.prm = dict(prm)
        self._tables: dict[str, dict] = {}

    def _table(self, term) -> dict:
        """Section entries keyed by parsed type tuple (built once)."""
        table = self._tables.get(term)
        if table is None:
            section = self.prm.get(term) or {}
            table = {_parse_key(k): v for k, v in section.items()}
            self._tables[term] = table
        return table

    def get_parameters(self, term, atomtypes):
        """Most-specific matching entry for `atomtypes` in section `term`."""
        table = self._table(term)
        query = tuple(atomtypes)
        orders = list(_orderings(term, query))
        for nwild in range(len(query) + 1):
            for order in orders:
                for pattern in _with_wildcards(order, nwild):
                    if pattern in table:
                        return table[pattern]
        raise RuntimeError(
            f"{list(atomtypes)} doesn't have {term} information in the FF"
        )

    # --- _ForceFieldBase getters -------------------------------------

    def get_atom_types(self):
        return np.unique(self.prm["atomtypes"])

    def get_charge(self, at):
        return self.get_parameters("electrostatics", [at])["charge"]

    def get_mass(self, at):
        return self.prm["masses"][at]

    def get_LJ(self, at):
        entry = self.get_parameters("lj", [at])
        return entry["sigma"], entry["epsilon"]

    def get_polarizability(self, at):
        """Optional Drude section `polarizabilities: {TYPE: {alpha: A^3,
        thole: a}}` (or a bare alpha number per type). Returns
        (alpha, thole_or_None); (0.0, None) for non-polarizable types."""
        table = self.prm.get("polarizabilities") or {}
        entry = table.get(at)
        if entry is None:
            return 0.0, None
        if isinstance(entry, dict):
            return float(entry.get("alpha", 0.0)), entry.get("thole")
        return float(entry), None

    def get_bond(self, at1, at2):
        entry = self.get_parameters("bonds", [at1, at2])
        return entry["k0"], entry["req"]

    def get_angle(self, at1, at2, at3):
        entry = self.get_parameters("angles", [at1, at2, at3])
        return entry["k0"], radians(entry["theta0"])

    def get_dihedral(self, at1, at2, at3, at4):
        entry = self.get_parameters("dihedrals", [at1, at2, at3, at4])
        return [
            [t["phi_k"], radians(t["phase"]), t["per"]] for t in entry["terms"]
        ]

    def get_14(self, at1, at2, at3, at4):
        dih = self.get_parameters("dihedrals", [at1, at2, at3, at4])
        end1 = self.get_parameters("lj", [at1])
        end4 = self.get_parameters("lj", [at4])
        return (
            dih.get("scnb", 1),
            dih.get("scee", 1),
            end1["sigma14"],
            end1["epsilon14"],
            end4["sigma14"],
            end4["epsilon14"],
        )

    def get_improper(self, at1, at2, at3, at4):
        entry = self.get_parameters("impropers", [at1, at2, at3, at4])
        return entry["phi_k"], radians(entry["phase"]), entry["per"]

    def get_cmap(self, *types8):
        """(n, n) CMAP grid for an 8-type cross-term key, or None. Schema
        extension (native; the reference YAML format has no CMAP):

            cmap:
              "(C, NH1, CA, C, NH1, CA, C, NH1)":
                resolution: 24
                values: [...]   # n*n kcal/mol, phi-major from -180 deg
        """
        table = self._table("cmap")
        key = tuple(types8)
        rev = tuple(reversed(key[:4])) + tuple(reversed(key[4:]))
        for k in (key, rev):
            entry = table.get(k)
            if entry is not None:
                n = int(entry["resolution"])
                vals = np.asarray(entry["values"], dtype=np.float64)
                if vals.size != n * n:
                    raise ValueError(
                        f"cmap {k}: {vals.size} values != {n}x{n}"
                    )
                return vals.reshape(n, n)
        return None
