"""GROMACS .mdp run-parameter translation.

The port's own copy of `torchmd_tpu.io.mdp`; it imports nothing of the JAX
package.

New capability beyond the reference: a GROMACS user's third input file
(besides .top and .gro) is the .mdp run config. `--conf md.mdp` translates
the common subset onto the CLI namespace so the standard GROMACS triple
drives a run directly:

    python -m torchmd_tpu_torch.run --conf md.mdp \
        --topology topol.top --coordinates conf.gro --forcefield topol.top

Covered keys: integrator (md/md-vv/sd/steep), dt, nsteps, nstenergy /
nstlog -> output-period, nstxout(-compressed) -> save-period, rvdw /
rcoulomb -> cutoff, rvdw-switch (+ vdw-modifier *switch*) -> switch_dist,
coulombtype (PME / Ewald / Reaction-Field / Cut-off), epsilon-rf, tcoupl
(v-rescale -> csvr, nose-hoover -> nhc, berendsen -> csvr with a warning),
ref-t / tau-t (first group), gen-vel / gen-temp, pcoupl (berendsen /
C-rescale -> MC barostat; Parrinello-Rahman / MTTK -> MTK), ref-p,
constraints (h-bonds -> settle, all-bonds -> allbonds), ld-seed/gen-seed,
define (-DPOSRES... -> TMD_GMX_DEFINES). Unknown keys are ignored (the
.mdp namespace is huge); unit conversions are ps -> fs and nm -> Angstrom.
"""

from __future__ import annotations

import os


def read_mdp(path_or_text, is_text=False):
    """Parse .mdp `key = value` lines -> {normalized_key: raw value str}.
    Keys are lowercased with '_' -> '-' (GROMACS treats them the same)."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as fh:
            text = fh.read()
    out = {}
    for raw in text.splitlines():
        line = raw.split(";", 1)[0].strip()
        if not line or line.startswith(("#", "[")):
            continue
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        key = key.strip().lower().replace("_", "-")
        out[key] = val.strip()
    return out


def _f(val):
    return float(str(val).split()[0])


def _i(val):
    return int(float(str(val).split()[0]))


def mdp_to_args(mdp: dict, warn=print) -> dict:
    """Translate a parsed .mdp dict into run.py namespace attributes."""
    args: dict = {}

    integrator = mdp.get("integrator", "md").lower()
    if integrator in ("steep", "cg", "l-bfgs"):
        # an energy-minimization .mdp: map onto the CLI minimizer
        args["minimize"] = _i(mdp.get("nsteps", 1000))
        args["steps"] = 0
        args["temperature"] = 0.0

    if "dt" in mdp:
        args["timestep"] = _f(mdp["dt"]) * 1000.0  # ps -> fs
    if "nsteps" in mdp and "steps" not in args:
        args["steps"] = _i(mdp["nsteps"])
    for k in ("nstenergy", "nstlog"):
        if k in mdp and _i(mdp[k]) > 0:
            args["output_period"] = _i(mdp[k])
            break
    for k in ("nstxout-compressed", "nstxout"):
        if k in mdp and _i(mdp[k]) > 0:
            args["save_period"] = _i(mdp[k])
            break

    rvdw = _f(mdp["rvdw"]) if "rvdw" in mdp else None
    rcoul = _f(mdp["rcoulomb"]) if "rcoulomb" in mdp else None
    if rvdw is not None or rcoul is not None:
        cut = max(v for v in (rvdw, rcoul) if v is not None)
        if rvdw is not None and rcoul is not None and rvdw != rcoul:
            warn(f"mdp: rvdw={rvdw} != rcoulomb={rcoul}; using {cut} nm "
                 "for the shared cutoff")
        args["cutoff"] = cut * 10.0
    vdw_mod = mdp.get("vdw-modifier", "").lower()
    if "switch" in vdw_mod or "switch" in mdp.get("vdwtype", "").lower():
        if "rvdw-switch" in mdp and _f(mdp["rvdw-switch"]) > 0:
            args["switch_dist"] = _f(mdp["rvdw-switch"]) * 10.0

    coulomb = mdp.get("coulombtype", "cut-off").lower().replace("_", "-")
    if coulomb in ("pme", "pme-switch", "pme-user"):
        args["elec"] = "pme"
    elif coulomb == "ewald":
        args["elec"] = "ewald"
    elif coulomb in ("reaction-field", "reaction-field-zero",
                     "generalized-reaction-field"):
        args["rfa"] = True
        if "epsilon-rf" in mdp:
            eps = _f(mdp["epsilon-rf"])
            args["solvent_dielectric"] = 78.5 if eps == 0 else eps

    tcoupl = mdp.get("tcoupl", "no").lower()
    ref_t = _f(mdp["ref-t"]) if "ref-t" in mdp else None
    tau_t = _f(mdp["tau-t"]) if "tau-t" in mdp else None
    if integrator in ("sd", "sd1"):
        # GROMACS stochastic dynamics: friction gamma = 1/tau-t [1/ps]
        args["thermostat"] = "langevin"
        if ref_t is not None:
            args["langevin_temperature"] = ref_t
        if tau_t:
            args["langevin_gamma"] = 1.0 / tau_t
    elif tcoupl in ("v-rescale", "berendsen", "nose-hoover"):
        if tcoupl == "berendsen":
            warn("mdp: berendsen tcoupl has no equivalent (flawed "
                 "ensemble); using the v-rescale (CSVR) thermostat")
        args["thermostat"] = ("nhc" if tcoupl == "nose-hoover" else "csvr")
        if ref_t is not None:
            args["langevin_temperature"] = ref_t
        if tau_t:
            args["thermostat_tau"] = tau_t * 1000.0  # ps -> fs

    if mdp.get("gen-vel", "no").lower() == "yes":
        args["temperature"] = _f(mdp.get("gen-temp", ref_t or 300.0))
    else:
        # GROMACS continuation semantics: keep the coordinate file's
        # velocities when it carries them (run.py checks availability)
        args["use_file_velocities"] = True
        if ref_t is not None and "temperature" not in args:
            args["temperature"] = ref_t
    for k in ("ld-seed", "gen-seed"):
        if k in mdp and _i(mdp[k]) > 0:
            args["seed"] = _i(mdp[k])
            break

    pcoupl = mdp.get("pcoupl", "no").lower()
    if pcoupl not in ("no", ""):
        if "ref-p" in mdp:
            args["pressure"] = _f(mdp["ref-p"])  # bar in, bar out
        if pcoupl in ("parrinello-rahman", "mttk"):
            args["barostat_mode"] = "mtk"

    cons = mdp.get("constraints", "none").lower()
    if cons == "h-bonds":
        # rigid waters ride SETTLE, remaining hydrogen bonds SHAKE --
        # the framework's 'settle' mode is exactly GROMACS h-bonds+settle
        args["constraints"] = "settle"
    elif cons == "all-bonds":
        args["constraints"] = "allbonds"

    if "disre-fc" in mdp:
        args["disre_fc"] = _f(mdp["disre-fc"])

    if "define" in mdp:
        names = [tok[2:] for tok in mdp["define"].split()
                 if tok.startswith("-D")]
        if names:
            # carried on the namespace; run.py applies them scoped to the
            # topology parse (a process-global env mutation would leak
            # POSRES/FLEXIBLE into every later parse in the same process)
            args["gmx_defines"] = names

    return args
