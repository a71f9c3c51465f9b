"""Run-loop utilities: CSV metric monitors, config-file handling for the
CLI, and trajectory export.

The port's own copy of `torchmd_tpu.utils`; it imports nothing of the JAX
package.

Behavior spec from the reference (torchmd/utils.py:10-93): a per-replica
``monitor_{k}.csv`` with a trailing wall-time column, a ``--conf`` argparse
action that merges YAML or ``key=value`` files into the namespace, a
resolved-config dump, and an npy→xyz converter. Beyond the reference, the
monitor supports append mode so ``--resume`` continues history instead of
truncating it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import yaml


class LogWriter:
    """Appends rows of run metrics to a flushed CSV file.

    Columns are the caller's `keys` plus a trailing wall-clock column ``t``
    (seconds since the writer opened). Every row is flushed immediately so a
    crashed run keeps its history. With ``append=True`` a non-empty existing
    file is continued without rewriting the header (used on --resume);
    otherwise the file is recreated.
    """

    def __init__(self, path, keys, header="", name="monitor.csv",
                 append=False):
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, name)
        continuing = (
            append and os.path.isfile(target) and os.path.getsize(target) > 0
        )
        self._fields = list(keys) + ["t"]
        self._fh = open(target, "a" if continuing else "w", newline="")
        self._csv = csv.DictWriter(self._fh, fieldnames=self._fields)
        self._t0 = time.time()
        if not continuing:
            if isinstance(header, dict):
                self._fh.write("# {} \n".format(json.dumps(header)))
            elif header:
                self._fh.write(header)
            self._csv.writeheader()
            self._fh.flush()

    # kept as attributes for duck-type compatibility with older callers
    @property
    def keys(self):
        return tuple(self._fields)

    def write_row(self, row):
        stamped = dict(row)
        stamped["t"] = time.time() - self._t0
        self._csv.writerow(stamped)
        self._fh.flush()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LoadFromFile(argparse.Action):
    """``--conf FILE`` argparse action: merge settings from FILE into the
    namespace. ``.yaml``/``.yml`` files update it wholesale; anything else
    is read as ``key=value`` lines (blank lines and ``#`` comments are
    skipped), each value coerced to the type of the flag's current value."""

    def __call__(self, parser, namespace, values, option_string=None):
        fh = open(values) if isinstance(values, str) else values
        with fh:
            text = fh.read()
            filename = getattr(fh, "name", str(values))
        if filename.endswith((".yaml", ".yml")):
            for key, val in (yaml.safe_load(text) or {}).items():
                setattr(namespace, key, val)
            return
        if filename.endswith(".mdp"):
            # GROMACS run parameters: translate the common subset
            from .io.mdp import mdp_to_args, read_mdp

            for key, val in mdp_to_args(
                read_mdp(text, is_text=True)
            ).items():
                setattr(namespace, key, val)
            return
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition("=")
            key, val = key.strip(), val.strip()
            current = getattr(namespace, key, None)
            setattr(namespace, key,
                    type(current)(val) if current is not None else val)


class AsyncWriter:
    """Single background thread draining an ordered queue of write
    closures: trajectory/monitor IO overlaps the next chunk of steps
    instead of serializing with it. The closures touch only host numpy
    copies. Ordering is preserved (one worker). Worker exceptions surface
    on the next submit() or on close()."""

    def __init__(self, maxsize=64):
        import queue
        import threading

        self._q = queue.Queue(maxsize=maxsize)
        self._err = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="tmd-async-writer"
        )
        self._thread.start()

    def _loop(self):
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                if self._err is None:
                    fn()
            except Exception as e:  # re-raised on the submitting thread
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, fn):
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        self._q.put(fn)

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_argparse(args, filename, exclude=None):
    """Persist the resolved run configuration (the reference writes
    ``log_dir/input.yaml``) so a run is reproducible from its output dir."""
    if isinstance(exclude, str):
        exclude = [exclude]
    skip = set(exclude or ())
    entries = {k: v for k, v in vars(args).items() if k not in skip}
    with open(filename, "w") as fh:
        if filename.endswith((".yaml", ".yml")):
            yaml.dump(entries, fh)
        else:
            fh.writelines(f"{key}={val}\n" for key, val in entries.items())


def xyz_writer(input_file, output_file, mol_elements):
    """Append an ``(natoms, 3, nframes)`` .npy trajectory to `output_file`
    in xyz format, one block per frame."""
    traj = np.load(input_file)
    natoms = traj.shape[0]
    with open(output_file, "a") as fh:
        for frame in np.moveaxis(traj, 2, 0):
            fh.write(f"{natoms}\n\n")
            for element, xyz in zip(mol_elements, frame):
                coords = " ".join(str(c) for c in xyz)
                fh.write(f"{element} {coords}\n")
