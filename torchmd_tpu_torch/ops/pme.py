"""PME charge spreading and ik force gathering: the CUDA kernels, their
plain PyTorch versions, and the wrappers that pick between them by device.

Counterpart of `torchmd_tpu/ops/pallas_pme.py` (`pme_spread` and
`pme_gather_ik`). The contract is the TPU kernels' function, computed from
positions rather than from dense tap rows: each atom's order-p cardinal
B-spline weights per axis, tap t landing on grid point floor(u) - t
(mod K) for the scaled coordinate u = frac(r / L) * K, and

    spread:  mesh[x, y, z] = sum_i q_i Mx_i(x) My_i(y) Mz_i(z)
    gather:  F_i,a = -q_i sum_xyz Mx_i(x) My_i(y) Mz_i(z) dphi_a[x, y, z]

with dphi_a the three spectral-derivative grids of the convolved potential
(built with torch.fft in `ewald.PmeRecip`). Orders 4 and 6.

`pme_spread` / `pme_gather_ik` run the plain version for a CPU tensor and
launch the kernel (`csrc/pme.cu`) for a CUDA tensor; on a CUDA tensor
they launch or raise. The spread takes an optional order of the atoms in
space (`order_idx`, e.g. a cell list's slots), along which the kernel sums
chunks of nearby atoms in shared memory first; without one the kernel
adds each atom's taps straight to the mesh. The function does not depend
on it. The gather takes a thread an atom and skips zero charges.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Kernel launches made by `pme_spread` and `pme_gather_ik` (one per call
# on CUDA).
SPREAD_LAUNCHES = 0
GATHER_LAUNCHES = 0

ORDERS = (4, 6)
CHUNK = 512      # order entries per spread block at most (csrc/pme.cu CHUNK)
SPREAD_STATS = ("global_atomics", "brick_chunks", "direct_chunks",
                "charged_atoms")  # the spread's counters (`stats=`)
GATHER_STATS = ("charged_atoms", "zero_charge_atoms")  # the gather's counters (`stats=`)


def bspline_weights(frac, n):
    """M_n(frac + t) for t = 0..n-1, frac in [0, 1); returns (..., n).

    Cox-de Boor recursion on the n points u_t = frac + t, whose shifted
    term M_{k-1}(u_t - 1) is M_{k-1}(u_{t-1}), a slot shift."""
    u = frac[..., None] + torch.arange(n, dtype=frac.dtype, device=frac.device)
    m = torch.clamp(1.0 - torch.abs(u - 1.0), min=0.0)  # M_2, support [0, 2)
    for k in range(3, n + 1):
        prev = torch.cat([torch.zeros_like(m[..., :1]), m[..., :-1]], dim=-1)
        m = (u / (k - 1)) * m + ((k - u) / (k - 1)) * prev
    return m


def bspline_dweights(frac, n):
    """d/dfrac of `bspline_weights` by the recursion M_n'(u) = M_{n-1}(u)
    - M_{n-1}(u - 1): lower-order spline values, exact at the knots (an
    atom on a mesh node), where differentiating the recursion is not."""
    wm1 = bspline_weights(frac, n - 1)
    pad = torch.zeros_like(wm1[..., :1])
    return torch.cat([wm1, pad], dim=-1) - torch.cat([pad, wm1], dim=-1)


def spline_taps(pos, box, kmesh, order, deriv=False):
    """Per-atom taps: weights w (N, 3, order) (tap t on grid point
    floor(u) - t), flat mesh indices (N, order, order, order) and, with
    `deriv`, the weights' derivatives wrt the coordinate (N, 3, order)."""
    K = torch.as_tensor(kmesh, dtype=pos.dtype, device=pos.device)
    u = pos / box
    u = (u - torch.floor(u)) * K
    base = torch.floor(u)
    frac = u - base
    Ki = torch.as_tensor(kmesh, device=pos.device)[:, None]
    idx = torch.remainder(base.long()[..., None]
                          - torch.arange(order, device=pos.device), Ki)
    ky, kz = kmesh[1], kmesh[2]
    flat = ((idx[:, 0, :, None, None] * ky + idx[:, 1, None, :, None]) * kz
            + idx[:, 2, None, None, :])
    w = bspline_weights(frac, order)
    if not deriv:
        return w, flat
    return w, flat, bspline_dweights(frac, order) * (K / box)[:, None]


def tap_products(q, w):
    """(N, order, order, order) q_i Mx My Mz."""
    return (q[:, None, None, None] * w[:, 0, :, None, None]
            * w[:, 1, None, :, None] * w[:, 2, None, None, :])


# ----------------------------------------------------------------------
# Plain PyTorch versions
# ----------------------------------------------------------------------

def spread_reference(pos, q, box, kmesh, order, order_idx=None):
    """Plain version of the spread kernel: one scatter-add of the N*p^3
    tap products. Returns the (Kx, Ky, Kz) mesh at pos's dtype. The
    atoms' order (`order_idx`) changes only the kernel's schedule: it is
    not read here."""
    w, flat = spline_taps(pos, box, kmesh, order)
    mesh = torch.zeros(kmesh[0] * kmesh[1] * kmesh[2], dtype=pos.dtype,
                       device=pos.device)
    mesh.index_add_(0, flat.reshape(-1), tap_products(q.to(pos.dtype), w).reshape(-1))
    return mesh.reshape(kmesh)


def gather_ik_reference(pos, q, box, grids, order):
    """Plain version of the ik gather kernel: forces (N, 3) from the three
    derivative grids at each atom's p^3 taps."""
    kmesh = tuple(grids[0].shape)
    w, flat = spline_taps(pos, box, kmesh, order)
    wq = tap_products(q.to(pos.dtype), w).reshape(pos.shape[0], -1)
    flat = flat.reshape(pos.shape[0], -1)
    return -torch.stack([(wq * g.reshape(-1)[flat]).sum(1) for g in grids], dim=1)


# ----------------------------------------------------------------------
# CUDA kernels
# ----------------------------------------------------------------------

class PmeCfg(ctypes.Structure):
    """Mirror of `struct PmeCfg` in csrc/pme.cu."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("natoms", "kx", "ky", "kz", "order", "rows", "width", "nsub")]


_P = ctypes.c_void_p
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("pme")
        lib.tmd_pme_spread.argtypes = [_P] * 4 + [PmeCfg] + [_P] * 3
        lib.tmd_pme_spread.restype = ctypes.c_int
        lib.tmd_pme_gather_ik.argtypes = [_P] * 3 + [PmeCfg] + [_P] * 6
        lib.tmd_pme_gather_ik.restype = ctypes.c_int
        lib.tmd_error_string.argtypes = [ctypes.c_int]
        lib.tmd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build():
    """Compile and load the kernel library (done at first launch anyway)."""
    _library()


def _checked_cfg(pos, q, box, kmesh, order) -> PmeCfg:
    if order not in ORDERS:
        raise ValueError(f"the PME kernels take spline orders {ORDERS}, not {order}")
    n, dev, f32 = pos.shape[0], pos.device, torch.float32
    _build.check_tensor(pos, "pos", f32, (n, 3), dev)
    _build.check_tensor(q, "q", f32, (n,), dev)
    _build.check_tensor(box, "box", f32, (3,), dev)
    return PmeCfg(natoms=n, kx=kmesh[0], ky=kmesh[1], kz=kmesh[2], order=order)


def _check(err, what):
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {_library().tmd_error_string(err).decode()}")


def spread_rows(order_idx):
    """(rows, width, nsub) of the spread's order: a (rows, width) table of
    atom ids, or a flat one (one row), each row cut into nsub chunks of at
    most CHUNK entries; (0, 0, 0) for the input order (None), where the
    kernel takes a thread an atom."""
    if order_idx is None:
        return 0, 0, 0
    if order_idx.dim() == 1:
        rows, width = 1, int(order_idx.shape[0])
    else:
        rows, width = (int(v) for v in order_idx.shape)
    return rows, width, max(1, -(-width // CHUNK))


def pme_spread(pos, q, box, kmesh, order, order_idx=None, stats=None):
    """pos (N, 3), q (N,), box (3,) diagonal -> the (Kx, Ky, Kz) mesh.
    `order_idx`: None, or int32 atom ids, flat or (rows, width), in which
    consecutive entries are atoms close in space and ids >= N are padding;
    every atom must appear exactly once. A CPU tensor runs the plain
    version (which ignores the order); a CUDA tensor launches the spread
    kernel (f32 only) or raises. `stats`, an int64 (4,) card tensor, gains
    the kernel's counters (SPREAD_STATS)."""
    global SPREAD_LAUNCHES
    if pos.device.type == "cpu":
        return spread_reference(pos, q, box, kmesh, order, order_idx)
    if pos.device.type != "cuda":
        raise ValueError(f"no PME spread kernel for device {pos.device}")
    cfg = _checked_cfg(pos, q, box, kmesh, order)
    if order_idx is not None:
        if order_idx.dim() not in (1, 2):
            raise ValueError(f"order_idx has shape {tuple(order_idx.shape)}, want 1-D or 2-D")
        _build.check_tensor(order_idx, "order_idx", torch.int32, tuple(order_idx.shape),
                            pos.device)
    cfg.rows, cfg.width, cfg.nsub = spread_rows(order_idx)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (len(SPREAD_STATS),), pos.device)
    mesh = torch.empty(tuple(kmesh), dtype=torch.float32, device=pos.device)
    _check(_library().tmd_pme_spread(
        pos.data_ptr(), q.data_ptr(), box.data_ptr(),
        None if order_idx is None else order_idx.data_ptr(), cfg, mesh.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream), "PME spread")
    SPREAD_LAUNCHES += 1
    return mesh


def pme_gather_ik(pos, q, box, grids, order, stats=None):
    """pos (N, 3), q (N,), box (3,), grids: the three (Kx, Ky, Kz)
    derivative grids -> forces (N, 3). A CPU tensor runs the plain
    version; a CUDA tensor launches the gather kernel (f32 only) or
    raises. `stats`, an int64 (2,) card tensor, gains the kernel's
    counters (GATHER_STATS)."""
    global GATHER_LAUNCHES
    if pos.device.type == "cpu":
        return gather_ik_reference(pos, q, box, grids, order)
    if pos.device.type != "cuda":
        raise ValueError(f"no PME gather kernel for device {pos.device}")
    kmesh = tuple(grids[0].shape)
    cfg = _checked_cfg(pos, q, box, kmesh, order)
    for a, g in enumerate(grids):
        _build.check_tensor(g, f"grid {a}", torch.float32, kmesh, pos.device)
    if stats is not None:
        _build.check_tensor(stats, "stats", torch.int64, (len(GATHER_STATS),), pos.device)
    forces = torch.empty((pos.shape[0], 3), dtype=torch.float32, device=pos.device)
    _check(_library().tmd_pme_gather_ik(
        pos.data_ptr(), q.data_ptr(), box.data_ptr(), cfg,
        *(g.data_ptr() for g in grids), forces.data_ptr(),
        None if stats is None else stats.data_ptr(),
        torch.cuda.current_stream(pos.device).cuda_stream), "PME gather")
    GATHER_LAUNCHES += 1
    return forces
