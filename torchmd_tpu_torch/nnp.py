"""A compact, trainable neural-network potential, the port of
`torchmd_tpu.nnp`.

A SchNet-flavoured radial model that ships with the package, so the whole
workflow (train a potential, plug it into the Integrator as an external
term, run MD) needs nothing else:

    d_ij      : masked pair distances within `cutoff` (dense (n, n))
    phi_ij    : Gaussian radial basis x smooth cosine cutoff  (n, n, n_rbf)
    m_i       : sum_j ( phi_ij @ W_rbf + b ) * embed(z_j)     (messages)
    E_i       : MLP([m_i, embed(z_i)]) with SiLU
    E         : sum_i E_i

Energies in kcal/mol, distances in A, so it composes with the MM terms.
`NNP` is an `nn.Module` whose parameters are the JAX package's params
leaves under the same names and layouts (dense weights (nin, nout)), so
`interop.nnp_params_from_numpy` carries JAX weights across; `train_nnp`
takes `torch.optim.Adam`, whose update is optax.adam's (eps added outside
sqrt(v_hat)). The pair tensors are (n, n, features): at 4,676 atoms and
the default width ~2.8 GB each in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from .external import TorchExternal
from .potentials import wrap_displacement
from .systems import resolve_device

__all__ = ["NNPConfig", "NNP", "init_params", "nnp_energy", "NNPExternal", "train_nnp"]


class NNPConfig(NamedTuple):
    n_species: int
    cutoff: float = 5.0
    n_rbf: int = 16
    features: int = 32
    hidden: int = 64


def _dense(w, b):
    return nn.ParameterDict({"w": nn.Parameter(w), "b": nn.Parameter(b)})


class NNP(nn.Module):
    """The model's parameters (embed, rbf_proj, mlp1, mlp2, out,
    rbf_centers, rbf_gamma: every one trained, as in the JAX package) and
    its energy, `forward(species, pos, box=None)`. pos (..., n, 3) gives
    energies of shape (...); box (3,) or (..., 3), a component <= 0 (or
    None) meaning no wrap along that axis."""

    def __init__(self, cfg: NNPConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        for name in ("rbf_proj", "mlp1", "mlp2", "out"):
            setattr(self, name, _dense(params[name]["w"], params[name]["b"]))
        self.rbf_centers = nn.Parameter(params["rbf_centers"])
        self.rbf_gamma = nn.Parameter(params["rbf_gamma"])

    def forward(self, species, pos, box=None):
        cfg = self.cfg
        n = pos.shape[-2]
        dv = pos[..., :, None, :] - pos[..., None, :, :]
        if box is not None:
            box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
            dv = wrap_displacement(dv, box.reshape(box.shape[:-1] + (1, 1, 3)))
        d2 = (dv * dv).sum(-1)
        eye = torch.eye(n, dtype=torch.bool, device=pos.device)
        d2 = torch.where(eye, torch.ones_like(d2), d2)
        d = torch.sqrt(d2)
        within = ~eye & (d < cfg.cutoff)

        # radial basis with smooth cosine cutoff
        rbf = torch.exp(-self.rbf_gamma * (d[..., None] - self.rbf_centers) ** 2)
        fcut = 0.5 * (torch.cos(math.pi * torch.clamp(d / cfg.cutoff, 0, 1)) + 1.0)
        phi = rbf * (fcut * within.to(pos.dtype))[..., None]     # (..., n, n, n_rbf)

        emb = self.embed[species]                                  # (n, f)
        msg = phi @ self.rbf_proj["w"] + self.rbf_proj["b"]        # (..., n, n, f)
        m_i = (msg * emb).sum(-2)                                  # (..., n, f)
        x = torch.cat([m_i, emb.expand(m_i.shape)], dim=-1)
        x = nn.functional.silu(x @ self.mlp1["w"] + self.mlp1["b"])
        x = nn.functional.silu(x @ self.mlp2["w"] + self.mlp2["b"])
        return (x @ self.out["w"] + self.out["b"])[..., 0].sum(-1)


def init_params(cfg: NNPConfig, generator=None, seed=0, dtype=torch.float64,
                device=None) -> NNP:
    """A model with random weights drawn from `generator` (or one seeded
    with `seed`) on `device` (default the CUDA card): the JAX package's
    scheme (normal / sqrt(nin) weights, zero biases, 0.1 x normal
    embeddings), not its random stream."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    f, h, r = cfg.features, cfg.hidden, cfg.n_rbf

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype, device=device)

    def dense(nin, nout):
        return {"w": normal(nin, nout) / math.sqrt(nin),
                "b": torch.zeros(nout, dtype=dtype, device=device)}

    return NNP(cfg, {
        "embed": 0.1 * normal(cfg.n_species, f),
        "rbf_proj": dense(r, f), "mlp1": dense(2 * f, h), "mlp2": dense(h, h),
        "out": dense(h, 1),
        "rbf_centers": torch.linspace(0.5, cfg.cutoff, r, dtype=dtype, device=device),
        "rbf_gamma": torch.tensor(10.0 / cfg.cutoff, dtype=dtype, device=device)})


def nnp_energy(params: NNP, cfg: NNPConfig, species, pos, box=None):
    """Total energy of one conformation (or of a batch, pos (B, n, 3)).
    species: (natoms,) int indices into the embedding table. `cfg` must be
    the model's own."""
    if cfg != params.cfg:
        raise ValueError(f"config {cfg} is not the model's {params.cfg}")
    return params(species, pos, box)


class NNPExternal(TorchExternal):
    """The external-potential protocol for a (trained) NNP: `energy_fn`
    folds into `Forces` (forces by autograd), `calculate` serves the
    batched host API."""

    def __init__(self, params: NNP, cfg: NNPConfig, species):
        self.params = params
        self.cfg = cfg
        self.species = torch.as_tensor(species, dtype=torch.int64,
                                       device=params.embed.device)
        super().__init__(lambda pos, box: nnp_energy(params, cfg, self.species, pos, box))


def train_nnp(params: NNP, cfg: NNPConfig, species, pos_batch, e_ref, f_ref,
              steps=200, learning_rate=1e-3, force_weight=1.0, box=None,
              callback=None):
    """Joint energy + force matching with Adam: pos_batch (B, n, 3), e_ref
    (B,), f_ref (B, n, 3) on the model's device. Trains `params` in place;
    returns (params, loss history), the loss read on the host each step
    as the JAX package reads it."""
    dev, dt = params.embed.device, params.embed.dtype

    def tensor(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    species = torch.as_tensor(species, dtype=torch.int64, device=dev)
    pos_batch, e_ref, f_ref = tensor(pos_batch), tensor(e_ref), tensor(f_ref)
    box_b = (torch.zeros((pos_batch.shape[0], 3), dtype=dt, device=dev) if box is None
             else tensor(box).expand(pos_batch.shape[0], 3))
    opt = torch.optim.Adam(params.parameters(), lr=learning_rate)
    history = []
    for i in range(steps):
        x = pos_batch.detach().requires_grad_(True)
        E = params(species, x, box_b)
        (g,) = torch.autograd.grad(E.sum(), x, create_graph=True)
        loss = ((E - e_ref) ** 2).mean() + force_weight * ((-g - f_ref) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
        if callback is not None:
            callback(i, history[-1])
    return params, history
