"""Carry weights and algorithm state from the JAX package into the port.

The port cannot import JAX, so the caller hands over the leaves as numpy
arrays (``numpy.asarray`` of each JAX array).  The flat layouts are the same
in both packages, so a converted state or parameter vector means the same
thing on either side.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admm import AFadmmState
from repro_torch.core.channel import ChannelBlock
from repro_torch.core.cplx import Complex
from repro_torch.core.tree_ota import TreeChannel, TreeFLState
from repro_torch.device import resolve_device
from repro_torch.faults.plan import FaultState
from repro_torch.models.mlp import Unflatten, mlp_unflatten
from repro_torch.optim.optimizers import OptState
from repro_torch.phy.scenario import PhyState
from repro_torch.tree import tree_map

#: leaves of an ``AFadmmState`` as :func:`afadmm_state_from_numpy` takes them
#: (plus optional ``phys`` and ``flt`` entries under a scenario and a fault
#: plan)
STATE_KEYS = ("theta", "lam_re", "lam_im", "Theta", "h_re", "h_im",
              "h_prev_re", "h_prev_im", "changed", "age", "step")
#: leaves of a ``PhyState`` as :func:`phy_state_from_numpy` takes them; only
#: ``h_re``, ``h_im`` and ``age`` are required, as in the JAX state
PHY_KEYS = ("h_re", "h_im", "h_small_re", "h_small_im", "h_hat_re",
            "h_hat_im", "gain", "shadow", "pos", "dest", "mask", "age")
#: leaves of a ``FaultState`` as :func:`fault_state_from_numpy` takes them;
#: ``stale`` may be missing or None (no stragglers)
FAULT_KEYS = ("alive", "stale", "round", "n_evicted")


def phy_state_from_numpy(d: Mapping[str, Optional[np.ndarray]],
                         device="cuda") -> PhyState:
    """The port's ``PhyState`` from the JAX ``PhyState``'s leaves.

    ``d`` maps :data:`PHY_KEYS` to numpy arrays: h re/im (W, d), the
    optional h_small and h_hat re/im, gain and shadow (W,), pos and dest
    (W, 2), mask (W,) bool, and the int scalar ``age``.  A leaf that is
    missing or None is None in the port's state, as in JAX's."""
    missing = [k for k in ("h_re", "h_im", "age") if d.get(k) is None]
    if missing:
        raise KeyError(f"phy_state_from_numpy: missing leaves {missing}")
    unknown = sorted(set(d) - set(PHY_KEYS))
    if unknown:
        raise KeyError(f"phy_state_from_numpy: unknown leaves {unknown}")
    dev = resolve_device(device)

    def f32(k: str):
        v = d.get(k)
        return None if v is None else torch.tensor(np.asarray(v, np.float32),
                                                   device=dev)

    def cplx(k: str):
        re, im = f32(f"{k}_re"), f32(f"{k}_im")
        if (re is None) != (im is None):
            raise KeyError(f"phy_state_from_numpy: {k} needs both its _re "
                           f"and _im leaves")
        return None if re is None else Complex(re, im)

    mask = d.get("mask")
    return PhyState(
        h=cplx("h"), h_small=cplx("h_small"), h_hat=cplx("h_hat"),
        gain=f32("gain"), shadow=f32("shadow"), pos=f32("pos"),
        dest=f32("dest"),
        mask=None if mask is None else torch.tensor(np.asarray(mask, bool),
                                                    device=dev),
        age=int(d["age"]))


def fault_state_from_numpy(d: Mapping[str, Optional[np.ndarray]],
                           device="cuda") -> FaultState:
    """The port's ``FaultState`` from the JAX ``FaultState``'s leaves:
    ``alive`` (W,) bool, ``stale`` (W, d) or None, and the int scalars
    ``round`` and ``n_evicted``."""
    missing = [k for k in ("alive", "round", "n_evicted") if d.get(k) is None]
    if missing:
        raise KeyError(f"fault_state_from_numpy: missing leaves {missing}")
    unknown = sorted(set(d) - set(FAULT_KEYS))
    if unknown:
        raise KeyError(f"fault_state_from_numpy: unknown leaves {unknown}")
    dev = resolve_device(device)
    stale = d.get("stale")
    return FaultState(
        alive=torch.tensor(np.asarray(d["alive"], bool), device=dev),
        stale=None if stale is None else torch.tensor(
            np.asarray(stale, np.float32), device=dev),
        round=int(d["round"]),
        n_evicted=torch.tensor(int(d["n_evicted"]), dtype=torch.int32,
                               device=dev))


def afadmm_state_from_numpy(d: Mapping[str, np.ndarray],
                            device="cuda") -> AFadmmState:
    """The port's ``AFadmmState`` from the JAX state's leaves.

    ``d`` maps each of :data:`STATE_KEYS` to a numpy array: θ (W, d), λ
    re/im (W, d), Θ (d,), the block's h and h_prev re/im (W, d), ``changed``
    (W, d) bool, and the int scalars ``age`` and ``step``.  Under a
    scenario, ``d["phys"]`` holds the ``PhyState``'s leaves
    (:func:`phy_state_from_numpy`); under a fault plan, ``d["flt"]`` the
    ``FaultState``'s (:func:`fault_state_from_numpy`)."""
    missing = [k for k in STATE_KEYS if k not in d]
    if missing:
        raise KeyError(f"afadmm_state_from_numpy: missing leaves {missing}")
    dev = resolve_device(device)
    phys = d.get("phys")
    flt = d.get("flt")

    def f32(k: str) -> torch.Tensor:
        return torch.tensor(np.asarray(d[k], np.float32), device=dev)

    blk = ChannelBlock(
        h=Complex(f32("h_re"), f32("h_im")),
        h_prev=Complex(f32("h_prev_re"), f32("h_prev_im")),
        changed=torch.tensor(np.asarray(d["changed"], bool), device=dev),
        age=int(d["age"]))
    return AFadmmState(theta=f32("theta"), lam=Complex(f32("lam_re"),
                                                       f32("lam_im")),
                       Theta=f32("Theta"), blk=blk, step=int(d["step"]),
                       phys=None if phys is None
                       else phy_state_from_numpy(phys, device=dev),
                       flt=None if flt is None
                       else fault_state_from_numpy(flt, device=dev))


def mlp_flat_from_numpy(flat: np.ndarray, sizes: Sequence[int],
                        device="cuda") -> Tuple[torch.Tensor, Unflatten]:
    """(flat params, unflatten) from the JAX ``init_mlp_flat`` vector (or a
    (W, d) stack of them) with layer ``sizes``."""
    expect = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    if np.shape(flat)[-1] != expect:
        raise ValueError(f"mlp_flat_from_numpy: last dim {np.shape(flat)[-1]}"
                         f", layers {tuple(sizes)} need {expect}")
    dev = resolve_device(device)
    return (torch.tensor(np.asarray(flat, np.float32), device=dev),
            mlp_unflatten(sizes))


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """One array, dtype kept; bfloat16 (``ml_dtypes``, as JAX hands it
    over) travels as its 16 bits."""
    dev = resolve_device(device)
    a = np.array(a, order="C")          # a writable copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def model_params_from_numpy(tree: Mapping[str, Any], device="cuda"):
    """A nested dict of arrays (``numpy.asarray`` of each leaf of a JAX
    parameter tree, e.g. ``transformer.init_params``'s or the LLM trainer's
    worker-led θ) -> the same dict of tensors, dtypes kept."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, dev), dict(tree))


def tree_fl_state_from_numpy(theta: Mapping[str, Any],
                             Theta: Mapping[str, Any], lam_re, lam_im,
                             h_re=None, h_im=None, age: int = 0,
                             step: int = 0,
                             opt: Optional[Mapping[str, Any]] = None,
                             phys: Optional[Mapping[str, Any]] = None,
                             flt: Optional[Mapping[str, Any]] = None,
                             device="cuda") -> TreeFLState:
    """The port's ``TreeFLState`` from the JAX LLM trainer's state: θ
    (leaves (W, ...); (N, ...) for a population), Θ, λ and h, the channel's
    age and the step, and the local optimizer's ``{"mu", "nu", "count"}``
    (``nu`` None for sgd, whose second moment is the first's object, as in
    JAX).

    λ and h are the packed (W, D) planes, or, for the leafwise state
    (``packed_uplink=False``), nested dicts of per-leaf planes shaped as θ.
    Under a scenario ``phys`` holds the ``PhyState``'s leaves
    (:func:`phy_state_from_numpy`) and h and ``age`` are not read; under a
    fault plan ``flt`` holds the ``FaultState``'s
    (:func:`fault_state_from_numpy`)."""
    dev = resolve_device(device)

    def f32(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    def planes(re, im):
        if isinstance(re, Mapping):
            return tree_map(lambda r, i: Complex(f32(r), f32(i)), dict(re),
                            dict(im))
        return Complex(f32(re), f32(im))

    state_opt = None
    if opt is not None:
        mu = model_params_from_numpy(opt["mu"], dev)
        nu = mu if opt.get("nu") is None else model_params_from_numpy(
            opt["nu"], dev)
        state_opt = OptState(mu=mu, nu=nu, count=int(opt["count"]))
    if phys is not None:
        chan = phy_state_from_numpy(phys, device=dev)
    else:
        if h_re is None or h_im is None:
            raise KeyError("tree_fl_state_from_numpy: h_re and h_im are "
                           "needed without a scenario's phys")
        chan = TreeChannel(h=planes(h_re, h_im), age=int(age))
    return TreeFLState(theta=model_params_from_numpy(theta, dev),
                       lam=planes(lam_re, lam_im),
                       Theta=model_params_from_numpy(Theta, dev),
                       chan=chan, opt=state_opt, step=int(step),
                       flt=None if flt is None
                       else fault_state_from_numpy(flt, device=dev))


def shard_fl_state(state: TreeFLState, sspec, coords,
                   n_data: int) -> TreeFLState:
    """One mesh rank's part of a GLOBAL replicated-mode state (the JAX
    package's shard-global layout: θ and the optimizer moments (W, ...), Θ
    whole, λ, h and the straggler snapshot the shard-packed (W, d_pad)
    planes): the rows of the rank's workers, its (fsdp, model) shard of
    every leaf (``core.packing.shard_tree``) and its (W_local, d_local)
    block of each plane.  ``coords`` is the rank's
    ``tree_ota.ShardCoords``; ``n_data`` the data axes' rank count.  Global
    (W,) vectors (the fault state's ``alive``) stay whole; a scenario's
    ``PhyState`` keeps every worker's row and gives its per-element planes
    the rank's columns (:func:`phy_planes`).  The pieces are copies, so
    the global state can go."""
    from repro_torch.core.packing import shard_tree

    W = state.lam.re.shape[0]
    W_l = W // n_data
    rows = slice(coords.jd * W_l, (coords.jd + 1) * W_l)
    dl = sspec.d_local
    cols = slice(coords.j * dl, (coords.j + 1) * dl)

    def plane(x):
        return None if x is None else x[rows, cols].clone()

    def cplane(c):
        return Complex(plane(c.re), plane(c.im))

    def worker_tree(tree):
        return tree_map(lambda l: l[rows].clone(),
                        shard_tree(sspec, tree, coords.j))

    opt = state.opt
    if opt is not None:
        mu = worker_tree(opt.mu)
        nu = mu if opt.nu is opt.mu else worker_tree(opt.nu)
        opt = OptState(mu=mu, nu=nu, count=opt.count)
    flt = state.flt
    if flt is not None:
        flt = flt._replace(stale=plane(flt.stale))
    chan = state.chan
    if isinstance(chan, PhyState):
        chan = phy_planes(chan, sspec.d_pad, lambda x: x[:, cols].clone())
    else:
        chan = chan._replace(h=cplane(chan.h))
    return TreeFLState(
        theta=worker_tree(state.theta), lam=cplane(state.lam),
        Theta=tree_map(torch.clone, shard_tree(sspec, state.Theta,
                                               coords.j)),
        chan=chan, opt=opt, step=state.step, flt=flt)


def phy_planes(phys: PhyState, width: int, fn) -> PhyState:
    """``phys`` with ``fn`` applied to each plane of its per-element
    Complex fields (h, h_small, h_hat) that is ``width`` wide; a
    frequency-flat (W, 1) fade and the per-worker fields are kept."""
    def one(z):
        if z is None or z.re.shape[-1] != width:
            return z
        return Complex(fn(z.re), fn(z.im))

    return phys._replace(h=one(phys.h), h_small=one(phys.h_small),
                         h_hat=one(phys.h_hat))


def mesh_tree_fl_state_from_numpy(sspec, coords, n_data: int,
                                  *args, **kwargs) -> TreeFLState:
    """:func:`tree_fl_state_from_numpy` of the JAX trainer's shard-global
    state (λ and h the (W, d_pad) shard-packed planes), then one rank's
    part of it (:func:`shard_fl_state`)."""
    return shard_fl_state(tree_fl_state_from_numpy(*args, **kwargs), sspec,
                          coords, n_data)
