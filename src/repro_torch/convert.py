"""Carry weights and algorithm state from the JAX package into the port.

The port cannot import JAX, so the caller hands over the leaves as numpy
arrays (``numpy.asarray`` of each JAX array).  The flat layouts are the same
in both packages, so a converted state or parameter vector means the same
thing on either side.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admm import AFadmmState
from repro_torch.core.channel import ChannelBlock
from repro_torch.core.cplx import Complex
from repro_torch.device import resolve_device
from repro_torch.models.mlp import Unflatten, mlp_unflatten
from repro_torch.phy.scenario import PhyState

#: leaves of an ``AFadmmState`` as :func:`afadmm_state_from_numpy` takes them
#: (plus an optional ``phys`` entry under a scenario)
STATE_KEYS = ("theta", "lam_re", "lam_im", "Theta", "h_re", "h_im",
              "h_prev_re", "h_prev_im", "changed", "age", "step")
#: leaves of a ``PhyState`` as :func:`phy_state_from_numpy` takes them; only
#: ``h_re``, ``h_im`` and ``age`` are required, as in the JAX state
PHY_KEYS = ("h_re", "h_im", "h_small_re", "h_small_im", "h_hat_re",
            "h_hat_im", "gain", "shadow", "pos", "dest", "mask", "age")


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


def afadmm_state_from_numpy(d: Mapping[str, np.ndarray],
                            device="cuda") -> AFadmmState:
    """The port's ``AFadmmState`` from the JAX state's leaves.

    ``d`` maps each of :data:`STATE_KEYS` to a numpy array: θ (W, d), λ
    re/im (W, d), Θ (d,), the block's h and h_prev re/im (W, d), ``changed``
    (W, d) bool, and the int scalars ``age`` and ``step``.  Under a
    scenario, ``d["phys"]`` holds the ``PhyState``'s leaves
    (:func:`phy_state_from_numpy`)."""
    missing = [k for k in STATE_KEYS if k not in d]
    if missing:
        raise KeyError(f"afadmm_state_from_numpy: missing leaves {missing}")
    dev = resolve_device(device)
    phys = d.get("phys")

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
                       else phy_state_from_numpy(phys, device=dev))


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
