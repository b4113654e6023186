"""Carry weights and algorithm state from the JAX package into the port.

The port cannot import JAX, so the caller hands over the leaves as numpy
arrays (``numpy.asarray`` of each JAX array).  The flat layouts are the same
in both packages, so a converted state or parameter vector means the same
thing on either side.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.admm import AFadmmState
from repro_torch.core.channel import ChannelBlock
from repro_torch.core.cplx import Complex
from repro_torch.device import resolve_device
from repro_torch.models.mlp import Unflatten, mlp_unflatten

#: leaves of an ``AFadmmState`` as :func:`afadmm_state_from_numpy` takes them
STATE_KEYS = ("theta", "lam_re", "lam_im", "Theta", "h_re", "h_im",
              "h_prev_re", "h_prev_im", "changed", "age", "step")


def afadmm_state_from_numpy(d: Mapping[str, np.ndarray],
                            device="cuda") -> AFadmmState:
    """The port's ``AFadmmState`` from the JAX state's leaves.

    ``d`` maps each of :data:`STATE_KEYS` to a numpy array: θ (W, d), λ
    re/im (W, d), Θ (d,), the block's h and h_prev re/im (W, d), ``changed``
    (W, d) bool, and the int scalars ``age`` and ``step``."""
    missing = [k for k in STATE_KEYS if k not in d]
    if missing:
        raise KeyError(f"afadmm_state_from_numpy: missing leaves {missing}")
    dev = resolve_device(device)

    def f32(k: str) -> torch.Tensor:
        return torch.tensor(np.asarray(d[k], np.float32), device=dev)

    blk = ChannelBlock(
        h=Complex(f32("h_re"), f32("h_im")),
        h_prev=Complex(f32("h_prev_re"), f32("h_prev_im")),
        changed=torch.tensor(np.asarray(d["changed"], bool), device=dev),
        age=int(d["age"]))
    return AFadmmState(theta=f32("theta"), lam=Complex(f32("lam_re"),
                                                       f32("lam_im")),
                       Theta=f32("Theta"), blk=blk, step=int(d["step"]))


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
