"""Privacy demo (Theorems 2-3): what the parameter server actually sees.
Torch twin of ``examples/privacy_attack_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.privacy_attack_demo \
        [--device cpu]

1. Digital FL: the PS decodes every worker's model verbatim, so a
   model-inversion attack gets a perfect input.
2. A-FADMM: the PS sees only the fading-perturbed, dual-shifted SUM.  A
   second, different set of worker models produces the same observation,
   so no attack can tell them apart (Definition 1).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import rng
from repro_torch.core.channel import rayleigh
from repro_torch.core.cplx import Complex
from repro_torch.core.privacy import (construct_ambiguity, eavesdropper_view,
                                      model_inversion_attack,
                                      observation_gap)
from repro_torch.device import resolve_device

W, D, RHO = 8, 10, 0.5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    key = 0
    k1, k2, k3 = rng.split(key, 3)
    # the true private local models
    theta = torch.randn((W, D), generator=rng.generator(k1, dev), device=dev)
    lam = Complex(0.1 * torch.randn((W, D), generator=rng.generator(k2, dev),
                                    device=dev),
                  torch.zeros((W, D), device=dev))
    h = rayleigh(rng.generator(k3, dev), (W, D))
    Theta = theta.mean(0)

    print("=== digital FL (D-FADMM uplink) ===")
    print("PS receives worker 0's model exactly:",
          [round(v, 3) for v in theta[0].tolist()])
    print("reconstruction error: 0.0  -> privacy violated\n")

    print("=== A-FADMM (analog over-the-air uplink) ===")
    view = eavesdropper_view(theta, lam, h, RHO, Theta, Theta)
    print("PS receives only the perturbed aggregate (first 5 elements):",
          [round(v, 3) for v in view.y.re[:5].tolist()])

    guess = model_inversion_attack(view, W, RHO, key)
    err = float(torch.sqrt(torch.mean((guess - theta[0]) ** 2)))
    print(f"best-effort inversion of worker 0: RMSE = {err:.3f} "
          f"(vs 0.0 under digital)")

    theta2, lam2, _ = construct_ambiguity(rng.fold_in(key, 7), theta, lam,
                                          h, RHO)
    view2 = eavesdropper_view(theta2, lam2, h, RHO, Theta, Theta)
    diff = float((theta2 - theta).abs().max())
    gap = float(observation_gap(view, view2))
    print(f"\nambiguity witness: a different model set "
          f"(max |θ'-θ| = {diff:.3f}) gives observation gap {gap:.2e}")
    print("-> the inverse problem has multiple exact solutions: Definition-1 "
          "privacy holds before convergence (Thm 2) and on the trajectory "
          "after it (Thm 3).")
    return {"rmse": err, "max_theta_diff": diff, "observation_gap": gap}


if __name__ == "__main__":
    main()
