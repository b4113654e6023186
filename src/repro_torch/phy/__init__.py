"""``repro_torch.phy`` — the wireless scenario engine of the port.

Correlated (Jakes-Doppler) fading, path loss + shadowing with
random-waypoint mobility, imperfect CSI and deep-fade participation
truncation over the ``(W, d)`` worker planes, consumed by
``core.aggregators.AFadmm(scenario=...)``.  Counterpart of ``repro.phy``.
"""
from repro_torch.phy.csi import estimate as estimate_csi  # noqa: F401
from repro_torch.phy.fading import (bessel_j0, correlated_step,  # noqa: F401
                                    doppler_rho, gauss_markov_step,
                                    innovation_scale)
from repro_torch.phy.geometry import (SHADOW_SALT,  # noqa: F401
                                      GeometryConfig, init_positions,
                                      path_gain, shadowing, uniform_disk,
                                      waypoint_shadow_step, waypoint_step,
                                      worker_gains)
from repro_torch.phy.population import population_step  # noqa: F401
from repro_torch.phy.scenario import (PRESETS, PhyConfig,  # noqa: F401
                                      PhyDraws, PhyState, Scenario, h_tx,
                                      list_scenarios, make_scenario,
                                      participation_mask)
