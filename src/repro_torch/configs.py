"""The federation configuration (own copy of ``repro.configs.base``'s
``FederationConfig``; the model-zoo configs wait for their slice)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FederationConfig:
    algorithm: str = "fedpbc"  # fedpbc|fedavg|fedavg_all|fedau|mifa|fedavg_known_p|f3ast
    num_clients: int = 16
    local_steps: int = 5
    # placement: 'simulated' (batched clients), 'stacked_data', 'pod_silo'
    placement: str = "simulated"
    scheme: str = "bernoulli"  # bernoulli|markov|cyclic
    time_varying: bool = False
    gamma: float = 0.5          # Eq. (9) fluctuation
    period: int = 40            # Eq. (9) sine period
    delta: float = 0.02         # p_i clip lower bound
    sigma0: float = 10.0        # lognormal class-weight spread
    alpha: float = 0.1          # Dirichlet non-IID
    cyclic_length: int = 100
    cyclic_reset: bool = False
    fedau_K: int = 50
    f3ast_beta: float = 0.01
    f3ast_cap: int = 10
    known_p: bool = False
