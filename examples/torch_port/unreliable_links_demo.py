"""Fig. 5/6 analogue on the PyTorch port (the twin of
``examples/unreliable_links_demo.py``): ASCII traces of the six
unreliable-uplink schemes, plus a cross-device arm: FedPBC at m = 10,000
clients with a C = 256 cohort per round and buffered semi-async
aggregation (``repro_torch.scale``).

Each trace is ``T`` calls of the scheme's ``link.sample`` on uniforms drawn
from one ``torch.Generator``. The cross-device arm runs the real round
engine: clients are stateless (``FedState.clients`` is ``[B, 0, n]``, so
no ``[m, n_params]`` tensor exists), each round trains only the sampled
cohort, and the server commits its buffer when it fills or the deadline
passes.

  PYTHONPATH=src python examples/torch_port/unreliable_links_demo.py \\
      [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import FederationConfig
from repro_torch.core import make_link_process
from repro_torch.device import resolve_device

SCHEMES = [
    ("bernoulli, time-invariant", dict(scheme="bernoulli")),
    ("bernoulli, time-varying", dict(scheme="bernoulli", time_varying=True)),
    ("markov, homogeneous", dict(scheme="markov")),
    ("markov, non-homogeneous", dict(scheme="markov", time_varying=True)),
    ("cyclic, no reset", dict(scheme="cyclic", cyclic_length=40)),
    ("cyclic, periodic reset", dict(scheme="cyclic", cyclic_length=40,
                                    cyclic_reset=True)),
]

P = [0.05, 0.1, 0.5, 0.9]
T = 80


def trace(link, T: int, gen: torch.Generator) -> torch.Tensor:
    """``[T, m]`` bool activity matrix: ``T`` rounds of ``link.sample``."""
    m = len(P)
    dev = gen.device
    state = link.init(torch.rand(1, m, generator=gen, device=dev))
    rows = []
    for t in range(T):
        active, _, state = link.sample(
            state, t, torch.rand(1, m, generator=gen, device=dev))
        rows.append(active[0])
    return torch.stack(rows).cpu()


def cross_device_arm(dev, m=10_000, C=256, rounds=12):
    """FedPBC over m clients, C-cohort rounds, buffered aggregation."""
    from repro_torch.core import (
        GeneratorDraws,
        init_fed_state,
        make_algorithm_spec,
        make_run_rounds,
    )
    from repro_torch.data import fixed_source
    from repro_torch.experiments.sweep import seed_generators
    from repro_torch.optim import sgd
    from repro_torch.scale import BUFFER_METRIC_KEYS, Strategy

    fed = FederationConfig(algorithm="fedpbc", num_clients=m, local_steps=2)
    spec = make_algorithm_spec(("fedpbc",), fed)
    link = make_link_process(torch.full((1, m), 0.5, device=dev), fed)

    def loss(params, batch):                # [B, C, 8] -> [B, C]
        return ((params - batch["u"].mean(-1, keepdim=True)) ** 2).sum(-1)

    opt = sgd(0.05)
    source = fixed_source({"u": torch.zeros(m, fed.local_steps, 4,
                                            device=dev)})
    strat = Strategy("buffered", buffer_size=C // 2, deadline_rounds=3)
    run = make_run_rounds(loss, opt, spec, link, fed, source,
                          metric_keys=("loss", "num_active")
                          + BUFFER_METRIC_KEYS,
                          strategy=strat, cohort_size=C, device=dev)
    draws = GeneratorDraws([seed_generators(3, dev)], num_clients=m,
                           cohort_size=C)
    st = init_fed_state(draws.link_init(), torch.ones(1, 8, device=dev), fed,
                        spec, link, opt, stateless_clients=True,
                        buffered=True)
    st, _, mets = run(st, source.init(), draws, rounds)
    print(f"\n== cross-device: fedpbc, m={m:,}, cohort C={C}, "
          f"buffer={strat.buffer_size}, deadline={strat.deadline_rounds} ==")
    assert st.clients.shape[1] == 0        # stateless: O(C) round memory
    commit = mets["commit"][0].cpu()
    fill = mets["buffer_fill"][0].cpu()
    for t in range(rounds):
        bar = "#" * int(fill[t] * 30 / max(float(fill.max()), 1.0))
        mark = " COMMIT" if commit[t] else ""
        print(f"  round {t:2d} |{bar:<30s}| fill={int(fill[t]):4d}{mark}")
    commits = int(st.buffer.commits[0])
    print(f"  commits={commits}, "
          f"final loss={float(mets['loss'][0, -1]):.4f}")
    return commits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default; raises without CUDA)")
    dev = resolve_device(ap.parse_args(argv).device)
    p = torch.tensor([P], device=dev)
    traces = {}
    for name, kw in SCHEMES:
        fed = FederationConfig(num_clients=len(P), **kw)
        link = make_link_process(p, fed)
        actives = trace(link, T, torch.Generator(device=dev).manual_seed(1))
        traces[name] = actives
        print(f"\n== {name} ==")
        for i in range(len(P)):
            row = "".join("#" if a else "." for a in actives[:, i].tolist())
            print(f"  p={P[i]:4.2f} |{row}|")
    return {"traces": traces, "commits": cross_device_arm(dev)}


if __name__ == "__main__":
    main()
