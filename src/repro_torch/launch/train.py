"""Federated LM training launcher (port of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch smollm-135m --full \\
      --clients 8 --local-steps 2 --batch 2 --seq 2048 --rounds 10

Runs the FedPBC round engine (``repro_torch.core.make_run_rounds``) over
the selected architecture on the card (``--device cpu`` for the CPU; the
default is the card and raises without CUDA). ``--reduced`` (the default)
is the 2-layer, d_model-256 variant in fp32; ``--full`` is the published
widths in the config's dtype (bf16); ``--dtype`` overrides either, and
``--layers`` / ``--encoder-layers`` cut the depth. Token batches come from the
``lm_source`` (each client's half-vocab slice); every draw comes from the
per-seed generators of ``repro_torch.experiments.sweep.seed_generators``
(params seed+1, link seed+2, source offsets seed+3, tokens seed+4, the
reference's key offsets).

It trains every ``--arch`` of ``repro_torch.configs.ARCH_IDS``: the dense
family (smollm-135m, gemma2-9b, deepseek-coder-33b, granite-34b), the MoE
family (mixtral-8x22b, llama4-maverick-400b-a17b), RWKV6 (rwkv6-3b), the
hybrid (jamba-1.5-large-398b), the vlm (llama-3.2-vision-90b) and the
audio family (seamless-m4t-medium). As in the reference's launcher, the vlm and
audio batches carry the constant memory ``0.1 * ones([batch, M,
d_model])`` fp32 (``M`` image tokens or audio frames), which runs their
memory path in fp32. A bf16 model with fp32 leaves (the MoE router, the
Mamba leaves, the cross gate, RWKV6's decay base, bonus and ``ln_x``)
trains in two parameter groups
(``repro_torch.core.params.Groups``), its fp32 leaves never rounded.

Checkpoints (``--ckpt-dir``, every ``--ckpt-every`` rounds, as in the
reference): each holds ``(FedState, ds_state, drawer)``, the drawer's
generator states and draw counts included, so a rerun with the same
arguments restores the latest one into the freshly built state and goes on
with the trajectory of one uninterrupted run, bit for bit. Log and
checkpoint boundaries end the chunks of rounds run between log lines.

Kernels on this path: attention runs the CUDA flash kernel, forward and
backward, and RWKV6's WKV6 recurrence the chunked CUDA forward and the
CUDA backward, for CUDA tensors (``main(..., backend="torch")`` runs the
plain chunked versions instead, to compare the two paths);
``REPRO_USE_KERNEL=1`` routes the server update through the fused
aggregation kernel, as the knob does for the port's sweep.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--algorithm", default="fedpbc")
    ap.add_argument("--scheme", default="bernoulli",
                    choices=["bernoulli", "markov", "cyclic"])
    ap.add_argument("--time-varying", action="store_true")
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--encoder-layers", type=int, default=None,
                    help="cut the audio encoder to this many layers")
    ap.add_argument("--dtype", default=None,
                    help="the model's dtype (default: float32 with "
                         "--reduced, the config's with --full)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, *,
         backend: Optional[str] = None) -> Dict:
    """Run the launcher; returns ``{"losses", "round_seconds",
    "log_rounds", "initial", "state"}``: the mean client loss of every
    round this call ran (after a restore, the rounds past the checkpoint),
    the wall clock at each log line (after the rounds up to
    ``log_rounds[i]``), a copy of the initial server params (``Groups``
    for a model in two parameter groups) and the final ``FedState``.
    ``backend``: ``None`` (the kernels on the card) or ``"torch"`` (the
    plain attention and WKV6), see ``repro_torch.kernels.dispatch``."""
    args = parse_args(argv)

    from repro_torch.checkpointing import latest_step, restore, save
    from repro_torch.configs import FederationConfig, get_config, reduced
    from repro_torch.core import (
        GeneratorDraws,
        build_base_probs,
        gmap,
        init_fed_state,
        make_algorithm_spec,
        make_link_process,
        make_run_rounds,
    )
    from repro_torch.data import lm_source, memory_shape
    from repro_torch.device import resolve_device
    from repro_torch.experiments.sweep import seed_generators
    from repro_torch.kernels.dispatch import resolve_use_kernel
    from repro_torch.models.model import init_params, make_loss
    from repro_torch.optim import paper_decay, sgd

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=args.encoder_layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    print(f"arch={cfg.name} family={cfg.family} params~"
          f"{cfg.param_count() / 1e6:.1f}M reduced={args.reduced} "
          f"layers={cfg.num_layers} dtype={cfg.dtype} device={dev}",
          flush=True)

    m = args.clients
    fed = FederationConfig(algorithm=args.algorithm, num_clients=m,
                           local_steps=args.local_steps, scheme=args.scheme,
                           time_varying=args.time_varying)
    p, _, _ = build_base_probs(args.seed, m, 10, alpha=0.1, sigma0=4.0,
                               delta=0.05)
    print("client uplink probabilities:", p.round(3), flush=True)
    algo = make_algorithm_spec((fed.algorithm,), fed)
    link = make_link_process(torch.as_tensor(p, device=dev)[None], fed)
    opt = sgd(paper_decay(args.lr))
    source = lm_source(num_clients=m, local_steps=args.local_steps,
                       batch=args.batch, seq=args.seq, vocab=cfg.vocab_size,
                       memory_shape=memory_shape(cfg, args.batch))
    run_rounds = make_run_rounds(make_loss(cfg, backend), opt,
                                 algo, link, fed, source,
                                 use_kernel=resolve_use_kernel(),
                                 device=dev)
    draws = GeneratorDraws([seed_generators(args.seed, dev)], num_clients=m,
                           pick_spec=source.pick_spec)
    server = draws.params(lambda g: init_params(g, cfg))
    initial = gmap(torch.clone, server)
    st = init_fed_state(draws.link_init(), server, fed, algo, link, opt)
    ds_state = source.init(draws.source_init(source.init_high))

    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            try:
                st, ds_state, drawn = restore(args.ckpt_dir, last,
                                              (st, ds_state, draws.state()))
            except (KeyError, ValueError) as e:
                raise SystemExit(
                    f"checkpoint {args.ckpt_dir}/ckpt_{last:08d}.npz does "
                    "not match the current (FedState, ds_state, drawer) "
                    "layout — likely a different --arch/--clients setting. "
                    f"Delete or move --ckpt-dir to start fresh. ({e})")
            draws = draws.restored(drawn)
            print(f"restored round {int(st.round)} from {args.ckpt_dir}",
                  flush=True)

    def next_boundary(t: int) -> int:
        """Next log or checkpoint boundary after round t (a chunk's end)."""
        nxt = min(t - t % args.log_every + args.log_every, args.rounds)
        if args.ckpt_dir:
            nxt = min(nxt, t - t % args.ckpt_every + args.ckpt_every)
        return nxt

    losses, stamps, log_rounds = [], [], []
    t0 = time.time()
    start_round = t = int(st.round)
    while t < args.rounds:
        chunk = next_boundary(t) - t
        st, ds_state, mets = run_rounds(st, ds_state, draws, chunk)
        t += chunk
        losses += mets["loss"][0].tolist()
        loss = losses[-1]
        stamps.append(time.time() - t0)
        log_rounds.append(t)
        print(f"round {t:4d} loss {loss:.4f} "
              f"active {int(mets['num_active'][0, -1])}/{m} "
              f"mean_staleness "
              f"{float(mets['staleness'][0, -1].mean()):.1f} "
              f"({stamps[-1]:.1f}s)", flush=True)
        if args.ckpt_dir and t % args.ckpt_every == 0:
            save(args.ckpt_dir, t, (st, ds_state, draws.state()))
    print(f"done: {args.rounds - start_round} rounds in "
          f"{time.time() - t0:.1f}s", flush=True)
    return {"losses": losses, "round_seconds": stamps,
            "log_rounds": log_rounds, "initial": initial, "state": st}


if __name__ == "__main__":
    main()
