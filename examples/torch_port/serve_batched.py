"""Batched serving on the PyTorch port: greedy decoding with per-family
caches (KV ring buffers for SWA archs, RWKV/SSM states for recurrent ones),
the twin of ``examples/serve_batched.py``.

A thin wrapper over the port's launcher, ``repro_torch.launch.serve``; its
flags, plus ``--device`` (the card by default, ``cpu`` without one):

  PYTHONPATH=src python examples/torch_port/serve_batched.py \\
      --arch rwkv6-3b --gen 24
"""
import argparse

from repro_torch.launch import serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)
    return serve.main(rest, device=args.device)


if __name__ == "__main__":
    main()
