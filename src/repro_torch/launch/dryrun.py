"""Dry run on the meta device (port of ``repro.launch.dryrun``): every
(architecture × input shape) step at the config's published size, run on
tensors that carry shapes and dtypes and no data, counted and put on the
H100's roofline. It needs no card and allocates nothing of the model's size.

For each arch × ``applicable_shapes(cfg)`` the step of ``launch/steps.py``
(train: one FedPBC round of one client holding the shape's global batch,
one local step, as the reference's single-pod mesh; prefill: ``forward``;
decode: one ``decode_step`` against a full cache) runs eagerly on meta:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (every matmul,
  forward and backward, and each activation-checkpointed chunk recomputed);
- bytes: the sum over the step's aten ops of each input's and each
  output's bytes (an input that broadcasts counts its storage), the
  counterpart of XLA's "bytes accessed"; views, which move nothing, count
  nothing;
- parameter bytes and the step's input bytes (the ``FedState`` and batches,
  or the params, cache and tokens), and whether those fit one 80 GB card
  (activations are not counted: meta tensors have no allocator to ask).

Attention is counted as the card runs it (``dispatch.attention`` is
swapped for ``_card_attention`` while the step runs): at the flash
kernels' shapes (``dispatch.flash_shape_ok``) the torch ops around the
kernels (GQA's repeat, the transposes, the wrapper's contiguous copies)
run on meta and each of the three kernels adds its work
(``roofline.flash_work``: the causal pairs only, each operand moved
once), so no ``T x T`` score tensor is counted; every other shape takes
the plain version, as on the card. The WKV6 recurrence (the rwkv rows)
likewise: ``dispatch.wkv6`` is swapped for ``_card_wkv6``, whose forward
and backward add ``roofline.wkv6_work`` and raise for a head dim the
kernels do not take (``rwkv6_chunk.HEAD_DIMS``), as the card does. The
steps ask for the plain versions (``steps.BACKEND``: no kernel has a meta
mode), which these swaps stand in for. The aggregation is the engine's
branch path, the launcher's default. Eager counting sees every loop trip, so the
reference's depth extrapolation (``_extrapolate`` over unrolled 1- and
2-period programs, ``models/flags.py``) has no counterpart. An arch ×
shape that cannot run on meta is a ``FAIL`` row with its error.

Usage (CPU only):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out X.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional
from unittest import mock

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (
    ARCH_IDS,
    INPUT_SHAPES,
    ShapeConfig,
    applicable_shapes,
    get_config,
)
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import padded_head_dim
from repro_torch.kernels.rwkv6_chunk import HEAD_DIMS as WKV6_HEAD_DIMS
from repro_torch.launch import steps
from repro_torch.launch.roofline import (
    Roofline,
    flash_work,
    model_flops_for,
    wkv6_work,
)
from repro_torch.models.attention import attention_ref, repeat_kv

MESH = "1xH100"
CARD_BYTES = 80e9
COUNTED_THROUGH = ("attention at the flash kernels' shapes as the kernels' "
                   "work (causal pairs, operands moved once); the WKV6 "
                   "recurrence as its kernels' work (roofline.wkv6_work); "
                   "the aggregation as the engine's branch path")
_ATEN = torch.ops.aten
# ops that move no bytes: allocation without a write
_NO_BYTES = {_ATEN.empty.memory_format, _ATEN.empty_strided.default,
             _ATEN.empty_like.default, _ATEN._unsafe_view.default}


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes, an input that broadcasts at its storage's size."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class ByteCounter(TorchDispatchMode):
    """Sums each aten op's input and output bytes (views count nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _NO_BYTES:
            self.ops += 1
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


class FlashTally:
    """The flash kernels' work in a counted step: flops, bytes and
    launches by kernel."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.launches = {"fwd": 0, "dq": 0, "dkdv": 0}

    def add(self, q: torch.Tensor, window: int, *kernels: str):
        bh, t, d = q.shape
        work = flash_work(bh, t, padded_head_dim(d), window,
                          q.element_size())
        for name in kernels:
            self.flops += work[name][0]
            self.bytes += work[name][1]
            self.launches[name] += 1


class _FlashWork(torch.autograd.Function):
    """The three flash kernels on meta ``[BH, T, D]``: empty outputs of
    their shapes, their work added to a ``FlashTally``."""

    @staticmethod
    def forward(ctx, q, k, v, window, tally):
        ctx.window, ctx.tally = window, tally
        tally.add(q, window, "fwd")
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        do = do.contiguous()                # as the wrapper's backward
        ctx.tally.add(do, ctx.window, "dq", "dkdv")
        return (torch.empty_like(do), torch.empty_like(do),
                torch.empty_like(do), None, None)


def _card_attention(tally: FlashTally):
    """``dispatch.attention`` as the card runs it, on meta (the module
    docstring); ``backend`` is ignored."""

    def attention(q, k, v, *, kind="full", window=4096, logit_softcap=0.0,
                  chunk=1024, q_offset=0, backend=None):
        if not dispatch.flash_shape_ok(kind, q.shape[1], k.shape[1],
                                       q_offset):
            return attention_ref(q, k, v, kind=kind, window=window,
                                 logit_softcap=logit_softcap, chunk=chunk,
                                 q_offset=q_offset)
        b, t, h, d = q.shape
        n_rep = h // k.shape[2]
        flat = [x.transpose(1, 2).reshape(b * h, t, d).contiguous()
                for x in (q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))]
        out = _FlashWork.apply(*flat, window if kind == "swa" else 0, tally)
        return out.view(b, h, t, d).transpose(1, 2)

    return attention


class WKV6Tally:
    """The WKV6 kernels' work in a counted step: flops, bytes and launches
    by direction."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0
        self.launches = {"fwd": 0, "bwd": 0}

    def add(self, r: torch.Tensor, heads: int, direction: str):
        b, h, t, d = r.shape
        flops, nbytes = wkv6_work(b * h, t, d, heads)[direction]
        self.flops += flops
        self.bytes += nbytes
        self.launches[direction] += 1


class _WKV6Work(torch.autograd.Function):
    """The WKV6 kernels on meta ``[B, H, T, D]``: empty outputs of their
    shapes, their work added to a ``WKV6Tally``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, tally):
        ctx.tally, ctx.heads = tally, u.shape[0]
        tally.add(r, u.shape[0], "fwd")
        return torch.empty_like(r), torch.empty_like(s0)

    @staticmethod
    def backward(ctx, do, ds_t):
        do = do.contiguous()                # as the wrapper's backward
        ctx.tally.add(do, ctx.heads, "bwd")
        b, h, _, d = do.shape
        empty = [torch.empty_like(do) for _ in range(4)]
        return (*empty, do.new_empty((ctx.heads, d)),
                do.new_empty((b, h, d, d)), None)


def _card_wkv6(tally: WKV6Tally):
    """``dispatch.wkv6`` as the card runs it, on meta: the kernels' work,
    and the card's refusal of another head dim; ``backend`` is ignored."""

    def wkv6(r, k, v, w, u, s0, *, backend=None):
        if r.shape[-1] not in WKV6_HEAD_DIMS:
            raise ValueError(f"the WKV6 kernels take head dims "
                             f"{WKV6_HEAD_DIMS}, got {r.shape[-1]}")
        return _WKV6Work.apply(r, k, v, w, u, s0, tally)

    return wkv6


def _tree_bytes(tree) -> int:
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(x) for x in tree)
    return _nbytes(tree) if isinstance(tree, torch.Tensor) else 0


def count_step(cfg, shape: ShapeConfig, *, num_clients: int = 1,
               local_steps: int = 1, algorithm: str = "fedpbc") -> dict:
    """Run one step of ``shape.mode`` on meta; returns ``{"flops", "bytes",
    "ops", "input_bytes", "flash_launches", "wkv6_launches"}``:
    FlopCounterMode's flops and the aten ops' bytes, each with the flash
    and WKV6 kernels' work added."""
    with torch.no_grad():
        if shape.mode == "train":
            args = steps.train_input_specs(
                cfg, shape, num_clients=num_clients,
                local_steps=local_steps, algorithm=algorithm)
            step = steps.make_train_step(
                cfg, num_clients=num_clients, local_steps=local_steps,
                algorithm=algorithm)
        elif shape.mode == "prefill":
            args = steps.prefill_input_specs(cfg, shape)
            step = steps.make_prefill_step(cfg)
        else:
            args = steps.serve_input_specs(cfg, shape)
            step = steps.make_serve_step(cfg)
    counter, flash, wkv = ByteCounter(), FlashTally(), WKV6Tally()
    with FlopCounterMode(display=False) as flops, counter, \
            mock.patch.object(dispatch, "attention", _card_attention(flash)), \
            mock.patch.object(dispatch, "wkv6", _card_wkv6(wkv)):
        step(*args)
    return {"flops": float(flops.get_total_flops() + flash.flops
                           + wkv.flops),
            "bytes": float(counter.bytes + flash.bytes + wkv.bytes),
            "ops": counter.ops, "input_bytes": _tree_bytes(args),
            "flash_launches": dict(flash.launches),
            "wkv6_launches": dict(wkv.launches)}


def param_bytes(cfg) -> int:
    return _tree_bytes(steps.empty_params(cfg))


def lower_pair(arch: str, shape_name: str, *, verbose: bool = True,
               algorithm: str = "fedpbc", cfg=None) -> dict:
    """One row: the arch (or ``cfg``) × shape counted on meta and put on
    the roofline, or a ``skip`` / ``FAIL`` row."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    row = {"arch": arch, "shape": shape_name, "mesh": MESH}
    if shape.name not in [s.name for s in applicable_shapes(cfg)]:
        return {**row, "status": "skip",
                "reason": "full-attention arch at 500k / enc-dec long decode"}
    t0 = time.time()
    try:
        c = count_step(cfg, shape, algorithm=algorithm)
    except Exception as e:     # the row records any step that cannot run
        return {**row, "status": "FAIL", "mode": shape.mode,
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2500:]}
    rf = Roofline(flops=c["flops"], hbm_bytes=c["bytes"], coll_bytes=0.0,
                  chips=1, model_flops=model_flops_for(cfg, shape,
                                                       mode=shape.mode))
    pbytes = param_bytes(cfg)
    result = {
        **row, "status": "ok", "mode": shape.mode,
        "count_s": round(time.time() - t0, 2), "aten_ops": c["ops"],
        "param_bytes": pbytes, "argument_bytes": c["input_bytes"],
        "fits_one_card": c["input_bytes"] <= CARD_BYTES,
        "temp_bytes_per_device": None, "collectives": {},
        "flash_launches": c["flash_launches"],
        "wkv6_launches": c["wkv6_launches"],
        "counted_through": COUNTED_THROUGH, **rf.row(),
    }
    if verbose:
        print(f"== {arch} x {shape_name} mesh={MESH} ==")
        print(f"params {pbytes / 1e9:.3f} GB, step inputs "
              f"{c['input_bytes'] / 1e9:.3f} GB (fit one 80 GB card: "
              f"{result['fits_one_card']}); {c['ops']} aten ops")
        print("counted: flops=%.3e bytes=%.3e" % (rf.flops, rf.hbm_bytes))
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs -> %s"
              % (rf.t_compute, rf.t_memory, rf.t_collective, rf.bottleneck))
        print("useful fraction (model/counted flops): %.3f"
              % rf.useful_fraction)
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--algorithm", default="fedpbc")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (list(INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    results = []
    for a in archs:
        for s in shapes:
            r = lower_pair(a, s, algorithm=args.algorithm)
            print(json.dumps({k: v for k, v in r.items() if k != "trace"}),
                  flush=True)
            if r["status"] == "FAIL":
                print(r.get("trace", ""), flush=True)
            results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "FAIL" for r in results)
    print(f"DONE ok={n_ok} skip={n_skip} fail={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
