"""Serving launcher (port of ``repro.launch.serve``): batched greedy
decoding with the KV cache, the Mamba carry or the RWKV state.

  python -m repro_torch.launch.serve --full --batch 8 --prompt-len 128 \
      --gen 64                      # SmolLM-135M, the default --arch
  python -m repro_torch.launch.serve --arch rwkv6-3b --full \
      --batch 8 --prompt-len 128 --gen 64
  python -m repro_torch.launch.serve --arch gemma2-9b --full \
      --batch 8 --prompt-len 64 --gen 32
  python -m repro_torch.launch.serve --arch seamless-m4t-medium --full \
      --batch 8 --prompt-len 64 --gen 32

``--arch`` takes every arch id of ``configs.base.ARCH_IDS``, as the
reference's launcher does: the dense smollm-135m, gemma2-9b,
deepseek-coder-33b and granite-34b, the MoE mixtral-8x22b and
llama4-maverick-400b-a17b, rwkv6-3b, the hybrid jamba-1.5-large-398b, the
vlm llama-3.2-vision-90b and the audio seamless-m4t-medium. At ``--full``
the 33B-400B ones do not fit one 80 GB card (``chip_smoke.py`` runs the
MoE, hybrid and vlm ones at full width and reduced depth by calling
``forward`` and ``decode_step`` itself).

Runs on the card (``main(..., device="cpu")`` for the CPU; without CUDA the
default raises). ``--reduced`` (the default) is the 2-layer, d_model-256
variant in fp32; ``--full`` is the published widths in the config's dtype
(bf16). Weights come from ``--seed`` (``models.model.init_leaves``) and the
prompts from ``--seed + 1``, uniform over the vocabulary, unless
``main`` is given them. The vlm and audio families attend memory: as the
reference launcher builds it, ``0.1 * ones([batch, num_image_tokens |
num_audio_frames, d_model])`` in fp32, unless ``main`` is given one. As in
the reference, the prompt is prefilled through sequential ``decode_step``
calls (under ``torch.no_grad``), then ``--gen`` tokens are decoded
greedily; the tokens/s printed counts prompt and generated tokens over the
whole loop. Attention layers write each token's k/v into their cache (a
ring buffer for windowed layers) and attend it with the plain
``decode_attention``, which launches no kernel, as the reference calls
none there (MoE layers route each row's token, Mamba layers step their
carry and cross layers attend the memory, all in plain PyTorch); the
memory is projected (vlm) or encoded (audio: one flash launch per encoder
layer) again at every step, as in the reference; an RWKV6 model runs each
layer's WKV6 recurrence as one launch of the CUDA kernel at T = 1, the
state carried in the cache.
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
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, *, device=None, prompts=None,
         params=None, memory=None, keep_logits: bool = False) -> Dict:
    """Run the launcher; returns ``{"ids" [batch, gen], "prompts"
    [batch, prompt_len], "seconds", "prefill_seconds", "tokens_per_s",
    "logits"}`` (ids and prompts on the CPU; ``seconds`` the whole loop,
    ``prefill_seconds`` its prompt part). ``device``: ``None`` is the card;
    ``prompts``: int ``[batch, prompt_len]`` in place of the drawn ones;
    ``params``: the model's named leaves (``models.model.init_leaves``,
    ``convert.lm_leaves_from_jax``) in place of the seeded init;
    ``memory``: the vlm's image tokens or the audio frames ``[batch, M,
    d_model]`` in place of the launcher's constant 0.1;
    ``keep_logits``: also return each step's last-position logits
    (``[batch, V]`` fp32 on the CPU, prefill steps included)."""
    args = parse_args(argv)

    from repro_torch.configs import get_config, reduced
    from repro_torch.data import memory_shape
    from repro_torch.device import resolve_device, set_fp32_matmul_precision
    from repro_torch.models.model import decode_step, init_leaves, make_cache

    dev = resolve_device(device)
    set_fp32_matmul_precision()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg), dtype="float32")
    print(f"serving {cfg.name} ({cfg.family}), batch={args.batch}",
          flush=True)

    max_len = args.prompt_len + args.gen
    cache = make_cache(cfg, args.batch, max_len, device=dev)
    if params is None:
        params = init_leaves(torch.Generator(device=dev).manual_seed(
            args.seed), cfg)
    if prompts is None:
        prompts = torch.randint(
            0, cfg.vocab_size, (args.batch, args.prompt_len),
            generator=torch.Generator().manual_seed(args.seed + 1))
    prompts = torch.as_tensor(prompts).to(dev, torch.long)
    if tuple(prompts.shape) != (args.batch, args.prompt_len):
        raise ValueError(f"prompts {tuple(prompts.shape)}, expected "
                         f"{(args.batch, args.prompt_len)}")
    shape = memory_shape(cfg, args.batch)
    if memory is None and shape is not None:
        memory = torch.full(shape, 0.1, dtype=torch.float32)
    if memory is not None:
        memory = torch.as_tensor(memory).to(dev)
    kept = []

    @torch.no_grad()
    def step(tok, cache, pos):
        logits, cache = decode_step(params, cfg, tok, cache, pos,
                                    memory=memory)
        if keep_logits:
            kept.append(logits[:, -1].cpu())
        return logits, cache

    # prefill via sequential decode (cache-consistent for every family)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.prompt_len):
        logits, cache = step(prompts[:, i:i + 1], cache, i)
    _sync(dev)
    prefill = time.perf_counter() - t0
    generated = []
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(args.gen):
        generated.append(tok)
        logits, cache = step(tok, cache, args.prompt_len + i)
        tok = logits[:, -1].argmax(-1)[:, None]
    out = torch.cat(generated, 1)
    _sync(dev)
    dt = time.perf_counter() - t0
    total_tokens = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s incl. prefill)", flush=True)
    print("sample token ids:", out[0][:12].tolist(), flush=True)
    return {"ids": out.cpu(), "prompts": prompts.cpu(), "seconds": dt,
            "prefill_seconds": prefill, "tokens_per_s": total_tokens / dt,
            "logits": kept if keep_logits else None}


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


if __name__ == "__main__":
    main()
