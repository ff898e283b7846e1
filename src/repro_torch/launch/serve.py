"""Serving launcher: batched prefill + greedy decode loop on one device.

The full inference path (prefill builds the KV cache through the CUDA
flash-attention kernel; decode steps extend it) with batched requests and
per-phase timing::

    python -m repro_torch.launch.serve --arch qwen2-1.5b --batch 4 --prompt-len 64 --gen 32
    python -m repro_torch.launch.serve --arch qwen2-1.5b --device cpu

As the JAX package's CLI, it runs the arch's reduced ``smoke_config()``;
:func:`serve` takes any config (``chip_smoke.py`` drives qwen2-1.5b's
``full_config()`` through it).  ``--device`` defaults to ``cuda``, and
without a card the CLI stops unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import quantize_kv_token


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: tfm.TransformerConfig, params: tfm.TransformerParams, prompts: torch.Tensor,
          gen: int):
    """Prefill ``prompts`` (B, S) and decode greedily until ``gen`` new tokens.

    With ``cfg.kv_quant`` the prefill's K/V are quantized per token
    (:func:`~repro_torch.models.attention.quantize_kv_token`) into the int8
    cache of :func:`~repro_torch.models.transformer.init_kv_cache_int8`, and
    decode reads it through the int8 dots.

    Returns ``(tokens (B, gen) int32, timings)``; timings holds
    ``prefill_s`` (prefill, cache fill and the first token), ``decode_s``
    and ``decode_steps`` (the ``gen − 1`` decode steps), on the host clock
    with a device synchronise at the end of each phase.
    """
    dev = params.embed.device
    prompts = prompts.to(dev)
    batch, prompt_len = prompts.shape
    max_len = prompt_len + gen

    _sync(dev)
    t0 = time.perf_counter()
    last_logits, kv = tfm.prefill(params, prompts, cfg)
    if cfg.kv_quant:  # the prefill's K/V quantized per token into the int8 cache
        cache = tfm.init_kv_cache_int8(cfg, batch, max_len, device=dev)
        fill = quantize_kv_token(kv[0], kv[1])
    else:
        cache = tfm.init_kv_cache(cfg, batch, max_len, dtype=cfg.dtype, device=dev)
        fill = kv
    for dst, src in zip(cache, fill):
        dst[:, :, :, :prompt_len] = src
    del kv, fill
    tok = torch.argmax(last_logits, -1).to(torch.int32)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = tfm.decode_step(params, tok, prompt_len + i, cache, cfg)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return torch.stack(out, dim=1), {"prefill_s": t_prefill, "decode_s": t_decode,
                                     "decode_steps": gen - 1}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) or cpu; without a card, cuda stops the run")
    args = ap.parse_args()

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from None
    mod = get_arch(args.arch)
    if mod.FAMILY != "lm":
        raise SystemExit("serve.py drives LM archs; use examples/ for others")
    cfg = mod.smoke_config()
    params = tfm.init_params(cfg, args.seed, dev)
    gen = torch.Generator().manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen)

    toks, t = serve(cfg, params, prompts, args.gen)
    steps = t["decode_steps"]
    print(f"prefill: {args.batch}×{args.prompt_len} tokens in {t['prefill_s']*1e3:.1f} ms")
    print(
        f"decode: {steps} steps × batch {args.batch} in {t['decode_s']*1e3:.1f} ms "
        f"({steps*args.batch/max(t['decode_s'],1e-9):.0f} tok/s)"
    )
    print("sample continuation ids:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
