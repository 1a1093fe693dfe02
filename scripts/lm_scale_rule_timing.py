#!/usr/bin/env python3
"""Decode ms/token of an int8 W8A8 LM under the two activation-scale rules.

The LM serving forwards compute each activation fake quant's scale
``max(amax, 1e-8) / qmax`` by the jitted reference's rule, ``* fp32(1 /
qmax)`` (``launch/serve.py``'s ``serve_step`` enters
``quantization.jitted_scales``).  Before, the decode step divided.  This
script times both on one card in one process, in turns (divide, jitted,
jitted, divide): ``tinyllama-1.1b`` at its published width with
``--layers`` layers (11, path (h)'s student depth), ``export_lm`` int8
weights, W8A8, random bf16 weights from a CUDA generator seeded 0, batch
8, a prompt of 512 tokens, ``--tokens`` greedy steps from one cache each
turn.  Prints each turn's ms/token and the card's name and power limit.

    PYTHONPATH=src python scripts/lm_scale_rule_timing.py
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.export import export_lm
from repro_torch.data import SyntheticTokens
from repro_torch.launch import serve
from repro_torch.models.model import build_model
from repro_torch.tree import tree_map


def decode_ms(model, params, cache, tokens, batch, pos0, step):
    """ms/token of ``tokens`` steps of ``step`` from a copy of ``cache``."""
    cache = tree_map(lambda t: t.clone(), cache)   # written in place
    tok = torch.zeros((batch,), dtype=torch.int64, device='cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(tokens):
        tok, cache = step(model, params, tok, pos0 + t, cache)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / tokens * 1e3


def divide_step(model, params, token, cur, cache):
    """The decode step with the eager (dividing) scale rule."""
    with torch.inference_mode():
        logits, cache = model.decode_step(params, token, cur, cache)
    return torch.argmax(logits, -1), cache


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--layers', type=int, default=11)
    ap.add_argument('--tokens', type=int, default=64)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--prompt-len', type=int, default=512)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('lm_scale_rule_timing: needs a CUDA card')
    cfg = get_config('tinyllama-1.1b').replace(
        num_layers=args.layers, w_bits=8, a_bits=8)
    model = build_model(cfg)
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.no_grad():
        params = export_lm(model.init(gen, 'cuda'), cfg).params
    prompt = SyntheticTokens(vocab=cfg.vocab_size).batch(
        torch.Generator().manual_seed(1), args.batch, args.prompt_len,
        'cuda')['tokens']
    max_len = args.prompt_len + args.tokens + 8
    _, cache = serve.prefill_step(model, params, prompt, max_len=max_len)
    steps = {'divide': divide_step, 'jitted': serve.serve_step}
    decode_ms(model, params, cache, 4, args.batch, args.prompt_len,
              serve.serve_step)                   # warm-up: build, load
    for name in ('divide', 'jitted', 'jitted', 'divide'):
        ms = decode_ms(model, params, cache, args.tokens, args.batch,
                       args.prompt_len, steps[name])
        print(f'{name}: {ms:.3f} ms/token ({cfg.num_layers} layers, batch '
              f'{args.batch}, {args.tokens} tokens)')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())


if __name__ == '__main__':
    main()
