"""Serving example: batched prefill and greedy decode with a KV cache,
optionally on fake-quantized weights (the paper's Q pass at inference),
with the cost model's BitOps a token.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm \\
        --arch gemma2-9b --tokens 16 --device cpu

The reference's ``examples/serve_lm.py`` on the port, on the arch's smoke
config.  Every decode step runs the decode-attention kernel on the card
(its plain version on the CPU); prefill and decode are timed after a
synchronize.  An encoder-decoder exits, as in the reference.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.core.bitops import lm_bitops
    from repro_torch.core.export import resolve_device
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import serve

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default='gemma2-9b', choices=ARCH_NAMES)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--tokens', type=int, default=16)
    ap.add_argument('--w-bits', type=int, default=0,
                    help='8 -> serve with fake-quantized weights (Q pass)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'serve_lm: {e}', file=sys.stderr)
        return 2

    cfg = get_smoke_config(args.arch)
    if args.w_bits:
        cfg = cfg.replace(w_bits=args.w_bits, a_bits=8)
    if cfg.arch_kind == 'encdec':
        print('serve_lm: use whisper decode via tests; this example is '
              'decoder-only serving', file=sys.stderr)
        return 2
    model, params = serve.build(cfg, device)
    data = SyntheticTokens(vocab=cfg.vocab_size)
    prompt = data.batch(torch.Generator().manual_seed(1), args.batch,
                        args.prompt_len, device)['tokens']
    extra = serve.frontend_inputs(cfg, args.batch, device)
    pos0 = serve.decode_start(cfg, args.prompt_len)
    max_len = pos0 + args.tokens + 8

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    tok, cache = serve.prefill_step(model, params, prompt, max_len=max_len,
                                    **extra)
    sync()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = serve.decode(model, params, cache, tok, pos0=pos0,
                        tokens=args.tokens)
    sync()
    t_decode = (time.perf_counter() - t0) / max(args.tokens, 1)

    bops = lm_bitops(cfg, args.prompt_len, decode=True,
                     ctx_len=args.prompt_len + args.tokens)
    print(f'arch={cfg.name} w_bits={cfg.w_bits or 32} device={device.type}')
    print(f'prefill {args.batch}x{args.prompt_len}: {t_prefill * 1e3:.1f} ms')
    print(f'decode: {t_decode * 1e3:.1f} ms/token '
          f'({args.batch} sequences in flight)')
    print(f'BitOps/token (cost model): {bops:.3g}')
    print('sampled:', [int(tok[0])] + [int(t[0]) for t in outs])
    return 0


if __name__ == '__main__':
    sys.exit(main())
