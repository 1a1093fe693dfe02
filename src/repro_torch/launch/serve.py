"""LM decode serving launcher: prefill a batch of prompts, then greedy-decode
with the KV cache updated in place.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --batch 8 --prompt-len 512 --tokens 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b \\
        --smoke --device cpu

The single-device form of the reference's ``launch/serve.py``: random
weights from seed 0, prompts from ``SyntheticTokens`` (seed 1), a prefill
into a cache of ``prompt_len + tokens + 8`` slots, then ``--tokens`` greedy
decode steps (:func:`serve_step`, the counterpart of the reference's
``build_serve_step``, whose cache buffer is donated: here it is written in
place).  As in the reference (``serve.py:55``), decoding starts from token
0 after the prefill: the prefill's own greedy token is not fed back.
Every GQA layer of every step (global or local; recurrentgemma-9b's
local MQA layers) runs the decode-attention kernel
(``decode_attention``, or ``decode_attention_int8`` with
``--kv-cache-bits 8``); an MLA layer (deepseek-v3-671b) attends in its
latent space in torch ops (``attention.decode_mla_reference``: the
reference has no kernel for it), and its cache ignores
``--kv-cache-bits``, as the reference's does (the launcher says so).
An MoE layer (mixtral-8x7b, deepseek-v3-671b) runs ``models/moe.py``; an
RG-LRU or SSD layer (recurrentgemma-9b, mamba2-2.7b) runs
``models/recurrent.py`` in torch ops and keeps an fp32 state whatever
``--kv-cache-bits`` says (mamba2-2.7b has no KV cache at all).
Prints the ms/token.  ``--arch`` takes every
ported arch; the default is the reference's, ``gemma2-9b``.  A VLM's
prompt gets ``frontend_tokens`` zero patch embeddings before its tokens,
and decoding starts at ``prompt_len + frontend_tokens``; an
encoder-decoder exits, as the reference's launcher does.

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given; without a card it exits with an error instead of falling back.
``--int8-weights`` serves the ``export_lm`` weights (the reference's
``build_serve_step(int8_weights=True)``).  ``--layers N`` cuts the depth
to N layers at the published width (mixtral-8x7b's 93 GB of bf16 weights
do not fit one card; 12 layers do).
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.export import export_lm, resolve_device
from repro_torch.core.quantization import jitted_scales
from repro_torch.data import SyntheticTokens
from repro_torch.models.model import build_model
from repro_torch.models.transformer import torch_dtype


def build(cfg, device, *, seed=0, int8_weights=False):
    """(model, params): random weights drawn on ``device`` from ``seed``,
    int8-exported when asked."""
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        params = model.init(gen, device)
    if int8_weights:
        params = export_lm(params, cfg).params
    return model, params


def frontend_inputs(cfg, batch, device):
    """A prompt's frontend inputs as the reference's launchers give them:
    a VLM's ``frontend_tokens`` zero patch embeddings; none otherwise."""
    if cfg.arch_kind != 'vlm':
        return {}
    return {'patches': torch.zeros(
        (batch, cfg.frontend_tokens, cfg.d_model),
        dtype=torch_dtype(cfg.dtype), device=device)}


def decode_start(cfg, prompt_len):
    """The first decode position: after the prompt and a VLM's patches."""
    return prompt_len + (cfg.frontend_tokens if cfg.arch_kind == 'vlm'
                         else 0)


@torch.inference_mode()
def prefill_step(model, params, tokens, *, max_len, **inputs):
    """Prefill a (B, S) prompt batch, with the frontend ``inputs`` of the
    batch dict (``patches``, ``frames``): (greedy next token (B,), cache).
    The reference jits the prefill, so the activation fake quants take the
    jitted scale (``quantization.jitted_scales``)."""
    with jitted_scales():
        logits, cache = model.prefill(params, {'tokens': tokens, **inputs},
                                      max_len=max_len)
    return torch.argmax(logits, -1), cache


@torch.inference_mode()
def serve_step(model, params, token, cur, cache, *, ctx=None, enc=None):
    """One decode step at position ``cur`` (a Python int): greedy next
    token (B,), the cache updated in place; under the jitted scale, as
    the reference's jitted step.  ``enc``: an encoder-decoder's encoder
    output."""
    with jitted_scales():
        logits, cache = model.decode_step(params, token, cur, cache,
                                          ctx=ctx, enc=enc)
    return torch.argmax(logits, -1), cache


def decode(model, params, cache, tok, *, pos0, tokens, ctx=None, enc=None):
    """``tokens`` greedy steps from the (B,) token ``tok`` at position
    ``pos0`` (the reference feeds zeros): the (tokens, B) generated ids."""
    out = []
    for t in range(tokens):
        tok, cache = serve_step(model, params, tok, pos0 + t, cache, ctx=ctx,
                                enc=enc)
        out.append(tok)
    return torch.stack(out) if out else tok.new_zeros((0,) + tok.shape)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default='gemma2-9b', choices=ARCH_NAMES)
    ap.add_argument('--smoke', action='store_true')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--tokens', type=int, default=12)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--int8-weights', action='store_true')
    ap.add_argument('--kv-cache-bits', type=int, default=0, choices=(0, 8))
    ap.add_argument('--layers', type=int, default=0,
                    help='cut the depth to this many layers, the width '
                         'kept (a model one card cannot hold whole)')
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'serve: {e}', file=sys.stderr)
        return 2
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.arch_kind == 'encdec':
        print('serve: decoder-only serving example', file=sys.stderr)
        return 2
    cfg = cfg.replace(kv_cache_bits=args.kv_cache_bits)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    if cfg.use_mla and args.kv_cache_bits:
        print(f'serve: {cfg.name} keeps an MLA latent cache, which '
              f'--kv-cache-bits does not change (as in the reference)',
              file=sys.stderr)
    pos0 = decode_start(cfg, args.prompt_len)
    max_len = pos0 + args.tokens + 8
    data = SyntheticTokens(vocab=cfg.vocab_size)
    model, params = build(cfg, device, int8_weights=args.int8_weights)
    prompt = data.batch(torch.Generator().manual_seed(1), args.batch,
                        args.prompt_len, device)['tokens']
    if device.type == 'cuda':
        from repro_torch.kernels import _build
        _build.load('decode_attention')     # build before timing
    _, cache = prefill_step(model, params, prompt, max_len=max_len,
                            **frontend_inputs(cfg, args.batch, device))
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    decode(model, params, cache,
           torch.zeros((args.batch,), dtype=torch.int64, device=device),
           pos0=pos0, tokens=args.tokens)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / max(args.tokens, 1)
    name = torch.cuda.get_device_name(device) if device.type == 'cuda' \
        else 'cpu'
    print(f'{cfg.name}: {dt * 1e3:.1f} ms/token at batch {args.batch} '
          f'(device {name})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
