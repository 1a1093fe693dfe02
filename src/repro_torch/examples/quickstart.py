"""Quickstart: build any ported architecture, train a few steps, decode.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        --arch tinyllama-1.1b --device cpu

The reference's ``examples/quickstart.py`` on the port.  Serving the
compressed model (``--serve-cnn``): QAT params to the dynamic-scale int8
export (``export_cnn``), then a batch served with and without early exit.
CI smoke (``--smoke``): the pass registry's consistency check, then a tiny
P→L→Q pipeline through int8 export, in seconds.  The LM demo trains the
arch's smoke config (``reduced``) with AdamW and greedy-decodes 8 tokens
after a 16-token prompt (a VLM's prompt after its zero patch rows, as the
reference gives them).  An encoder-decoder trains on zero frames (the
reference's batch carries none, and its forward fails there) and, as in
the reference, is not decoded.
"""
from __future__ import annotations

import argparse
import sys

import torch


def serve_cnn_demo(device):
    """QAT params to int8 export to batched early-exit inference."""
    from repro_torch.configs.cnn import RESNET8_CIFAR
    from repro_torch.core.export import export_cnn
    from repro_torch.core.family import CNNFamily
    from repro_torch.data import SyntheticImages

    fam = CNNFamily(SyntheticImages(), device=str(device))
    params = fam.init(fam.generator(0), RESNET8_CIFAR)
    params, cfg = fam.add_exits(fam.generator(1), params, RESNET8_CIFAR,
                                fam.default_exit_points(RESNET8_CIFAR))
    cfg = cfg.replace(w_bits=8, a_bits=8)      # the chain's Q pass sets these
    model = export_cnn(params, cfg, device=device)  # scales snapshot here
    x, _ = fam.eval_batches(1, 16)[0]
    logits = model.serve(x)
    pred, stage = model.serve_early_exit(x, threshold=0.85)
    print('int8 serving logits:', tuple(logits.shape),
          'early-exit stages:', [int(s) for s in stage])


def smoke_demo(device):
    """The pass registry's consistency, then a tiny P→L→Q pipeline (typed
    hyperparameters, a validated sequence) compiled to int8 serving."""
    from repro_torch.configs.cnn import RESNET8_CIFAR
    from repro_torch.core import registry
    from repro_torch.core.chain import Pipeline
    from repro_torch.core.family import CNNFamily
    from repro_torch.core.passes import Trainer, init_chain_state
    from repro_torch.core.planner import theoretical_order
    from repro_torch.data import SyntheticImages

    keys = registry.check_consistency()
    print('registry consistent:', ''.join(keys))
    print('theoretical order over registry:', theoretical_order())
    fam = CNNFamily(SyntheticImages(), device=str(device))
    tr = Trainer(batch=16, steps=2, eval_n=1, eval_batch=32)
    st = init_chain_state(fam, RESNET8_CIFAR, 0, tr, pretrain_steps=2)
    pipe = Pipeline.from_sequence('PLQ', {'P': {'ratio': 0.3},
                                          'L': {'energy': 0.9},
                                          'Q': {'w_bits': 8, 'a_bits': 8}})
    st = pipe.run(fam, None, tr, state=st)
    model = pipe.export(st, device=device)
    x, _ = fam.eval_batches(1, 8)[0]
    print('smoke: stages', [h['pass'] for h in st.history],
          'served int8 logits', tuple(model.serve(x).shape))


def lm_demo(arch, steps, device):
    """Train the arch's smoke config for ``steps`` AdamW steps on synthetic
    tokens, then greedy-decode a few tokens."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.passes import value_and_grad
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch.serve import decode_start, frontend_inputs
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw, apply_updates

    cfg = get_smoke_config(arch)               # reduced config
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    data = SyntheticTokens(vocab=cfg.vocab_size)
    opt = adamw(1e-3)
    opt_state = opt.init(params)

    def loss_fn(p, cfg, batch):
        lg = model.forward(p, batch)
        lp = torch.log_softmax(lg.to(torch.float32), -1)
        return -torch.gather(lp, -1, batch['labels'][..., None]).mean(), None

    for i in range(steps):
        batch = data.batch(torch.Generator().manual_seed(i), 8, 64, device)
        if cfg.arch_kind == 'encdec':
            batch['frames'] = torch.zeros((8, cfg.frontend_tokens,
                                           cfg.d_model), device=device)
        loss, grads = value_and_grad(loss_fn, cfg, params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        if i % 5 == 0:
            print(f'step {i:3d} loss {float(loss):.3f}')

    if cfg.arch_kind in ('decoder', 'vlm'):
        prompt = {'tokens': data.batch(torch.Generator().manual_seed(99), 1,
                                       16, device)['tokens']}
        prompt.update(frontend_inputs(cfg, 1, device))
        with torch.inference_mode():
            logits, cache = model.prefill(params, prompt, max_len=64)
            tok = torch.argmax(logits, -1)
            out = [int(tok[0])]
            pos0 = decode_start(cfg, 16)
            for t in range(8):
                logits, cache = model.decode_step(params, tok, pos0 + t,
                                                  cache)
                tok = torch.argmax(logits, -1)
                out.append(int(tok[0]))
        print('decoded continuation:', out)


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.core.export import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default='tinyllama-1.1b', choices=ARCH_NAMES)
    ap.add_argument('--steps', type=int, default=20)
    ap.add_argument('--serve-cnn', action='store_true',
                    help='demo: export + serve an int8 compressed CNN')
    ap.add_argument('--smoke', action='store_true',
                    help='CI smoke: registry check + tiny pipeline + export')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'quickstart: {e}', file=sys.stderr)
        return 2
    if args.smoke:
        smoke_demo(device)
    elif args.serve_cnn:
        serve_cnn_demo(device)
    else:
        lm_demo(args.arch, args.steps, device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
