"""End to end (paper-native): train a CIFAR-style CNN, then compress
it with an ordered pass sequence (default: the paper's D→P→Q→E; pass
``--sequence DPLQE`` for the 5-pass law with low-rank factorization) and
report accuracy / BitOpsCR / CR per stage.

    PYTHONPATH=src python -m repro_torch.examples.chain_cnn \\
        --model resnet8-cifar --steps 300

The reference's ``examples/chain_cnn.py`` on the port.  Any registered
pass key works in ``--sequence`` (``core/registry.py``): the pipeline
validates the sequence and only accepts hyperparameters for keys in it.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from repro_torch.configs.cnn import CNN_REGISTRY
    from repro_torch.core.chain import OPTIMAL_SEQUENCE, Pipeline
    from repro_torch.core.export import resolve_device
    from repro_torch.core.family import CNNFamily
    from repro_torch.core.passes import Trainer, init_chain_state
    from repro_torch.data import SyntheticImages

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--model', default='resnet8-cifar',
                    choices=sorted(CNN_REGISTRY))
    ap.add_argument('--steps', type=int, default=300,
                    help='fine-tune steps per stage (pretrain = 3x)')
    ap.add_argument('--sequence', default=OPTIMAL_SEQUENCE)
    ap.add_argument('--w-bits', type=int, default=2)
    ap.add_argument('--prune-ratio', type=float, default=0.3)
    ap.add_argument('--energy', type=float, default=0.9,
                    help="low-rank 'L' spectral-energy threshold")
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'chain_cnn: {e}', file=sys.stderr)
        return 2

    fam = CNNFamily(SyntheticImages(difficulty=0.55), image=32,
                    device=str(device))
    tr = Trainer(batch=64, steps=args.steps, lr=2e-3, eval_n=2,
                 eval_batch=256)
    print(f'== training baseline {args.model} ({args.steps * 3} steps) ==')
    st = init_chain_state(fam, CNN_REGISTRY[args.model], 0, tr,
                          pretrain_steps=args.steps * 3)
    print(f'== compressing with sequence {args.sequence} ==')
    defaults = {'D': {'factor': 0.5}, 'P': {'ratio': args.prune_ratio},
                'L': {'energy': args.energy},
                'Q': {'w_bits': args.w_bits, 'a_bits': 8},
                'E': {'threshold': 0.85}}
    hps = {k: defaults[k] for k in args.sequence if k in defaults}
    st = Pipeline.from_sequence(args.sequence, hps).run(fam, None, tr,
                                                        state=st)
    print(f"\n{'stage':10s} {'acc':>7s} {'BitOpsCR':>10s} {'CR':>8s}")
    for h in st.history:
        print(f"{h['pass']:10s} {h['acc']:7.3f} {h['BitOpsCR']:9.1f}x "
              f"{h['CR']:7.1f}x")
    return 0


if __name__ == '__main__':
    sys.exit(main())
