"""Beyond-paper: the compression chain applied to an LM architecture.

Distills a reduced LM into a shallower student, prunes FFN channels,
QAT-quantizes to int8 and adds early-exit heads: the same D→P→Q→E law,
architecture-transferred (D→Q→E for an SSM such as ``mamba2-2.7b``, as
the reference does: its layers have no MLP to prune).

    PYTHONPATH=src python -m repro_torch.examples.chain_lm \\
        --arch tinyllama-1.1b

The reference's ``examples/chain_lm.py`` on the port.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES, get_smoke_config
    from repro_torch.core.chain import run_chain
    from repro_torch.core.export import resolve_device
    from repro_torch.core.family import LMFamily
    from repro_torch.core.passes import Trainer, init_chain_state
    from repro_torch.data import SyntheticTokens

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--arch', default='tinyllama-1.1b', choices=ARCH_NAMES)
    ap.add_argument('--steps', type=int, default=80)
    ap.add_argument('--layers', type=int, default=4)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f'chain_lm: {e}', file=sys.stderr)
        return 2

    cfg = get_smoke_config(args.arch, layers=args.layers).replace(
        vocab_size=256)
    fam = LMFamily(SyntheticTokens(vocab=cfg.vocab_size), seq=64,
                   device=str(device))
    tr = Trainer(batch=16, steps=args.steps, lr=2e-3, eval_n=1,
                 eval_batch=64)
    print(f'== training baseline {cfg.name} ==')
    st = init_chain_state(fam, cfg, 0, tr, pretrain_steps=args.steps * 3)
    seq = 'DPQE'
    if cfg.ssm_state:
        seq = 'DQE'          # channel pruning inapplicable to SSD state
        print('(ssm family: P skipped)')
    defaults = {'D': {'factor': 0.5}, 'P': {'ratio': 0.3},
                'Q': {'w_bits': 8, 'a_bits': 8},
                'E': {'threshold': 0.8}}
    # the pipeline rejects hps for keys outside the sequence: hand over
    # exactly what runs
    st = run_chain(fam, None, seq, {k: defaults[k] for k in seq}, tr,
                   state=st)
    print(f"\n{'stage':10s} {'next-tok acc':>12s} {'BitOpsCR':>10s} "
          f"{'CR':>8s}")
    for h in st.history:
        print(f"{h['pass']:10s} {h['acc']:12.3f} {h['BitOpsCR']:9.1f}x "
              f"{h['CR']:7.1f}x")
    return 0


if __name__ == '__main__':
    sys.exit(main())
