"""input_specs(): ``meta``-tensor stand-ins for every (arch x shape) cell
(the reference's ``launch/specs.py``, where they are ShapeDtypeStructs).

Shapes and dtypes only: a ``meta`` tensor never allocates.  The four
assigned shapes:

    train_4k     seq 4096,    global_batch 256   (train_step)
    prefill_32k  seq 32768,   global_batch 32    (prefill_step)
    decode_32k   ctx 32768,   global_batch 128   (serve_step, 1 new token)
    long_500k    ctx 524288,  global_batch 1     (serve_step; sub-quadratic
                                                  archs only)

Modality frontends are stubs: whisper gets precomputed frame embeddings,
internvl2 precomputed patch embeddings.  Token ids are int32, as the
reference's.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import torch_dtype

SHAPES = {
    'train_4k': dict(kind='train', seq=4096, batch=256),
    'prefill_32k': dict(kind='prefill', seq=32768, batch=32),
    'decode_32k': dict(kind='decode', seq=32768, batch=128),
    'long_500k': dict(kind='decode', seq=524288, batch=1, long_ctx=True),
}

# archs with a sub-quadratic long-context path (SSM / recurrent / majority
# sliding-window).  Pure full-attention archs skip long_500k.
LONG_CTX_ARCHS = {'mamba2-2.7b', 'recurrentgemma-9b', 'gemma2-9b',
                  'gemma3-12b', 'mixtral-8x7b'}


def cells(arch_names):
    """All defined (arch, shape) dry-run cells."""
    out = []
    for a in arch_names:
        for s in SHAPES:
            if s == 'long_500k' and a not in LONG_CTX_ARCHS:
                continue
            out.append((a, s))
    return out


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device='meta')


def input_specs(cfg, shape_name: str):
    """Abstract inputs for the given cell: dict for train/prefill batches."""
    info = SHAPES[shape_name]
    B, S = info['batch'], info['seq']
    dt = torch_dtype(cfg.dtype)

    def tok(b, s):
        return _meta((b, s), torch.int32)

    if info['kind'] in ('train', 'prefill'):
        n_front = cfg.frontend_tokens if cfg.arch_kind in ('vlm', 'encdec') \
            else 0
        batch = {}
        if cfg.arch_kind == 'vlm':
            text = S - n_front
            batch['tokens'] = tok(B, text)
            batch['patches'] = _meta((B, n_front, cfg.d_model), dt)
            batch['labels'] = tok(B, text)
        elif cfg.arch_kind == 'encdec':
            # seq budget split: encoder frames (stub embeddings) + decoder
            batch['frames'] = _meta((B, min(n_front, S // 2), cfg.d_model),
                                    dt)
            batch['tokens'] = tok(B, S)
            batch['labels'] = tok(B, S)
        else:
            batch['tokens'] = tok(B, S)
            batch['labels'] = tok(B, S)
        if info['kind'] == 'prefill':
            batch.pop('labels')
        return batch

    # decode: handled by build_serve_step's avals (cache + one token)
    return dict(batch=B, max_len=S, long_ctx=info.get('long_ctx', False))
