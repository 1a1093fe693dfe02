from repro_torch.optim.adamw import (AdamWState, Optimizer,  # noqa: F401
                                     adamw, apply_updates,
                                     clip_by_global_norm, cosine_schedule)
from repro_torch.optim.compression import (  # noqa: F401
    allreduce_compressed, int8_compress_grads)
