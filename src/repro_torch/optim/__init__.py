from repro_torch.optim.adamw import (AdamWState, Optimizer,  # noqa: F401
                                     adamw, apply_updates,
                                     clip_by_global_norm, cosine_schedule)
