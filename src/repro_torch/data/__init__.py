from repro_torch.data.synthetic import (SyntheticImages,  # noqa: F401
                                       SyntheticTokens, image_batches,
                                       lm_batches)
