"""The repo's own AdamW, LR schedules and gradient compression (port of
``repro.optim``)."""
from repro_torch.optim.adam import (AdamConfig, AdamW, adam_state_from_numpy,
                                    clip_by_global_norm)
from repro_torch.optim.compression import (ErrorFeedbackState, compress_int8,
                                           decompress_int8,
                                           ef_compress_update)
from repro_torch.optim.schedules import constant, inverse_sqrt, warmup_cosine

__all__ = ["AdamConfig", "AdamW", "adam_state_from_numpy",
           "clip_by_global_norm", "constant", "inverse_sqrt",
           "warmup_cosine", "compress_int8", "decompress_int8",
           "ErrorFeedbackState", "ef_compress_update"]
