from repro_torch.optim.adamw import AdamW, OptState  # noqa: F401
from repro_torch.optim.compression import (  # noqa: F401
    compress_topk,
    decompress_topk,
    int8_allreduce,
    topk_error_feedback_update,
)
