"""Training for the port: AdamW, data, the train step and loop, gradient
compression (``repro.training``)."""
from repro_torch.training.data import Prefetcher, TokenStream  # noqa: F401
from repro_torch.training.grad_compress import (  # noqa: F401
    compress,
    compress_with_feedback,
    decompress,
)
from repro_torch.training.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    init_opt_state,
    schedule,
)
from repro_torch.training.train_loop import TrainLoop, make_train_step  # noqa: F401
