"""The port's model stack (dense family)."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    init_model,
    prefill_step,
)
