"""The port's model stack (the dense and rwkv6 families)."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    init_model,
    prefill_step,
)
