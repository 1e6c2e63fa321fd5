"""Serving for the port: byte tokenizer, sampler, continuous-batching engine."""
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.sampler import sample  # noqa: F401
from repro_torch.serving.tokenizer import ByteTokenizer  # noqa: F401
