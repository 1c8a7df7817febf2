"""Serving: the encoder-mode engine, its typed API and admission control."""
from repro_torch.serving.api import HeadFn  # noqa: F401
from repro_torch.serving.engine import (EngineConfig,  # noqa: F401
                                        RequestTooLong, ServingEngine)
from repro_torch.serving.scheduler import (AdmissionQueue,  # noqa: F401
                                           RequestQueue)
