"""The port's model core: the block stack in PyTorch (GECToR's encoder,
the Qwen2 decoder, the RecurrentGemma hybrid of RG-LRU and local
attention blocks), with its caches, decode loop and sampler."""
from repro_torch.models.transformer import (decode_loop,  # noqa: F401
                                            decode_segment, decode_step,
                                            forward, init_params,
                                            make_caches, prefill,
                                            prefill_chunk, sample_logits,
                                            spec_round, verify_chunk)
