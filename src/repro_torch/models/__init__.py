from repro_torch.models.model import (decode_step, forward_hidden, init_cache,
                                      long_context_variant, loss_fn,
                                      model_stages, prefill, prefill_chunk,
                                      supports_chunked_prefill)

__all__ = ["decode_step", "forward_hidden", "init_cache",
           "long_context_variant", "loss_fn", "model_stages", "prefill",
           "prefill_chunk", "supports_chunked_prefill"]
