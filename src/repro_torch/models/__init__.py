from repro_torch.models.model import (decode_step, forward_hidden, init_cache,
                                      long_context_variant, loss_fn,
                                      model_stages, prefill, prefill_chunk,
                                      supports_chunked_prefill)
from repro_torch.models.sharding import (batch_axes, batch_specs, cache_specs,
                                         param_specs)

__all__ = ["decode_step", "forward_hidden", "init_cache",
           "long_context_variant", "loss_fn", "model_stages", "prefill",
           "prefill_chunk", "supports_chunked_prefill",
           "batch_axes", "batch_specs", "cache_specs", "param_specs"]
