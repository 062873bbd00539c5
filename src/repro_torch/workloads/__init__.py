from repro_torch.workloads.synthetic import (SCENARIOS, balanced, diurnal, dynamic,
                                       overload, stochastic, tag_slo_classes,
                                       zipf_scale)
from repro_torch.workloads.traces import (corpus, lmsys_like,
                                    multiturn_interactions,
                                    multiturn_sharegpt_like, sharegpt_like,
                                    true_output_len)
from repro_torch.workloads.vocab import (TRACE_VOCAB, prompt_token_ids, stable_hash,
                                   token_id)

__all__ = ["SCENARIOS", "balanced", "diurnal", "dynamic", "overload",
           "stochastic", "tag_slo_classes", "zipf_scale", "corpus",
           "lmsys_like",
           "multiturn_interactions", "multiturn_sharegpt_like",
           "sharegpt_like", "true_output_len",
           "TRACE_VOCAB", "prompt_token_ids", "stable_hash", "token_id"]
