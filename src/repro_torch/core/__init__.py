"""Equinox's primary contribution: holistic-fairness counters, the HF
scheduler (+ FCFS/RPM/VTC/DLPM baselines), the policy-independent HF
observer and the discrete-event continuous-batching simulator."""
from repro_torch.core.counters import (DEFAULT_ALPHA, DEFAULT_BETA,
                                       DEFAULT_DELTA, OUT_TOKEN_WEIGHT,
                                       HFParams, hf_scores, rfc_increment,
                                       select_min_hf, ufc_increment)
from repro_torch.core.metrics import (HFObserver, delivered_jain, jain,
                                      service_difference_stats, summarize)
from repro_torch.core.request import (Interaction, Request, SLO_CLASSES,
                                      SLOTarget, set_slo)
from repro_torch.core.schedulers import (DLPM, FCFS, RPM, VTC, Equinox,
                                         SchedulerBase, make_scheduler)
from repro_torch.core.simulator import SimConfig, SimResult, Simulator

__all__ = ["DEFAULT_ALPHA", "DEFAULT_BETA", "DEFAULT_DELTA",
           "OUT_TOKEN_WEIGHT", "HFParams", "hf_scores", "rfc_increment",
           "select_min_hf", "ufc_increment", "HFObserver", "delivered_jain",
           "jain", "service_difference_stats", "summarize", "Interaction",
           "Request", "SLO_CLASSES", "SLOTarget", "set_slo", "DLPM",
           "FCFS", "RPM", "VTC", "Equinox", "SchedulerBase",
           "make_scheduler", "SimConfig", "SimResult", "Simulator"]
