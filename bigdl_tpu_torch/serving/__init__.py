"""bigdl_tpu_torch.serving: continuous-batching LM inference (port of
``bigdl_tpu/serving``, dense slots).

- ``ContinuousBatchingEngine`` (``engine``): the loop thread, the pooled
  ``(max_slots, ...)`` KV cache, mid-flight chunked-prefill admission
  (``prefill_rows`` wide through one ragged call a round) and per-token
  slot eviction and reuse;
- ``PrefixCache`` (``prefix_cache``): the host-side radix trie over token
  prefixes mapping to retained KV pool rows;
- ``AdmissionQueue`` / ``PrefillPolicy`` (``scheduler``): the bounded
  admission queue with deadline and cancellation sweeps and its
  prefix-aware pop, and the prefill-vs-decode token budget (with the
  JAX module's ``TokenBucket``, ``SpeculationPolicy``, ``pages_needed``
  and ``page_fit_score``, which later steps use);
- ``RequestHandle`` (``streams``): per-request streaming iterator and
  blocking ``result()``; greedy output is token-identical to a lone
  ``model.generate``;
- ``run_poisson_comparison`` / ``run_shared_prefix_comparison``
  (``benchmark``): the engine against ``GenerationService`` under
  Poisson arrivals, and the prefix cache on against off.

Quick start::

    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    with ContinuousBatchingEngine(model, max_slots=8) as engine:
        h = engine.submit(prompt_ids, max_new_tokens=128)
        for tok in h.tokens():      # streams as the loop decodes
            ...
        row = h.result()            # prompt + generated
"""

from bigdl_tpu_torch.serving.benchmark import (
    poisson_workload, run_poisson_comparison, run_shared_prefix_comparison,
    shared_prefix_workload,
)
from bigdl_tpu_torch.serving.engine import ContinuousBatchingEngine
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from bigdl_tpu_torch.serving.scheduler import (
    AdmissionQueue, PrefillPolicy, SpeculationPolicy, TokenBucket,
    page_fit_score, pages_needed,
)
from bigdl_tpu_torch.serving.streams import (
    PRIORITIES, EngineDraining, EngineStopped, QueueFull,
    RequestCancelled, RequestError, RequestHandle, RequestRateLimited,
    RequestShed, RequestTimedOut,
)

__all__ = [
    "ContinuousBatchingEngine", "PrefixCache", "PrefixEntry",
    "AdmissionQueue", "PrefillPolicy", "SpeculationPolicy",
    "TokenBucket", "pages_needed", "page_fit_score",
    "RequestHandle", "RequestError", "RequestCancelled",
    "RequestTimedOut", "RequestShed", "RequestRateLimited",
    "QueueFull", "EngineStopped", "EngineDraining", "PRIORITIES",
    "poisson_workload", "run_poisson_comparison",
    "shared_prefix_workload", "run_shared_prefix_comparison",
]
