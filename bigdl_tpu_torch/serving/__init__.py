"""bigdl_tpu_torch.serving: continuous-batching LM inference (port of
``bigdl_tpu/serving``: dense slots, paged KV, speculative decoding,
int8 KV and weights, the prefix host tier, QoS and chaos drills).

- ``ContinuousBatchingEngine`` (``engine``): the loop thread, the pooled
  ``(max_slots, ...)`` KV cache or (``page_size=``) the page pool,
  mid-flight chunked-prefill admission (``prefill_rows`` wide through
  one ragged call a round), per-token slot eviction and reuse,
  (``draft=``) draft-propose / target-verify decoding, (``kv_dtype=`` /
  ``weights_dtype="int8"``) int8 KV pools and the int8 weight clone,
  (``prefix_host_bytes=``) the prefix cache's host tier, and QoS:
  preemption of lower-class slots for waiting high-class requests,
  load shedding under a TTFT SLO burn, per-tenant token buckets over
  the usage ledger's device-seconds;
- ``ChaosInjector`` / ``ChaosFault`` (``chaos``): scripted TTFT burns,
  dispatch faults and frozen slots;
- ``PrefixCache`` (``prefix_cache``): the host-side radix trie over token
  prefixes mapping to retained KV pool rows, with a host tier that
  demoted rows spill to;
- ``PagePool`` / ``BlockTable`` / ``PagedPrefixIndex`` (``paging``): the
  refcounted page allocator, one request's page list, and the prefix
  index with shared pages as its currency;
- ``AdmissionQueue`` / ``PrefillPolicy`` / ``SpeculationPolicy``
  (``scheduler``): the bounded admission queue with deadline and
  cancellation sweeps and its prefix-aware pop, the prefill-vs-decode
  token budget, the draft's gamma, ``pages_needed`` and
  ``page_fit_score``, and the per-tenant ``TokenBucket``;
- ``RequestHandle`` (``streams``): per-request streaming iterator and
  blocking ``result()``; greedy output is token-identical to a lone
  ``model.generate``;
- ``run_poisson_comparison`` / ``run_shared_prefix_comparison`` /
  ``run_speculative_comparison`` / ``run_paged_comparison`` /
  ``run_quantized_comparison`` / ``run_working_set_sweep`` /
  ``run_qos_storm`` / ``run_tp_comparison`` and
  ``quantized_quality_report`` (``benchmark``): the engine against
  ``GenerationService`` under Poisson arrivals, the prefix cache on
  against off, a draft against none, paged against dense KV at equal
  bytes, int8 against full precision, the host tier against device-only
  past the pool's rows, a mixed-priority storm against its high class
  alone, sharded over a model-axis mesh against unsharded, and the int8
  path's logit drift.

Quick start::

    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    with ContinuousBatchingEngine(model, max_slots=8) as engine:
        h = engine.submit(prompt_ids, max_new_tokens=128)
        for tok in h.tokens():      # streams as the loop decodes
            ...
        row = h.result()            # prompt + generated
"""

from bigdl_tpu_torch.serving.benchmark import (
    mixed_length_workload, poisson_workload, qos_storm_workload,
    quantized_quality_report, repeated_text_workload, run_paged_comparison,
    run_poisson_comparison, run_qos_storm, run_quantized_comparison,
    run_shared_prefix_comparison, run_speculative_comparison,
    run_tp_comparison, run_working_set_sweep, shared_prefix_workload,
)
from bigdl_tpu_torch.serving.chaos import ChaosFault, ChaosInjector
from bigdl_tpu_torch.serving.engine import ContinuousBatchingEngine
from bigdl_tpu_torch.serving.paging import (
    SCRATCH_PAGE, BlockTable, PagedPrefixIndex, PagePool,
)
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
    "PagePool", "BlockTable", "PagedPrefixIndex", "SCRATCH_PAGE",
    "AdmissionQueue", "PrefillPolicy", "SpeculationPolicy",
    "TokenBucket", "pages_needed", "page_fit_score",
    "RequestHandle", "RequestError", "RequestCancelled",
    "RequestTimedOut", "RequestShed", "RequestRateLimited",
    "QueueFull", "EngineStopped", "EngineDraining", "PRIORITIES",
    "poisson_workload", "run_poisson_comparison",
    "shared_prefix_workload", "run_shared_prefix_comparison",
    "repeated_text_workload", "run_speculative_comparison",
    "mixed_length_workload", "run_paged_comparison",
    "quantized_quality_report", "run_quantized_comparison",
    "run_working_set_sweep", "qos_storm_workload", "run_qos_storm",
    "run_tp_comparison", "ChaosInjector", "ChaosFault",
]
