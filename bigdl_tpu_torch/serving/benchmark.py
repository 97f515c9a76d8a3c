"""Poisson-arrival serving comparisons (port of the engine-against-
``GenerationService``, shared-prefix, speculative, paged, quantized,
working-set and QoS-storm parts of ``bigdl_tpu/serving/benchmark.py``).

:func:`run_poisson_comparison` replays ONE sampled open-loop workload
(exponential inter-arrival gaps, mixed prompt and decode lengths)
against the continuous-batching engine and against ``GenerationService``
and reports per-request latency p50/p99 both ways, the engine's TTFT and
mean inter-token gap p50/p99, and delivered tokens/s both ways.
:func:`run_shared_prefix_comparison` replays a prefix-heavy workload
through the engine with its prefix cache on and off and reports the
TTFT speedups, the hit rate and whether both paths gave the same rows.
:func:`run_speculative_comparison` replays a repeated-text workload with
a draft proposing ``gamma`` tokens a round against plain decode: the
inter-token and TTFT speedups, the acceptance rate and token parity.
:func:`run_paged_comparison` replays a mixed short/long storm through
the paged engine and the dense engine at an equal KV byte budget: the
peak admitted concurrency both ways, the TTFT speedups, the pool block
and token parity.
:func:`quantized_quality_report` teacher-forces the int8 path (int8 KV,
optionally the int8 weight clone) down the float model's greedy
trajectory: logit divergence and the greedy prefix agreement.
:func:`run_quantized_comparison` replays a repeated-text workload through
the int8 engine and the float engine (plus int8-KV-only and the two
speculative legs under the int8 draft): percentiles both ways, the row
bytes both ways, the quality report, the acceptance delta and token
parity within each numerics regime. :func:`run_working_set_sweep` grows
a round-robin template working set past the prefix pool's rows and
replays it through a host-tiered, a device-only and a cache-off engine:
hit rates, TTFT, demotions and promotions, token parity.
:func:`run_qos_storm` replays a mixed-priority storm into an undersized
engine with the whole QoS stack on (a tripwire TTFT objective, zero
preemption slack, a starved tenant bucket), then the high class alone:
the high-class TTFT ratios, the shed / preempted / rate-limited counts,
outcome conservation and the usage ledger's per-tenant device-seconds.
:func:`run_tp_comparison` replays a Poisson workload through the engine
sharded over a model-axis mesh (every rank of the mesh calls it) and
unsharded on the leader: both legs' percentiles, the mesh block, the
collectives' transport and token parity.
The workload generators draw from ``numpy.random.RandomState(seed)`` in
the JAX package's order, so a seed gives the same arrays in both
packages. Every engine leg carries the cost model's and the loop
phases' blocks (``cost``, ``loop``); the Poisson comparison's engine
leg the incident block, and the working-set sweep's legs the
dispatch-signature check (``jit_flat``), as the JAX rows do.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.quantized import Quantizer
from bigdl_tpu_torch.serving.streams import (
    RequestCancelled, RequestRateLimited, RequestShed, RequestTimedOut,
)


def poisson_workload(n_requests: int, rate_hz: float, vocab: int,
                     prompt_lens=(4, 16), decode_lens=(4, 24),
                     seed: int = 0,
                     tenants=("tenant-a", "tenant-b", "tenant-c")
                     ) -> List[dict]:
    """Sample an open-loop workload: each request gets an arrival offset
    (cumulative exponential gaps at ``rate_hz``), a random prompt, a
    random decode length and a round-robin ``tenant``; the same list
    replays against every serving path under comparison."""
    r = np.random.RandomState(seed)
    at = np.cumsum(r.exponential(1.0 / rate_hz, n_requests))
    out = []
    for i in range(n_requests):
        t0 = int(r.randint(prompt_lens[0], prompt_lens[1] + 1))
        out.append({
            "arrival_s": float(at[i]),
            "prompt": r.randint(0, vocab, (t0,)).astype(np.int32),
            "n": int(r.randint(decode_lens[0], decode_lens[1] + 1)),
            "tenant": tenants[i % len(tenants)] if tenants else None,
        })
    return out


def shared_prefix_workload(n_requests: int, rate_hz: float, vocab: int,
                           n_templates: int = 4, template_len: int = 96,
                           tail_lens=(4, 12), decode_lens=(4, 16),
                           seed: int = 0,
                           template_order: str = "random") -> List[dict]:
    """Sample a prefix-heavy open-loop workload: every prompt is one of
    ``n_templates`` shared heads followed by a short random tail. Same
    arrival and replay semantics as :func:`poisson_workload`;
    ``template_order="cycle"`` visits the templates round-robin (the LRU
    worst case) instead of uniformly at random."""
    if template_order not in ("random", "cycle"):
        raise ValueError(
            f"template_order must be 'random' or 'cycle', "
            f"got {template_order!r}")
    r = np.random.RandomState(seed)
    templates = [r.randint(0, vocab, (template_len,)).astype(np.int32)
                 for _ in range(n_templates)]
    at = np.cumsum(r.exponential(1.0 / rate_hz, n_requests))
    out = []
    for i in range(n_requests):
        ti = (i % n_templates if template_order == "cycle"
              else int(r.randint(0, n_templates)))
        tail = r.randint(0, vocab, (int(r.randint(
            tail_lens[0], tail_lens[1] + 1)),)).astype(np.int32)
        out.append({
            "arrival_s": float(at[i]),
            "prompt": np.concatenate([templates[ti], tail]),
            "n": int(r.randint(decode_lens[0], decode_lens[1] + 1)),
            "tenant": f"tpl-{ti}",
        })
    return out


def repeated_text_workload(n_requests: int, rate_hz: float, vocab: int,
                           motif_len: int = 4, prompt_lens=(8, 16),
                           decode_lens=(8, 24), seed: int = 0,
                           tenants=("tenant-a", "tenant-b", "tenant-c")
                           ) -> List[dict]:
    """Sample a repeated-text open-loop workload: each prompt tiles a
    short random motif (boilerplate, markup, table rows: the
    self-similar traffic a draft predicts well), so speculative decoding
    gets a fair shot at a high acceptance rate while prompts stay
    distinct enough that the prefix cache is not what is measured. Same
    arrival and replay semantics as :func:`poisson_workload`."""
    r = np.random.RandomState(seed)
    at = np.cumsum(r.exponential(1.0 / rate_hz, n_requests))
    out = []
    for i in range(n_requests):
        motif = r.randint(0, vocab, (motif_len,)).astype(np.int32)
        t0 = int(r.randint(prompt_lens[0], prompt_lens[1] + 1))
        reps = -(-t0 // motif_len)
        out.append({
            "arrival_s": float(at[i]),
            "prompt": np.tile(motif, reps)[:t0],
            "n": int(r.randint(decode_lens[0], decode_lens[1] + 1)),
            "tenant": tenants[i % len(tenants)] if tenants else None,
        })
    return out


def mixed_length_workload(n_requests: int, rate_hz: float, vocab: int,
                          short_prompt=(4, 12), short_decode=(4, 12),
                          long_prompt: int = 32, long_decode: int = 8,
                          long_every: int = 6, seed: int = 0,
                          tenants=("tenant-a", "tenant-b", "tenant-c")
                          ) -> List[dict]:
    """Sample a mixed short/long open-loop workload: mostly short
    interactive requests with every ``long_every``-th a long-prompt job,
    the traffic where full-window slot reservation wastes the most KV
    and page-granular reservation buys the most concurrency. Long
    requests have fixed lengths, so their page footprint does not depend
    on the seed. Same arrival and replay semantics as
    :func:`poisson_workload`."""
    r = np.random.RandomState(seed)
    at = np.cumsum(r.exponential(1.0 / rate_hz, n_requests))
    out = []
    for i in range(n_requests):
        if long_every and i % long_every == long_every - 1:
            t0, n = int(long_prompt), int(long_decode)
        else:
            t0 = int(r.randint(short_prompt[0], short_prompt[1] + 1))
            n = int(r.randint(short_decode[0], short_decode[1] + 1))
        out.append({
            "arrival_s": float(at[i]),
            "prompt": r.randint(0, vocab, (t0,)).astype(np.int32),
            "n": n,
            "tenant": tenants[i % len(tenants)] if tenants else None,
        })
    return out


def _peak_concurrency(spans) -> int:
    """Max number of overlapping ``(start, end)`` intervals: the peak
    count of requests holding a slot at once (admitted, not yet
    finished), from the handles' own stamps. A release at exactly
    another's admission is a handoff, not an overlap."""
    events = []
    for a, b in spans:
        events.append((a, 1))
        events.append((b, -1))
    events.sort()   # (t, -1) orders before (t, +1): handoff, not overlap
    cur = peak = 0
    for _, d in events:
        cur += d
        peak = max(peak, cur)
    return peak


def _percentiles(xs) -> dict:
    if not xs:
        return {"p50": None, "p99": None}
    return {"p50": round(float(np.percentile(xs, 50)), 6),
            "p99": round(float(np.percentile(xs, 99)), 6)}


def _append_itl(itl: List[float], handle) -> None:
    """Record the request's mean inter-token gap (decode wall time over
    the decoded-token count)."""
    tl = handle.timeline()
    if tl["decode_s"] is not None and tl["tokens"] > 1:
        itl.append(tl["decode_s"] / (tl["tokens"] - 1))


def _usage_blocks(stats: dict) -> dict:
    """Compress ``engine.stats()["usage"]`` into the bench-row shape:
    the goodput block verbatim plus a per-tenant token /
    device-second breakdown (the columns a capacity planner reads)."""
    u = stats.get("usage") or {}
    tenants = {
        t: {"requests": a["requests"],
            "prefill_tokens": a["prefill_tokens"],
            "decode_tokens": a["decode_tokens"],
            "device_s": a["device_s"],
            "tokens_per_device_second": a["tokens_per_device_second"]}
        for t, a in (u.get("tenants") or {}).items()}
    return {"goodput": u.get("goodput"), "tenants": tenants}


def _open_loop(workload, one) -> float:
    """The open-loop arrival loop: each request is handed to ``one`` at
    its arrival offset, from a thread of its own (late submissions go
    at once: arrival times are an offered load, not a barrier). Joins
    every thread, re-raises the first error, returns the wall
    seconds."""
    errs: List[BaseException] = []
    lock = threading.Lock()
    t_start = time.monotonic()

    def run(req):
        try:
            one(req)
        except BaseException as e:
            with lock:
                errs.append(e)

    threads = []
    for req in workload:
        delay = t_start + req["arrival_s"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=run, args=(req,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    if errs:
        raise errs[0]
    return wall


def _replay(workload, submit_fn, collect_fn) -> dict:
    """Open-loop replay (:func:`_open_loop`); ``collect_fn`` blocks per
    request and returns its delivered token count."""
    lat: List[float] = []
    toks: List[int] = []
    lock = threading.Lock()

    def one(req):
        t_sub = time.monotonic()
        pending = submit_fn(req)
        n_tok = collect_fn(pending, req)
        dt = time.monotonic() - t_sub
        with lock:
            lat.append(dt)
            toks.append(n_tok)

    wall = _open_loop(workload, one)
    return {"latency": _percentiles(lat),
            "tokens_per_sec": round(sum(toks) / max(wall, 1e-9), 2),
            "wall_s": round(wall, 3), "requests": len(workload)}


def _engine_replay(model, workload, warm_prompt, warm_tokens,
                   stats_keys, log, label, after_warm=None,
                   **engine_kw) -> dict:
    """One engine leg of a comparison: build the engine, serve one warm
    request outside the measurement (none when ``warm_prompt`` is
    None), open-loop replay the workload, and return latency / TTFT /
    inter-token percentiles, delivered tokens/s, the per-request rows
    (keyed by ``id(req)``), the whole ``stats()`` under ``stats`` and
    the entries named by ``stats_keys`` at the top level, the usage
    ledger's goodput and per-tenant blocks, the cost model's and the
    loop phases' blocks, the active alerts, and the peak number of
    requests admitted at once (``peak_admitted_concurrency``).
    ``after_warm(engine)`` runs between the warm request and the replay
    (a baseline probe that must exclude warmup)."""
    from bigdl_tpu_torch.serving.engine import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(model, **engine_kw)
    ttft: List[float] = []
    itl: List[float] = []
    rows: dict = {}
    spans: List[tuple] = []
    tlock = threading.Lock()

    def collect(handle, req):
        row = handle.result()
        with tlock:
            rows[id(req)] = row
            if handle.first_token_at is not None:
                ttft.append(handle.first_token_at - handle.submitted_at)
            _append_itl(itl, handle)
            if handle.admitted_at is not None \
                    and handle.finished_at is not None:
                spans.append((handle.admitted_at, handle.finished_at))
        return row.shape[0] - req["prompt"].shape[0]

    if not engine.is_leader:
        # a follower rank of a mesh leg: run the leader's programs until
        # its stop header; the leader measures and reports
        engine.start()
        return None
    log(f"[serving-bench] {label} replay ({engine.service_name})...")
    with engine:
        if warm_prompt is not None:
            engine.submit(warm_prompt, warm_tokens).result(timeout=300)
        if after_warm is not None:
            after_warm(engine)
        res = _replay(
            workload,
            lambda req: engine.submit(req["prompt"], req["n"],
                                      tenant=req.get("tenant")),
            collect)
        stats = engine.stats()
    res["ttft"] = _percentiles(ttft)
    res["inter_token"] = _percentiles(itl)
    res["peak_admitted_concurrency"] = _peak_concurrency(spans)
    res["stats"] = stats
    for key in stats_keys:
        res[key] = stats[key]
    res.update(_usage_blocks(stats))
    res["cost"] = stats["cost"]
    res["loop"] = stats["loop"]
    res["alerts"] = stats["alerts"]
    res["rows"] = rows
    return res


def run_shared_prefix_comparison(model, n_requests: int = 24,
                                 rate_hz: float = 30.0,
                                 max_slots: int = 4,
                                 prefill_chunk: int = 8,
                                 prefill_rows: int = 2,
                                 n_templates: int = 4,
                                 template_len: int = 96,
                                 eos_id: Optional[int] = None,
                                 seed: int = 0, registry=None,
                                 log=None) -> dict:
    """Replay ONE shared-prefix Poisson workload through the engine
    twice, prefix cache enabled and disabled, everything else identical;
    report TTFT/latency percentiles for both, the cached run's
    hit-rate block, the p50/p99 TTFT speedups, and whether the two
    paths produced the same rows (``token_parity``; each leg's rows are
    kept under ``rows``, keyed by request index)."""
    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    # fit tail + decode inside the engine's serving window (the model
    # context rounded down to a chunk multiple, as the engine caps it)
    window = (model.max_len // prefill_chunk) * prefill_chunk
    room = window - template_len
    if room < 2:
        raise ValueError(
            f"template_len {template_len} leaves only {room} of the "
            f"engine's {window}-token serving window for tail + decode")
    tail_hi = max(1, min(12, room // 2))
    decode_hi = max(1, min(16, room - tail_hi))
    wl = shared_prefix_workload(
        n_requests, rate_hz, vocab, n_templates=n_templates,
        template_len=template_len,
        tail_lens=(min(4, tail_hi), tail_hi),
        decode_lens=(min(4, decode_hi), decode_hi),
        seed=seed)
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(
            0, vocab, (template_len,)), np.int32)

    def run_path(name: str, **engine_kw) -> dict:
        # the warm prompt is not a template, so the template cache
        # starts cold for both paths
        return _engine_replay(
            model, wl, warm_prompt, 2, ("prefix_cache",), log,
            "shared-prefix",
            max_slots=max_slots, prefill_chunk=prefill_chunk,
            prefill_rows=prefill_rows, eos_id=eos_id,
            registry=registry, service_name=name, **engine_kw)

    cached = run_path("bench_prefix_on")
    uncached = run_path("bench_prefix_off", prefix_cache_bytes=0)
    parity = all(
        np.array_equal(cached["rows"][id(req)], uncached["rows"][id(req)])
        for req in wl)
    for r in (cached, uncached):
        r["rows"] = [r["rows"][id(req)] for req in wl]

    def ratio(key):
        a, b = uncached["ttft"][key], cached["ttft"][key]
        return round(a / b, 4) if a and b else None

    return {"cached": cached, "uncached": uncached,
            "ttft_p50_speedup": ratio("p50"),
            "ttft_p99_speedup": ratio("p99"),
            "token_parity": bool(parity),
            "workload": {"kind": "shared_prefix",
                         "requests": n_requests, "rate_hz": rate_hz,
                         "seed": seed, "max_slots": max_slots,
                         "prefill_rows": prefill_rows,
                         "n_templates": n_templates,
                         "template_len": template_len},
            "requests": wl}


def run_poisson_comparison(model, n_requests: int = 16,
                           rate_hz: float = 20.0, max_slots: int = 4,
                           prefill_chunk: int = 8, max_batch: int = 4,
                           batch_timeout_ms: float = 10.0,
                           eos_id: Optional[int] = None, seed: int = 0,
                           registry=None, log=None, prompt_lens=(4, 16),
                           decode_lens=None, prefill_rows: int = 1) -> dict:
    """Run the same Poisson workload through the continuous-batching
    engine and through ``GenerationService``; return both result dicts
    (with the per-request rows under ``rows``, by request index, and the
    engine's ``stats()`` under ``stats``), the engine's TTFT and
    inter-token percentiles, and the p99 latency speedup (> 1.0: the
    engine's tail is shorter). ``prompt_lens`` and ``decode_lens`` size
    the workload (the defaults are the JAX package's)."""
    from bigdl_tpu_torch.optim.generation_service import GenerationService

    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    if decode_lens is None:
        decode_lens = (4, min(24, model.max_len // 2))
    wl = poisson_workload(n_requests, rate_hz, vocab,
                          prompt_lens=prompt_lens, decode_lens=decode_lens,
                          seed=seed)

    # no warm request: the JAX comparison replays the engine cold
    eng = _engine_replay(
        model, wl, None, 0, (), log, "poisson",
        max_slots=max_slots, prefill_chunk=prefill_chunk,
        prefill_rows=prefill_rows, eos_id=eos_id, registry=registry,
        service_name="bench_engine")
    eng["rows"] = [eng["rows"][id(req)] for req in wl]
    # calm-storm incident gate: a healthy Poisson replay records no
    # incident
    inc = eng["stats"]["incidents"]
    incidents = {"count": inc["count"], "by_kind": inc["by_kind"],
                 "calm": True}

    svc = GenerationService(model, max_batch=max_batch,
                            batch_timeout_ms=batch_timeout_ms,
                            bucket_tokens=8, prompt_bucket=8,
                            eos_id=eos_id, registry=registry,
                            service_name="bench_generation")
    log("[serving-bench] GenerationService replay...")
    svc_rows: dict = {}

    def collect_service(row, req):
        svc_rows[id(req)] = row
        return row.shape[0] - req["prompt"].shape[0]

    gen = _replay(
        wl, lambda req: svc.generate(req["prompt"], req["n"]),
        collect_service)
    gen["rows"] = [svc_rows[id(req)] for req in wl]

    p99_ratio = (round(gen["latency"]["p99"] / eng["latency"]["p99"], 4)
                 if eng["latency"]["p99"] else None)
    return {"engine": eng, "generation_service": gen,
            "p99_speedup": p99_ratio,
            "incidents": incidents,
            "workload": {"requests": n_requests, "rate_hz": rate_hz,
                         "seed": seed, "max_slots": max_slots,
                         "max_batch": max_batch,
                         "prefill_rows": prefill_rows,
                         "prompt_lens": list(prompt_lens),
                         "decode_lens": list(decode_lens)},
            "requests": wl}


def _parity(a: dict, b: dict, workload) -> bool:
    return all(np.array_equal(a["rows"][id(req)], b["rows"][id(req)])
               for req in workload)


def run_speculative_comparison(model, draft=None, n_requests: int = 24,
                               rate_hz: float = 30.0,
                               max_slots: int = 4,
                               prefill_chunk: int = 8,
                               prefill_rows: int = 2,
                               gamma: int = 4,
                               eos_id: Optional[int] = None,
                               seed: int = 0, registry=None,
                               log=None) -> dict:
    """Replay ONE repeated-text Poisson workload through the engine twice,
    speculative decoding on (``draft`` proposing ``gamma`` tokens a
    round) and off, everything else identical; report
    inter-token/TTFT/latency percentiles both ways, the acceptance rate,
    the inter-token and TTFT p50/p99 speedups, and whether the two paths
    produced the same rows (``token_parity``: under greedy decoding a
    draft changes how many target calls a row costs, never its tokens;
    each leg's rows are kept under ``rows``, by request index). The
    default draft is the int8 clone of ``model``."""
    if draft is None:
        draft = Quantizer.quantize(model)
        draft.evaluate()
    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    window = (model.max_len // prefill_chunk) * prefill_chunk
    decode_hi = max(8, min(24, window // 2 - 16))
    wl = repeated_text_workload(
        n_requests, rate_hz, vocab,
        prompt_lens=(8, min(16, window - decode_hi - 1)),
        decode_lens=(min(8, decode_hi), decode_hi), seed=seed)
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(0, vocab, (12,)), np.int32)

    def run_path(name: str, **engine_kw) -> dict:
        return _engine_replay(
            model, wl, warm_prompt, 4, ("speculation",), log,
            "speculative", max_slots=max_slots,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
            eos_id=eos_id, registry=registry, service_name=name,
            **engine_kw)

    spec = run_path("bench_spec_on", draft=draft, spec_gamma=gamma)
    nospec = run_path("bench_spec_off")
    parity = _parity(spec, nospec, wl)
    for r in (spec, nospec):
        r["rows"] = [r["rows"][id(req)] for req in wl]

    def ratio(metric, key):
        a, b = nospec[metric][key], spec[metric][key]
        return round(a / b, 4) if a and b else None

    return {"spec": spec, "nospec": nospec,
            "inter_token_p50_speedup": ratio("inter_token", "p50"),
            "inter_token_p99_speedup": ratio("inter_token", "p99"),
            "ttft_p50_speedup": ratio("ttft", "p50"),
            "ttft_p99_speedup": ratio("ttft", "p99"),
            "acceptance_rate":
                spec["speculation"].get("acceptance_rate"),
            "token_parity": bool(parity),
            "workload": {"kind": "speculative",
                         "requests": n_requests, "rate_hz": rate_hz,
                         "seed": seed, "max_slots": max_slots,
                         "prefill_rows": prefill_rows, "gamma": gamma},
            "requests": wl}


def run_paged_comparison(model, n_requests: int = 32,
                         rate_hz: float = 200.0, dense_slots: int = 2,
                         paged_slots: int = 8, page_size: int = 4,
                         prefill_chunk: int = 8, prefill_rows: int = 2,
                         eos_id: Optional[int] = None, seed: int = 0,
                         registry=None, log=None) -> dict:
    """Replay ONE mixed short/long Poisson storm through the engine twice
    at an EQUAL KV byte budget: paged (a ``page_size``-token pool holding
    exactly the dense leg's slot-row bytes, shared page by page among
    ``paged_slots`` slots) and dense (``dense_slots`` full serving-window
    rows). Reports the peak admitted concurrency both ways and its ratio
    (the capacity claim), TTFT/latency percentiles both ways, the paged
    leg's pool and fragmentation block, the byte budget, and whether the
    two paths produced the same rows (``token_parity``: paging moves
    bytes, never tokens; each leg's rows are kept under ``rows``, by
    request index). Both legs run with the prefix cache off, so the
    comparison isolates the reservation's granularity."""
    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    window = (model.max_len // prefill_chunk) * prefill_chunk
    table_len = -(-window // page_size)
    # EQUAL BYTE BUDGET: the paged pool gets exactly the bytes the dense
    # leg spends on its slot rows, plus the one scratch page every pool
    # carries
    max_pages = 1 + dense_slots * table_len
    # long jobs inside the window; the storm dense enough to queue
    # (arrivals outpace service, decodes long enough that early slots
    # are still held while admission fills the rest), or neither leg
    # reaches its concurrency ceiling
    long_prompt = min(32, window // 2)
    long_decode = min(16, max(1, window - long_prompt))
    wl = mixed_length_workload(
        n_requests, rate_hz, vocab,
        short_prompt=(4, min(12, window // 4)),
        short_decode=(8, min(16, window // 4)),
        long_prompt=long_prompt, long_decode=long_decode, seed=seed)
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(0, vocab, (12,)), np.int32)

    def leg(name: str, stats_keys, **engine_kw) -> dict:
        return _engine_replay(
            model, wl, warm_prompt, 4, stats_keys, log, "paged A/B",
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
            eos_id=eos_id, registry=registry, service_name=name,
            prefix_cache_rows=0, **engine_kw)

    paged = leg("bench_paged", ("paging",), max_slots=paged_slots,
                page_size=page_size, max_pages=max_pages)
    dense = leg("bench_dense", (), max_slots=dense_slots)
    parity = _parity(paged, dense, wl)
    for r in (paged, dense):
        r["rows"] = [r["rows"][id(req)] for req in wl]

    def ttft_ratio(key):
        a, b = dense["ttft"][key], paged["ttft"][key]
        return round(a / b, 4) if a and b else None

    page_bytes = paged["paging"]["pool"]["page_bytes"]
    peak_p = paged["peak_admitted_concurrency"]
    peak_d = dense["peak_admitted_concurrency"]
    return {
        "paged": paged, "dense": dense,
        "admitted_concurrency_ratio":
            round(peak_p / peak_d, 4) if peak_d else None,
        "ttft_p50_speedup": ttft_ratio("p50"),
        "ttft_p99_speedup": ttft_ratio("p99"),
        "token_parity": bool(parity),
        "kv_budget": {
            # what each leg could spend on request KV: the same by
            # construction (the scratch page is pool overhead)
            "dense_bytes": dense_slots * table_len * page_bytes,
            "paged_bytes": (max_pages - 1) * page_bytes,
            "page_bytes": page_bytes,
            "max_pages": max_pages,
            "table_len": table_len},
        "workload": {"kind": "paged", "requests": n_requests,
                     "rate_hz": rate_hz, "seed": seed,
                     "dense_slots": dense_slots,
                     "paged_slots": paged_slots,
                     "page_size": page_size,
                     "prefill_rows": prefill_rows},
        "requests": wl}


def quantized_quality_report(model, prompts=None, horizon: int = 16,
                             kv_dtype: str = "int8",
                             weights_dtype: Optional[str] = "int8",
                             n_prompts: int = 6, prompt_len: int = 8,
                             seed: int = 0) -> dict:
    """The numerics gate of quantized serving: roll the FLOAT model
    greedily for ``horizon`` tokens a prompt, then (a) teacher-force the
    quantized path (the int8 KV cache, and the int8 ``Quantizer`` clone
    when ``weights_dtype="int8"``) down the same trajectory and measure
    the per-token logit divergence, and (b) let the quantized path run
    free and measure how long its greedy output agrees with the float
    run. Deterministic for a (model, prompts, horizon): the same floats
    quantize to the same bytes.

    Returns ``logit_div_max`` / ``logit_div_mean`` (absolute),
    ``logit_div_rel`` (the max divergence over the float run's largest
    |logit|) and ``greedy_match_fraction`` (mean common-prefix length
    over the horizon)."""
    model.evaluate()
    if weights_dtype is not None and str(weights_dtype) == "int8":
        qmodel = Quantizer.quantize(model)
    else:
        qmodel = model
    qmodel.evaluate()
    vocab = model.vocab_size
    window = model.max_len
    horizon = max(2, min(horizon, window - prompt_len - 1))
    if prompts is None:
        r = np.random.RandomState(seed)
        prompts = [r.randint(0, vocab, (prompt_len,)).astype(np.int32)
                   for _ in range(n_prompts)]

    def greedy_roll(m, ids, kv, forced=None):
        """Greedy rollout (teacher-forced when ``forced`` lists the
        tokens to feed): (tokens, per-step f32 logits)."""
        c = m.init_cache(1, window, kv_dtype=kv)
        lg, c = m.prefill(ids, c)
        logits = [lg.float().reshape(-1).cpu().numpy()]
        toks = [int(np.argmax(logits[-1]))]
        pos = ids.shape[1]
        for i in range(horizon - 1):
            nxt = forced[i] if forced is not None else toks[-1]
            lg, c = m.decode_step(torch.tensor([nxt], device=m.device),
                                  pos, c)
            logits.append(lg.float().reshape(-1).cpu().numpy())
            toks.append(int(np.argmax(logits[-1])))
            pos += 1
        return toks, logits

    div_max, fp_scale = 0.0, 0.0
    div_means, match = [], []
    with torch.inference_mode():
        for p in prompts:
            ids = torch.as_tensor(np.asarray(p, np.int64),
                                  device=model.device)[None]
            fp_toks, fp_logits = greedy_roll(model, ids, None)
            fp_scale = max(fp_scale, max(float(np.max(np.abs(lg)))
                                         for lg in fp_logits))
            _, q_logits = greedy_roll(qmodel, ids, kv_dtype,
                                      forced=fp_toks)
            d = [float(np.max(np.abs(a - b)))
                 for a, b in zip(fp_logits, q_logits)]
            div_max = max(div_max, max(d))
            div_means.append(float(np.mean(d)))
            q_toks, _ = greedy_roll(qmodel, ids, kv_dtype)
            k = 0
            for a, b in zip(fp_toks, q_toks):
                if a != b:
                    break
                k += 1
            match.append(k / len(fp_toks))
    return {
        "kv_dtype": kv_dtype,
        "weights_dtype": (weights_dtype or "fp"),
        "prompts": len(prompts), "horizon": horizon,
        "vocab": vocab,
        "logit_div_max": round(div_max, 6),
        "logit_div_mean": round(float(np.mean(div_means)), 6),
        "logit_div_rel": (round(div_max / fp_scale, 6)
                          if fp_scale else 0.0),
        "greedy_match_fraction": round(float(np.mean(match)), 4),
    }


def run_quantized_comparison(model, n_requests: int = 24,
                             rate_hz: float = 30.0,
                             max_slots: int = 4,
                             prefill_chunk: int = 8,
                             prefill_rows: int = 2,
                             gamma: int = 4,
                             eos_id: Optional[int] = None,
                             seed: int = 0, registry=None,
                             log=None) -> dict:
    """Replay ONE repeated-text Poisson workload through the engine with
    int8 KV and int8 weights and at full precision, everything else
    identical, plus three more legs: int8 KV only, and the int8 draft
    (the ``Quantizer`` clone) proposing ``gamma`` tokens over float KV
    and over int8 KV. Reports the percentiles of every leg, the row
    bytes both ways (``capacity``), the quality report with the
    acceptance rates and their signed delta (float KV minus int8 KV),
    and token parity WITHIN each numerics regime: speculation must not
    change tokens over float KV or over int8 KV (across regimes int8
    rounds differently; the quality report bounds that drift), and the
    memory-bandwidth pair (``membw_util``) from each leg's cost model.
    Each leg's rows are kept under ``rows``, by request index."""
    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    window = (model.max_len // prefill_chunk) * prefill_chunk
    decode_hi = max(8, min(24, window // 2 - 16))
    wl = repeated_text_workload(
        n_requests, rate_hz, vocab,
        prompt_lens=(8, min(16, window - decode_hi - 1)),
        decode_lens=(min(8, decode_hi), decode_hi), seed=seed)
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(0, vocab, (12,)),
        np.int32)
    log("[serving-bench] quantizing the int8 draft clone...")
    draft = Quantizer.quantize(model)
    draft.evaluate()

    def run_path(name: str, **engine_kw) -> dict:
        return _engine_replay(
            model, wl, warm_prompt, 4, ("speculation", "quantization"),
            log, "quantized", max_slots=max_slots,
            prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
            eos_id=eos_id, registry=registry, service_name=name,
            **engine_kw)

    quant = run_path("bench_quant_on", kv_dtype="int8",
                     weights_dtype="int8")
    fp = run_path("bench_quant_off")
    # the acceptance-delta probe: the same draft over the same workload,
    # float KV against int8 KV (float weights in both, so the cache is
    # the only thing that moves); the int8-KV-only leg is the
    # non-speculative twin the int8 speculative leg's parity holds to
    kv8 = run_path("bench_quant_kv_only", kv_dtype="int8")
    spec_fp = run_path("bench_quant_spec_fp", draft=draft,
                       spec_gamma=gamma)
    spec_q = run_path("bench_quant_spec_int8", draft=draft,
                      spec_gamma=gamma, kv_dtype="int8")
    parity_fp = _parity(fp, spec_fp, wl)
    parity_q = _parity(kv8, spec_q, wl)
    for r in (quant, fp, kv8, spec_fp, spec_q):
        r["rows"] = [r["rows"][id(req)] for req in wl]
    log("[serving-bench] quantized quality report "
        "(teacher-forced logit divergence)...")
    quality = quantized_quality_report(model, horizon=min(16, window // 2))
    acc_fp = spec_fp["speculation"].get("acceptance_rate")
    acc_q = spec_q["speculation"].get("acceptance_rate")
    quality["acceptance_rate_fp"] = acc_fp
    quality["acceptance_rate_int8"] = acc_q
    # signed, positive = the int8 cache LOST acceptance
    quality["acceptance_delta"] = (round(acc_fp - acc_q, 4)
                                   if acc_fp is not None
                                   and acc_q is not None else None)

    def ratio(key, base=None, new=None):
        a = (base or fp)["inter_token"][key]
        b = (new or quant)["inter_token"][key]
        return round(a / b, 4) if a and b else None

    def membw(leg):
        return leg["cost"]["overall"]["membw_util"]

    qz = quant["quantization"]
    return {"quantized": quant, "fp_baseline": fp, "kv_only": kv8,
            "spec_fp": spec_fp, "spec_int8": spec_q,
            "inter_token_p50_speedup": ratio("p50"),
            "inter_token_p99_speedup": ratio("p99"),
            "spec_inter_token_p50_speedup":
                ratio("p50", base=spec_fp, new=spec_q),
            "spec_inter_token_p99_speedup":
                ratio("p99", base=spec_fp, new=spec_q),
            "membw_util": {"fp": membw(fp), "quantized": membw(quant)},
            "capacity": {
                "kv_row_bytes": qz["kv_row_bytes"],
                "fp_row_bytes": qz["fp_row_bytes"],
                "row_bytes_ratio": qz["row_bytes_ratio"],
                "capacity_multiplier":
                    (round(qz["fp_row_bytes"] / qz["kv_row_bytes"], 4)
                     if qz["kv_row_bytes"] else None)},
            "quality": quality,
            "token_parity_spec_fp": bool(parity_fp),
            "token_parity_spec_int8": bool(parity_q),
            "workload": {"kind": "quantized",
                         "requests": n_requests, "rate_hz": rate_hz,
                         "seed": seed, "max_slots": max_slots,
                         "prefill_rows": prefill_rows,
                         "gamma": gamma},
            "requests": wl}


def run_tp_comparison(model, tp: int = 2, n_requests: int = 16,
                      rate_hz: float = 30.0, max_slots: int = 4,
                      prefill_chunk: int = 8, prefill_rows: int = 2,
                      eos_id: Optional[int] = None, seed: int = 0,
                      registry=None, log=None, mesh=None,
                      model_axis: str = "model") -> Optional[dict]:
    """Replay ONE Poisson workload through the engine twice: SHARDED over
    a ``tp``-way model-axis mesh (``parallel/tp.py``'s shards, KV pools
    split on heads, every program led by the mesh's first rank) and on
    the leader alone, unsharded, everything else identical. Every rank
    of the mesh calls it with the same arguments (``mesh`` default: a
    ``tp``-way mesh over ranks ``[0, tp)`` of the world, made on every
    rank); the followers serve the sharded leg's programs and return
    None, the leader returns TTFT / inter-token / latency percentiles of
    both legs, the sharded leg's ``mesh`` block, the collectives'
    transport (``gloo-host``: ranks sharing a card, each message staged
    through host memory; ``nccl``) and messages, and whether the two
    legs gave token-identical rows (a mesh changes where the math runs,
    not the tokens), with each differing row's first difference
    (``mismatches``: the row-parallel sums add in another order than
    the whole GEMM, which in bf16 can tip a near tie)."""
    from bigdl_tpu_torch.parallel import Engine
    from bigdl_tpu_torch.parallel import collectives as C

    log = log or (lambda *a, **k: None)
    if mesh is None:
        world = C.group_size(None)
        if world < tp:
            raise ValueError(
                f"tp={tp} needs {tp} ranks but the world has {world}; "
                f"start them with python -m bigdl_tpu_torch.tools.launch "
                f"--procs {tp} (add --backend gloo for ranks that share "
                "one card)")
        mesh = Engine.create_mesh([(model_axis, tp)],
                                  devices=list(range(tp)))
    if C.group_rank(None) not in mesh.ranks:
        return None
    vocab = model.vocab_size
    wl = poisson_workload(n_requests, rate_hz, vocab,
                          decode_lens=(4, min(24, model.max_len // 2)),
                          seed=seed)
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(0, vocab, (12,)),
        np.int32)

    def run_path(name: str, **engine_kw):
        return _engine_replay(
            model, wl, warm_prompt, 4, ("mesh",), log, "tensor-parallel",
            max_slots=max_slots, prefill_chunk=prefill_chunk,
            prefill_rows=prefill_rows, eos_id=eos_id,
            registry=registry, service_name=name, **engine_kw)

    calls0 = dict(C.calls)
    sharded = run_path("bench_tp_sharded", mesh=mesh,
                       model_axis=model_axis)
    if sharded is None:
        return None
    messages = {k: v - calls0.get(k, 0) for k, v in C.calls.items()
                if v - calls0.get(k, 0)}
    unsharded = run_path("bench_tp_unsharded")
    # where the legs part: the first differing position of each row that
    # differs (the row-parallel sums run in another order than the whole
    # GEMM's, so a near tie can fall the other way)
    mismatches = []
    for i, req in enumerate(wl):
        a, b = sharded["rows"][id(req)], unsharded["rows"][id(req)]
        if not np.array_equal(a, b):
            j = int(np.flatnonzero(a != b)[0])
            mismatches.append({"request": i, "position": j,
                               "prefix": b[:j].tolist(),
                               "sharded_token": int(a[j]),
                               "unsharded_token": int(b[j])})
    parity = not mismatches
    for r in (sharded, unsharded):
        del r["rows"]

    def ratio(block, key):
        a, b = unsharded[block][key], sharded[block][key]
        return round(a / b, 4) if a and b else None

    return {"sharded": sharded, "unsharded": unsharded,
            "ttft_p50_ratio": ratio("ttft", "p50"),
            "inter_token_p50_ratio": ratio("inter_token", "p50"),
            "inter_token_p99_ratio": ratio("inter_token", "p99"),
            "token_parity": bool(parity),
            "mismatches": mismatches,
            "collectives": {
                "transport": C.transport(mesh.group(model_axis),
                                         model.tok_embed),
                "leader_messages": messages},
            "workload": {"kind": "tensor_parallel", "tp": int(tp),
                         "requests": n_requests, "rate_hz": rate_hz,
                         "seed": seed, "max_slots": max_slots,
                         "prefill_rows": prefill_rows}}


def run_working_set_sweep(model, working_sets=(2, 8),
                          device_rows: int = 2,
                          requests_per_template: int = 3,
                          rate_hz: float = 40.0, max_slots: int = 4,
                          prefill_chunk: int = 8,
                          prefill_rows: int = 2,
                          template_len: int = 16,
                          eos_id: Optional[int] = None, seed: int = 0,
                          registry=None, log=None) -> dict:
    """Sweep the shared-prefix WORKING SET past the prefix pool's
    ``device_rows`` and measure where each cache tier's hit rate falls
    off. Each point replays one round-robin template workload (the LRU
    worst case: every revisit is ``working_set`` requests away) through
    three engines, everything else identical: a host tier sized to the
    workload (``tiered``), ``device_only`` and ``disabled``. The
    device-only leg collapses once the working set passes
    ``device_rows``; the tiered leg keeps its hits, because evictions
    demote to host memory and revisits promote back. Every point checks
    token parity of both cached legs against the cache-off leg, each
    leg's usage-ledger conservation (``ledger_conserved``: the tenants'
    device-seconds against the busy total), and that its dispatch
    signatures stayed flat from the warm request on (``jit_flat``:
    demote and promote traffic launches no new signature)."""
    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    window = (model.max_len // prefill_chunk) * prefill_chunk
    room = window - template_len
    if room < 2:
        raise ValueError(
            f"template_len {template_len} leaves only {room} of the "
            f"engine's {window}-token serving window for tail + decode")
    tail_hi = max(1, min(4, room // 2))
    decode_hi = max(1, min(8, room - tail_hi))
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(
            0, vocab, (template_len,)), np.int32)

    points = []
    for ws in working_sets:
        n_req = max(int(ws) * max(2, requests_per_template), 8)
        wl = shared_prefix_workload(
            n_req, rate_hz, vocab, n_templates=int(ws),
            template_len=template_len,
            tail_lens=(min(2, tail_hi), tail_hi),
            decode_lens=(min(4, decode_hi), decode_hi),
            seed=seed + int(ws), template_order="cycle")
        legs = {}
        baseline = {}

        def probe(eng, _b=baseline):
            _b["jit"] = eng.stats()["jit_compiles"]

        # the host tier absorbs the DONATION working set: every request
        # donates its own template + tail entry, so the hot set is the
        # request count, not the template count
        for name, kw in (
                ("tiered", {"prefix_cache_rows": device_rows,
                            "prefix_host_rows": n_req}),
                ("device_only", {"prefix_cache_rows": device_rows}),
                ("disabled", {"prefix_cache_bytes": 0})):
            baseline.clear()
            r = _engine_replay(
                model, wl, warm_prompt, 2, ("prefix_cache", "jit_compiles"),
                log, f"ws{ws}_{name}", after_warm=probe,
                max_slots=max_slots,
                prefill_chunk=prefill_chunk, prefill_rows=prefill_rows,
                eos_id=eos_id, registry=registry,
                service_name=f"ws{ws}_{name}", **kw)
            r["jit_flat"] = bool(r["jit_compiles"] == baseline["jit"])
            legs[name] = r
        parity = all(_parity(legs[a], legs["disabled"], wl)
                     for a in ("tiered", "device_only"))

        def trim(r):
            pc = r["prefix_cache"]
            tenant_s = sum(t["device_s"] for t in r["tenants"].values())
            total_s = r["goodput"]["device_seconds"]["total"]
            out = {"ttft": r["ttft"], "latency": r["latency"],
                   "inter_token": r["inter_token"],
                   "tokens_per_sec": r["tokens_per_sec"],
                   "jit_flat": r["jit_flat"],
                   "ledger_conserved": bool(
                       abs(tenant_s - total_s)
                       <= 1e-6 * max(total_s, 1e-9))}
            if pc.get("enabled"):
                out.update(
                    hit_rate=pc["hit_rate"], hits=pc["hits"],
                    misses=pc["misses"],
                    reused_tokens=pc["reused_tokens"],
                    capacity_bytes=pc["capacity_bytes"])
                if pc.get("host_rows"):
                    out.update(
                        host_hits=pc["host_hits"],
                        demotions=pc["demotions"],
                        promotions=pc["promotions"],
                        host_evictions=pc["host_evictions"],
                        host_capacity_bytes=pc["host_capacity_bytes"])
            return out

        points.append({
            "working_set": int(ws),
            "ws_to_budget": round(int(ws) / device_rows, 2),
            "requests": n_req,
            "token_parity": bool(parity),
            **{name: trim(leg) for name, leg in legs.items()},
        })
        log(f"[serving-bench] working-set {ws}: tiered hit-rate "
            f"{points[-1]['tiered'].get('hit_rate')} vs device-only "
            f"{points[-1]['device_only'].get('hit_rate')}")

    # the headline: the deepest point past the budget (the cliff the
    # host tier exists to hold), else the last point
    past = [p for p in points if p["ws_to_budget"] >= 4.0]
    head = (past or points)[-1]
    dev_hr = head["device_only"].get("hit_rate") or 0.0
    tier_hr = head["tiered"].get("hit_rate") or 0.0
    return {
        "points": points,
        "tiered": head["tiered"],
        "device_only": head["device_only"],
        "headline": {
            "working_set": head["working_set"],
            "ws_to_budget": head["ws_to_budget"],
            "tiered_hit_rate": tier_hr,
            "device_only_hit_rate": dev_hr,
            "hit_rate_gain": (round(tier_hr / dev_hr, 2)
                              if dev_hr > 0 else None),
            "tiered_ttft_p50_s": head["tiered"]["ttft"]["p50"],
            "device_only_ttft_p50_s": head["device_only"]["ttft"]["p50"],
            "token_parity": head["token_parity"],
            "jit_flat": bool(head["tiered"]["jit_flat"]),
            "ledger_conserved": bool(head["tiered"]["ledger_conserved"]),
        },
        "workload": {"kind": "working_set_sweep",
                     "device_rows": device_rows,
                     "working_sets": [int(w) for w in working_sets],
                     "max_working_set": int(max(working_sets)),
                     "n_points": len(list(working_sets)),
                     "requests_per_template": requests_per_template,
                     "rate_hz": rate_hz, "seed": seed,
                     "max_slots": max_slots,
                     "prefill_rows": prefill_rows,
                     "template_len": template_len}}


#: priority assignment cycle for the storm mix: half the traffic is
#: low-class batch work (long decodes that hold slots), a quarter
#: latency-sensitive high-class interactive traffic (long prompts,
#: short decodes), a quarter normal. The cycle leads with TWO lows so
#: the storm opens with every slot held by batch work — the first
#: high-class arrival then exercises the preemption path, not a free
#: slot
_QOS_MIX = ("low", "low", "high", "normal")

#: tenant names by class — the ledger's fair-share breakdown needs the
#: classes billed apart; the over-budget tenant is added on top
_QOS_TENANTS = {"high": "interactive", "normal": "standard",
                "low": "batch"}


def qos_storm_workload(n_requests: int, rate_hz: float, vocab: int,
                       n_greedy: int = 3, seed: int = 0) -> List[dict]:
    """Sample the MIXED-PRIORITY storm: Poisson arrivals cycling
    through ``_QOS_MIX`` — high-class requests get LONG prompts and
    short decodes (interactive: TTFT is the product), low/normal get
    short prompts and LONG decodes (batch: they hold slots, which is
    what makes them preemption victims) — plus ``n_greedy`` extra
    high-class requests under the ``greedy`` tenant spread across the
    storm span (the token-bucket's prey: even the top class cannot buy
    unmetered device time). Each request carries ``priority`` and
    ``tenant`` next to the usual arrival/prompt/n fields."""
    r = np.random.RandomState(seed)
    at = np.cumsum(r.exponential(1.0 / rate_hz, n_requests))
    out = []
    for i in range(n_requests):
        cls = _QOS_MIX[i % len(_QOS_MIX)]
        if cls == "high":
            # interactive prompts are LONG (12-14 prefill chunks):
            # TTFT is then dominated by real prefill work, so the
            # fixed few-ms cost of a preemption reads as the small
            # fraction it is, not as a 2x on a trivial baseline
            t0 = int(r.randint(96, 113))
            n = int(r.randint(4, 9))
        else:
            t0 = int(r.randint(8, 17))
            n = int(r.randint(56, 81))
        out.append({
            "arrival_s": float(at[i]),
            "prompt": r.randint(0, vocab, (t0,)).astype(np.int32),
            "n": n,
            "priority": cls,
            "tenant": _QOS_TENANTS[cls],
        })
    # pin the storm's opening: the second batch job lands 10ms behind
    # the first and the first interactive request 20ms behind that —
    # DETERMINISTICALLY, both slots are held by mid-decode batch work
    # when the first high-class request arrives, so the preemption
    # path runs on every seed, not just unlucky ones
    if n_requests > 2:
        out[1]["arrival_s"] = out[0]["arrival_s"] + 0.01
        out[2]["arrival_s"] = out[1]["arrival_s"] + 0.02
    span = float(at[-1])
    for k in range(n_greedy):
        out.append({
            # the first greedy request lands early enough to ADMIT and
            # drain the bucket (16 decode tokens bill well past the
            # bucket's burst); the rest arrive after it has finished
            # and been billed, so they meet an exhausted bucket
            "arrival_s": span * (0.2 + 0.65 * k / max(1, n_greedy - 1)),
            "prompt": r.randint(0, vocab, (24,)).astype(np.int32),
            "n": 16,
            "priority": "high",
            "tenant": "greedy",
        })
    out.sort(key=lambda q: q["arrival_s"])
    return out


def _qos_replay(engine, workload, timeout_s: float = 300.0) -> dict:
    """Open-loop replay (:func:`_open_loop`) with OUTCOME accounting:
    structured QoS rejections (shed / rate-limited) are expected results
    here, not errors — every submit is tallied into exactly one
    terminal outcome and the TTFT samples are kept PER CLASS (the
    storm's headline is the high class's tail, measured apart from the
    traffic being sacrificed for it)."""
    outcomes = {"finished": 0, "shed": 0, "rate_limited": 0,
                "cancelled": 0, "timed_out": 0}
    # the greedy tenant is high-CLASS but not the headline: its TTFTs
    # land in their own bucket so the interactive tail stays clean
    ttft_by_class = {"high": [], "normal": [], "low": [], "greedy": []}
    itl_high: List[float] = []
    lat: List[float] = []
    toks: List[int] = []
    retry_hints: List[float] = []
    lock = threading.Lock()

    def one(req):
        t_sub = time.monotonic()
        try:
            h = engine.submit(req["prompt"], req["n"],
                              tenant=req["tenant"],
                              priority=req["priority"])
        except (RequestShed, RequestRateLimited) as e:
            kind = ("shed" if isinstance(e, RequestShed)
                    else "rate_limited")
            with lock:
                outcomes[kind] += 1
                retry_hints.append(float(e.retry_after_s))
            return
        try:
            row = h.result(timeout=timeout_s)
        except RequestTimedOut:
            with lock:
                outcomes["timed_out"] += 1
            return
        except RequestCancelled:
            with lock:
                outcomes["cancelled"] += 1
            return
        dt = time.monotonic() - t_sub
        cls = ("greedy" if req["tenant"] == "greedy"
               else req["priority"])
        with lock:
            outcomes["finished"] += 1
            lat.append(dt)
            toks.append(row.shape[0] - req["prompt"].shape[0])
            if h.first_token_at is not None:
                ttft_by_class[cls].append(
                    h.first_token_at - h.submitted_at)
            if cls == "high":
                _append_itl(itl_high, h)

    wall = _open_loop(workload, one)
    return {"latency": _percentiles(lat),
            "ttft_by_class": {c: _percentiles(v)
                              for c, v in ttft_by_class.items()},
            # the leg's headline percentile blocks are the HIGH class's
            # — the class the SLO is written for
            "ttft": _percentiles(ttft_by_class["high"]),
            "inter_token": _percentiles(itl_high),
            "tokens_per_sec": round(sum(toks) / max(wall, 1e-9), 2),
            "wall_s": round(wall, 3),
            "submitted": len(workload),
            "outcomes": outcomes,
            "retry_after_s_max": (round(max(retry_hints), 3)
                                  if retry_hints else None)}


def run_qos_storm(model, n_requests: int = 24, rate_hz: float = 20.0,
                  max_slots: int = 2, prefill_chunk: int = 8,
                  prefill_rows: int = 2, n_greedy: int = 3,
                  eos_id: Optional[int] = None, seed: int = 0,
                  registry=None, log=None) -> dict:
    """Replay ONE mixed-priority Poisson storm into a deliberately
    undersized engine (``max_slots`` far below the offered load) wired
    with the full QoS stack — a hair-trigger TTFT SLO objective so the
    burn-rate shedder fires on the real watchdog, zero preemption
    slack so waiting high-class requests evict batch slots through the
    KV-donation path, ``shed_classes=("low", "normal")`` so a severe
    burn widens the shed set, and a starved token bucket for the
    ``greedy`` tenant — then replay ONLY the high-class interactive
    requests through the SAME engine config as the uncontended
    baseline.

    The headline is ``high_ttft_p99_ratio`` (storm / uncontended high-
    class p99 TTFT: under a storm that sheds and preempts everything
    else, how far the top class's tail moves from its uncontended self;
    reported, with no limit set here). The row also
    carries the shed / preempted / rate-limited counts (all must be
    > 0: a storm that never fired the machinery measured nothing), the
    outcome-conservation verdict (client-side outcome tally == submits
    AND == the engine's own finished+shed+rate_limited accounting — no
    silent drops), and the per-tenant ledger breakdown."""
    from bigdl_tpu_torch.serving.engine import ContinuousBatchingEngine

    log = log or (lambda *a, **k: None)
    vocab = model.vocab_size
    wl = qos_storm_workload(n_requests, rate_hz, vocab,
                            n_greedy=n_greedy, seed=seed)
    # the uncontended baseline is the HIGH-PRIORITY traffic alone —
    # interactive AND greedy, at the same arrival offsets, under the
    # same rate limits — so any high-vs-high collision lands in both
    # legs identically and the ratio isolates what the STORM adds
    high_only = [q for q in wl if q["priority"] == "high"]
    warm_prompt = np.asarray(
        np.random.RandomState(seed + 1).randint(0, vocab, (12,)),
        np.int32)
    engine_kw = dict(
        max_slots=max_slots, prefill_chunk=prefill_chunk,
        prefill_rows=prefill_rows, eos_id=eos_id, registry=registry,
        # the burn objective is a tripwire, not a target: every real
        # TTFT lands over 0.1ms, so the storm's traffic itself drives
        # the watchdog into a SEVERE burn (burn 10 >= 2x threshold)
        # within min_count observations — shedding activates on the
        # same machinery production would use, just tuned to fire
        # min_count 3 = warm + the two leading lows: the slot-holding
        # batch work ADMITS before the burn trips, so the first high
        # arrival preempts a live victim; everything low/normal after
        # the trip sheds at submit
        slo_objectives=[{"name": "ttft_burn", "metric": "ttft",
                         "threshold_s": 1e-4, "target": 0.9,
                         "window_s": 30.0, "min_count": 3,
                         "burn_threshold": 2.0}],
        shed_classes=("low", "normal"),
        preempt_slack_s=0.0,
        tenant_rate_limits={"greedy": (0.01, 0.001)})

    def leg(name: str, work) -> dict:
        log(f"[serving-bench] qos {name} replay...")
        with ContinuousBatchingEngine(model, service_name=name,
                                      **engine_kw) as eng:
            eng.submit(warm_prompt, 4).result(timeout=300)
            res = _qos_replay(eng, work)
            stats = eng.stats()
        res["qos_state"] = stats["qos"]
        res.update(_usage_blocks(stats))
        res["alerts"] = stats["alerts"]
        # conservation against the ENGINE's own books, not just the
        # client's: every submit the engine saw must have landed in
        # exactly one terminal outcome counter
        qc = stats["qos"]
        eng_terminal = (stats["finished"] + qc["shed"]
                        + qc["rate_limited"] + stats["cancelled"]
                        + stats["timed_out"])
        client_terminal = sum(res["outcomes"].values())
        res["conservation_ok"] = bool(
            client_terminal == res["submitted"]
            # +1: the warm request finished outside the tally
            and eng_terminal == res["submitted"] + 1)
        return res

    storm = leg("bench_qos_storm", wl)
    uncont = leg("bench_qos_uncontended", high_only)

    def ratio(key):
        a = storm["ttft"][key]
        b = uncont["ttft"][key]
        return round(a / b, 4) if a and b else None

    qc = storm["qos_state"]
    return {
        "qos": storm, "uncontended": uncont,
        "high_ttft_p50_ratio": ratio("p50"),
        "high_ttft_p99_ratio": ratio("p99"),
        "shed": qc["shed"], "preempted": qc["preempted"],
        "rate_limited": qc["rate_limited"],
        "conservation_ok": bool(storm["conservation_ok"]
                                and uncont["conservation_ok"]),
        "workload": {"kind": "qos_storm", "requests": n_requests,
                     "n_greedy": n_greedy, "rate_hz": rate_hz,
                     "seed": seed, "max_slots": max_slots,
                     "prefill_rows": prefill_rows}}
