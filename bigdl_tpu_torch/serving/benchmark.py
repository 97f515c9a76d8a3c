"""Poisson-arrival serving comparisons (port of the engine-against-
``GenerationService`` and shared-prefix parts of
``bigdl_tpu/serving/benchmark.py``).

:func:`run_poisson_comparison` replays ONE sampled open-loop workload
(exponential inter-arrival gaps, mixed prompt and decode lengths)
against the continuous-batching engine and against ``GenerationService``
and reports per-request latency p50/p99 both ways, the engine's TTFT and
mean inter-token gap p50/p99, and delivered tokens/s both ways.
:func:`run_shared_prefix_comparison` replays a prefix-heavy workload
through the engine with its prefix cache on and off and reports the
TTFT speedups, the hit rate and whether both paths gave the same rows.
The workload generators draw from ``numpy.random.RandomState(seed)`` in
the JAX package's order, so a seed gives the same arrays in both
packages. The usage, alert and incident blocks of the JAX rows wait for
the observability slice.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np


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


def _replay(workload, submit_fn, collect_fn) -> dict:
    """Open-loop replay: each request is submitted at its arrival offset
    from a thread of its own (late submissions go at once: arrival times
    are an offered load, not a barrier); ``collect_fn`` blocks per
    request and returns its delivered token count."""
    lat: List[float] = []
    toks: List[int] = []
    errs: List[BaseException] = []
    lock = threading.Lock()
    t_start = time.monotonic()

    def one(req):
        try:
            t_sub = time.monotonic()
            pending = submit_fn(req)
            n_tok = collect_fn(pending, req)
            dt = time.monotonic() - t_sub
            with lock:
                lat.append(dt)
                toks.append(n_tok)
        except BaseException as e:
            with lock:
                errs.append(e)

    threads = []
    for req in workload:
        delay = t_start + req["arrival_s"] - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        t = threading.Thread(target=one, args=(req,), daemon=True)
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    if errs:
        raise errs[0]
    return {"latency": _percentiles(lat),
            "tokens_per_sec": round(sum(toks) / max(wall, 1e-9), 2),
            "wall_s": round(wall, 3), "requests": len(workload)}


def _engine_replay(model, workload, warm_prompt, warm_tokens,
                   stats_keys, log, label, **engine_kw) -> dict:
    """One engine leg of a comparison: build the engine, serve one warm
    request outside the measurement (none when ``warm_prompt`` is
    None), open-loop replay the workload, and return latency / TTFT /
    inter-token percentiles, delivered tokens/s, the per-request rows
    (keyed by ``id(req)``), the whole ``stats()`` under ``stats`` and
    the entries named by ``stats_keys`` at the top level."""
    from bigdl_tpu_torch.serving.engine import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(model, **engine_kw)
    ttft: List[float] = []
    itl: List[float] = []
    rows: dict = {}
    tlock = threading.Lock()

    def collect(handle, req):
        row = handle.result()
        with tlock:
            rows[id(req)] = row
            if handle.first_token_at is not None:
                ttft.append(handle.first_token_at - handle.submitted_at)
            _append_itl(itl, handle)
        return row.shape[0] - req["prompt"].shape[0]

    log(f"[serving-bench] {label} replay ({engine.service_name})...")
    with engine:
        if warm_prompt is not None:
            engine.submit(warm_prompt, warm_tokens).result(timeout=300)
        res = _replay(
            workload,
            lambda req: engine.submit(req["prompt"], req["n"],
                                      tenant=req.get("tenant")),
            collect)
        stats = engine.stats()
    res["ttft"] = _percentiles(ttft)
    res["inter_token"] = _percentiles(itl)
    res["stats"] = stats
    for key in stats_keys:
        res[key] = stats[key]
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

    svc = GenerationService(model, max_batch=max_batch,
                            batch_timeout_ms=batch_timeout_ms,
                            bucket_tokens=8, prompt_bucket=8,
                            eos_id=eos_id)
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
            "workload": {"requests": n_requests, "rate_hz": rate_hz,
                         "seed": seed, "max_slots": max_slots,
                         "max_batch": max_batch,
                         "prefill_rows": prefill_rows,
                         "prompt_lens": list(prompt_lens),
                         "decode_lens": list(decode_lens)},
            "requests": wl}
