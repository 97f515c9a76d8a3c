"""LM serving walkthrough: every inference path on one model (port of
``bigdl_tpu/example/serving/serve.py``).

This demo drives the generative serving stack end to end, hermetically
(a small randomly-initialized LM — the POINT is the serving machinery,
not the prose):

  1. greedy + sampled generate (top-k/top-p, eos)
  2. beam search
  3. ragged mixed-length batch
  4. int8 draft + speculative decoding (greedy and full sampling)
  5. GenerationService: concurrent requests, coalescing stats
  6. ContinuousBatchingEngine: streaming requests, request-scoped
     flight-recorder timelines, and the ops surface — /healthz wired
     to engine liveness (503 once the decode loop dies; a watchdog
     alert degrades the body while staying 200), /debug/requests TTFT
     breakdowns, /debug/trace Chrome trace, /debug/memory per-pool
     device-memory attribution (KV slots / staging / tiered prefix
     pool — device rows AND host-RAM spill — / params), per-tenant
     usage accounting (the /debug/usage table — tokens,
     device-seconds, KV byte-seconds, goodput — round-tripped over
     HTTP), on-demand /debug/profile capture (--profile-seconds N),
     the dispatch cost model (per-kind MFU + roofline class from
     stats()["cost"], loop-phase bubble breakdown from
     stats()["loop"]), and the live /debug/dashboard sparkline page
     (URL printed on startup)
  7. --paged: the SAME engine on the paged KV cache — one refcounted
     block pool per model, per-request block tables, zero-copy prefix
     sharing — with the pool's occupancy, fragmentation, and
     alloc/share/COW/free flow printed from stats()["paging"]
  8. --tp N: the SAME engine tensor-parallel over an N-rank model-axis
     mesh (Megatron-sharded params, heads-sharded KV pools); a command
     line run starts its N ranks through ``tools/launch.py`` (gloo when
     the ranks share one card or run on the CPU) — topology and
     per-rank pool bytes printed from stats()["mesh"]
  9. --fleet N: the multi-replica fleet instead — N in-process engine
     replicas behind a ReplicaSupervisor and the HTTP front door;
     POST /v1/generate streams tokens as SSE (the meta event says
     which replica the prefix-affinity router picked and why), the
     per-replica routing table prints from GET /v1/replicas, one
     replica drains mid-demo (traffic reroutes, then it rejoins), and
     GET /v1/stats reports the fleet-wide prefix hit rate

``--chaos`` runs the overload drill instead. ``--device`` is ``cuda``
(the card) by default; without a GPU the walkthrough raises unless
given ``--device cpu``.

Run: python -m bigdl_tpu_torch.example.serving.serve [--tokens 24] [--tp 2]
     python -m bigdl_tpu_torch.example.serving.serve --fleet 3
"""

from __future__ import annotations

import argparse
import threading

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tokens", type=int, default=24)
    p.add_argument("--vocab", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--profile-seconds", type=float, default=0.0,
                   help="also exercise GET /debug/profile with a "
                        "capture of this many seconds (0 = skip)")
    p.add_argument("--draft", action="store_true",
                   help="run the continuous-batching engine with the "
                        "int8 clone as a speculative DRAFT (gamma "
                        "proposals per decode round) and print the "
                        "acceptance rate from stats()")
    p.add_argument("--gamma", type=int, default=4,
                   help="--draft: tokens proposed per decode round")
    p.add_argument("--tp", type=int, default=0, metavar="N",
                   help="run the continuous-batching engine TENSOR-"
                        "PARALLEL over an N-rank model-axis mesh "
                        "(params Megatron-sharded, KV pools sharded on "
                        "heads) — N must divide the demo model's 4 KV "
                        "heads; a command-line run starts its N ranks "
                        "through the launcher")
    p.add_argument("--quantized", action="store_true",
                   help="run the continuous-batching engine with int8 "
                        "KV pools (per-row/head scale sidecars, "
                        "dequantize fused into the attention read) "
                        "and int8 weights, and print membw_util + "
                        "pool bytes next to the fp engine's figures")
    p.add_argument("--paged", action="store_true",
                   help="run the continuous-batching engine on the "
                        "PAGED KV cache (one refcounted block pool "
                        "per model, per-request block tables, prefix "
                        "hits share pages copy-on-write) and print "
                        "the pool's occupancy, fragmentation, and "
                        "alloc/share/COW/free flow from stats()")
    p.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="run the MULTI-REPLICA demo instead: N in-"
                        "process engine replicas behind the "
                        "ReplicaSupervisor + HTTP front door — SSE "
                        "streaming with routing metadata, the per-"
                        "replica routing table, a mid-demo drain/"
                        "rejoin, and the fleet-wide prefix hit rate")
    p.add_argument("--chaos", action="store_true",
                   help="run the OVERLOAD DRILL instead: a scripted "
                        "ChaosInjector forces a synthetic SLO burn "
                        "(low-class sheds with Retry-After while "
                        "high-class serves), a starved token bucket "
                        "rate-limits a greedy tenant, a preemption "
                        "frees a slot for a waiting high-class "
                        "request (token-identical resume), a frozen "
                        "slot rides out its straggler window, and a "
                        "failed dispatch crashes a sacrificial "
                        "engine into its postmortem")
    args = p.parse_args(argv)

    from bigdl_tpu_torch.device import resolve_device

    args.dev = resolve_device(args.device)   # raises without a GPU
    if args.chaos:
        return _chaos_demo(args)
    if args.fleet and args.fleet > 1:
        return _fleet_demo(args)

    import os
    import sys

    import torch

    from bigdl_tpu_torch.parallel import Engine as MeshEngine

    tp = bool(args.tp and args.tp > 1)
    if tp and argv is None and "WORLD_SIZE" not in os.environ:
        # a tensor-parallel engine is one rank per process: a command
        # line run re-executes itself under the launcher (gloo when the
        # ranks share one card, which NCCL refuses, or run on the CPU)
        share = (args.device == "cpu"
                 or torch.cuda.device_count() < args.tp)
        os.execv(sys.executable,
                 [sys.executable, "-m", "bigdl_tpu_torch.tools.launch",
                  "--procs", str(args.tp), "--device", args.device]
                 + (["--backend", "gloo"] if share else [])
                 + ["-m", "bigdl_tpu_torch.example.serving.serve"]
                 + sys.argv[1:])
    mesh = None
    if tp:
        if MeshEngine.node_number() < args.tp:
            raise SystemExit(
                f"--tp {args.tp} needs a process group of {args.tp} "
                f"ranks but this one has {MeshEngine.node_number()} "
                "(run it through bigdl_tpu_torch.tools.launch)")
        mesh = MeshEngine.create_mesh(
            [("model", args.tp)], devices=list(range(args.tp)))
    leader = mesh is None or mesh.index("model") == 0
    say = print if leader else (lambda *a, **k: None)

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.nn.quantized import Quantizer
    from bigdl_tpu_torch.optim import GenerationService

    dev = args.dev
    n = args.tokens
    model = TransformerLM(args.vocab, embed_dim=64, num_heads=8,
                          num_kv_heads=4, num_layers=4,
                          max_len=64 + 2 * n, use_rope=True, seed=0,
                          device=dev)
    model.evaluate()
    r = np.random.RandomState(0)
    prompt = torch.as_tensor(r.randint(0, args.vocab, (2, 12)),
                             device=dev)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    greedy = model.generate(prompt, n)
    say(f"[greedy]    {greedy[0, 12:12 + 8].tolist()}...")
    out = model.generate(prompt, n, temperature=0.8, top_k=40,
                         top_p=0.95, eos_id=0, generator=gen(1))
    say(f"[sampled]   {out[0, 12:12 + 8].tolist()}...")
    out = model.beam_search(prompt, n, num_beams=4, eos_id=0)
    say(f"[beam k=4]  {out[0, 12:12 + 8].tolist()}...")

    # ragged: three different-length prompts, one batch
    lengths = np.asarray([5, 9, 12])
    padded = torch.zeros((3, 12), dtype=torch.long, device=dev)
    for i, L in enumerate(lengths):
        padded[i, :L] = prompt[0, :L]
    toks = model.generate_ragged(padded, lengths, n)
    say(f"[ragged]    lengths {lengths.tolist()} -> "
        f"{tuple(toks.shape)} tokens")

    # speculative: int8 clone as the draft (greedy stays EXACT)
    draft = Quantizer.quantize(model)
    draft.evaluate()
    ids, st = model.speculative_generate(prompt, n, draft=draft, gamma=4,
                                         return_stats=True)
    exact = bool(torch.equal(ids, greedy))
    say(f"[speculate] greedy: accept {st['accept_rate']:.0%} over "
        f"{st['rounds']} rounds; exact == generate(): {exact}")
    _, st = model.speculative_generate(prompt, n, draft=draft, gamma=4,
                                       temperature=0.8, generator=gen(2),
                                       return_stats=True)
    say(f"[speculate] sampled: accept {st['accept_rate']:.0%} over "
        f"{st['rounds']} rounds")

    # concurrent serving: mixed lengths and decode budgets coalesce
    svc = GenerationService(model, max_batch=4, batch_timeout_ms=50.0,
                            bucket_tokens=16, prompt_bucket=16, eos_id=0)
    reqs = [(r.randint(0, args.vocab, (L,)), nn_)
            for L, nn_ in ((5, n), (9, n // 2), (12, n), (7, n // 2))]
    rows = [None] * len(reqs)
    errs = []

    def worker(i, q, k):
        try:
            rows[i] = svc.generate(q, k)
        except Exception as e:  # surface after join, don't swallow
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i, q, k))
               for i, (q, k) in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    s = svc.stats()
    say(f"[service]   {s['served']} requests in {s['dispatches']} "
        f"dispatches (occupancy {s['mean_batch_occupancy']:.1f})")

    # continuous batching with the full ops surface: the engine's
    # liveness feeds /healthz (a crashed decode loop flips it to 503
    # instead of lying "ok"), and the flight recorder's per-request
    # timelines come back over /debug/requests + /debug/trace
    import json
    import urllib.error
    import urllib.request

    from bigdl_tpu_torch import observability as obs
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine

    engine_kw = {}
    if args.draft:
        # the int8 clone doubles as the ENGINE's speculative draft:
        # per iteration it proposes gamma tokens for every live slot,
        # the target verifies them in one ragged forward, and greedy
        # output stays token-identical
        engine_kw = dict(draft=draft, spec_gamma=args.gamma)
    if mesh is not None:
        # tensor-parallel serving: one mesh, same engine API — every
        # rank builds the engine with the same arguments, params load
        # Megatron-sharded and every KV pool shards its heads dim;
        # tokens match the single-device engine
        engine_kw["mesh"] = mesh
    if args.paged:
        # paged KV: requests hold page_size-token pages from ONE
        # refcounted pool instead of a dense full-length slot row, so
        # a short chat never bills a document's worth of device memory
        # and a prefix hit is a refcount bump, not a row copy
        engine_kw["page_size"] = 4
    # tiered prefix cache: a tiny device pool forces LRU eviction to
    # DEMOTE rows into pinned host RAM instead of dropping them; a
    # revisit of a demoted prefix promotes it back asynchronously
    engine_kw.setdefault("prefix_cache_rows", 2)
    engine_kw.setdefault("prefix_host_rows", 8)
    fp_before = None
    if args.quantized and leader:
        # measure the FP engine on the same traffic first, so the
        # quantized engine below prints an honest before/after pair
        # (membw_util from the cost model, pool bytes from the
        # memory-pool registry)
        from bigdl_tpu_torch.observability import memory as obs_memory

        rq = np.random.RandomState(7)
        with ContinuousBatchingEngine(model, max_slots=2,
                                      prefill_chunk=8, eos_id=0,
                                      prefix_cache_rows=2,
                                      prefix_host_rows=8,
                                      service_name="fp-ref") as fp_eng:
            for L, nn_ in ((6, n), (10, n // 2), (8, n // 2)):
                fp_eng.submit(rq.randint(0, args.vocab, (L,)),
                              nn_).result(timeout=120)
            fp_st = fp_eng.stats()
            fp_before = {
                "membw": fp_st["cost"]["overall"]["membw_util"],
                "row_bytes": fp_st["quantization"]["kv_row_bytes"],
                "pool_kb": sum(
                    v for k, v in obs_memory.pool_sizes().items()
                    if k.startswith("serving/fp-ref/")) // 1024,
            }
    if args.quantized:
        # int8 end to end: every KV pool stores codes + scale
        # sidecars (dequantize fused into the attention read), params
        # go through the Quantizer clone
        engine_kw["kv_dtype"] = "int8"
        engine_kw["weights_dtype"] = "int8"
    engine = ContinuousBatchingEngine(model, max_slots=2,
                                      prefill_chunk=8, eos_id=0,
                                      **engine_kw)
    if not engine.is_leader:
        # a follower rank runs the leader's programs until its stop
        engine.start()
        return rows
    with engine, \
            obs.start_http_server(host="127.0.0.1",
                                  healthz=engine.healthz,
                                  debug_requests=engine.debug_requests,
                                  debug_usage=engine.debug_usage,
                                  debug_timeseries=engine.debug_timeseries,
                                  dashboard=engine.dashboard,
                                  debug_capacity=engine.debug_capacity
                                  ) as server:
        base = f"http://127.0.0.1:{server.port}"
        print(f"[engine]    live dashboard: {base}/debug/dashboard "
              "(SVG sparklines, self-refreshing, no metrics stack)")
        # each request bills a tenant: the usage ledger attributes
        # queue wait, tokens, KV byte-seconds, and pro-rata dispatch
        # device-seconds to it (unknown names past the cardinality
        # cap would fold into "other")
        handles = [engine.submit(r.randint(0, args.vocab, (L,)), nn_,
                                 tenant=t)
                   for L, nn_, t in ((6, n, "alice"),
                                     (10, n // 2, "bob"),
                                     (8, n // 2, "alice"))]
        streamed = sum(1 for _ in handles[0].tokens())
        for h in handles:
            h.result(timeout=120)
        hz = json.loads(urllib.request.urlopen(
            f"{base}/healthz").read())
        dbg = json.loads(urllib.request.urlopen(
            f"{base}/debug/requests").read())
        ttft = dbg["latency"]["ttft"]["p50"]
        print(f"[engine]    {handles[0].request_id} streamed "
              f"{streamed} tokens; /healthz {hz['status']} "
              f"(loop_alive={hz['loop_alive']}, "
              f"alerts={len(hz['alerts'])}); /debug/requests "
              f"p50 TTFT {ttft * 1e3:.1f}ms over "
              f"{dbg['latency']['ttft']['count']} requests")
        if args.draft:
            sp = engine.stats()["speculation"]
            print(f"[spec-eng]  int8 draft gamma={sp['gamma']}: "
                  f"accepted {sp['accepted_tokens']}/"
                  f"{sp['proposed_tokens']} proposals "
                  f"({sp['acceptance_rate']:.0%} acceptance rate)")
        if mesh is not None:
            ms = engine.stats()["mesh"]
            kv = ms["pools"]["kv_slots"]
            print(f"[tp]        {ms['model_shards']}-way model mesh "
                  f"over {ms['devices']} ranks; kv_slots "
                  f"{kv['physical_bytes'] // 1024} KB global, "
                  f"{kv['bytes_per_device'] // 1024} KB/rank "
                  f"(sharded={kv['sharded']})")

        # who owns the device memory: the engine registered its KV
        # slot pool, prefill staging, prefix pool, and params as named
        # memory pools — /debug/memory attributes bytes to each
        mem = json.loads(urllib.request.urlopen(
            f"{base}/debug/memory").read())
        eng_pools = {k.split("/")[-1]: v
                     for k, v in mem["now"]["pools"].items()
                     if k.startswith("serving/")}
        in_use = mem["now"]["bytes_in_use"]
        print(f"[memory]    /debug/memory: "
              + (f"{in_use / 1e6:.1f} MB in use; " if in_use is not None
                 else "no device counter on the CPU; ")
              + "engine pools (KB): "
              + ", ".join(f"{k}={v // 1024}"
                          for k, v in sorted(eng_pools.items())))
        # the tiered prefix cache shows up as TWO pools: device rows
        # in prefix_kv_in_use, demoted rows in prefix_host_kv
        pc = engine.stats()["prefix_cache"]
        print(f"[prefix]    device tier "
              f"{eng_pools.get('prefix_kv_in_use', 0) // 1024} KB "
              f"({pc['entries']} rows), host tier "
              f"{eng_pools.get('prefix_host_kv', 0) // 1024} KB "
              f"({pc['host_entries']} rows); hits "
              f"{pc['hits']} ({pc['host_hits']} from host), "
              f"demoted {pc['demotions']}, promoted {pc['promotions']}")
        if args.paged:
            # the block pool's health: live occupancy (prefix entries
            # still hold their pages), internal fragmentation (wasted
            # tail of each trailing partial page), and the cumulative
            # alloc/share/COW/free flow
            pg = engine.stats()["paging"]
            pool = pg["pool"]
            print(f"[paged]     page_size {pg['page_size']}: "
                  f"{pool['pages_in_use']}/{pool['max_pages']} pages "
                  f"held ({pool['bytes_in_use'] // 1024} KB of "
                  f"{pool['capacity_bytes'] // 1024} KB), "
                  f"fragmentation {pg['fragmentation']:.0%}; flow: "
                  f"{pool['allocated_total']} allocated, "
                  f"{pool['shared_total']} shared, "
                  f"{pool['cow_forks_total']} cow, "
                  f"{pool['freed_total']} freed")

        # who consumed the device: the per-tenant usage table, the
        # goodput block, and the top requests by device-seconds —
        # round-tripped over HTTP exactly as a billing scraper would
        usage = json.loads(urllib.request.urlopen(
            f"{base}/debug/usage?n=3").read())
        for t, a in sorted(usage["tenants"].items()):
            print(f"[usage]     tenant {t:<8} {a['requests']} req, "
                  f"{a['prefill_tokens']:>3} prefill + "
                  f"{a['decode_tokens']:>3} decoded tok, "
                  f"{a['device_s'] * 1e3:8.1f} ms device, "
                  f"{a['kv_byte_seconds'] / 1024:8.1f} KB*s KV")
        g = usage["goodput"]
        top = usage["top_requests"][0] if usage["top_requests"] else {}
        print(f"[usage]     goodput {g['tokens_per_device_second']} "
              f"tok/device-s, utilization {g['utilization']:.0%}, "
              f"padding waste {g['padding_waste_mean']:.0%}; top "
              f"burner {top.get('request_id')} "
              f"({top.get('tenant')}, "
              f"{top.get('device_s', 0) * 1e3:.1f} ms)")

        # how WELL the device time was spent: per-dispatch-kind MFU +
        # roofline class, and the loop-phase breakdown attributing
        # device-idle time to named host bubbles
        st = engine.stats()
        for kind, c in sorted(st["cost"]["kinds"].items()):
            if not c["dispatches"]:
                continue
            print(f"[cost]      {kind:<8} {c['roofline']:>13} "
                  f"(intensity {c['arithmetic_intensity']:.1f} "
                  f"FLOP/B vs ridge {c['ridge_intensity']:.1f}), "
                  f"mfu {c['mfu']:.2%}, membw {c['membw_util']:.2%} "
                  f"[{c['flops_source']}]")
        if fp_before is not None:
            qz = st["quantization"]
            q_pool_kb = sum(eng_pools.values()) // 1024
            print(f"[quant]     int8 kv+weights: row "
                  f"{qz['kv_row_bytes']} B vs fp "
                  f"{qz['fp_row_bytes']} B "
                  f"({qz['row_bytes_ratio']:.2f}x); engine pools "
                  f"{q_pool_kb} KB vs fp {fp_before['pool_kb']} KB; "
                  f"membw_util {st['cost']['overall']['membw_util']:.2%}"
                  f" vs fp {fp_before['membw']:.2%}")
        lp = st["loop"]
        bars = ", ".join(f"{ph}={fr:.0%}"
                         for ph, fr in sorted(lp["fractions"].items(),
                                              key=lambda kv: -kv[1])
                         if fr >= 0.005)
        print(f"[loop]      {lp['iterations']} iterations, device idle "
              f"{lp['device_idle_fraction']:.0%} of loop time; "
              f"phases: {bars}")

        if args.profile_seconds > 0:
            # zero-redeploy profiling: one bounded capture over HTTP
            try:
                prof = json.loads(urllib.request.urlopen(
                    f"{base}/debug/profile"
                    f"?seconds={args.profile_seconds}").read())
                print(f"[profile]   /debug/profile -> "
                      f"{prof['artifact']}")
            except urllib.error.HTTPError as e:
                print(f"[profile]   unavailable here: "
                      f"{json.loads(e.read()).get('error')}")

        # the same counters, scraped: a stdlib /metrics endpoint any
        # Prometheus-compatible collector can poll
        body = urllib.request.urlopen(f"{base}/metrics").read().decode()
    shown = [ln for ln in body.splitlines()
             if ln.startswith(("bdt_serve_requests_total",
                               "bdt_generation_tokens_total"))]
    print(f"[metrics]   GET /metrics -> {len(body.splitlines())} lines, "
          f"e.g. {'; '.join(shown)}")
    return rows


def _chaos_demo(args):
    """``--chaos``: the overload drill. Every QoS degradation path
    fires deterministically via the scripted injector — no real storm
    needed — and the drill prints what an operator would see on each
    surface (structured rejections, ``stats()["qos"]``, healthz).
    Each fault class additionally mints exactly one correctly-
    classified incident bundle (slo / stall / crash) through the
    anomaly→incident pipeline, round-tripped over
    ``/debug/fleet/incidents`` in a closing fleet leg, and the tally
    lands in ``bench_history.jsonl`` (``BIGDL_BENCH_HISTORY`` names
    another file)."""
    import tempfile
    import time

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.observability.anomaly import (
        DetectorBank, StallDetector,
    )
    from bigdl_tpu_torch.serving import (
        ChaosInjector, ContinuousBatchingEngine, EngineStopped,
        RequestRateLimited, RequestShed,
    )

    def _wait_incident(engine, kind, timeout=30.0):
        """Poll ``debug_incidents`` until a ``kind`` bundle exists."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            d = engine.debug_incidents()
            if d["by_kind"].get(kind):
                return d
            time.sleep(0.1)
        return engine.debug_incidents()

    model = TransformerLM(args.vocab, embed_dim=32, num_heads=4,
                          num_kv_heads=2, num_layers=2, max_len=96,
                          use_rope=True, seed=0, device=args.dev)
    model.evaluate()
    r = np.random.RandomState(3)
    chaos = ChaosInjector()
    inc_dir = tempfile.mkdtemp(prefix="bdt-incidents-")
    with ContinuousBatchingEngine(
            model, max_slots=1, prefill_chunk=8, prefix_cache_rows=4,
            admission_window=4, preempt_slack_s=0.002,
            shed_classes=("low",),
            tenant_rate_limits={"greedy": (1e-4, 1e-4)},
            chaos=chaos, service_name="chaos-drill",
            incident_dir=inc_dir,
            # a 20-iteration scripted freeze must trip the stall
            # detector (the default 200-iteration threshold is sized
            # for production, not a drill)
            anomaly_detectors=DetectorBank(
                stall=StallDetector(threshold=8))) as eng:
        warm = eng.submit(r.randint(1, args.vocab, (6,)), 2)
        warm.result(timeout=120)

        # 1. synthetic SLO burn: low-class sheds at submit with retry
        #    advice, high-class sails through the same instant
        chaos.force_burn(active=True)
        shed, retry = 0, 0.0
        for _ in range(4):
            try:
                eng.submit(r.randint(1, args.vocab, (8,)), 4,
                           priority="low")
            except RequestShed as e:
                shed, retry = shed + 1, e.retry_after_s
        hi = eng.submit(r.randint(1, args.vocab, (8,)), 4,
                        priority="high")
        hi.result(timeout=120)
        chaos.force_burn(active=False)
        print(f"[shed]      synthetic TTFT burn: {shed}/4 low-class "
              f"shed (Retry-After {retry:.0f}s), high-class served")
        d = _wait_incident(eng, "slo")
        slo_inc = d["by_kind"].get("slo", 0)
        phases = [e["phase"] for b in d["incidents"]
                  for e in b.get("exemplars", [])][:3]
        print(f"[incident]  burn captured as kind=slo: "
              f"{slo_inc} bundle(s), exemplars phase-attributed "
              f"{phases}")

        # 2. token bucket: "greedy" has a near-zero refill — its first
        #    request drains the bucket, the next bounces with the
        #    refill-derived backoff
        eng.submit(r.randint(1, args.vocab, (8,)), 4,
                   tenant="greedy").result(timeout=120)
        time.sleep(0.3)   # let the loop thread post the final debit
        try:
            eng.submit(r.randint(1, args.vocab, (8,)), 4,
                       tenant="greedy")
            limited = "NOT limited (bucket still positive?)"
        except RequestRateLimited as e:
            limited = (f"rate-limited, retry in "
                       f"{e.retry_after_s:.0f}s")
        print(f"[bucket]    tenant greedy second request: {limited}")

        # 3. preemption: a low request holds the ONLY slot; a high
        #    arrival past the slack evicts it (KV donated) and the
        #    victim resumes token-identical
        low_p = r.randint(1, args.vocab, (8,))
        h_low = eng.submit(low_p, 40, priority="low")
        next(h_low.tokens())
        h_hi = eng.submit(r.randint(1, args.vocab, (8,)), 4,
                          priority="high")
        h_hi.result(timeout=120)
        low_row = h_low.result(timeout=120)
        solo = model.generate(np.asarray(low_p)[None], 40)[0].cpu().numpy()
        print(f"[preempt]   victim preempted {h_low.preempted}x, "
              f"resumed token-identical: "
              f"{bool((np.asarray(low_row) == solo).all())}")

        # 4. freeze drill: one slot stalls for 20 iterations (a
        #    synthetic straggler) and still finishes
        chaos.freeze_slot(0, iterations=20)
        frozen = eng.submit(r.randint(1, args.vocab, (8,)), 6)
        frozen.result(timeout=120)
        q = eng.stats()["qos"]
        print(f"[freeze]    slot 0 stalled 20 iterations, request "
              f"still finished; qos counters: "
              f"preempted={q['preempted']} shed={q['shed']} "
              f"rate_limited={q['rate_limited']}")
        d = _wait_incident(eng, "stall")
        drill_counts = dict(d["by_kind"])
        print(f"[incident]  freeze captured as kind=stall: "
              f"{d['by_kind'].get('stall', 0)} bundle(s); drill "
              f"engine totals {drill_counts}; bundles on disk under "
              f"{inc_dir}")

    # 5. dispatch failure: a sacrificial engine takes a scripted fault
    #    on its next dispatch — the loop crashes into the postmortem
    #    path and healthz flips to the crashed-loop signal
    boom = ChaosInjector()
    with ContinuousBatchingEngine(
            model, max_slots=1, prefill_chunk=8, chaos=boom,
            service_name="chaos-crash") as eng2:
        boom.fail_dispatch(nth=1)
        h = eng2.submit(r.randint(1, args.vocab, (8,)), 4)
        try:
            h.result(timeout=120)
            print("[crash]     dispatch fault did not propagate?!")
        except EngineStopped:
            try:
                eng2.healthz()
                status = "healthz still ok?!"
            except EngineStopped as e:
                status = f"healthz raises ({type(e).__name__})"
            print(f"[crash]     scripted dispatch fault: request "
                  f"failed structured, {status}, postmortem "
                  "written")
    # the crashed engine's incident ring survives stop() — the crash
    # handler captured a kind=crash bundle next to the postmortem
    crash_d = eng2.debug_incidents()
    err = ((crash_d["incidents"][0].get("error") or {}).get("type")
           if crash_d["incidents"] else None)
    print(f"[incident]  crash captured as kind=crash: "
          f"{crash_d['by_kind'].get('crash', 0)} bundle(s), "
          f"error={err}")

    # 6. fleet round trip: the same drill surfaces aggregate across a
    #    fleet — one replica burns, the front door's
    #    /debug/fleet/incidents stamps its bundles with replica= and
    #    the exemplar trace ids resolve in the merged fleet trace
    _chaos_fleet_leg(args, model, r)

    totals = dict(drill_counts)
    for k, v in crash_d["by_kind"].items():
        totals[k] = totals.get(k, 0) + v
    _append_chaos_history(totals, args.dev)
    print(f"[history]   serving_chaos_incidents row appended: "
          f"{sum(totals.values())} incidents {totals}")
    return totals


def _chaos_fleet_leg(args, model, r):
    """The ``--chaos`` closing leg: two in-process replicas behind the
    HTTP front door; r0 takes a forced burn, and the drill verifies
    the bundle round-trips over ``GET /debug/fleet/incidents`` with
    its replica stamp and a trace id resolvable in the merged fleet
    timelines (``/debug/fleet/requests``)."""
    import json
    import time
    import urllib.request

    from bigdl_tpu_torch.serving import (
        ChaosInjector, ContinuousBatchingEngine,
    )
    from bigdl_tpu_torch.serving.fleet import (
        FleetFrontDoor, InProcessReplica, ReplicaSupervisor,
    )

    burn = ChaosInjector()
    replicas = [
        InProcessReplica("r0", ContinuousBatchingEngine(
            model, max_slots=1, prefill_chunk=8, chaos=burn,
            service_name="chaos-fleet-r0")),
        InProcessReplica("r1", ContinuousBatchingEngine(
            model, max_slots=1, prefill_chunk=8,
            service_name="chaos-fleet-r1")),
    ]
    with ReplicaSupervisor(replicas, chunk=8,
                           fleet_name="chaos-fleet") as sup, \
            FleetFrontDoor(sup) as door:
        base = f"http://127.0.0.1:{door.port}"

        def post(prompt):
            body = json.dumps({"prompt_ids": prompt,
                               "max_new_tokens": 4,
                               "stream": False}).encode()
            req = urllib.request.Request(
                f"{base}/v1/generate", data=body,
                headers={"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(
                req, timeout=60).read())

        for i in range(4):
            post(r.randint(1, args.vocab, (6 + i,)).tolist())
        burn.force_burn(active=True, severe=True)
        post(r.randint(1, args.vocab, (8,)).tolist())
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if replicas[0].engine.debug_incidents()["count"]:
                break
            time.sleep(0.1)
        burn.force_burn(active=False)
        fi = json.loads(urllib.request.urlopen(
            f"{base}/debug/fleet/incidents?n=5", timeout=10).read())
        fr = json.loads(urllib.request.urlopen(
            f"{base}/debug/fleet/requests", timeout=10).read())
        tls = fr.get("timelines")
        known = (set(tls) if isinstance(tls, dict)
                 else {t.get("trace_id") for t in tls or []})
        resolved = [t for t in fi["trace_ids"] if t in known]
        stamps = sorted({b.get("replica") for b in fi["incidents"]})
        print(f"[fleet]     /debug/fleet/incidents: {fi['count']} "
              f"incident(s) {fi['by_kind']} stamped replica="
              f"{stamps}; {len(resolved)}/{len(fi['trace_ids'])} "
              f"exemplar trace ids resolve in the merged fleet trace")


def _append_chaos_history(by_kind, dev):
    """One ``serving_chaos_incidents`` row into the repo's
    ``bench_history.jsonl`` (UTC ts; ``BIGDL_BENCH_HISTORY`` names
    another file)."""
    import datetime
    import json
    import os

    import torch

    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    path = (os.environ.get("BIGDL_BENCH_HISTORY")
            or os.path.join(here, "bench_history.jsonl"))
    device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu")
    row = {
        "metric": "serving_chaos_incidents",
        "value": int(sum(by_kind.values())),
        "unit": "incidents",
        "vs_baseline": None,
        "detail": {
            "chaos_drill": True,
            "device": device,
            "incidents": {"count": int(sum(by_kind.values())),
                          "by_kind": dict(by_kind)},
        },
        "ts": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
    }
    try:
        with open(path, "a") as f:
            f.write(json.dumps(row) + "\n")
    except OSError as e:
        print(f"[history]   append failed: {e}")


def _fleet_demo(args):
    """``--fleet N``: the horizontal-scale walkthrough. Everything a
    fleet operator touches, over HTTP where a client would: SSE
    streaming with routing metadata, the routing table, a drain/rejoin
    drill, and the fleet-wide prefix hit rate. Returns one
    ``{"meta", "tokens"}`` row per streamed request of the second lap
    and of the drill."""
    import json
    import urllib.request

    from bigdl_tpu_torch.models.transformer import TransformerLM
    from bigdl_tpu_torch.serving import ContinuousBatchingEngine
    from bigdl_tpu_torch.serving.fleet import (
        FleetFrontDoor, InProcessReplica, ReplicaSupervisor,
    )

    n_rep = args.fleet
    model = TransformerLM(args.vocab, embed_dim=32, num_heads=4,
                          num_kv_heads=2, num_layers=2, max_len=96,
                          use_rope=True, seed=0, device=args.dev)
    model.evaluate()
    replicas = [
        InProcessReplica(
            f"r{i}",
            ContinuousBatchingEngine(model, max_slots=2, prefill_chunk=8,
                                     prefill_rows=2, prefix_cache_rows=4,
                                     service_name=f"fleet-demo-r{i}"))
        for i in range(n_rep)]

    r = np.random.RandomState(0)
    templates = [r.randint(1, args.vocab, (24,)).tolist()
                 for _ in range(2 * n_rep)]
    rows = []

    def post(base, prompt, tenant):
        """One streaming POST /v1/generate; returns (meta, tokens)."""
        body = json.dumps({"prompt_ids": prompt,
                           "max_new_tokens": min(args.tokens, 8),
                           "tenant": tenant, "stream": True}).encode()
        req = urllib.request.Request(
            f"{base}/v1/generate", data=body,
            headers={"Content-Type": "application/json"})
        meta, toks = None, []
        with urllib.request.urlopen(req) as resp:
            event = None
            for raw in resp:
                ln = raw.decode().strip()
                if ln.startswith("event: "):
                    event = ln[7:]
                elif ln.startswith("data: "):
                    payload = json.loads(ln[6:])
                    if event == "meta":
                        meta = payload
                    elif event is None:
                        toks.append(payload["token"])
                    event = None
        return meta, toks

    with ReplicaSupervisor(replicas, chunk=8,
                           fleet_name="demo") as sup, \
            FleetFrontDoor(sup) as door:
        base = f"http://127.0.0.1:{door.port}"
        print(f"[fleet]     {n_rep} in-process replicas behind {base}")

        # one pass over the templates, then a revisit: the second
        # visit of each template lands on the SAME replica (affinity)
        # and hits the prefix KV its first visit left there
        for lap in range(2):
            for ti, tpl in enumerate(templates):
                tail = r.randint(1, args.vocab, (3,)).tolist()
                meta, toks = post(base, tpl + tail, f"tpl-{ti}")
                if lap == 1:
                    rows.append({"prompt": tpl + tail, "meta": meta,
                                 "tokens": toks})
                    print(f"[route]     tpl-{ti} -> {meta['replica']} "
                          f"({meta['route']}), {len(toks)} tokens "
                          "streamed")

        table = json.loads(urllib.request.urlopen(
            f"{base}/v1/replicas").read())
        print(f"[table]     ring: {table['vnodes']} vnodes/replica, "
              f"chunk {table['chunk']} tokens")
        for rid in sorted(table["per_replica"]):
            own = table["ownership"].get(rid, 0.0)
            c = table["per_replica"][rid]
            print(f"[table]       {rid}: {own:.0%} of keyspace, "
                  f"{c['affinity']} affinity + {c['spilled']} spilled "
                  "requests")

        # the drain drill: r0 leaves rotation (in-flight finishes, new
        # traffic routes away), serves nothing, then rejoins
        sup.drain("r0", reason="operator")
        sup.drain_wait("r0", timeout=30)
        meta, toks = post(base, templates[0] + [1, 2], "drill")
        rows.append({"prompt": templates[0] + [1, 2], "meta": meta,
                     "tokens": toks})
        hz = json.loads(urllib.request.urlopen(
            f"{base}/healthz").read())
        print(f"[drain]     r0 draining: /healthz {hz['status']} "
              f"(live {hz['live']}); tpl-0 rerouted to "
              f"{meta['replica']} ({meta['route']})")
        sup.rejoin("r0")
        hz = json.loads(urllib.request.urlopen(
            f"{base}/healthz").read())
        print(f"[rejoin]    r0 back: /healthz {hz['status']} "
              f"(live {hz['live']})")

        stats = json.loads(urllib.request.urlopen(
            f"{base}/v1/stats").read())
        pc = stats["prefix_cache"]
        print(f"[stats]     fleet prefix hit rate "
              f"{pc['hit_rate']:.0%} ({pc['hits']}/{pc['lookups']} "
              f"lookups), {pc['reused_tokens']} tokens served from "
              f"cache across {len(stats['replicas'])} replicas")

        # the telemetry plane: every replica's sampler rings merged
        # onto one clock-aligned timeline, and the capacity model's
        # what-if answer for the load the demo just offered
        ts = json.loads(urllib.request.urlopen(
            f"{base}/debug/fleet/timeseries").read())
        pts = sum(len(s["points"])
                  for m in ts["metrics"].values()
                  for s in m["replicas"].values())
        print(f"[telemetry] /debug/fleet/timeseries: "
              f"{len(ts['metrics'])} metrics x "
              f"{len(ts['replicas'])} replicas, {pts} aligned points "
              f"(dashboard: {base}/debug/fleet/dashboard)")
        cap = json.loads(urllib.request.urlopen(
            f"{base}/debug/fleet/capacity").read())
        if cap.get("ready"):
            print(f"[capacity]  sustainable "
                  f"{cap['sustainable_rps']:.1f} req/s fleet-wide, "
                  f"headroom {cap['headroom']:.0%}, "
                  f"{cap['replicas_needed']} replica(s) needed at the "
                  f"observed {cap['observed_rps']:.1f} req/s")
            what_if = json.loads(urllib.request.urlopen(
                f"{base}/debug/fleet/capacity?offered="
                f"{2 * cap['observed_rps']:.4f}").read())
            print(f"[capacity]  what-if 2x load -> "
                  f"{what_if['replicas_needed']} replica(s) needed")
        body = urllib.request.urlopen(f"{base}/metrics").read().decode()
    shown = [ln for ln in body.splitlines()
             if ln.startswith("bdt_fleet_routed_total")]
    print(f"[metrics]   GET /metrics -> e.g. {'; '.join(shown)}")
    return rows


if __name__ == "__main__":
    main()
